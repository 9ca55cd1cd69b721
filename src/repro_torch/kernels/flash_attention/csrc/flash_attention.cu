// flash attention (forward) for Hopper (sm_90a):
//   o[bh] = softmax(mask(q[bh] @ k[bh]^T * hd^-0.5)) @ v[bh]
// for q [BH, Sq, hd] and k, v [BH, Sk, hd], bf16 or fp32, contiguous.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py:
// flash_attention_pallas (pallas_call) with body _flash_kernel. Same
// arithmetic: scores in fp32, scale hd^-0.5, causal mask
// kpos <= q_start + qpos with masked scores set to -1e30, an online softmax
// whose running max m, sum l and output accumulator acc stay in fp32, and
// o = acc / max(l, 1e-30) rounded once to the input type. Keys at kpos >= Sk
// (the ragged edge) are never admitted: their score is -inf, so they add
// exactly 0. The reference's wrapper padded the keys instead and let the
// padding into the softmax when q_start > 0; these kernels match the plain
// attention (../ref.py) there.
//
// The Pallas grid (BH, Sq/bq, Sk/bk) walked the KV axis in order on one core
// and carried (m, l, acc) in VMEM scratch across grid steps. On Hopper
// blocks run in no order, so the KV axis is a loop inside the block. With
// causal masking a block stops at the last key its last row can see: a
// skipped tile is wholly above the diagonal, and since key 0 is visible to
// every row (q_start >= 0) such a tile would give p = 0 and alpha = 1, so
// skipping it is exact. Blocks start with the longest causal rows first.
//
// What bounds it on this card. Work: 4 * BH * Sq * Sk * hd operations (two
// products), halved when causal; bytes: q, k, v and o each moved once. At
// the yi-6b prefill shape (BH = 64, S = 2048, hd = 128, bf16, causal) that
// is 68.7 GFLOP against 134 MB: at the H100's 989 TFLOP/s bf16 dense peak
// and 3.35 TB/s the bound is 0.069 ms, set by the operations. The bf16
// body issues 1.5 times that tensor work (P.V twice, below), so its own
// floor there is 0.104 ms.
//
// bf16 runs flash_kernel_wgmma on the tensor cores, fp32 (off the main
// path) flash_kernel on the CUDA cores.
//
// bf16 P.V precision. P is split into two bf16 parts, hi = bf16(p) and
// lo = bf16(p - hi), and P.V takes one product for each, so P keeps about
// 16 bits. With hi alone (the rounding of the plain chunked attention in
// layers/attention.py) the output moves by up to about 2^-9 max|v|, which
// leaves a bf16 result one ulp off the plain version now and then; at
// |o| >= 4 one ulp is 0.031, above the bf16 tolerance of 2e-2. The lo part
// removes that, for a second P.V product.
//
// flash_kernel_wgmma, the bf16 body (an FA3 schedule). One block of three
// warpgroups owns one (bh, 128-row q tile) and walks the keys in tiles of
// 128. Warpgroup 0 is the producer: it gives up registers (setmaxnreg 24)
// and one of its threads loads Q once and K and V into two rings of two
// stages by TMA (cp.async.bulk.tensor over 3-D tensor maps of [BH, S, hd],
// 128-byte swizzle, boxes of 64 columns x 128 rows, two per row above hd
// 64), behind full and empty mbarriers for K and V apart. TMA fills rows
// past S and columns past hd with zeros, so ragged Sq and Sk need no
// padding in device memory. Warpgroups 1 and 2 are the consumers
// (setmaxnreg 240), 64 query rows each. S = Q K^T is wgmma m64n128k16 with
// both operands K-major in shared memory; its fp32 accumulator fragment is
// the softmax's input and, split into hi and lo, the A operand of
// O += P V (wgmma m64n{hd}k16, A from registers, V MN-major through the
// descriptor's transpose bit). A consumer issues Q K^T of tile i and P V
// of tile i - 1 together and runs the softmax of tile i while P V is still
// in flight; two named barriers make the consumers take turns at issuing,
// so that one's softmax overlaps the other's products. Only the diagonal
// and the ragged tiles are masked; elsewhere the scale is fused into the
// exponent's FMA. Each consumer holds S (64 registers), O (hd / 2) and
// P hi + lo (64): no spills. Shared memory: Q + 2 x (K + V) = 160 KB at
// hd 80 and 128, 80 KB up to hd 64; one block per SM. Every head dim runs
// natively: Q and K are zero-filled to whole boxes in shared memory, Q K^T
// takes ceil(hd / 16) k16 steps (five at hd 80; at hd 8 the one step reads
// 8 zero columns), and P V is m64n{hd}. Blocks go out in groups of heads
// whose K and V fit in 32 MB of L2, within a group the longest causal rows
// first. A wait on an mbarrier that lasts 10 s can only be a broken
// pipeline and traps, so that the launch fails instead of hanging.
//
// flash_kernel, the fp32 CUDA-core body. TF32 tensor cores would miss the
// fp32 tolerance of 2e-5, and fp32 is not on the main path. One block of 256
// threads owns a (bh, 64-row q tile) and walks the keys in tiles of 64
// staged in shared memory as fp32; each thread computes a 4x4 block of
// scores with fp32 FMAs and owns a 4 x hd/16 slice of acc.
//
// Left for later: a persistent schedule (a block's epilogue overlapping the
// next tile's loads), and GQA without repeating the kv heads.

#include <algorithm>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;  // the reference's mask value

// ---------------------------------------------------------------- fp32 body

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr int TX = 16;            // threads across keys / output columns
constexpr int RM = 4;             // query rows per thread (BQ = 16 * RM)
constexpr int CK = 4;             // keys per thread (BK = TX * CK)
constexpr int THREADS = 256;
constexpr int LDQ = BQ + 4;       // q_s[d][row], padded, 16-byte aligned rows
constexpr int LDK = BK + 4;       // k_s[d][key]
constexpr int LDP = BQ + 4;       // p_s[key][row]

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (HD * LDQ + HD * LDK + BK * HD + BK * LDP);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             int Sq, int Sk, int causal, int q_start, float scale) {
  constexpr int CN = (HD + TX - 1) / TX;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [HD][LDQ]
  float* k_s = q_s + HD * LDQ;                   // [HD][LDK]
  float* v_s = k_s + HD * LDK;                   // [BK][HD]
  float* p_s = v_s + BK * HD;                    // [BK][LDP]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const float* qb = q + bh * Sq * HD;
  const float* kb = k + bh * Sk * HD;
  const float* vb = v + bh * Sk * HD;
  float* ob = o + bh * Sq * HD;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    q_s[d * LDQ + r] = q0 + r < Sq ? qb[int64_t(q0 + r) * HD + d] : 0.f;
  }

  float m[RM], l[RM], acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < CN; ++n) acc[i][n] = 0.f;
  }

  // keys this block can see: all of them, or up to its last row's position
  int k_end = Sk;
  if (causal) {
    const int64_t last = int64_t(q_start) + min(q0 + BQ, Sq);  // exclusive
    if (last < Sk) k_end = int(last);
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int c = idx / HD, d = idx % HD;
      const bool in = k0 + c < Sk;
      const int64_t off = int64_t(k0 + c) * HD + d;
      k_s[d * LDK + c] = in ? kb[off] : 0.f;
      v_s[c * HD + d] = in ? vb[off] : 0.f;
    }
    __syncthreads();

    float s[RM][CK];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(q_s + d * LDQ + ty * RM);
      const float4 b = *reinterpret_cast<const float4*>(k_s + d * LDK + tx * CK);
      const float av[RM] = {a.x, a.y, a.z, a.w};
      const float bv[CK] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q_start + q0 + ty * RM + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kpos = k0 + tx * CK + j;
        float x = s[i][j] * scale;
        if (kpos >= Sk) x = -INFINITY;                 // ragged edge: never admitted
        else if (causal && kpos > qpos) x = NEG_INF;   // the reference's mask
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < CN; ++n) acc[i][n] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      *reinterpret_cast<float4*>(p_s + (tx * CK + j) * LDP + ty * RM) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    const int c_end = min(BK, Sk - k0);
    for (int c = 0; c < c_end; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(p_s + c * LDP + ty * RM);
      const float pv[RM] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int n = 0; n < CN; ++n) {
        const int col = n * TX + tx;
        if (col < HD) {
          const float x = v_s[c * HD + col];
#pragma unroll
          for (int i = 0; i < RM; ++i) acc[i][n] = fmaf(pv[i], x, acc[i][n]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty * RM + i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < CN; ++n) {
      const int col = n * TX + tx;
      if (col < HD) ob[int64_t(r) * HD + col] = acc[i][n] / denom;
    }
  }
}

template <int HD>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o,
                        int BH, int Sq, int Sk, int causal, int q_start,
                        cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_kernel<HD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, causal,
      q_start, float(1.0 / sqrt(double(HD))));  // hd**-0.5 rounded once
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 body

using bf16 = __nv_bfloat16;

// 2^x on the special-function unit (flushes denormals; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// (x0, x1) = hi + lo: hi rounded to bf16 (nearest even), lo the bf16 of the
// rest; packed two to a register, x0 in the low half
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h),
                                                 x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

constexpr int WG = 128;               // threads of a warpgroup
constexpr int HBQ = 128;              // query rows per block, 64 per consumer
constexpr int HBK = 128;              // keys per tile
constexpr int BOX_COLS = 64;          // bf16 columns of a 128-byte swizzle atom
constexpr int BOX_BYTES = 128 * 128;  // one box: 128 rows of 128 bytes
// registers after setmaxnreg: 24 + 2 * 240 = 3 * 168, the launch's share
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr long long WAIT_LIMIT_NS = 10000000000LL;  // a stuck pipeline traps

template <int HD>
struct WgShape {
  static constexpr int NB = (HD + BOX_COLS - 1) / BOX_COLS;  // boxes a row
  static constexpr int STAGES = 2;             // K and V rings
  static constexpr int TILE = NB * BOX_BYTES;  // a Q, K or V tile
  static constexpr int BARS = 1 + 4 * STAGES;  // q_full, full and empty K, V
  // 1024 of slack to align the tiles to the swizzle's 1024-byte period
  static constexpr size_t smem =
      1024 + size_t(TILE) * (1 + 2 * STAGES) + 8 * BARS;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity` to complete. A wait of more than
// WAIT_LIMIT_NS can only be a broken pipeline: it traps, so that the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint64_t t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = global_ns();
    else if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
  }
}

// TMA: the box at (c0 columns, c1 rows, c2 = bh) into shared memory at
// dst; its bytes complete on the barrier, and rows and columns outside the
// tensor arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t(lbo >> 4) << 16 |
         uint64_t(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from touching registers a wgmma still owns
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// d (+)= A B, m64n128k16, A and B K-major in shared memory (descriptors);
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64n8k16, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n16k16, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n32k16, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n64k16, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n80k16, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n128k16, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 8) wgmma_rs_n8(d, a, db);
  else if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 80) wgmma_rs_n80(d, a, db);
  else {
    static_assert(N == 128, "a head dim the kernel is not built for");
    wgmma_rs_n128(d, a, db);
  }
}

// bar.sync / bar.arrive on a named barrier of the two consumer warpgroups
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * WG) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * WG) : "memory");
}

// S = Q K^T for one key tile: both K-major; a k16 step is 32 bytes into a
// swizzle atom, the fifth starts the second box. At hd 8 the one step
// reads 8 zero-filled columns.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[HBK / 2], uint64_t dq,
                                         uint64_t dk) {
#pragma unroll
  for (int ks = 0; ks < (HD + 15) / 16; ++ks) {
    const uint32_t off = ((ks / 4) * BOX_BYTES + (ks % 4) * 32) >> 4;
    wgmma_ss_n128(s, dq + off, dk + off, ks > 0);
  }
}

// acc += P V, P = hi + lo from registers, one wgmma for each part
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         uint32_t (&hi)[HBK / 16][4],
                                         uint32_t (&lo)[HBK / 16][4],
                                         uint64_t dv) {
#pragma unroll
  for (int kc = 0; kc < HBK / 16; ++kc) {
    const uint32_t off = (kc * 16 * 128) >> 4;  // 16 keys of 128 bytes
    wgmma_rs<HD>(acc, hi[kc], dv + off);
    wgmma_rs<HD>(acc, lo[kc], dv + off);
  }
}

// max (sum) of s[4j + o] and s[4j + o + 1] over j, as a tree
template <bool MAX>
__device__ __forceinline__ float row_reduce(const float (&s)[HBK / 2],
                                            int o) {
  float r[HBK / 8];
#pragma unroll
  for (int j = 0; j < HBK / 8; ++j)
    r[j] = MAX ? fmaxf(s[4 * j + o], s[4 * j + o + 1])
               : s[4 * j + o] + s[4 * j + o + 1];
  static_assert(HBK / 8 == 16, "four levels below");
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = MAX ? fmaxf(r[j], r[j + 8]) : r[j] + r[j + 8];
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = MAX ? fmaxf(r[j], r[j + 4]) : r[j] + r[j + 4];
#pragma unroll
  for (int j = 0; j < 2; ++j) r[j] = MAX ? fmaxf(r[j], r[j + 2]) : r[j] + r[j + 2];
  return MAX ? fmaxf(r[0], r[1]) : r[0] + r[1];
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Scale, mask and the online softmax of one score tile, in fp32 and the
// log2 domain: s becomes P, m and l move on, alpha rescales acc.
// s[4j + e] is row g + 8 (e / 2), key k0 + 8j + 2t + (e & 1). Only a tile
// on the diagonal or the ragged edge is masked; elsewhere the scale is
// fused into the exponent's FMA (the row max is taken before scaling,
// which the positive scale leaves in place).
__device__ __forceinline__ void online_softmax(
    float (&s)[HBK / 2], bool edge, int k0, int Sk, bool causal, int qpos,
    int t, float scale_log2, float& m0, float& m1, float& l0, float& l1,
    float& alpha0, float& alpha1) {
  float mx0, mx1;
  if (edge) {
#pragma unroll
    for (int j = 0; j < HBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[4 * j + e] * scale_log2;
        if (kpos >= Sk) x = -INFINITY;  // ragged edge: never admitted
        else if (causal && kpos > qpos + (e / 2) * 8) x = NEG_INF;
        s[4 * j + e] = x;
      }
    mx0 = fmaxf(m0, quad_max(row_reduce<true>(s, 0)));
    mx1 = fmaxf(m1, quad_max(row_reduce<true>(s, 2)));
#pragma unroll
    for (int j = 0; j < HBK / 8; ++j) {
      s[4 * j] = ex2(s[4 * j] - mx0);
      s[4 * j + 1] = ex2(s[4 * j + 1] - mx0);
      s[4 * j + 2] = ex2(s[4 * j + 2] - mx1);
      s[4 * j + 3] = ex2(s[4 * j + 3] - mx1);
    }
  } else {
    mx0 = fmaxf(m0, quad_max(row_reduce<true>(s, 0)) * scale_log2);
    mx1 = fmaxf(m1, quad_max(row_reduce<true>(s, 2)) * scale_log2);
#pragma unroll
    for (int j = 0; j < HBK / 8; ++j) {
      s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -mx0));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -mx0));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -mx1));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -mx1));
    }
  }
  alpha0 = ex2(m0 - mx0);
  alpha1 = ex2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  l0 = l0 * alpha0 + row_reduce<false>(s, 0);
  l1 = l1 * alpha1 + row_reduce<false>(s, 2);
}

// P as bf16 hi + lo A fragments: the accumulator layout of S is the A
// layout of P (keys 16kc..16kc+15 are S's n8 blocks 2kc and 2kc + 1)
__device__ __forceinline__ void split_p(const float (&s)[HBK / 2],
                                        uint32_t (&hi)[HBK / 16][4],
                                        uint32_t (&lo)[HBK / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < HBK / 16; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1], hi[kc][r],
                 lo[kc][r]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], float alpha0,
                                        float alpha1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    acc[4 * j] *= alpha0;
    acc[4 * j + 1] *= alpha0;
    acc[4 * j + 2] *= alpha1;
    acc[4 * j + 3] *= alpha1;
  }
}

template <int HD>
__global__ void __launch_bounds__(3 * WG, 1)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   bf16* __restrict__ o, int BH, int Sq, int Sk, int causal,
                   int q_start, float scale_log2, int n_qt,
                   int heads_per_group) {
  using S = WgShape<HD>;
  constexpr int ST = S::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                       // [NB][128 rows][64]
  const uint32_t k_s = base + S::TILE;             // [ST][NB][128][64]
  const uint32_t v_s = base + S::TILE * (1 + ST);  // [ST][NB][128][64]
  const uint32_t q_full = base + S::TILE * (1 + 2 * ST);
  const uint32_t full_k = q_full + 8;              // [ST] each
  const uint32_t full_v = full_k + 8 * ST;
  const uint32_t empty_k = full_v + 8 * ST;
  const uint32_t empty_v = empty_k + 8 * ST;

  // the block's (bh, q tile): heads in groups whose K and V fit in L2,
  // within a group the longest causal rows first
  const int span = heads_per_group * n_qt;
  const int grp = blockIdx.x / span, rem = blockIdx.x % span;
  const int hg = min(heads_per_group, BH - grp * heads_per_group);
  const int bh = grp * heads_per_group + rem % hg;
  const int q0 = (n_qt - 1 - rem / hg) * HBQ;

  // keys this block can see: all of them, or up to its last row's position
  int k_end = Sk;
  if (causal) {
    const int64_t last = int64_t(q_start) + min(q0 + HBQ, Sq);  // exclusive
    if (last < Sk) k_end = int(last);
  }
  const int n_tiles = (k_end + HBK - 1) / HBK;

  const int tid = threadIdx.x, wg = tid / WG;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty_k + 8 * st, 8);  // one arrival per consumer warp
      mbar_init(empty_v + 8 * st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread keeps the K and V rings full by TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      mbar_expect_tx(q_full, S::TILE);
      for (int b = 0; b < S::NB; ++b)
        tma_load(q_s + b * BOX_BYTES, &tq, b * BOX_COLS, q0, bh, q_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % ST, ph = (it / ST) & 1;
        mbar_wait(empty_k + 8 * st, ph ^ 1);  // the first round passes
        mbar_expect_tx(full_k + 8 * st, S::TILE);
        for (int b = 0; b < S::NB; ++b)
          tma_load(k_s + st * S::TILE + b * BOX_BYTES, &tk, b * BOX_COLS,
                   it * HBK, bh, full_k + 8 * st);
        mbar_wait(empty_v + 8 * st, ph ^ 1);
        mbar_expect_tx(full_v + 8 * st, S::TILE);
        for (int b = 0; b < S::NB; ++b)
          tma_load(v_s + st * S::TILE + b * BOX_BYTES, &tv, b * BOX_COLS,
                   it * HBK, bh, full_v + 8 * st);
      }
    }
  } else {
    // two consumers of 64 query rows each. Each issues Q K^T of tile i
    // and P V of tile i - 1 together, then runs the softmax of tile i
    // while P V is still in flight; named barriers 1 and 2 let the two
    // warpgroups take turns at issuing, so that one's softmax overlaps
    // the other's products.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = wg - 1, warp = (tid / 32) % 4, lane = tid % 32;
    const int t = lane % 4;
    const int row0 = c * 64 + warp * 16;  // the warp's first row in the tile
    const int64_t warp_first = int64_t(q_start) + q0 + row0;
    const int qpos = q_start + q0 + row0 + lane / 4;
    const bool is_causal = causal != 0;

    float acc[HD / 2], s[HBK / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < HBK / 2; ++i) s[i] = 0.f;
    uint32_t hi[HBK / 16][4], lo[HBK / 16][4];
    float m0 = NEG_INF, m1 = NEG_INF;  // rows g and g + 8 of the warp
    float l0 = 0.f, l1 = 0.f;          // this thread's part of the row sums
    float alpha0, alpha1;
    // Q and K: K-major, 8-row groups 1024 bytes apart (this consumer's 64
    // rows of Q); V: MN-major, 8-key groups 1024 bytes apart, 64-column
    // atoms a box apart
    const uint64_t dq = smem_desc(q_s + c * 64 * 128, 16, 1024);
    auto dk = [&](int st) { return smem_desc(k_s + st * S::TILE, 16, 1024); };
    auto dv = [&](int st) {
      return smem_desc(v_s + st * S::TILE, BOX_BYTES, 1024);
    };
    auto edge = [&](int k0) {
      return k0 + HBK > Sk || (is_causal && k0 + HBK - 1 > warp_first);
    };
    // turns: consumer 0 issues first; the last turn of consumer 1 passes
    // nothing on, so every arrival is matched by a sync
    const int my_turn = 1 + c, their_turn = 2 - c;
    if (c == 1) named_arrive(1);

    mbar_wait(q_full, 0);
    mbar_wait(full_k, 0);
    named_sync(my_turn);
    wgmma_fence();
    issue_qk<HD>(s, dq, dk(0));
    wgmma_commit();
    named_arrive(their_turn);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(empty_k);
    online_softmax(s, edge(0), 0, Sk, is_causal, qpos, t, scale_log2, m0, m1,
                   l0, l1, alpha0, alpha1);
    split_p(s, hi, lo);

    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % ST, ph = (it / ST) & 1;
      const int pst = (it - 1) % ST, pph = ((it - 1) / ST) & 1;
      mbar_wait(full_k + 8 * st, ph);
      mbar_wait(full_v + 8 * pst, pph);
      named_sync(my_turn);
      wgmma_fence();
      issue_qk<HD>(s, dq, dk(st));
      wgmma_commit();
      issue_pv<HD>(acc, hi, lo, dv(pst));
      wgmma_commit();
      named_arrive(their_turn);
      wgmma_wait<1>();  // Q K^T of tile `it` is done
      fence_regs(s);
      if (lane == 0) mbar_arrive(empty_k + 8 * st);
      online_softmax(s, edge(it * HBK), it * HBK, Sk, is_causal, qpos, t,
                     scale_log2, m0, m1, l0, l1, alpha0, alpha1);
      wgmma_wait<0>();  // P V of tile it - 1 is done
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
      if (lane == 0) mbar_arrive(empty_v + 8 * pst);
      rescale(acc, alpha0, alpha1);
      split_p(s, hi, lo);
    }
    const int lst = (n_tiles - 1) % ST, lph = ((n_tiles - 1) / ST) & 1;
    mbar_wait(full_v + 8 * lst, lph);
    named_sync(my_turn);
    wgmma_fence();
    issue_pv<HD>(acc, hi, lo, dv(lst));
    wgmma_commit();
    if (c == 0) named_arrive(their_turn);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    if (lane == 0) mbar_arrive(empty_v + 8 * lst);

#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const int r0 = q0 + row0 + lane / 4, r1 = r0 + 8;
    bf16* ob = o + int64_t(bh) * Sq * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (r0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + int64_t(r0) * HD + col) =
            __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
      if (r1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + int64_t(r1) * HD + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that nothing links libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [BH, S, hd] bf16 read in boxes of 64 columns x 128 rows, 128-byte swizzle;
// rows past S and columns past hd read as zeros
bool tensor_map(CUtensorMap* map, const void* ptr, int BH, int S, int hd) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(hd), cuuint64_t(S), cuuint64_t(BH)};
  const cuuint64_t strides[2] = {cuuint64_t(hd) * 2, cuuint64_t(S) * hd * 2};
  const cuuint32_t box[3] = {BOX_COLS, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int BH, int Sq, int Sk, int causal, int q_start,
                         cudaStream_t stream) {
  using S = WgShape<HD>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, BH, Sq, HD) || !tensor_map(&tk, k, BH, Sk, HD) ||
      !tensor_map(&tv, v, BH, Sk, HD))
    return cudaErrorInvalidValue;
  auto kernel = flash_kernel_wgmma<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(S::smem));
  if (err != cudaSuccess) return err;
  const int n_qt = (Sq + HBQ - 1) / HBQ;
  // heads whose K and V together fit in 32 MB of the 50 MB L2
  const int64_t kv_head = int64_t(Sk) * HD * 4;
  const int per_group = int(std::max<int64_t>(
      1, std::min<int64_t>(BH, (int64_t(32) << 20) / kv_head)));
  const float scale_log2 = float(1.4426950408889634 / sqrt(double(HD)));
  kernel<<<unsigned(int64_t(BH) * n_qt), 3 * WG, S::smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), BH, Sq, Sk, causal, q_start,
      scale_log2, n_qt, per_group);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, int BH, int Sq, int Sk, int causal, int q_start,
                   cudaStream_t s) {
  if (dtype == 0)
    return launch_fp32<HD>(q, k, v, o, BH, Sq, Sk, causal, q_start, s);
  if (dtype == 1)
    return launch_bf16<HD>(q, k, v, o, BH, Sq, Sk, causal, q_start, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o 16-byte aligned). Returns
// the CUDA error of the launch (0 on success); the wrapper raises on
// anything else.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int Sq,
                                      int Sk, int hd, int dtype, int causal,
                                      int q_start, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (hd) {
    case 8: err = launch<8>(dtype, q, k, v, o, BH, Sq, Sk, causal, q_start, s); break;
    case 16: err = launch<16>(dtype, q, k, v, o, BH, Sq, Sk, causal, q_start, s); break;
    case 32: err = launch<32>(dtype, q, k, v, o, BH, Sq, Sk, causal, q_start, s); break;
    case 64: err = launch<64>(dtype, q, k, v, o, BH, Sq, Sk, causal, q_start, s); break;
    case 80: err = launch<80>(dtype, q, k, v, o, BH, Sq, Sk, causal, q_start, s); break;
    case 128: err = launch<128>(dtype, q, k, v, o, BH, Sq, Sk, causal, q_start, s); break;
  }
  return int(err);
}
