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
// and 3.35 TB/s the bound is 0.069 ms, set by the operations. So the
// products must run on the tensor cores.
//
// bf16 (the main path): flash_kernel_mma, an FA2 schedule on mma.sync.
// One block of NW warps owns one (bh, 16*NW-row q tile); each warp owns 16
// query rows. The Q tile is loaded once into registers as m16n8k16 A
// fragments (ldmatrix). K and V tiles of 64 keys are stored as bf16 in
// shared memory and double-buffered with cp.async (16 bytes a thread), so
// the next tile's copy overlaps this tile's math; each row is padded by
// 16 bytes, which makes every ldmatrix phase hit 32 distinct banks. S = QK^T
// runs as mma.sync m16n8k16 bf16 -> fp32 with K read by ldmatrix; the
// scores stay in registers, where scale, mask and the online softmax run in
// fp32 (ex2.approx with the scale folded into log2 e; row max and sum through
// quad shuffles). P goes from the fp32 accumulator fragment straight into
// bf16 A fragments for P.V, with V read by ldmatrix.trans. P is split into
// two bf16 parts, hi = bf16(p) and lo = bf16(p - hi), and P.V takes one MMA
// for each, so P keeps about 16 bits. With hi alone (the rounding of the
// plain chunked attention in layers/attention.py) the output moves by up to
// about 2^-9 max|v|, which leaves a bf16 result one ulp off the plain
// version now and then; at |o| >= 4 one ulp is 0.031, above the bf16
// tolerance of 2e-2. The lo part removes that, for a second P.V product.
// A warp also skips the key tiles wholly above its own 16 rows. hd = 8 is
// padded to 16 with zero columns in shared memory, which add nothing to
// QK^T. Left for later: wgmma with TMA (an FA3 schedule with a producer
// warp), and GQA without repeating the kv heads.
//
// fp32: flash_kernel, the CUDA-core body. TF32 tensor cores would miss the
// fp32 tolerance of 2e-5, and fp32 is not on the main path. One block of 256
// threads owns a (bh, 64-row q tile) and walks the keys in tiles of 64
// staged in shared memory as fp32; each thread computes a 4x4 block of
// scores with fp32 FMAs and owns a 4 x hd/16 slice of acc.

#include <cstdint>
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

constexpr int NW = 4;             // warps per block: 16 query rows each
constexpr int BKV = 64;           // keys per tile

// 2^x on the special-function unit (flushes denormals; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

template <int HD>
struct MmaShape {
  static constexpr int HDP = HD < 16 ? 16 : HD;  // head dim padded to k16
  static constexpr int LD = HDP + 8;             // smem row, +16 bytes
  static constexpr int BQ = 16 * NW;
  static constexpr size_t smem = sizeof(bf16) * (BQ + 4 * BKV) * LD;
};

template <int HD>
__global__ void __launch_bounds__(NW * 32)
flash_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
                 int Sk, int causal, int q_start, float scale_log2) {
  using S = MmaShape<HD>;
  constexpr int HDP = S::HDP, LD = S::LD, BQ = S::BQ;
  constexpr int THR = NW * 32;
  constexpr int KC = HDP / 16;   // k16 chunks of the head dim
  constexpr int NO = HDP / 8;    // n8 column groups of the output
  constexpr int NS = BKV / 8;    // n8 key groups of a score tile
  constexpr int CPR = HD / 8;    // 16-byte chunks per row in device memory
  extern __shared__ uint4 smem_u4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_u4);  // [BQ][LD]
  bf16* k_s = q_s + BQ * LD;                     // [2][BKV][LD]
  bf16* v_s = k_s + 2 * BKV * LD;                // [2][BKV][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const int wrow = warp * 16;                        // warp's first tile row
  const bf16* qb = q + bh * Sq * HD;
  const bf16* kb = k + bh * Sk * HD;
  const bf16* vb = v + bh * Sk * HD;
  bf16* ob = o + bh * Sq * HD;

  if (HD < HDP) {  // zero the padded columns once; cp.async never writes them
    for (int r = tid; r < BQ + 4 * BKV; r += THR)
      for (int c = HD; c < HDP; ++c) q_s[r * LD + c] = __float2bfloat16(0.f);
  }
  auto load_rows = [&](bf16* dst, const bf16* src, int row0, int rows_total,
                       int rows) {
    for (int c = tid; c < rows * CPR; c += THR) {
      const int r = c / CPR, ch = c % CPR;
      const bool in = row0 + r < rows_total;
      const bf16* p = src + (in ? int64_t(row0 + r) * HD + ch * 8 : 0);
      cp_async16(smem_addr(dst + r * LD + ch * 8), p, in ? 16 : 0);
    }
  };

  // keys this block can see: all of them, or up to its last row's position
  int k_end = Sk;
  if (causal) {
    const int64_t last = int64_t(q_start) + min(q0 + BQ, Sq);  // exclusive
    if (last < Sk) k_end = int(last);
  }
  const int n_tiles = (k_end + BKV - 1) / BKV;
  const int64_t warp_last = int64_t(q_start) + q0 + wrow + 15;  // its last qpos

  load_rows(q_s, qb, q0, Sq, BQ);
  load_rows(k_s, kb, 0, Sk, BKV);
  load_rows(v_s, vb, 0, Sk, BKV);
  cp_async_commit();

  uint32_t qf[KC][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // rows g and g + 8 of the warp
  float l0 = 0.f, l1 = 0.f;          // this thread's part of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_rows(k_s + (buf ^ 1) * BKV * LD, kb, (it + 1) * BKV, Sk, BKV);
      load_rows(v_s + (buf ^ 1) * BKV * LD, vb, (it + 1) * BKV, Sk, BKV);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile `it` (and Q) has landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldmatrix_x4(qf[kc], smem_addr(q_s + (wrow + lane % 16) * LD + kc * 16 +
                                      (lane / 16) * 8));
    }
    const int k0 = it * BKV;
    if (!(causal && k0 > warp_last)) {  // else wholly above this warp's rows
      const bf16* kt = k_s + buf * BKV * LD;
      const bf16* vt = v_s + buf * BKV * LD;
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          uint32_t b[4];
          const int key = j * 8 + (lane % 8) + (lane / 16) * 8;
          const int col = kc * 16 + ((lane / 8) % 2) * 8;
          ldmatrix_x4(b, smem_addr(kt + key * LD + col));
          mma_bf16(s[j], qf[kc], b[0], b[1]);
          mma_bf16(s[j + 1], qf[kc], b[2], b[3]);
        }
      }

      // scale, mask and the online softmax, in fp32 and the log2 domain
      const bool edge = k0 + BKV > Sk || (causal && k0 + BKV - 1 >
                                          int64_t(q_start) + q0 + wrow);
      const int qpos = q_start + q0 + wrow + g;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (edge) {
            const int kpos = k0 + j * 8 + 2 * t + (e & 1);
            if (kpos >= Sk) x = -INFINITY;  // ragged edge: never admitted
            else if (causal && kpos > qpos + (e / 2) * 8) x = NEG_INF;
          }
          s[j][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float alpha0 = ex2(m0 - mx0), alpha1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][0] = ex2(s[j][0] - mx0);
        s[j][1] = ex2(s[j][1] - mx0);
        s[j][2] = ex2(s[j][2] - mx1);
        s[j][3] = ex2(s[j][3] - mx1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha0;
        acc[n][1] *= alpha0;
        acc[n][2] *= alpha1;
        acc[n][3] *= alpha1;
      }

      // acc += P V: the score fragments become bf16 A fragments in place,
      // P = hi + lo with both parts in bf16
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) {
        uint32_t hi[4], lo[4];
        split_bf16(s[2 * kc][0], s[2 * kc][1], hi[0], lo[0]);
        split_bf16(s[2 * kc][2], s[2 * kc][3], hi[1], lo[1]);
        split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], hi[2], lo[2]);
        split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t b[4];
          const int key = kc * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
          const int col = n * 8 + (lane / 16) * 8;
          ldmatrix_x4_trans(b, smem_addr(vt + key * LD + col));
          mma_bf16(acc[n], hi, b[0], b[1]);
          mma_bf16(acc[n + 1], hi, b[2], b[3]);
          mma_bf16(acc[n], lo, b[0], b[1]);
          mma_bf16(acc[n + 1], lo, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer `buf`
  }

#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int r0 = q0 + wrow + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= HD) continue;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + int64_t(r0) * HD + col) =
          __floats2bfloat162_rn(acc[n][0] / d0, acc[n][1] / d0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + int64_t(r1) * HD + col) =
          __floats2bfloat162_rn(acc[n][2] / d1, acc[n][3] / d1);
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int BH, int Sq, int Sk, int causal, int q_start,
                        cudaStream_t stream) {
  using S = MmaShape<HD>;
  auto kernel = flash_kernel_mma<HD>;
  if (S::smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(S::smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(BH, (Sq + S::BQ - 1) / S::BQ);
  // hd**-0.5 * log2(e), rounded once: exp(x * scale) == exp2(x * scale_log2)
  const float scale_log2 = float(1.4426950408889634 / sqrt(double(HD)));
  kernel<<<grid, NW * 32, S::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, causal,
      q_start, scale_log2);
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
