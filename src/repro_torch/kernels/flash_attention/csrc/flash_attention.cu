// flash attention (forward) for Hopper (sm_90a):
//   o[bh] = softmax(mask(q[bh] @ k[bh]^T * hd^-0.5)) @ v[bh]
// for q [BH, Sq, hd] and k, v [BH, Sk, hd], fp32 or bf16, contiguous.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py:
// flash_attention_pallas (pallas_call) with body _flash_kernel. Same
// arithmetic: scores in fp32, scale hd^-0.5, causal mask
// kpos <= q_start + qpos with masked scores set to -1e30, an online softmax
// whose running max m, sum l and output accumulator acc stay in fp32, the
// PV product in fp32, and o = acc / max(l, 1e-30) stored in the input type.
// Keys at kpos >= Sk (the ragged edge) are never admitted: their score is
// -inf, so they add exactly 0. The reference's wrapper padded the keys
// instead and let the padding into the softmax when q_start > 0; this
// kernel matches the plain attention (../ref.py) there.
//
// Design. The Pallas grid (BH, Sq/bq, Sk/bk) walked the KV axis in order on
// one core and carried (m, l, acc) in VMEM scratch across grid steps. On
// Hopper blocks run in no order, so the KV axis becomes a loop inside the
// block: one block of 256 threads owns one (bh, 64-row q tile) and walks
// the keys in tiles of 64. The q tile (pre-transposed), each K tile
// (transposed) and V tile, and the tile's probabilities P sit in shared
// memory as fp32 (119,808 bytes at hd = 128, so the launch raises the
// dynamic shared-memory limit first). Thread (ty, tx), ty in [0,16),
// tx in [0,16), computes a 4x4 block of scores (rows 4ty..4ty+3, keys
// 4tx..4tx+3) with fp32 FMAs on the CUDA cores, reduces the row max and
// sum across the 16 threads of its row group with warp shuffles, and owns
// a 4 x hd/16 slice of acc (columns tx, tx+16, ...). With causal masking a
// block stops at the last key its last row can see: a skipped tile is
// wholly above the diagonal, and since key 0 is visible to every row
// (q_start >= 0) such a tile would give p = 0 and alpha = 1, so skipping
// it is exact. Blocks start with the longest causal rows first.
//
// What bounds it on this card. Work: 4 * BH * Sq * Sk * hd operations (two
// products), halved when causal; bytes: q, k, v and o each moved once. At
// the path shape (BH = 64, S = 2048, hd = 128, bf16, causal) that is
// 68.7 GFLOP against 134 MB: at the H100's 989 TFLOP/s bf16 dense peak and
// 3.35 TB/s the bound is 0.069 ms, set by the operations. This simple
// kernel reads each K/V tile once per q tile from device memory (L2 keeps
// most of it) and does its products in fp32 on the CUDA cores (67 TFLOP/s
// peak), so it is operation-bound at well below the tensor-core peak. Left
// on the table for a later change: mma.sync/wgmma bf16 products with the
// scores kept in registers, TMA/cp.async double buffering of K/V, and GQA
// without repeating the kv heads.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr int TX = 16;            // threads across keys / output columns
constexpr int RM = 4;             // query rows per thread (BQ = 16 * RM)
constexpr int CK = 4;             // keys per thread (BK = TX * CK)
constexpr int THREADS = 256;
constexpr int LDQ = BQ + 4;       // q_s[d][row], padded, 16-byte aligned rows
constexpr int LDK = BK + 4;       // k_s[d][key]
constexpr int LDP = BQ + 4;       // p_s[key][row]
constexpr float NEG_INF = -1e30f; // the reference's mask value

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T store_t(float x);
template <>
__device__ __forceinline__ float store_t<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_t<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as the reference's cast
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (HD * LDQ + HD * LDK + BK * HD + BK * LDP);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
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
  const T* qb = q + bh * Sq * HD;
  const T* kb = k + bh * Sk * HD;
  const T* vb = v + bh * Sk * HD;
  T* ob = o + bh * Sq * HD;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    q_s[d * LDQ + r] = q0 + r < Sq ? load_f(qb + int64_t(q0 + r) * HD + d) : 0.f;
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
      k_s[d * LDK + c] = in ? load_f(kb + off) : 0.f;
      v_s[c * HD + d] = in ? load_f(vb + off) : 0.f;
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
      if (col < HD) ob[int64_t(r) * HD + col] = store_t<T>(acc[i][n] / denom);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Sk, int causal, int q_start, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, causal, q_start,
      float(1.0 / sqrt(double(HD))));  // hd**-0.5 rounded once to fp32
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int BH,
                int Sq, int Sk, int hd, int causal, int q_start,
                cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, o, BH, Sq, Sk, causal, q_start, stream);
    case 16: return launch<T, 16>(q, k, v, o, BH, Sq, Sk, causal, q_start, stream);
    case 32: return launch<T, 32>(q, k, v, o, BH, Sq, Sk, causal, q_start, stream);
    case 64: return launch<T, 64>(q, k, v, o, BH, Sq, Sk, causal, q_start, stream);
    case 128: return launch<T, 128>(q, k, v, o, BH, Sq, Sk, causal, q_start, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error of the launch
// (0 on success); the wrapper raises on anything else.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int Sq,
                                      int Sk, int hd, int dtype, int causal,
                                      int q_start, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, BH, Sq, Sk, hd, causal, q_start, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, BH, Sq, Sk, hd, causal,
                                      q_start, s);
  return int(cudaErrorInvalidValue);
}
