// qmatmul for Hopper (sm_90a): y[M,N] = ReLU?(SRS(x[M,K] @ w[K,N] + bias[N])).
//
// Replaces the TPU kernel src/repro/kernels/qmatmul/qmatmul.py:qmatmul_pallas
// (body _qmatmul_kernel, epilogue _srs_block). Bit-exact against the plain
// version in ../ref.py: the int32 accumulator wraps, SRS rounds by floor,
// half_up or half_even, saturates to int8/int16, and ReLU runs after SRS.
//
// Exactness. Addition modulo 2^32 is associative and commutative, so any
// tiling, any split of K and any place for the bias give the same bits. The
// Pallas (qm x qn) macro-tile and its sequential K grid are therefore not
// carried over. The products run on the int8 tensor cores,
// mma.sync.m16n8k32.s32.{s8,u8}.{s8,u8}.s32 without .satfinite, whose s32
// accumulator wraps modulo 2^32 like the reference's int32. An int16
// operand is split into bytes, x = xh * 2^8 + xl with xh = x >> 8 (signed)
// and xl = x & 0xFF (unsigned): int16 x int8 takes two MMAs (s8.s8 and
// u8.s8) recombined as (acc_h << 8) + acc_l, int16 x int16 four (shifts 16,
// 8, 8, 0; the two middle ones share an accumulator). Every step is exact
// modulo 2^32. Sums are kept as uint32_t (signed overflow is undefined in
// C++) and reinterpreted as int32 only in the epilogue.
//
// Design. A block owns a BM x 128 output tile (BM = 16 for M <= 16, four
// warps of 16 x 32; else BM = 64, eight warps of 32 x 32) and walks its
// range of K in stages of 64, four stages in flight through cp.async (16
// bytes a thread). Both operands are staged at their own width (1 or 2
// bytes) with an XOR swizzle of the 16-byte chunks that keeps every
// fragment load free of bank conflicts. x tiles are k-contiguous, so an A
// fragment is one 32-bit (int8) or 64-bit (int16, split by __byte_perm)
// load. w is (K, N) with n contiguous, while a B fragment wants four
// consecutive k of one n: each thread loads a 4 x 4 byte block (four k rows,
// four columns) and transposes it in registers with __byte_perm, which
// gives it one fragment for each of four n8 groups. The columns of a group
// are thereby permuted, which the epilogue undoes: a thread ends up owning
// eight consecutive output columns of each of its rows. Ragged M, N and K
// are zero-filled by the copies; operands whose rows are not 16-byte
// aligned take a scalar loading path into the same layout.
//
// Split-K. When the (M, N) tiles fill fewer than about two waves of the
// SMs, the host plan (ops.py) splits K across blocks (blockIdx.z). Each
// split writes its uint32 partial sums to a workspace [splits, M, N], and
// qmatmul_kernel_reduce sums them, adds the bias and runs the SRS epilogue;
// a call with one split runs the epilogue in qmatmul_kernel itself.
//
// What bounds it on this card. At the decode shapes of the LM path (M = 4:
// the a16w8 down-projection 4 x 11008 x 4096 and the int8 head 4 x 4096 x
// 64000) it is the bytes of w: 45 MB and 262 MB, 0.013 and 0.078 ms at
// 3.35 TB/s. Split-K puts 9 blocks on each of the down-projection's 32
// column tiles so that every SM streams w. The paper models' GEMMs (M x K x
// N from 1x512x512 to 1024x512x256, int8) need under 1.5 MB each: launch
// cost and the latency of one pass over K bound them. Left for later:
// wgmma with TMA, and persistent blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 128;     // output columns per block
constexpr int BK = 64;      // contraction depth per pipeline stage
constexpr int STAGES = 4;   // pipeline stages in flight

// Rounding codes, in the order of VALID_ROUNDING in repro_torch.quant.srs.
constexpr int FLOOR = 0, HALF_UP = 1, HALF_EVEN = 2;

__device__ __forceinline__ int32_t round_shift(uint32_t acc, int shift,
                                               int rounding) {
  const int32_t v = static_cast<int32_t>(acc);
  if (shift == 0) return v;
  if (rounding == FLOOR) return v >> shift;
  const uint32_t half = 1u << (shift - 1);
  if (rounding == HALF_UP) return static_cast<int32_t>(acc + half) >> shift;
  const int32_t floor = v >> shift;
  const uint32_t rem = acc & ((1u << shift) - 1u);  // in [0, 2^shift)
  const bool bump = rem > half || (rem == half && (floor & 1));
  return floor + static_cast<int32_t>(bump);
}

// SRS, saturation to the output type, ReLU after SRS; stores y[idx]
__device__ __forceinline__ void store_out(void* y, int64_t idx, uint32_t acc,
                                          int shift, int rounding, int relu,
                                          int out_bits) {
  const int32_t v = round_shift(acc, shift, rounding);
  const int32_t lo = relu ? 0 : (out_bits == 8 ? -128 : -32768);
  const int32_t hi = out_bits == 8 ? 127 : 32767;
  const int32_t r = min(max(v, lo), hi);
  if (out_bits == 8)
    static_cast<int8_t*>(y)[idx] = static_cast<int8_t>(r);
  else
    static_cast<int16_t*>(y)[idx] = static_cast<int16_t>(r);
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

// d += a (16x32, row) * b (32x8, col); AU/BU: the operand is unsigned (u8)
template <bool AU, bool BU>
__device__ __forceinline__ void mma_i8(uint32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
#define QMM_MMA(TYPES)                                                      \
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." TYPES ".s32 "       \
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"    \
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
  if constexpr (!AU && !BU) QMM_MMA("s8.s8");
  else if constexpr (AU && !BU) QMM_MMA("u8.s8");
  else if constexpr (!AU && BU) QMM_MMA("s8.u8");
  else QMM_MMA("u8.u8");
#undef QMM_MMA
}

// high and low bytes of four int16 packed in (x, y)
__device__ __forceinline__ uint32_t hi_bytes(uint32_t x, uint32_t y) {
  return __byte_perm(x, y, 0x7531);
}
__device__ __forceinline__ uint32_t lo_bytes(uint32_t x, uint32_t y) {
  return __byte_perm(x, y, 0x6420);
}

// r[i] holds bytes (row i, columns 0..3); on return r[j] holds
// (rows 0..3 of column j)
__device__ __forceinline__ void transpose4x4(uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

template <typename TA, typename TB, int BM>
struct Tile {
  static constexpr int MT = BM == 16 ? 1 : 2;      // m16 tiles per warp
  static constexpr int WARPS = (BM / (16 * MT)) * 4;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int XROW = BK * int(sizeof(TA));  // bytes of an x row
  static constexpr int WROW = BN * int(sizeof(TB));  // bytes of a w row
  static constexpr int XBYTES = BM * XROW;
  static constexpr int STAGE = XBYTES + BK * WROW;
  static constexpr int SMEM = STAGES * STAGE;
  // byte offset of (row, byte) in the swizzled x and w tiles
  static __device__ __forceinline__ int xoff(int r, int b) {
    const int c = b / 16;
    const int p = sizeof(TA) == 1 ? c ^ ((r >> 1) & 3) : c ^ ((r & 3) << 1);
    return r * XROW + p * 16 + b % 16;
  }
  static __device__ __forceinline__ int woff(int r, int b) {
    return r * WROW + ((b / 16) ^ (((r >> 2) & 3) << 1)) * 16 + b % 16;
  }
};

template <typename TA, typename TB, int BM, bool VEC>
__global__ void __launch_bounds__(Tile<TA, TB, BM>::THREADS)
qmatmul_kernel(const TA* __restrict__ x, const TB* __restrict__ w,
               const int32_t* __restrict__ bias, void* __restrict__ y,
               uint32_t* __restrict__ partial, int M, int K, int N,
               int k_per_split, int shift, int rounding, int relu,
               int out_bits) {
  using T = Tile<TA, TB, BM>;
  constexpr int MT = T::MT, THR = T::THREADS;
  constexpr bool A16 = sizeof(TA) == 2, B16 = sizeof(TB) == 2;
  constexpr int PARTS = A16 ? (B16 ? 3 : 2) : 1;  // accumulators per output
  extern __shared__ uint4 smem_u4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_u4);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;  // warp's row block, column block
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_lo = blockIdx.z * k_per_split;
  const int k_hi = min(K, k_lo + k_per_split);
  const int n_stages = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  auto load_stage = [&](int stage, int k0) {
    uint8_t* xs = smem + stage * T::STAGE;
    uint8_t* ws = xs + T::XBYTES;
    if constexpr (VEC) {
      constexpr int XC = T::XROW / 16, WC = T::WROW / 16;
      for (int c = tid; c < BM * XC; c += THR) {
        const int r = c / XC, b = (c % XC) * 16;
        const int gm = m0 + r, gk = k0 + b / int(sizeof(TA));
        const bool in = gm < M && gk < k_hi;
        const TA* src = x + (in ? int64_t(gm) * K + gk : 0);
        cp_async16(smem_addr(xs + T::xoff(r, b)), src, in ? 16 : 0);
      }
      for (int c = tid; c < BK * WC; c += THR) {
        const int r = c / WC, b = (c % WC) * 16;
        const int gk = k0 + r, gn = n0 + b / int(sizeof(TB));
        const bool in = gk < k_hi && gn < N;
        const TB* src = w + (in ? int64_t(gk) * N + gn : 0);
        cp_async16(smem_addr(ws + T::woff(r, b)), src, in ? 16 : 0);
      }
    } else {  // rows not 16-byte aligned: element by element
      for (int e = tid; e < BM * BK; e += THR) {
        const int r = e / BK, kk = e % BK;
        const int gm = m0 + r, gk = k0 + kk;
        *reinterpret_cast<TA*>(xs + T::xoff(r, kk * int(sizeof(TA)))) =
            gm < M && gk < k_hi ? x[int64_t(gm) * K + gk] : TA(0);
      }
      for (int e = tid; e < BK * BN; e += THR) {
        const int r = e / BN, nn = e % BN;
        const int gk = k0 + r, gn = n0 + nn;
        *reinterpret_cast<TB*>(ws + T::woff(r, nn * int(sizeof(TB)))) =
            gk < k_hi && gn < N ? w[int64_t(gk) * N + gn] : TB(0);
      }
    }
  };

  uint32_t acc[PARTS][MT][4][4];
#pragma unroll
  for (int p = 0; p < PARTS; ++p)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][i][j][e] = 0u;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) load_stage(s, k_lo + s * BK);
    cp_async_commit();
  }

  for (int it = 0; it < n_stages; ++it) {
    cp_async_wait<STAGES - 2>();  // stage `it` has landed
    __syncthreads();              // and every warp is done with stage it - 1
    {
      const int next = it + STAGES - 1;
      if (next < n_stages) load_stage(next % STAGES, k_lo + next * BK);
      cp_async_commit();
    }
    const uint8_t* xs = smem + (it % STAGES) * T::STAGE;
    const uint8_t* ws = xs + T::XBYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      // A fragments: rows g, g + 8 at k 4t..4t+3 and 16+4t..16+4t+3
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int r = (wm * MT + i) * 16 + g + (h & 1) * 8;
          const int kb = kk + (h >> 1) * 16 + 4 * t;
          if constexpr (A16) {
            const uint2 v =
                *reinterpret_cast<const uint2*>(xs + T::xoff(r, 2 * kb));
            ah[i][h] = hi_bytes(v.x, v.y);
            al[i][h] = lo_bytes(v.x, v.y);
          } else {
            ah[i][h] = *reinterpret_cast<const uint32_t*>(xs + T::xoff(r, kb));
          }
        }
      // B fragments of four n8 groups: thread (g, t) holds column
      // wn*32 + 4g + j of group j, at k 4t..4t+3 (h = 0) and 16+4t.. (h = 1)
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t rh[4], rl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = kk + h * 16 + 4 * t + i;
          const int nb = wn * 32 + 4 * g;
          if constexpr (B16) {
            const uint2 v =
                *reinterpret_cast<const uint2*>(ws + T::woff(r, 2 * nb));
            rh[i] = hi_bytes(v.x, v.y);
            rl[i] = lo_bytes(v.x, v.y);
          } else {
            rh[i] = *reinterpret_cast<const uint32_t*>(ws + T::woff(r, nb));
          }
        }
        transpose4x4(rh);
        if constexpr (B16) transpose4x4(rl);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bh[j][h] = rh[j];
          if constexpr (B16) bl[j][h] = rl[j];
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_i8<false, false>(acc[0][i][j], ah[i], bh[j][0], bh[j][1]);
          if constexpr (A16 && !B16) {
            mma_i8<true, false>(acc[1][i][j], al[i], bh[j][0], bh[j][1]);
          } else if constexpr (A16 && B16) {
            mma_i8<false, true>(acc[1][i][j], ah[i], bl[j][0], bl[j][1]);
            mma_i8<true, false>(acc[1][i][j], al[i], bh[j][0], bh[j][1]);
            mma_i8<true, true>(acc[2][i][j], al[i], bl[j][0], bl[j][1]);
          }
        }
    }
  }
  cp_async_wait<0>();

  // epilogue: element e of group j is row g (+8 for e >= 2) and column
  // wn*32 + 8t + j (+4 for odd e)
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + (wm * MT + i) * 16 + g + (e / 2) * 8;
        const int n = n0 + wn * 32 + 8 * t + (e % 2) * 4 + j;
        if (m >= M || n >= N) continue;
        uint32_t v = acc[0][i][j][e];
        if constexpr (PARTS == 2) v = (v << 8) + acc[1][i][j][e];
        if constexpr (PARTS == 3)
          v = (v << 16) + (acc[1][i][j][e] << 8) + acc[2][i][j][e];
        const int64_t idx = int64_t(m) * N + n;
        if (partial != nullptr) {
          partial[int64_t(blockIdx.z) * M * N + idx] = v;
        } else {
          if (bias != nullptr) v += static_cast<uint32_t>(bias[n]);
          store_out(y, idx, v, shift, rounding, relu, out_bits);
        }
      }
}

// the sum of the splits' partials, the bias, and the SRS epilogue
__global__ void qmatmul_kernel_reduce(const uint32_t* __restrict__ partial,
                                      const int32_t* __restrict__ bias,
                                      void* __restrict__ y, int64_t MN, int N,
                                      int splits, int shift, int rounding,
                                      int relu, int out_bits) {
  const int64_t idx = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= MN) return;
  uint32_t v = 0u;
  for (int s = 0; s < splits; ++s) v += partial[s * MN + idx];
  if (bias != nullptr) v += static_cast<uint32_t>(bias[idx % N]);
  store_out(y, idx, v, shift, rounding, relu, out_bits);
}

template <typename TA, typename TB, int BM, bool VEC>
cudaError_t launch_tile(const void* x, const void* w, const void* bias,
                        void* y, uint32_t* partial, int M, int K, int N,
                        int splits, int k_per_split, int shift, int rounding,
                        int relu, int out_bits, cudaStream_t stream) {
  using T = Tile<TA, TB, BM>;
  auto kernel = qmatmul_kernel<TA, TB, BM, VEC>;
  if (T::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const TA*>(x), static_cast<const TB*>(w),
      static_cast<const int32_t*>(bias), y, partial, M, K, N, k_per_split,
      shift, rounding, relu, out_bits);
  return cudaGetLastError();
}

template <typename TA, typename TB>
cudaError_t launch_pair(int block_m, bool vec, const void* x, const void* w,
                        const void* bias, void* y, uint32_t* partial, int M,
                        int K, int N, int splits, int k_per_split, int shift,
                        int rounding, int relu, int out_bits,
                        cudaStream_t s) {
#define QMM_TILE(BMV, VECV)                                                  \
  return launch_tile<TA, TB, BMV, VECV>(x, w, bias, y, partial, M, K, N,    \
                                        splits, k_per_split, shift,         \
                                        rounding, relu, out_bits, s)
  if (block_m == 16) {
    if (vec) QMM_TILE(16, true);
    QMM_TILE(16, false);
  }
  if (block_m == 64) {
    if (vec) QMM_TILE(64, true);
    QMM_TILE(64, false);
  }
#undef QMM_TILE
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() (0 on success). The
// caller checks shapes, dtypes, contiguity and 0 <= shift <= 31; ``bias``
// may be null. Operand pairs: int8 x int8, int16 x int8, int16 x int16.
// The plan: output tile rows ``block_m`` (16 or 64) and ``splits`` ranges of
// K of ``k_per_split`` (a multiple of 64) each. With splits > 1,
// ``workspace`` holds splits * M * N uint32 partials and a second device
// function (qmatmul_kernel_reduce) finishes the call.
extern "C" int qmatmul_launch(const void* x, const void* w, const void* bias,
                              void* y, void* workspace, int M, int K, int N,
                              int a_bits, int w_bits, int out_bits, int shift,
                              int rounding, int relu, int block_m, int splits,
                              int k_per_split, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || shift < 0 || shift > 31 || rounding < 0 ||
      rounding > HALF_EVEN || (out_bits != 8 && out_bits != 16) || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits == 1) {
    k_per_split = K;
  } else if (workspace == nullptr || k_per_split <= 0 ||
             k_per_split % BK != 0 ||
             int64_t(k_per_split) * (splits - 1) >= K ||
             int64_t(k_per_split) * splits < K) {
    return static_cast<int>(cudaErrorInvalidValue);  // splits must tile K
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* partial = splits > 1 ? static_cast<uint32_t*>(workspace) : nullptr;
  const bool vec = aligned16(x) && aligned16(w) &&
                   int64_t(K) * (a_bits / 8) % 16 == 0 &&
                   int64_t(N) * (w_bits / 8) % 16 == 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (a_bits == 8 && w_bits == 8)
    err = launch_pair<int8_t, int8_t>(block_m, vec, x, w, bias, y, partial, M,
                                      K, N, splits, k_per_split, shift,
                                      rounding, relu, out_bits, s);
  else if (a_bits == 16 && w_bits == 8)
    err = launch_pair<int16_t, int8_t>(block_m, vec, x, w, bias, y, partial,
                                       M, K, N, splits, k_per_split, shift,
                                       rounding, relu, out_bits, s);
  else if (a_bits == 16 && w_bits == 16)
    err = launch_pair<int16_t, int16_t>(block_m, vec, x, w, bias, y, partial,
                                        M, K, N, splits, k_per_split, shift,
                                        rounding, relu, out_bits, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t MN = int64_t(M) * N;
  const int threads = 256;
  qmatmul_kernel_reduce<<<unsigned((MN + threads - 1) / threads), threads, 0,
                          s>>>(partial, static_cast<const int32_t*>(bias), y,
                               MN, N, splits, shift, rounding, relu, out_bits);
  return static_cast<int>(cudaGetLastError());
}
