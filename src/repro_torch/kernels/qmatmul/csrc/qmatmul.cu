// qmatmul for Hopper (sm_90a): y[M,N] = ReLU?(SRS(x[M,K] @ w[K,N] + bias[N])).
//
// Replaces the TPU kernel src/repro/kernels/qmatmul/qmatmul.py:qmatmul_pallas
// (body _qmatmul_kernel, epilogue _srs_block). Bit-exact against the plain
// version in ../ref.py: the int32 accumulator wraps, SRS rounds by floor,
// half_up or half_even, saturates to int8/int16, and ReLU runs after SRS.
//
// Design. Addition modulo 2^32 is associative and commutative, so any order
// of summation, with the bias added first or last, gives the same bits. The
// Pallas (qm x qn) macro-tile and its sequential K grid are therefore not
// carried over. One block of 256 threads owns a 64x64 output tile and walks
// K in steps of 32: it stages the x and w tiles through shared memory
// (sign-extended to int32, zero outside the ragged M/N/K edges) and each
// thread keeps a 4x4 register tile of uint32_t accumulators. uint32_t
// because signed overflow is undefined in C++; the sum is reinterpreted as
// int32 only for the epilogue's arithmetic shift, its half_up addend (which
// wraps too) and its half_even remainder.
//
// What bounds it on this card. The path's GEMMs (M x K x N from 1x512x512
// to 1024x512x256, int8) need at most ~0.4 GOP and ~1.5 MB each: at the
// H100's 1979 TOP/s int8 tensor-core peak and 3.35 TB/s they would take
// well under a microsecond, so launch cost, not the card, bounds them. This
// simple kernel runs on the CUDA cores (one IMAD per multiply-accumulate,
// no dp4a), so it is operation-bound at far below the tensor-core peak.
// Left on the table: mma.sync/wgmma s8.s8.s32 (int16 operands split into a
// signed high byte and an unsigned low byte), cp.async/TMA double buffering,
// and split-K for the M=1 GEMV, whose 8 blocks leave most SMs idle.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 32;   // contraction step staged through shared memory
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int TX = BN / TN;                      // 16 threads across N

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

template <typename TO>
__device__ __forceinline__ TO saturate(int32_t v, bool relu);

template <>
__device__ __forceinline__ int8_t saturate<int8_t>(int32_t v, bool relu) {
  v = min(max(v, relu ? 0 : -128), 127);
  return static_cast<int8_t>(v);
}

template <>
__device__ __forceinline__ int16_t saturate<int16_t>(int32_t v, bool relu) {
  v = min(max(v, relu ? 0 : -32768), 32767);
  return static_cast<int16_t>(v);
}

template <typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(THREADS)
qmatmul_kernel(const TA* __restrict__ x, const TB* __restrict__ w,
               const int32_t* __restrict__ bias, TO* __restrict__ y,
               int M, int K, int N, int shift, int rounding, int relu) {
  // x tile stored k-major (+1 column against bank conflicts on the store)
  __shared__ int32_t xs[BK][BM + 1];
  __shared__ int32_t ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  uint32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // neighbouring threads read neighbouring k of one x row
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K)
                     ? static_cast<int32_t>(x[static_cast<size_t>(gm) * K + gk])
                     : 0;
    }
    // neighbouring threads read neighbouring n of one w row
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < K && gn < N)
                     ? static_cast<int32_t>(w[static_cast<size_t>(gk) * N + gn])
                     : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      int32_t a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * TX];
      // |a * b| <= 2^30 for int16 x int16, so the product itself is exact
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += static_cast<uint32_t>(a[i] * b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * (BM / TM);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n >= N) continue;
      uint32_t v = acc[i][j];
      if (bias != nullptr) v += static_cast<uint32_t>(bias[n]);
      y[static_cast<size_t>(m) * N + n] =
          saturate<TO>(round_shift(v, shift, rounding), relu != 0);
    }
  }
}

template <typename TA, typename TB, typename TO>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y,
                   int M, int K, int N, int shift, int rounding, int relu,
                   cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmatmul_kernel<TA, TB, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const TA*>(x), static_cast<const TB*>(w),
      static_cast<const int32_t*>(bias), static_cast<TO*>(y), M, K, N, shift,
      rounding, relu);
  return cudaGetLastError();
}

template <typename TA, typename TB>
cudaError_t launch_out(int out_bits, const void* x, const void* w,
                       const void* bias, void* y, int M, int K, int N,
                       int shift, int rounding, int relu, cudaStream_t s) {
  if (out_bits == 8)
    return launch<TA, TB, int8_t>(x, w, bias, y, M, K, N, shift, rounding,
                                  relu, s);
  if (out_bits == 16)
    return launch<TA, TB, int16_t>(x, w, bias, y, M, K, N, shift, rounding,
                                   relu, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() (0 on success). The
// caller checks shapes, dtypes, contiguity and 0 <= shift <= 31; ``bias``
// may be null. Operand pairs: int8 x int8, int16 x int8, int16 x int16.
extern "C" int qmatmul_launch(const void* x, const void* w, const void* bias,
                              void* y, int M, int K, int N, int a_bits,
                              int w_bits, int out_bits, int shift,
                              int rounding, int relu, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || shift < 0 || shift > 31 || rounding < 0 ||
      rounding > HALF_EVEN)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (a_bits == 8 && w_bits == 8)
    err = launch_out<int8_t, int8_t>(out_bits, x, w, bias, y, M, K, N, shift,
                                     rounding, relu, s);
  else if (a_bits == 16 && w_bits == 8)
    err = launch_out<int16_t, int8_t>(out_bits, x, w, bias, y, M, K, N, shift,
                                      rounding, relu, s);
  else if (a_bits == 16 && w_bits == 16)
    err = launch_out<int16_t, int16_t>(out_bits, x, w, bias, y, M, K, N,
                                       shift, rounding, relu, s);
  return static_cast<int>(err);
}
