// qmatmul for Hopper (sm_90a): y[M,N] = ReLU?(SRS(x[M,K] @ w[K,N] + bias[N])).
//
// Replaces the TPU kernel src/repro/kernels/qmatmul/qmatmul.py:106-164,
// qmatmul_pallas (pallas_call at :149), with body _qmatmul_kernel and
// epilogue _srs_block. Bit-exact against the plain version in ../ref.py: the
// int32 accumulator wraps, SRS rounds by floor, half_up or half_even,
// saturates to int8/int16, and ReLU runs after SRS.
//
// Exactness. Addition modulo 2^32 is associative and commutative, so any
// tiling, any split of K, any order of partial sums (atomics included) and
// any place for the bias give the same bits. The Pallas (qm x qn)
// macro-tile and its sequential K grid are therefore not carried over. The
// products run on the int8 tensor cores without .satfinite, whose s32
// accumulator wraps modulo 2^32 like the reference's int32. An int16
// operand is split into bytes, x = xh * 2^8 + xl with xh = x >> 8 (signed)
// and xl = x & 0xFF (unsigned): int16 x int8 takes two products (s8.s8 and
// u8.s8, or s8.s8 and s8.u8 with the operands swapped) recombined as
// (acc_h << 8) + acc_l, int16 x int16 four (shifts 16, 8, 8, 0; the two
// middle ones share an accumulator). Every step is exact modulo 2^32. Sums
// are kept as uint32_t (signed overflow is undefined in C++) and
// reinterpreted as int32 only in the epilogue.
//
// Two bodies; the wrapper (ops.py, route) picks one per call:
// - qmatmul_kernel_wgmma<x bytes, NT>: an int8 w, an int8 or int16 x,
//   17 <= M <= 64, x and w 16-byte aligned with rows of a multiple of 16
//   bytes: the rows that the mma.sync body pads to its 64-row tile. On the
//   decode path that is the speculative verify step (M = 32: the int8
//   heads and the a16w8 down-projections). It takes any M from 1 when a
//   caller forces it (ops.qlinear_planned with a WgPlan).
// - qmatmul_kernel (mma.sync): everything else, that is M <= 16 (the
//   decode steps at M = 4 and 8, and the paper models' one-row requests),
//   where its 16-row tile pads nothing and it measured as fast or faster
//   in a decode step; M > 64 (the paper models' row counts, the
//   reference's test grid), an int16 w and unaligned rows; and every call
//   the wrapper is given a Plan for (ops.qlinear_planned), which is how
//   tests keep it held.
//
// What bounds it on this card. At the decode shapes it is the bytes of w,
// read once: 45 MB for a yi-6b down-projection (0.0135-0.0137 ms at 3.35
// TB/s at M = 4-32), 262 MB for its head (0.078 ms), 18 MB for qwen1.5-4b's
// down (0.0053 ms). The products are small beside that: at 32 x 11008 x
// 4096 with int16 x, 5.8 G int8 operations, 2.9 us at the int8 peak. The
// mma.sync body missed that bound by a fixed 8-17 us per call: split-K ran
// as a second device function over a workspace the wrapper allocated per
// call, 288-500 non-persistent blocks left 2 or 3 waves per SM with a
// tail, and M 17-64 ran in a 64-row tile that was half zeros.
//
// qmatmul_kernel_wgmma. Swap A and B: y^T[N, M] = w^T[N, K] . x^T[K, M],
// so that w's columns fill wgmma's 64 rows and the tokens are its N, M
// rounded up to a width integer wgmma takes (NT = 8, 16, 24, 32, 48, 64):
// no row is padded to 64. The work is a grid of units, a 128-column tile
// of w by a 128-deep block of K (16 KB of w). A persistent grid of one
// block per SM (fewer if there are fewer units) walks them as the struct
// Walk says: whole tiles dealt round robin while there are at least as
// many tiles as blocks (the heads), so that every SM streams the same
// bytes and all read the same rows of w at once; the remaining tiles
// shared stream-K, equal give or take one unit (the down-projections,
// whose 20-64 tiles are fewer than the SMs).
//
// A block is three warpgroups (setmaxnreg: 88 registers for the first, 208
// for the others). One thread of the first loads each unit by TMA (2-D
// tensor maps, 128-byte swizzle, zero fill past N, K and M; no L2
// promotion for w, whose 128-byte rows a tile reads once) into a ring of 4,
// 6 or 8 stages behind full and empty mbarriers, 128-192 KB in flight, and
// starts before the block's first barrier. The two other warpgroups take
// alternate units, each into accumulators of its own: 8-bit wgmma takes
// only K-major operands, so x (K-major already) is the B operand straight
// from shared memory, and w (n-contiguous) is the A operand from registers:
// each thread loads 4 x 4 byte blocks of the swizzled w tile and transposes
// them with __byte_perm (transpose4x4), which gives it the fragments of
// four consecutive columns, placed as rows g and g + 8 of two m64 products;
// the epilogue undoes that permutation, and each thread then owns four
// consecutive output columns of every token it holds. An int16 x is split
// once per stage into a signed high and an unsigned low byte plane in
// shared memory (two wgmma, .s8.s8 and .s8.u8). A wgmma.fence waits for the
// warpgroup's products in flight, so one warpgroup cannot overlap a unit's
// products with the next unit's fragment loads; two warpgroups can.
//
// At a segment's end (the block's last unit of a tile) the two consumers
// add their parts in a shared buffer and hand it to the other three warps
// of the first warpgroup, which finish the segment while the consumers go
// on: a tile the block holds whole is stored (bias, SRS, ReLU). A split
// tile is reduced inside the same launch: each part is added to a
// workspace slot with red.global.add.u32 (any order gives the same bits),
// and one thread counts the part's k blocks into the slot's counter with
// atom.acq_rel.gpu; the part that completes the count reads the sum, stores
// y, and writes the slot and the counter back to zero. So the workspace,
// which the wrapper allocates once per (device, stream), stays zero
// between calls: one device function per call and no memset. Nothing
// waits on another block, so calls on several streams cannot deadlock. A
// wait on an mbarrier that lasts 10 s can only be a broken pipeline and
// traps, so that the launch fails instead of hanging.
//
// What is left, per call (PERF.md): about 2.5 us from entry to the first
// data (the startup burst of all SMs at once), the spread of the SMs'
// finishing times, and on the down-projections the fixup of the split
// tiles at the end (3 L2 round trips, and M x 128 red.adds per part). At
// M <= 16 that leaves it 2-3 us behind the mma.sync body on a yi-6b
// down-projection and 5-7 us on its head, timed per device function,
// which is why the router keeps those rows on mma.sync.
//
// qmatmul_kernel. A block owns a BM x 128 output tile (BM = 16 for M <=
// 16, four warps of 16 x 32; else BM = 64, eight warps of 32 x 32) and
// walks its range of K in stages of 64, four stages in flight through
// cp.async (16 bytes a thread), with mma.sync.m16n8k32. Both operands are
// staged at their own width (1 or 2 bytes) with an XOR swizzle of the
// 16-byte chunks that keeps every fragment load free of bank conflicts. x
// tiles are k-contiguous, so an A fragment is one 32-bit (int8) or 64-bit
// (int16, split by __byte_perm) load. w is (K, N) with n contiguous, while
// a B fragment wants four consecutive k of one n: each thread loads a 4 x
// 4 byte block and transposes it in registers, which gives it one fragment
// for each of four n8 groups; the epilogue undoes the permutation. Ragged
// M, N and K are zero-filled by the copies; operands whose rows are not
// 16-byte aligned take a scalar loading path into the same layout. When
// the (M, N) tiles fill fewer than about two waves of the SMs, the host
// plan (ops.py) splits K across blocks (blockIdx.z); each split writes its
// uint32 partial sums to a workspace [splits, M, N] and
// qmatmul_kernel_reduce sums them, adds the bias and runs the epilogue. The
// paper models' GEMMs (M x K x N from 1x512x512 to 1024x512x256, int8)
// need under 1.5 MB each: launch cost and one pass over K bound them.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include <type_traits>

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

// SRS, saturation to the output type, ReLU after SRS
__device__ __forceinline__ int32_t srs_value(uint32_t acc, int shift,
                                             int rounding, int relu,
                                             int out_bits) {
  const int32_t v = round_shift(acc, shift, rounding);
  const int32_t lo = relu ? 0 : (out_bits == 8 ? -128 : -32768);
  const int32_t hi = out_bits == 8 ? 127 : 32767;
  return min(max(v, lo), hi);
}

// srs_value(acc) stored as y[idx]
__device__ __forceinline__ void store_out(void* y, int64_t idx, uint32_t acc,
                                          int shift, int rounding, int relu,
                                          int out_bits) {
  const int32_t r = srs_value(acc, shift, rounding, relu, out_bits);
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

// ---------------------------------------------------------------- wgmma body

constexpr int WG = 128;                // threads of a warpgroup
constexpr int WG_BN = 128;             // w columns per unit: two m64 products
constexpr int WG_BK = 128;             // k per unit: one 128-byte row of x
constexpr int WG_MAX_NT = 64;          // token columns of the widest product
constexpr int WG_W_BYTES = WG_BK * WG_BN;   // a w tile: 128 rows of 128 bytes
constexpr int WG_MAX_STAGES = 8;
constexpr int WG_SLOT = WG_MAX_NT * WG_BN;  // uint32 partials of a split tile
constexpr int EROW = WG_BN + 4;        // ebuf's row: 132 uint32, 16-byte rows
constexpr int EPI_THREADS = 96;        // warps 1-3 of the first warpgroup
constexpr int FIN = 4;                 // loads in flight per epilogue thread
// registers after setmaxnreg: 88 + 2 * 208 = 3 * 168, the launch's share
constexpr int LEAD_REGS = 88, CONSUMER_REGS = 208;
constexpr int SMEM_MAX = 232448;       // dynamic shared memory of one block
constexpr long long WAIT_LIMIT_NS = 10000000000LL;  // a stuck pipeline traps

template <int XB, int NT>
struct WgShape {
  static constexpr int X_BYTES = NT * WG_BK * XB;   // x tile as TMA loads it
  static constexpr int PLANE = NT * WG_BK;          // one byte plane of x
  static constexpr int PLANES = XB == 2 ? 2 * PLANE : 0;  // int16 x: hi, lo
  static constexpr int STAGE = WG_W_BYTES + X_BYTES + PLANES;
  static constexpr int TX = WG_W_BYTES + X_BYTES;   // bytes TMA brings a stage
  static constexpr int EBUF = NT * EROW * 4;        // a segment's sum
  static constexpr int HALVES = XB * NT >= 128 ? 2 : 1;  // A passes a unit
  // 1024 of slack to align the stages to the swizzle's 1024-byte period;
  // a full and an empty barrier per stage, three more, and four ints
  static constexpr int FIXED = 1024 + EBUF + 256;
  // An even number of stages: the two consumers take alternate units, so
  // each stage then always serves the same consumer, which waits for its
  // rounds in order. With an odd number a stage alternates between them,
  // and a consumer could wait on a round two phases ahead of the barrier,
  // which a parity wait takes for the round before.
  static constexpr int FIT = (SMEM_MAX - FIXED) / STAGE;
  static constexpr int STAGES = (FIT < WG_MAX_STAGES ? FIT : WG_MAX_STAGES)
                                & ~1;
  static_assert(STAGES >= 4 && STAGES % 2 == 0, "a ring of 4, 6 or 8");
  static constexpr size_t smem = size_t(FIXED) + size_t(STAGE) * STAGES;
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

// TMA: the box at (c0 columns, c1 rows) into shared memory at dst; its
// bytes complete on the barrier, and what lies outside the tensor arrives
// as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in 128-byte swizzle
// atoms (8 rows of 128 bytes, 1024 bytes apart); start address in 16-byte
// units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t(16 >> 4) << 16 |
         uint64_t(1024 >> 4) << 32 | 1ull << 62;
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
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// bar.sync on the named barrier of consumer warpgroup c (1 or 2) or of the
// three epilogue warps (3)
__device__ __forceinline__ void consumer_sync(int c) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(WG) : "memory");
}

// *p += v at gpu scope, releasing what this thread (and, through a barrier
// before it, its warpgroup) wrote and acquiring what the other parts wrote
__device__ __forceinline__ uint32_t atom_add_acq_rel(uint32_t* p, uint32_t v) {
  uint32_t old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ void epilogue_sync() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(EPI_THREADS) : "memory");
}

// d += A B, m64 x NT x k32, A (w^T, s8) from registers, B (x^T) K-major in
// shared memory, s8 or (BU) u8
template <bool BU>
__device__ __forceinline__ void wgmma_n8(uint32_t (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
#define QMM_WGMMA(BT)                                                       \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8." BT " "                \
        "{%0, %1, %2, %3}, "                                                \
        "{%4, %5, %6, %7}, %8, p;\n}\n"                                     \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                    \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)       \
        : "memory")
  if constexpr (BU) QMM_WGMMA("u8");
  else QMM_WGMMA("s8");
#undef QMM_WGMMA
}

template <bool BU>
__device__ __forceinline__ void wgmma_n16(uint32_t (&d)[8],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
#define QMM_WGMMA(BT)                                                       \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8." BT " "               \
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "                                \
        "{%8, %9, %10, %11}, %12, p;\n}\n"                                  \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),       \
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])                                \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)       \
        : "memory")
  if constexpr (BU) QMM_WGMMA("u8");
  else QMM_WGMMA("s8");
#undef QMM_WGMMA
}

template <bool BU>
__device__ __forceinline__ void wgmma_n24(uint32_t (&d)[12],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
#define QMM_WGMMA(BT)                                                       \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8." BT " "               \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "              \
        "{%12, %13, %14, %15}, %16, p;\n}\n"                                \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),       \
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),       \
          "+r"(d[10]), "+r"(d[11])                                          \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)       \
        : "memory")
  if constexpr (BU) QMM_WGMMA("u8");
  else QMM_WGMMA("s8");
#undef QMM_WGMMA
}

template <bool BU>
__device__ __forceinline__ void wgmma_n32(uint32_t (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
#define QMM_WGMMA(BT)                                                       \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8." BT " "               \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
        "%15}, "                                                            \
        "{%16, %17, %18, %19}, %20, p;\n}\n"                                \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),       \
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),       \
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),  \
          "+r"(d[15])                                                       \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)       \
        : "memory")
  if constexpr (BU) QMM_WGMMA("u8");
  else QMM_WGMMA("s8");
#undef QMM_WGMMA
}

template <bool BU>
__device__ __forceinline__ void wgmma_n48(uint32_t (&d)[24],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
#define QMM_WGMMA(BT)                                                       \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8." BT " "               \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "                    \
        "{%24, %25, %26, %27}, %28, p;\n}\n"                                \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),       \
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),       \
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),  \
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),  \
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])                \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)       \
        : "memory")
  if constexpr (BU) QMM_WGMMA("u8");
  else QMM_WGMMA("s8");
#undef QMM_WGMMA
}

template <bool BU>
__device__ __forceinline__ void wgmma_n64(uint32_t (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
#define QMM_WGMMA(BT)                                                       \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8." BT " "               \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
        "%28, %29, %30, %31}, "                                             \
        "{%32, %33, %34, %35}, %36, p;\n}\n"                                \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),       \
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),       \
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),  \
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),  \
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),  \
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),  \
          "+r"(d[30]), "+r"(d[31])                                          \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)       \
        : "memory")
  if constexpr (BU) QMM_WGMMA("u8");
  else QMM_WGMMA("s8");
#undef QMM_WGMMA
}

template <int NT, bool BU>
__device__ __forceinline__ void wgmma(uint32_t (&d)[NT / 2],
                                      const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NT == 8) wgmma_n8<BU>(d, a, db);
  else if constexpr (NT == 16) wgmma_n16<BU>(d, a, db);
  else if constexpr (NT == 24) wgmma_n24<BU>(d, a, db);
  else if constexpr (NT == 32) wgmma_n32<BU>(d, a, db);
  else if constexpr (NT == 48) wgmma_n48<BU>(d, a, db);
  else wgmma_n64<BU>(d, a, db);
}

// byte offset of (row, byte) in a tile of 128-byte rows under the TMA's
// 128-byte swizzle: 16-byte chunk c of row r lies at chunk c ^ (r % 8)
__device__ __forceinline__ int swz(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// The A fragments of k32 steps S0 .. S0 + NS - 1 of one unit: for each step
// s and each of the two m64 products i, registers {row g, row g + 8} x
// {k 4t.., k 16 + 4t..}. Thread (warp, g, t) reads four k rows of the four
// columns 32 warp + 4 g .. + 3, transposes them, and places column
// 4g + 2i + h as row g + 8h of product i.
template <int S0, int NS>
__device__ __forceinline__ void load_a(uint32_t (&a)[NS][2][4],
                                       const uint8_t* ws, int warp, int g,
                                       int t) {
  const int col = 32 * warp + 4 * g;
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = *reinterpret_cast<const uint32_t*>(
            ws + swz(32 * (S0 + s) + 16 * q + 4 * t + i, col));
      transpose4x4(r);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) a[s][i][h + 2 * q] = r[2 * i + h];
    }
}

// An int16 x tile (two TMA boxes of 64 columns) into its high (signed) and
// low (unsigned) byte planes, each laid out as an int8 tile would be
template <int NT>
__device__ __forceinline__ void split_planes(const uint8_t* xs, uint8_t* hi,
                                             uint8_t* lo, int ct) {
#pragma unroll
  for (int it = ct; it < NT * 8; it += WG) {
    const int m = it >> 3, c = it & 7;  // plane chunk c: k 16c .. 16c + 15
    const uint8_t* row = xs + (c >> 2) * (NT * 128);
    const uint4 r0 = *reinterpret_cast<const uint4*>(
        row + swz(m, 32 * (c & 3)));
    const uint4 r1 = *reinterpret_cast<const uint4*>(
        row + swz(m, 32 * (c & 3) + 16));
    *reinterpret_cast<uint4*>(hi + swz(m, 16 * c)) =
        make_uint4(hi_bytes(r0.x, r0.y), hi_bytes(r0.z, r0.w),
                   hi_bytes(r1.x, r1.y), hi_bytes(r1.z, r1.w));
    *reinterpret_cast<uint4*>(lo + swz(m, 16 * c)) =
        make_uint4(lo_bytes(r0.x, r0.y), lo_bytes(r0.z, r0.w),
                   lo_bytes(r1.x, r1.y), lo_bytes(r1.z, r1.w));
  }
}

// the (i, e) accumulator that holds column n0 + q of token 8j + 2t + c
#define QMM_ACC(v, j, c, q) v[(q) >> 1][4 * (j) + 2 * ((q) & 1) + (c)]

// How a block walks its work. With at least as many column tiles as
// blocks, the first rounds * G tiles are whole tiles dealt round robin
// (block b takes b, b + G, ...), so that all blocks read the same rows of
// w at once. The remaining tiles, fewer than G, are shared stream-K: block
// b takes the units [u0, u1) of them in tile-major order, equal give or
// take one unit and shorter than a tile, so at most two segments (parts of
// tiles). A block walks its stream-K share first, then its whole tiles:
// the split parts' fixups overlap the rest of its work, and a block with
// whole tiles ends with plain stores. `pos` is a position in the walk,
// `j` a segment of it (the stream-K ones first).
struct Walk {
  int k_blocks, rounds, sk_base, u0, u1, t_first, n_sk;
  uint32_t sk_units;
  __device__ Walk(int block, int grid, int units, int k_blocks_)
      : k_blocks(k_blocks_) {
    rounds = units / k_blocks / grid;
    sk_base = rounds * grid;  // the first stream-K tile
    sk_units = uint32_t(units - sk_base * k_blocks);
    u0 = sk_base * k_blocks + int(uint32_t(block) * sk_units / uint32_t(grid));
    u1 = sk_base * k_blocks +
         int(uint32_t(block + 1) * sk_units / uint32_t(grid));
    t_first = u0 / k_blocks;
    n_sk = u1 > u0 ? (u1 - 1) / k_blocks - t_first + 1 : 0;
  }
  __device__ int n_units() const { return u1 - u0 + rounds * k_blocks; }
  __device__ int n_segs() const { return n_sk + rounds; }
  // segment j: its tile, its first position and its k blocks [kb_lo, kb_hi]
  __device__ void segment(int j, int block, int grid, int& tile, int& p_lo,
                          int& kb_lo, int& kb_hi) const {
    if (j < n_sk) {
      tile = t_first + j;
      p_lo = max(u0, tile * k_blocks) - u0;
      kb_lo = u0 + p_lo - tile * k_blocks;
      kb_hi = min(u1, (tile + 1) * k_blocks) - 1 - tile * k_blocks;
    } else {
      tile = block + grid * (j - n_sk);
      p_lo = u1 - u0 + (j - n_sk) * k_blocks;
      kb_lo = 0;
      kb_hi = k_blocks - 1;
    }
  }
  // the tile and k block at position pos
  __device__ void unit(int pos, int block, int grid, int& tile,
                       int& kb) const {
    const int n = u1 - u0;
    if (pos >= n) {
      tile = block + grid * ((pos - n) / k_blocks);
      kb = (pos - n) % k_blocks;
    } else {
      tile = (u0 + pos) / k_blocks;
      kb = (u0 + pos) % k_blocks;
    }
  }
  // a split tile's slot: that of the first block whose share holds part
  // of it, which no other split tile shares
  __device__ int slot(int tile, int grid) const {
    return int((uint32_t((tile - sk_base) * k_blocks + 1) * uint32_t(grid) -
                1u) / sk_units);
  }
};

template <int XB, int NT>
__global__ void __launch_bounds__(3 * WG, 1)
qmatmul_kernel_wgmma(const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap tx,
                     const int32_t* __restrict__ bias, void* __restrict__ y,
                     uint32_t* __restrict__ ws, uint32_t* __restrict__ counters,
                     int M, int N, int k_blocks, int units, int shift,
                     int rounding, int relu, int out_bits) {
  using S = WgShape<XB, NT>;
  constexpr int ST = S::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  // a segment's sum, [NT][EROW] uint32, then the barriers and the
  // segment's description
  uint32_t* const ebuf = reinterpret_cast<uint32_t*>(gbase + ST * S::STAGE);
  const uint32_t full = base + ST * S::STAGE + S::EBUF;  // [ST] each
  const uint32_t empty = full + 8 * ST;
  const uint32_t c1_done = empty + 8 * ST;   // consumer 1's part is in ebuf
  const uint32_t epi_ready = c1_done + 8;    // ebuf holds the whole sum
  const uint32_t ebuf_free = epi_ready + 8;  // the epilogue has read ebuf
  // [3], [4]: whether the block's split parts completed their tiles
  volatile int* const info =
      reinterpret_cast<volatile int*>(gbase + (ebuf_free + 8 - base));

  const int G = gridDim.x, block = blockIdx.x;
  const Walk walk(block, G, units, k_blocks);
  const int n_units = walk.n_units(), n_segs = walk.n_segs();

  // the producer: one thread keeps the ring full by TMA, from before the
  // block's first barrier, as soon as its mbarriers exist
  auto produce = [&](int i) {
    const int st = i % ST, ph = (i / ST) & 1;
    const uint32_t w_s = base + st * S::STAGE, x_s = w_s + WG_W_BYTES;
    int tile, kb;
    walk.unit(i, block, G, tile, kb);
    mbar_wait(empty + 8 * st, ph ^ 1);  // the first round passes
    mbar_expect_tx(full + 8 * st, S::TX);
    tma_load(w_s, &tw, tile * WG_BN, kb * WG_BK, full + 8 * st);
    tma_load(x_s, &tx, kb * WG_BK, 0, full + 8 * st);
    if constexpr (XB == 2)
      tma_load(x_s + NT * 128, &tx, kb * WG_BK + 64, 0, full + 8 * st);
  };
  const int n_early = n_units < ST ? n_units : ST;
  const int tid = threadIdx.x, wg = tid / WG;
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tw) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tx) : "memory");
    for (int st = 0; st < ST; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 4);  // one arrival per consumer warp
    }
    mbar_init(c1_done, WG);
    mbar_init(epi_ready, WG);
    mbar_init(ebuf_free, EPI_THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < n_early; ++i) produce(i);
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(LEAD_REGS));
    if (tid == 0) {
      for (int i = n_early; i < n_units; ++i) produce(i);
    } else if (tid >= 32) {
      // the epilogue: three warps finish each segment from ebuf while the
      // consumers go on with the next. Thread e always holds the columns
      // 4 c4 .. 4 c4 + 3 of a tile, of tokens e / 32, e / 32 + 3, ...
      const int e = tid - 32, c4 = e % 32, m0 = e / 32;
      constexpr int MS = EPI_THREADS / 32;
      auto store = [&](int m, int n, const uint32_t (&bq)[4], uint4 v) {
        uint32_t r[4] = {v.x + bq[0], v.y + bq[1], v.z + bq[2], v.w + bq[3]};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          r[q] = uint32_t(srs_value(r[q], shift, rounding, relu, out_bits));
        const int64_t idx = int64_t(m) * N + n;
        if (out_bits == 8)
          *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(y) + idx) =
              (r[0] & 0xFFu) | (r[1] & 0xFFu) << 8 | (r[2] & 0xFFu) << 16 |
              r[3] << 24;
        else
          *reinterpret_cast<uint2*>(static_cast<int16_t*>(y) + idx) =
              make_uint2((r[0] & 0xFFFFu) | r[1] << 16,
                         (r[2] & 0xFFFFu) | r[3] << 16);
      };
      // this thread's first column of `tile`, or -1 past N; its bias
      auto column = [&](int tile, uint32_t (&bq)[4]) {
        const int n = tile * WG_BN + 4 * c4;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bq[q] = bias != nullptr && n < N
                      ? static_cast<uint32_t>(bias[n + q]) : 0u;
        return n < N ? n : -1;
      };
      auto slot_of = [&](int tile) { return walk.slot(tile, G); };
      // the parts that completed a count: every part is in, so take the
      // sum, store it, and leave the slot and its counter zero
      auto finish = [&](int tile) {
        const int slot = slot_of(tile);
        uint32_t bq[4];
        const int n = column(tile, bq);
        uint4* const wt =
            reinterpret_cast<uint4*>(ws + int64_t(slot) * WG_SLOT) + c4;
        // FIN loads in flight before any store (y might alias ws for all
        // the compiler knows, so it would not overlap them itself)
        for (int mb = m0; n >= 0 && mb < M; mb += FIN * MS) {
          uint4 v[FIN];
#pragma unroll
          for (int f = 0; f < FIN; ++f) {
            const int m = mb + f * MS;
            if (m < M) v[f] = __ldcg(wt + m * (WG_BN / 4));
          }
#pragma unroll
          for (int f = 0; f < FIN; ++f) {
            const int m = mb + f * MS;
            if (m < M) {
              __stcg(wt + m * (WG_BN / 4), make_uint4(0u, 0u, 0u, 0u));
              store(m, n, bq, v[f]);
            }
          }
        }
        if (e == 0) atomicExch(counters + slot, 0u);
      };
      // A split part is added to its tile's slot (red.global.add; any
      // order gives the same bits), then thread 0 counts its k blocks into
      // the slot's counter and keeps what the counter held. Whether a part
      // completed the count is looked at once the walk is past both split
      // parts (after the first whole tile, if any), so the counters' round
      // trips overlap the block's other work.
      int split0 = -1, split1 = -1;  // the block's split tiles, in order
      uint32_t done0 = 0u, done1 = 0u;  // thread 0: counter after each part
      const int resolve = walk.n_sk == 0 ? -1
                          : walk.rounds > 0 ? walk.n_sk
                                            : walk.n_sk - 1;
      for (int j = 0; j < n_segs; ++j) {
        mbar_wait(epi_ready, j & 1);
        int tile, p_lo, kb_lo, kb_hi;
        walk.segment(j, block, G, tile, p_lo, kb_lo, kb_hi);
        uint32_t bq[4];
        const int n = column(tile, bq);
        const uint4* const src =
            reinterpret_cast<const uint4*>(ebuf + 4 * c4);
        if (kb_lo == 0 && kb_hi == k_blocks - 1) {
          // the block holds the tile whole: store it
          if (n >= 0)
            for (int m = m0; m < M; m += MS) store(m, n, bq, src[m * EROW / 4]);
          mbar_arrive(ebuf_free);
        } else {
          const int slot = slot_of(tile);
          uint32_t* const wt = ws + int64_t(slot) * WG_SLOT + 4 * c4;
          if (n >= 0)
            for (int m = m0; m < M; m += MS) {
              const uint4 v = src[m * EROW / 4];
              uint32_t* const p = wt + m * WG_BN;
              atomicAdd(p, v.x);
              atomicAdd(p + 1, v.y);
              atomicAdd(p + 2, v.z);
              atomicAdd(p + 3, v.w);
            }
          mbar_arrive(ebuf_free);
          epilogue_sync();  // every red is issued before thread 0 releases
          const uint32_t add = uint32_t(kb_hi - kb_lo + 1);
          if (split0 < 0) {
            split0 = tile;
            if (e == 0) done0 = atom_add_acq_rel(counters + slot, add) + add;
          } else {
            split1 = tile;
            if (e == 0) done1 = atom_add_acq_rel(counters + slot, add) + add;
          }
        }
        if (j == resolve) {
          if (e == 0) {
            info[3] = done0 == uint32_t(k_blocks);
            info[4] = done1 == uint32_t(k_blocks);
          }
          epilogue_sync();
          if (split0 >= 0 && info[3]) finish(split0);
          if (split1 >= 0 && info[4]) finish(split1);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup c takes every other position of the walk,
  // each into accumulators of its own
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int c = wg - 1;
  const int ct = tid % WG, warp = ct / 32, lane = ct % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_local = 32 * warp + 4 * g;  // this thread's four columns

  uint32_t acc[XB][2][NT / 2];  // [high, low part][product][fragment]
  auto zero_acc = [&]() {
#pragma unroll
    for (int p = 0; p < XB; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int f = 0; f < NT / 2; ++f) acc[p][q][f] = 0u;
  };
  zero_acc();

  for (int j = 0; j < n_segs; ++j) {
    int tile, p_lo, kb_lo, kb_hi;
    walk.segment(j, block, G, tile, p_lo, kb_lo, kb_hi);
    const int p_hi = p_lo + kb_hi - kb_lo + 1;
    for (int i = p_lo + ((p_lo & 1) != c); i < p_hi; i += 2) {
      const int st = i % ST, ph = (i / ST) & 1;
      const uint32_t w_s = base + st * S::STAGE, x_s = w_s + WG_W_BYTES;
      mbar_wait(full + 8 * st, ph);
      uint32_t b_hi = x_s, b_lo = x_s;
      if constexpr (XB == 2) {
        b_hi = x_s + S::X_BYTES;
        b_lo = b_hi + S::PLANE;
        split_planes<NT>(gbase + (x_s - base), gbase + (b_hi - base),
                         gbase + (b_lo - base), ct);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumer_sync(c);
      }
      // the unit's four k32 steps, in HALVES passes: with 128 int16
      // accumulators (NT 64) the fragments of all four would not fit
      auto pass = [&](auto half) {
        constexpr int NS = 4 / S::HALVES, S0 = decltype(half)::value * NS;
        uint32_t a[NS][2][4];
        load_a<S0, NS>(a, gbase + (w_s - base), warp, g, t);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < NS; ++k)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            wgmma<NT, false>(acc[0][p], a[k][p],
                             smem_desc(b_hi + 32 * (S0 + k)));
            if constexpr (XB == 2)
              wgmma<NT, true>(acc[XB - 1][p], a[k][p],
                              smem_desc(b_lo + 32 * (S0 + k)));
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < XB; ++p)
#pragma unroll
          for (int q = 0; q < 2; ++q) fence_regs(acc[p][q]);
#pragma unroll
        for (int k = 0; k < NS; ++k)
#pragma unroll
          for (int p = 0; p < 2; ++p) fence_regs(a[k][p]);
      };
      pass(std::integral_constant<int, 0>());
      if constexpr (S::HALVES == 2) pass(std::integral_constant<int, 1>());
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

    // the segment's end: consumer 1 puts its part in ebuf, consumer 0 adds
    // its own and hands the sum to the epilogue warps
    if constexpr (XB == 2) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int f = 0; f < NT / 2; ++f)
          acc[0][q][f] = (acc[0][q][f] << 8) + acc[XB - 1][q][f];
    }
    uint32_t (&v)[2][NT / 2] = acc[0];
    if (c == 1) mbar_wait(ebuf_free, (j & 1) ^ 1);
    else mbar_wait(c1_done, j & 1);
#pragma unroll
    for (int jj = 0; jj < NT / 8; ++jj)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        uint4* const p = reinterpret_cast<uint4*>(
            ebuf + (8 * jj + 2 * t + cc) * EROW + n_local);
        uint4 sum = make_uint4(QMM_ACC(v, jj, cc, 0), QMM_ACC(v, jj, cc, 1),
                               QMM_ACC(v, jj, cc, 2), QMM_ACC(v, jj, cc, 3));
        if (c == 0) {
          const uint4 o = *p;
          sum = make_uint4(sum.x + o.x, sum.y + o.y, sum.z + o.z,
                           sum.w + o.w);
        }
        *p = sum;
      }
    mbar_arrive(c == 1 ? c1_done : epi_ready);
    zero_acc();
  }
}
#undef QMM_ACC

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

// a row-major [rows, cols] tensor of 1- or 2-byte integers read in boxes
// of 128 bytes x box_rows, 128-byte swizzle; outside it reads zeros. Rows
// of w are read 128 bytes at a time, tile after tile down K, so the L2
// promotes nothing there: 256 bytes would drag in the next tile's bytes,
// read much later and by then evicted (1.7x the bound on the heads, 1.27x
// without)
bool tensor_map(CUtensorMap* map, const void* ptr, int elem_bytes, int rows,
                int cols, int box_rows, bool promote) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * elem_bytes};
  const cuuint32_t box[2] = {cuuint32_t(128 / elem_bytes),
                             cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                     : CU_TENSOR_MAP_DATA_TYPE_UINT16,
                2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                promote ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B
                        : CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int XB, int NT>
cudaError_t launch_wgmma(const void* x, const void* w, const void* bias,
                         void* y, uint32_t* ws, uint32_t* counters, int M,
                         int K, int N, int grid, int shift, int rounding,
                         int relu, int out_bits, cudaStream_t stream) {
  using S = WgShape<XB, NT>;
  CUtensorMap tw, tx;
  if (!tensor_map(&tw, w, 1, K, N, WG_BK, false) ||
      !tensor_map(&tx, x, XB, M, K, NT, true))
    return cudaErrorInvalidValue;
  auto kernel = qmatmul_kernel_wgmma<XB, NT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(S::smem));
  if (err != cudaSuccess) return err;
  const int k_blocks = (K + WG_BK - 1) / WG_BK;
  const int units = (N + WG_BN - 1) / WG_BN * k_blocks;
  kernel<<<grid, 3 * WG, S::smem, stream>>>(
      tw, tx, static_cast<const int32_t*>(bias), y, ws,
      counters, M, N, k_blocks, units, shift, rounding, relu, out_bits);
  return cudaGetLastError();
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

// The wgmma body (qmatmul_kernel_wgmma), one device function per call, on
// ``stream``; returns cudaGetLastError() (0 on success). It takes an int8 w,
// an int8 (a_bits 8) or int16 (16) x, 1 <= M <= nt, where nt, the tokens
// per product, is 8, 16, 24, 32, 48 or 64; x and w 16-byte aligned, with
// K * a_bits / 8 and N multiples of 16. ``grid`` persistent blocks, at most
// ``slots`` and at most the call's units (ceil(N / 128) * ceil(K / 128)).
// ``workspace`` holds slots x 64 x 128 uint32 partials and ``counters``
// slots uint32, all zero; the launch leaves them zero. Nothing else may use
// them while it runs.
extern "C" int qmatmul_wgmma_launch(const void* x, const void* w,
                                    const void* bias, void* y,
                                    void* workspace, void* counters,
                                    int slots, int M, int K, int N,
                                    int a_bits, int out_bits, int shift,
                                    int rounding, int relu, int nt, int grid,
                                    void* stream) {
  const int64_t units = int64_t((N + WG_BN - 1) / WG_BN) *
                        ((K + WG_BK - 1) / WG_BK);
  if (M <= 0 || M > nt || K <= 0 || N <= 0 || shift < 0 || shift > 31 ||
      rounding < 0 || rounding > HALF_EVEN ||
      (out_bits != 8 && out_bits != 16) || (a_bits != 8 && a_bits != 16) ||
      workspace == nullptr || counters == nullptr || grid < 1 ||
      grid > slots || grid > units || units * grid > INT32_MAX ||
      !aligned16(x) ||
      !aligned16(w) || int64_t(K) * (a_bits / 8) % 16 != 0 || N % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* ws = static_cast<uint32_t*>(workspace);
  uint32_t* cnt = static_cast<uint32_t*>(counters);
#define QMM_WG(XBV, NTV)                                                    \
  return static_cast<int>(launch_wgmma<XBV, NTV>(                           \
      x, w, bias, y, ws, cnt, M, K, N, grid, shift, rounding, relu,         \
      out_bits, s))
#define QMM_WG_NT(NTV)                                                      \
  case NTV:                                                                 \
    if (a_bits == 8) QMM_WG(1, NTV);                                        \
    QMM_WG(2, NTV)
  switch (nt) {
    QMM_WG_NT(8);
    QMM_WG_NT(16);
    QMM_WG_NT(24);
    QMM_WG_NT(32);
    QMM_WG_NT(48);
    QMM_WG_NT(64);
  }
#undef QMM_WG_NT
#undef QMM_WG
  return static_cast<int>(cudaErrorInvalidValue);
}
