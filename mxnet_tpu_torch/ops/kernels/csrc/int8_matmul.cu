// Int8 matmul for Hopper (sm_90a), CUDA C++: int32 out, or the per-channel
// dequant fused into the epilogue.  Two variants, which the Python planner
// (int8_matmul.py, plan_int8_matmul) picks between by layout alone:
//
//   wgmma -- tensor cores through wgmma m64nNk32 s8, fed by TMA through an
//            mbarrier ring, with split-K for grids under one wave; every
//            input TMA can read (K % 16 == 0, row strides % 16 == 0, bases
//            16-byte aligned);
//   mma   -- mma.sync m16n8k32 s8 fed through cp.async (or byte loads):
//            everything else (K odd, unaligned or offset views).
//
// Replaces the Pallas TPU kernels mxnet_tpu/ops/pallas/int8_matmul.py
// `_mm_i32_kernel` and `_mm_dequant_kernel` (launched by
// `_int8_matmul_pallas`, public `int8_matmul`).  Semantics, kept exactly:
//
//   acc[m, n] = sum_k int32(A[m, k]) * int32(B[n, k])     A [M, K], B [N, K]
//   out       = acc                              (int32; scale == nullptr)
//   out       = float(acc) * scale[n]            (f32, round to nearest)
//
// The int32 sum is exact in any order, so the result is bit for bit the
// XLA lowering's (int8_matmul_lax): wraparound past 2^31 included, since
// neither mma.sync nor wgmma without .satfinite saturates, and int32
// addition with wraparound is associative and commutative -- which is also
// what makes split-K exact: partial sums over disjoint K ranges, added in
// any order, give the single pass's bits.  The dequant form never scales a
// partial sum: it converts and scales the complete int32 sum once.
//
// What bounds it on the card: at large M, N and K operations (2·M·N·K at
// 1979 dense int8 TOP/s: ~240 int8 operations per byte read); at the small
// M of a classifier head bytes (the weight, N·K bytes, read once).
//
// wgmma variant.
//
// * One CTA of 384 threads per (128 rows of M, BN columns of N, split of
//   K): two consumer warpgroups own 64 rows each; one thread of a producer
//   warpgroup issues every copy.  setmaxnreg moves registers from the
//   producer (40 a thread) to the consumers (232), which hold BN / 2 int32
//   accumulators each (128 at BN = 256).
// * K goes in tiles of 128 bytes: one 128-byte-swizzled row per matrix row,
//   four k-steps of 32 (the wgmma s8 depth), stepped 32 bytes at a time in
//   the K-major descriptor exactly as the bf16 kernels step k16.  For 8-bit
//   types wgmma takes only K-major operands, which is this layout: A [M, K]
//   and B [N, K] are both K-contiguous.
// * TMA: 2-d maps over [M, K] and [N, K] (hopper.cuh, make_map_2d_s8),
//   built per launch; rows past M or N and K past its end are zero-filled
//   by the TMA unit, which is exact in int32, so no operand is padded in
//   device memory (a VGG16 fc6 weight is 103 MB).  A ring of STAGES slots
//   (4 at BN 256, 6 at 128, 8 at 64: 192 KB, all of it in flight) with a
//   "full" mbarrier (the TMA's bytes) and an "empty" one (the 256 consumer
//   threads) per slot.
// * The products of K tile j stay in flight while tile j + 1's are issued:
//   a consumer waits for the group before the last and only then releases
//   that group's slot.
// * Tiles by shape (the planner): 128 x 256 or 128 x 128 CTA tiles when
//   the output has at least one wave of 128 x 128 tiles (whichever fills
//   its waves better; 2048^3 takes 128 x 256, one wave of 128 CTAs); below
//   that (classifier heads, M <= 128) the column tile (256, 128 or 64) and
//   a split of K over a grid axis that fill one wave best with the fewest
//   splits, at least two K tiles a split.  At fc6 (M 128, K 25088, N 4096)
//   that is 64 column tiles x 2 splits: the 3.2 MB of A is read 64 times,
//   from the L2 (evict-last, below), the weight once, and 192 KB per SM is
//   in flight.
// * Epilogue without a split: from registers, int32 or f32(acc) * s[n], s
//   formed from the two scale operands in the epilogue (no kernel of the
//   wrapper forms it first).
// * L2 policies on the TMA loads: evict-last for an operand other CTAs
//   read again (A at more than one column tile, B at more than one row
//   tile), evict-first for one that only this CTA reads (a classifier
//   head's weight).
// * Split-K: each CTA stores its partial tile, plainly, into its own slice
//   of an int32 workspace [splits][M][N]; a second small kernel
//   (split_k_reduce_kernel, launched from the same C call) adds the slices
//   in split order and writes int32 or f32(sum) * s[n] once.  No atomics
//   (an earlier version added the partials with red.global.add: 4M atomic
//   adds in the L2 at fc6), no memset, and the dequant form scales only
//   complete sums.
//
// mma variant (the first port's kernel, unchanged):
//
//   * CTA tile BM x BN x 64 bytes of K; each warp owns a WM x WN sub-tile
//     of (WM/16) x (WN/8) mma tiles in registers.  128 x 128 with 8 warps
//     when that grid fills the card; 64 x 64 with 4 warps otherwise.
//   * Operands are K-contiguous on both sides ("row" A, "col" B), which is
//     what mma.m16n8k32.row.col wants: every fragment register is 4
//     consecutive K bytes of one row, one 32-bit shared-memory load.
//     Shared rows are padded to 80 bytes so the 32 lanes of a fragment
//     load hit 32 distinct banks.
//   * Aligned inputs (K % 16 == 0, rows and bases 16-byte aligned): 16-byte
//     cp.async into a two-stage ring.  Rows past M or N and K past the end
//     are zero-filled by cp.async's src-size operand.
//   * Any other input: the same tiles loaded a byte at a time with bounds
//     checks, one stage.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers, sizes, strides, the plan and the current cudaStream_t
// through ctypes, and raises on any non-zero return (the cudaGetLastError()
// after the launch, or a code of hopper.cuh).

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kBK = 64;               // K bytes per tile
constexpr int kLds = kBK + 16;        // shared row stride in bytes

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rows x kBK bytes of X (row stride ld) starting at (row0, k0) into smem,
// 16 bytes per cp.async; out-of-range chunks are zero-filled.  K % 16 == 0,
// so a chunk is either wholly inside a row or wholly past its end.
template <int kThreads>
__device__ __forceinline__ void load_tile_async(int8_t* smem,
                                                const int8_t* X, int rows,
                                                int nrows, int row0, int k0,
                                                int K, long long ld) {
  for (int c = threadIdx.x; c < rows * (kBK / 16); c += kThreads) {
    const int r = c / (kBK / 16);
    const int kc = (c % (kBK / 16)) * 16;
    const int gr = row0 + r, gk = k0 + kc;
    const bool ok = gr < nrows && gk < K;
    const int8_t* src = ok ? X + gr * ld + gk : X;
    cp_async16(smem + r * kLds + kc, src, ok ? 16 : 0);
  }
}

// the same tile a byte at a time, zero outside [nrows) x [K)
template <int kThreads>
__device__ __forceinline__ void load_tile_bytes(int8_t* smem,
                                                const int8_t* X, int rows,
                                                int nrows, int row0, int k0,
                                                int K, long long ld) {
  for (int i = threadIdx.x; i < rows * kBK; i += kThreads) {
    const int r = i / kBK, kk = i % kBK;
    const int gr = row0 + r, gk = k0 + kk;
    smem[r * kLds + kk] = (gr < nrows && gk < K) ? X[gr * ld + gk] : 0;
  }
}

// The dequant scale s[n] = scale_a[n * a_step] * scale_b[n * b_step] in f32
// (a missing operand is 1; a step of 0 broadcasts one value over N): the
// product the Python wrapper's _dequant_scale builds, 1 * a * b, since
// multiplying by 1 is exact.  Read in the epilogue, so no kernel of the
// wrapper forms the product first.
struct Scales {
  const float* a;
  const float* b;
  int a_step, b_step;
  __device__ __forceinline__ float at(int n) const {
    return (a ? a[n * a_step] : 1.f) * (b ? b[n * b_step] : 1.f);
  }
};

template <int BM, int BN, int WM, int WN, bool kAsync, bool kDequant>
__global__ void __launch_bounds__(32 * (BM / WM) * (BN / WN))
int8_mm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
               Scales scale, void* __restrict__ out,
               int M, int N, int K, long long lda, long long ldb,
               long long ldc) {
  constexpr int kWarpsN = BN / WN;
  constexpr int kThreads = 32 * (BM / WM) * kWarpsN;
  constexpr int kMT = WM / 16, kNT = WN / 8;
  constexpr int kStages = kAsync ? 2 : 1;
  constexpr int kStage = (BM + BN) * kLds;
  __shared__ __align__(16) int8_t smem[kStages * kStage];

  const int bm0 = blockIdx.y * BM, bn0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp / kWarpsN) * WM, wn0 = (warp % kWarpsN) * WN;
  const int g = lane >> 2, t = lane & 3;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int nk = (K + kBK - 1) / kBK;
  auto load = [&](int stage, int kt) {
    int8_t* sa = smem + stage * kStage;
    int8_t* sb = sa + BM * kLds;
    if (kAsync) {
      load_tile_async<kThreads>(sa, A, BM, M, bm0, kt * kBK, K, lda);
      load_tile_async<kThreads>(sb, B, BN, N, bn0, kt * kBK, K, ldb);
      cp_async_commit();
    } else {
      load_tile_bytes<kThreads>(sa, A, BM, M, bm0, kt * kBK, K, lda);
      load_tile_bytes<kThreads>(sb, B, BN, N, bn0, kt * kBK, K, ldb);
    }
  };

  if (kAsync) load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    int stage = 0;
    if (kAsync) {
      stage = kt & 1;
      if (kt + 1 < nk) {
        load(stage ^ 1, kt + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      load(0, kt);
    }
    __syncthreads();
    const int8_t* sa = smem + stage * kStage;
    const int8_t* sb = sa + BM * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned af[kMT][4], bf[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int8_t* p = sa + (wm0 + i * 16 + g) * kLds + kk + t * 4;
        af[i][0] = *reinterpret_cast<const unsigned*>(p);
        af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * kLds);
        af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * kLds + 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int8_t* p = sb + (wn0 + j * 8 + g) * kLds + kk + t * 4;
        bf[j][0] = *reinterpret_cast<const unsigned*>(p);
        bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();   // the stage is overwritten by the next load
  }

  // epilogue: c0, c1 at (g, 2t), (g, 2t + 1); c2, c3 eight rows down
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = bm0 + wm0 + i * 16 + g + (r >> 1) * 8;
        const int n = bn0 + wn0 + j * 8 + 2 * t + (r & 1);
        if (m < M && n < N) {
          if (kDequant)
            static_cast<float*>(out)[m * ldc + n] =
                __int2float_rn(acc[i][j][r]) * scale.at(n);
          else
            static_cast<int*>(out)[m * ldc + n] = acc[i][j][r];
        }
      }
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch_mma(const int8_t* a, const int8_t* b, Scales scale,
                       void* out, int M, int N, int K, long long lda,
                       long long ldb, long long ldc, bool aligned,
                       cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int threads = 32 * (BM / WM) * (BN / WN);
  const bool dequant = scale.a || scale.b;
  if (aligned && dequant)
    int8_mm_kernel<BM, BN, WM, WN, true, true><<<grid, threads, 0, s>>>(
        a, b, scale, out, M, N, K, lda, ldb, ldc);
  else if (aligned)
    int8_mm_kernel<BM, BN, WM, WN, true, false><<<grid, threads, 0, s>>>(
        a, b, scale, out, M, N, K, lda, ldb, ldc);
  else if (dequant)
    int8_mm_kernel<BM, BN, WM, WN, false, true><<<grid, threads, 0, s>>>(
        a, b, scale, out, M, N, K, lda, ldb, ldc);
  else
    int8_mm_kernel<BM, BN, WM, WN, false, false><<<grid, threads, 0, s>>>(
        a, b, scale, out, M, N, K, lda, ldb, ldc);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgmma variant
// ---------------------------------------------------------------------------

constexpr int WBM = 128;              // rows of M per CTA: two warpgroups
constexpr int WBK = 128;              // K bytes per tile: one swizzled row
constexpr int NCONS = 256;            // consumer threads (warpgroups 0, 1)
constexpr int WNT = NCONS + 128;      // and the producer warpgroup
// registers per thread after the split: 128 x 40 + 256 x 232 = 64512 of
// the SM's 65536; at launch every thread holds 65536 / 384 rounded down
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Byte offsets in the (1024-aligned) dynamic shared memory: STAGES A tiles
// [128][128], STAGES B tiles [BN][128], then full[STAGES] and
// empty[STAGES].
template <int BN>
struct WSmem {
  static constexpr int STAGES = BN == 256 ? 4 : BN == 128 ? 6 : 8;
  static constexpr uint32_t kABytes = WBM * WBK;
  static constexpr uint32_t kBBytes = BN * WBK;
  static constexpr uint32_t a = 0;
  static constexpr uint32_t b = a + STAGES * kABytes;
  static constexpr uint32_t bars = b + STAGES * kBBytes;
  static constexpr size_t alloc = bars + 16 * STAGES + 1024;
};

template <int BN>
__device__ __forceinline__ void wg_produce(const CUtensorMap* tm_a,
                                           const CUtensorMap* tm_b,
                                           uint32_t base, int m0, int n0,
                                           int kt0, int nk) {
  using L = WSmem<BN>;
  constexpr int S = L::STAGES;
  const uint32_t bars = base + L::bars;
  // an A tile is read by every column tile's CTA, a B tile by every row
  // tile's: keep in the L2 what another CTA reads again, and let what
  // only this CTA reads (the weight of a classifier head) leave it first
  const uint64_t keep_a = gridDim.x > 1 ? l2_evict_last() : l2_evict_first();
  const uint64_t keep_b = gridDim.y > 1 ? l2_evict_last() : l2_evict_first();
  for (int j = 0; j < nk; ++j) {
    const int s = j % S;
    // slot s last held tile j - S: wait for the consumers to release it
    if (j >= S) mbar_wait(bars + 8 * (S + s), ((j / S) - 1) & 1);
    mbar_expect_tx(bars + 8 * s, L::kABytes + L::kBBytes);
    const int k = (kt0 + j) * WBK;
    tma_load_2d(base + L::a + s * L::kABytes, tm_a, bars + 8 * s, k, m0,
                keep_a);
    tma_load_2d(base + L::b + s * L::kBBytes, tm_b, bars + 8 * s, k, n0,
                keep_b);
  }
}

// A consumer thread's accumulators (rows r0 and r1, columns c0 + 8i and
// c0 + 8i + 1) into X (row stride ld), inside [M) x [N): int32 values, or
// f32 ones as their bits.  Pairs go as one 8-byte store where ld is even.
template <int BN>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2], int* X,
                                           long long ld, int r0, int r1,
                                           int c0, int M, int N) {
  const bool vec = (ld & 1) == 0;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int c = c0 + i * 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? r1 : r0;
      if (r >= M || c >= N) continue;
      int* p = X + r * ld + c;
      const int v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
      if (c + 1 < N && vec) {
        *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
      } else {
        p[0] = v0;
        if (c + 1 < N) p[1] = v1;
      }
    }
  }
}

// As store_tile, f32(acc) * s[c] with s[c] = sa[c * a_step] * sb[c *
// b_step] (Scales::at), the scales read through restrict pointers so that
// their loads need not wait behind the stores.
template <int BN>
__device__ __forceinline__ void store_tile_dequant(
    const int (&acc)[BN / 2], float* __restrict__ X, long long ld, int r0,
    int r1, int c0, int M, int N, const float* __restrict__ sa, int a_step,
    const float* __restrict__ sb, int b_step) {
  const bool vec = (ld & 1) == 0;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int c = c0 + i * 8;
    if (c >= N) continue;
    const bool two = c + 1 < N;
    const float s0 = (sa ? sa[c * a_step] : 1.f) * (sb ? sb[c * b_step] : 1.f);
    const float s1 = two ? (sa ? sa[(c + 1) * a_step] : 1.f) *
                               (sb ? sb[(c + 1) * b_step] : 1.f)
                         : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? r1 : r0;
      if (r >= M) continue;
      float* p = X + r * ld + c;
      const float f0 = __int2float_rn(acc[4 * i + 2 * h]) * s0;
      const float f1 = __int2float_rn(acc[4 * i + 2 * h + 1]) * s1;
      if (two && vec) {
        *reinterpret_cast<float2*>(p) = make_float2(f0, f1);
      } else {
        p[0] = f0;
        if (two) p[1] = f1;
      }
    }
  }
}

template <int BN, bool kDequant>
__device__ __forceinline__ void wg_consume(
    uint32_t base, int m0, int n0, int nk, Scales scale,
    void* __restrict__ out, int* __restrict__ ws, int M, int N,
    long long ldc) {
  using L = WSmem<BN>;
  constexpr int S = L::STAGES;
  constexpr int NA = BN / 2;             // accumulator registers a thread
  const uint32_t bars = base + L::bars;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;

  int acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0;
  const uint32_t a_wg = base + L::a + wg * 64 * WBK;   // this warpgroup's rows
  for (int j = 0; j < nk; ++j) {
    const int s = j % S;
    mbar_wait(bars + 8 * s, (j / S) & 1);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WBK / 32; ++kk) {
      const uint64_t da =
          desc_sw128(a_wg + s * L::kABytes + kk * 32, 16, 1024);
      const uint64_t db =
          desc_sw128(base + L::b + s * L::kBBytes + kk * 32, 16, 1024);
      wgmma_s8<BN>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();                  // tile j - 1's products are done
    pin(acc);
    if (j > 0) mbar_arrive(bars + 8 * (S + (j - 1) % S));
  }
  wgmma_wait<0>();
  pin(acc);

  // wgmma's accumulator layout: this thread holds rows r0 and r0 + 8 of
  // the warpgroup's 64 and, in each 8-column group i, the columns c, c + 1
  // (registers 4i, 4i + 1 on row r0; 4i + 2, 4i + 3 on row r1)
  const int r0 = m0 + wg * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int cq = (lane & 3) * 2;
  if (gridDim.z > 1) {
    // split-K: this split's partial tile, plain stores into its own slice
    // of the workspace; split_k_reduce_kernel adds the slices
    store_tile<BN>(acc, ws + blockIdx.z * (long long)M * N, N, r0, r1,
                   n0 + cq, M, N);
    return;
  }
  if (kDequant)
    store_tile_dequant<BN>(acc, static_cast<float*>(out), ldc, r0, r1,
                           n0 + cq, M, N, scale.a, scale.a_step, scale.b,
                           scale.b_step);
  else
    store_tile<BN>(acc, static_cast<int*>(out), ldc, r0, r1, n0 + cq, M, N);
}

template <int BN, bool kDequant>
__global__ void __launch_bounds__(WNT, 1)
int8_mm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_b,
                     Scales scale, void* __restrict__ out,
                     int* __restrict__ ws, int M, int N, int k_tiles,
                     int k_per_split, long long ldc) {
  using L = WSmem<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + L::bars;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * WBM;
  const int kt0 = blockIdx.z * k_per_split;
  const int nk = min(k_tiles - kt0, k_per_split);   // >= 1 (the planner)

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (L::STAGES + s), NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if/else for the two roles, never reconverging, so that ptxas
  // applies each setmaxnreg to its whole branch
  if (threadIdx.x >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == NCONS)
      wg_produce<BN>(&tm_a, &tm_b, base, m0, n0, kt0, nk);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    wg_consume<BN, kDequant>(base, m0, n0, nk, scale, out, ws, M, N, ldc);
  }
}

// The split-K sum: out[m, n] = sum over s of ws[s][m][n], added in split
// order (exact in int32 in any order), then int32 or f32(sum) * s[n].  Four
// consecutive columns a thread where N and ldc allow 16-byte accesses.
template <bool kDequant>
__global__ void __launch_bounds__(256)
split_k_reduce_kernel(const int* __restrict__ ws, int splits, int M, int N,
                      Scales scale, void* __restrict__ out, long long ldc) {
  const long long total = (long long)M * N;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (N % 4 == 0 && ldc % 4 == 0) {
    const int4* w = reinterpret_cast<const int4*>(ws);
    for (long long q = first; q < total / 4; q += step) {
      int4 v = w[q];
#pragma unroll 4
      for (int s = 1; s < splits; ++s) {
        const int4 p = w[s * (total / 4) + q];
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
      const long long r = 4 * q / N;
      const int c = (int)(4 * q - r * N);
      if (kDequant) {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + r * ldc + c) =
            make_float4(__int2float_rn(v.x) * scale.at(c),
                        __int2float_rn(v.y) * scale.at(c + 1),
                        __int2float_rn(v.z) * scale.at(c + 2),
                        __int2float_rn(v.w) * scale.at(c + 3));
      } else {
        *reinterpret_cast<int4*>(static_cast<int*>(out) + r * ldc + c) = v;
      }
    }
    return;
  }
  for (long long e = first; e < total; e += step) {
    int v = ws[e];
    for (int s = 1; s < splits; ++s) v += ws[s * total + e];
    const long long r = e / N;
    const int c = (int)(e - r * N);
    if (kDequant)
      static_cast<float*>(out)[r * ldc + c] = __int2float_rn(v) * scale.at(c);
    else
      static_cast<int*>(out)[r * ldc + c] = v;
  }
}

template <int BN, bool kDequant>
int launch_wgmma(const void* a, const void* b, Scales scale, void* out,
                 int* ws, int M, int N, int K, long long lda, long long ldb,
                 long long ldc, int splits, int k_per_split,
                 cudaStream_t stream) {
  constexpr size_t smem = WSmem<BN>::alloc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_mm_wgmma_kernel<BN, kDequant>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap ma, mb;
  int rc = make_map_2d_s8(&ma, a, M, K, lda, WBM);
  if (rc == 0) rc = make_map_2d_s8(&mb, b, N, K, ldb, BN);
  if (rc != 0) return rc;
  const dim3 grid((N + BN - 1) / BN, (M + WBM - 1) / WBM, splits);
  const int k_tiles = (K + WBK - 1) / WBK;
  int8_mm_wgmma_kernel<BN, kDequant><<<grid, WNT, smem, stream>>>(
      ma, mb, scale, out, ws, M, N, k_tiles, k_per_split, ldc);
  cudaError_t rc2 = cudaGetLastError();
  if (rc2 != cudaSuccess || splits == 1) return (int)rc2;
  const long long items = (N % 4 == 0 && ldc % 4 == 0)
                              ? (long long)M * N / 4 : (long long)M * N;
  const int blocks = (int)std::min<long long>((items + 255) / 256, 4096);
  split_k_reduce_kernel<kDequant><<<blocks, 256, 0, stream>>>(
      ws, splits, M, N, scale, out, ldc);
  return (int)cudaGetLastError();
}

template <int BN>
int dispatch_wgmma(const void* a, const void* b, Scales scale, void* out,
                   int* ws, int M, int N, int K, long long lda,
                   long long ldb, long long ldc, int splits, int k_per_split,
                   cudaStream_t s) {
  return scale.a || scale.b
             ? launch_wgmma<BN, true>(a, b, scale, out, ws, M, N, K, lda,
                                        ldb, ldc, splits, k_per_split, s)
               : launch_wgmma<BN, false>(a, b, scale, out, ws, M, N, K, lda,
                                         ldb, ldc, splits, k_per_split, s);
}

}  // namespace

extern "C" {

// a [M, K] int8 (row stride lda), b [N, K] int8 (row stride ldb), out
// [M, N] (row stride ldc): int32 when both scales are null, else f32 with
// out = float(acc) * (scale_a[n * a_step] * scale_b[n * b_step]) (a null
// scale counts as 1; a step of 0 broadcasts its one value).  The mma
// variant; num_sms picks the tile size.  Returns a cudaError_t (0 on
// success).
int mxt_int8_mm_mma(const void* a, const void* b, const void* scale_a,
                    int a_step, const void* scale_b, int b_step, void* out,
                    int M, int N, int K, long long lda, long long ldb,
                    long long ldc, int num_sms, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || lda < K || ldb < K || ldc < N)
    return (int)cudaErrorInvalidValue;
  const bool aligned = K % 16 == 0 && lda % 16 == 0 && ldb % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* B = static_cast<const int8_t*>(b);
  const Scales S{static_cast<const float*>(scale_a),
                 static_cast<const float*>(scale_b), a_step, b_step};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long big_tiles =
      (long long)((M + 127) / 128) * ((N + 127) / 128);
  if (big_tiles >= num_sms)
    return (int)launch_mma<128, 128, 64, 32>(A, B, S, out, M, N, K, lda, ldb,
                                             ldc, aligned, s);
  return (int)launch_mma<64, 64, 32, 32>(A, B, S, out, M, N, K, lda, ldb,
                                         ldc, aligned, s);
}

// The wgmma variant on inputs TMA can read: K % 16 == 0, lda and ldb
// multiples of 16, both bases 16-byte aligned.  Scales as above.  The plan
// comes from the Python planner: block_n (64, 128 or 256) columns per CTA,
// `splits` splits of K of `k_per_split` tiles of 128 bytes each (the last
// may be shorter, none empty).  With splits > 1, ws is an int32 workspace
// of splits·M·N entries (unused, may be null, otherwise), and a second
// kernel adds its slices into `out`.  Returns 0, a cudaError_t or a code of
// hopper.cuh (mxt_int8_mm_error_string).
int mxt_int8_mm_wgmma(const void* a, const void* b, const void* scale_a,
                      int a_step, const void* scale_b, int b_step, void* out,
                      void* ws, int M, int N, int K, long long lda,
                      long long ldb, long long ldc, int block_n, int splits,
                      int k_per_split, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const long long k_tiles = (K + WBK - 1) / WBK;
  const bool aligned = K % 16 == 0 && lda % 16 == 0 && ldb % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (K <= 0 || lda < K || ldb < K || ldc < N || !aligned || splits < 1 ||
      splits > 65535 || k_per_split < 1 ||
      (long long)splits * k_per_split < k_tiles ||
      (long long)(splits - 1) * k_per_split >= k_tiles ||
      (splits > 1 && ws == nullptr) ||
      (M + WBM - 1) / WBM > 65535)
    return (int)cudaErrorInvalidValue;
  const Scales S{static_cast<const float*>(scale_a),
                 static_cast<const float*>(scale_b), a_step, b_step};
  int* W = static_cast<int*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_n) {
    case 64:
      return dispatch_wgmma<64>(a, b, S, out, W, M, N, K, lda, ldb, ldc,
                                splits, k_per_split, s);
    case 128:
      return dispatch_wgmma<128>(a, b, S, out, W, M, N, K, lda, ldb, ldc,
                                 splits, k_per_split, s);
    case 256:
      return dispatch_wgmma<256>(a, b, S, out, W, M, N, K, lda, ldb, ldc,
                                 splits, k_per_split, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mxt_int8_mm_error_string(int code) {
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused an operand's layout";
  if (code == kErrNoEntryPoint)
    return "the driver has no cuTensorMapEncodeTiled";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
