// Int8 matmul for Hopper (sm_90a), CUDA C++: int32 out, or the per-channel
// dequant fused into the epilogue.
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
// mma.sync without .satfinite wraps as XLA's int32 adds do.
//
// What bounds it on the card: at large M, N and K operations (2·M·N·K at
// 1979 dense int8 TOP/s: ~240 int8 operations per byte read), at the small
// M of a classifier head bytes (the weight, N·K bytes, read once).  The
// design is the simple one for a first port: mma.sync m16n8k32 s8 tensor
// core tiles (not wgmma), fed from shared memory.
//
//   * CTA tile BM x BN x 64 bytes of K; each warp owns a WM x WN sub-tile
//     of (WM/16) x (WN/8) mma tiles in registers.  128 x 128 with 8 warps
//     when that grid fills the card; 64 x 64 with 4 warps otherwise (a
//     classifier head at M = 128 would give a handful of CTAs).
//   * Operands are K-contiguous on both sides ("row" A, "col" B), which is
//     what mma.m16n8k32.row.col wants: every fragment register is 4
//     consecutive K bytes of one row, one 32-bit shared-memory load.
//     Shared rows are padded to 80 bytes so the 32 lanes of a fragment
//     load hit 32 distinct banks.
//   * Aligned path (K % 16 == 0, rows and bases 16-byte aligned): 16-byte
//     cp.async into a two-stage ring, so the next K tile loads while this
//     one multiplies.  Rows past M or N and K past the end are zero-filled
//     by cp.async's src-size operand.  No padding of the operands in device
//     memory: a VGG16 fc6 weight is 103 MB.
//   * General path (any K, any alignment): the same tiles loaded a byte at
//     a time with bounds checks, one stage.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers, sizes, strides and the current cudaStream_t through
// ctypes, and raises on any non-zero return (the cudaGetLastError() after
// the launch).

#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

template <int BM, int BN, int WM, int WN, bool kAsync, bool kDequant>
__global__ void __launch_bounds__(32 * (BM / WM) * (BN / WN))
int8_mm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
               const float* __restrict__ scale, void* __restrict__ out,
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
                __int2float_rn(acc[i][j][r]) * scale[n];
          else
            static_cast<int*>(out)[m * ldc + n] = acc[i][j][r];
        }
      }
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch(const int8_t* a, const int8_t* b, const float* scale,
                   void* out, int M, int N, int K, long long lda,
                   long long ldb, long long ldc, bool aligned,
                   cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int threads = 32 * (BM / WM) * (BN / WN);
  if (aligned && scale)
    int8_mm_kernel<BM, BN, WM, WN, true, true><<<grid, threads, 0, s>>>(
        a, b, scale, out, M, N, K, lda, ldb, ldc);
  else if (aligned)
    int8_mm_kernel<BM, BN, WM, WN, true, false><<<grid, threads, 0, s>>>(
        a, b, scale, out, M, N, K, lda, ldb, ldc);
  else if (scale)
    int8_mm_kernel<BM, BN, WM, WN, false, true><<<grid, threads, 0, s>>>(
        a, b, scale, out, M, N, K, lda, ldb, ldc);
  else
    int8_mm_kernel<BM, BN, WM, WN, false, false><<<grid, threads, 0, s>>>(
        a, b, scale, out, M, N, K, lda, ldb, ldc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a [M, K] int8 (row stride lda), b [N, K] int8 (row stride ldb), out
// [M, N] (row stride ldc): int32 when scale is null, else f32 with
// out = float(acc) * scale[n].  num_sms picks the tile size.  Returns a
// cudaError_t (0 on success).
int mxt_int8_mm(const void* a, const void* b, const void* scale, void* out,
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
  const float* S = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long big_tiles =
      (long long)((M + 127) / 128) * ((N + 127) / 128);
  if (big_tiles >= num_sms)
    return (int)launch<128, 128, 64, 32>(A, B, S, out, M, N, K, lda, ldb,
                                         ldc, aligned, s);
  return (int)launch<64, 64, 32, 32>(A, B, S, out, M, N, K, lda, ldb, ldc,
                                     aligned, s);
}

const char* mxt_int8_mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
