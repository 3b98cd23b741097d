// Fused RMSNorm forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel mxnet_tpu/ops/pallas/layers.py
// `_rmsnorm_kernel` (launched by `_rmsnorm_fwd_pallas`, public
// `fused_rmsnorm`).  Semantics, kept exactly:
//
//   xf  = float(x)                          variance in f32
//   r   = rsqrt(sum(xf * xf) / E + eps)
//   out = T(T(xf * r) * T(scale))           two roundings to the model
//                                           dtype, as the TPU kernel does
//
// What bounds it on the card: bytes.  x is read once and out written once
// (scale once), with a handful of flops per element, far below the H100's
// ~295 flop/byte ridge.  So the design is about keeping enough bytes in
// flight (Little's law: ~18 KB per SM at 3.35 TB/s) and about reading each
// row once.  Three variants, chosen by `plan_rmsnorm` (layers.py) from the
// shape and layout alone:
//
// * warp  — rows to warps.  A row group of WPR warps (one warp for rows up
//   to 4 KB) normalizes one row at a time, with 16-byte vector loads and
//   stores (8 bf16 or 4 f32 values; neighbouring lanes on neighbouring
//   addresses).  The row stays in registers from the load to the store, so
//   it is read once.  The sum is reduced by warp shuffles (and, for WPR >
//   1, one named barrier of the row group, never __syncthreads).  `scale`
//   is read once a CTA into shared memory and kept there for every row
//   (kept in registers, bf16's unpacked scale took 64 registers and, at
//   two CTAs of 256 threads an SM, spilled).  The grid is
//   persistent (a small multiple of the SM count) and walks the rows; each
//   row group issues the loads of its next row before it reduces the
//   current one (two register buffers), so the loads of one row overlap the
//   reduction and stores of the previous one.
// * block — one CTA per row, one to eight vectors per thread: for few rows
//   (decode's <= 8), where a call costs one load round trip and one
//   reduction (shuffles, then one __syncthreads), and for rows too wide for
//   a row group (up to 128 KB, still held in registers).
// * simt  — the first, scalar kernel (one CTA of 256 threads per row,
//   scalar loads, the row read twice): for what the vector variants cannot
//   take, a row base or row stride not 16-byte aligned (offset views), a
//   row whose bytes are not a multiple of 16, or a row wider than 128 KB.
//
// The f32 sum of squares is taken in a fixed order for a given variant and
// shape (each thread in order over its vectors, then an xor butterfly,
// which leaves the same bits in every lane, then the warps' sums in warp
// order), so repeated calls give identical bits.  No atomics.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers, sizes, the plan and the current cudaStream_t through
// ctypes, and raises on any non-zero return (an invalid plan or layout, or
// the cudaGetLastError() after the launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // simt: one CTA of 256 threads a row
constexpr int kWarpCtaThreads = 256;   // warp: at most 8 warps a CTA
constexpr int kBlockMaxThreads = 1024;

// ---------------------------------------------------------------------------
// simt: the first, scalar kernel
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA and torch do
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ out, int E, long long x_stride,
                   long long o_stride, float eps) {
  __shared__ float partial[kThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * x_stride;
  T* orow = out + row * o_stride;

  float ss = 0.f;
  for (int i = threadIdx.x; i < E; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < kThreads / 32 ? partial[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) partial[0] = ss;
  }
  __syncthreads();
  const float r = rsqrtf(partial[0] / static_cast<float>(E) + eps);

  for (int i = threadIdx.x; i < E; i += kThreads) {
    const T y = from_f32<T>(to_f32(xr[i]) * r);
    orow[i] = from_f32<T>(to_f32(y) * to_f32(scale[i]));
  }
}

// ---------------------------------------------------------------------------
// 16-byte vectors: 4 f32 or 8 bf16 values in a uint4
// ---------------------------------------------------------------------------

template <typename T>
constexpr int kPerVec = 16 / sizeof(T);

// Overloads by the array's extent: 4 values (f32) or 8 (bf16).
__device__ __forceinline__ void unpack(uint4 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower address is the low half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Pack 4 f32 values, or round 8 values to bf16 (nearest even) and pack.
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// v rounded to T and back: the kernel's first rounding.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ float add_squares(uint4 v, float acc) {
  float f[kPerVec<T>];
  unpack(v, f);
#pragma unroll
  for (int i = 0; i < kPerVec<T>; ++i) acc += f[i] * f[i];
  return acc;
}

// T(T(x·r)·T(scale)) of one vector.
template <typename T>
__device__ __forceinline__ uint4 normalize(uint4 xv, uint4 sv, float r) {
  float f[kPerVec<T>], s[kPerVec<T>];
  unpack(xv, f);
  unpack(sv, s);
#pragma unroll
  for (int i = 0; i < kPerVec<T>; ++i) f[i] = round_to<T>(f[i] * r) * s[i];
  return pack(f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// warp: rows to row groups of WPR warps, persistent, two row buffers
// ---------------------------------------------------------------------------

// Vector j of thread t holds the row's 16-byte chunk t + j·G (G = 32·WPR),
// zero past the row's `chunks`.  x is read once: evict first.
template <int VPT, int G>
__device__ __forceinline__ void load_row(uint4 (&v)[VPT], const uint4* xr,
                                         int chunks, int t) {
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = t + j * G;
    v[j] = c < chunks ? __ldcs(xr + c) : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int VPT, int WPR>
__device__ __forceinline__ void finish_row(
    const uint4 (&v)[VPT], const uint4* s, uint4* orow, int chunks, int E,
    float eps, int t, int group, float* partial, int& parity) {
  constexpr int G = 32 * WPR;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) ss = add_squares<T>(v[j], ss);
  ss = warp_sum(ss);
  if constexpr (WPR > 1) {
    // the row group's warps: one named barrier, two slots used in turn
    // (a slot is written again only after every thread of the group has
    // passed the next row's barrier, so after it read this row's sums)
    float* p = partial + (parity * (kWarpCtaThreads / 32)) + group * WPR;
    if ((t & 31) == 0) p[t >> 5] = ss;
    named_barrier(1 + group, G);
    ss = 0.f;
#pragma unroll
    for (int k = 0; k < WPR; ++k) ss += p[k];
    parity ^= 1;
  }
  const float r = rsqrtf(ss / static_cast<float>(E) + eps);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = t + j * G;
    if (c < chunks) orow[c] = normalize<T>(v[j], s[c], r);
  }
}

template <typename T, int VPT, int WPR>
__global__ void __launch_bounds__(kWarpCtaThreads, 2)
rmsnorm_warp_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    T* __restrict__ out, long long n_rows, int E,
                    long long x_stride, long long o_stride, float eps) {
  constexpr int G = 32 * WPR;
  __shared__ float partial[2 * (kWarpCtaThreads / 32)];
  extern __shared__ uint4 s[];   // scale: read once a CTA, kept for every row
  const int t = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const int groups = blockDim.x / G;
  const int chunks = E / kPerVec<T>;
  const long long step = static_cast<long long>(gridDim.x) * groups;
  long long row = static_cast<long long>(blockIdx.x) * groups + group;
  int parity = 0;
  auto xrow = [&](long long i) {
    return reinterpret_cast<const uint4*>(x + i * x_stride);
  };
  auto orow = [&](long long i) {
    return reinterpret_cast<uint4*>(out + i * o_stride);
  };

  uint4 a[VPT], b[VPT];
  // the first row's loads go out before scale's copy and its barrier
  if (row < n_rows) load_row<VPT, G>(a, xrow(row), chunks, t);
  const uint4* s4 = reinterpret_cast<const uint4*>(scale);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) s[c] = __ldg(s4 + c);
  __syncthreads();  // once, before the first row's store
  // two buffers in turn: the next row's loads are in flight while this
  // row is reduced and stored
  while (row < n_rows) {
    long long next = row + step;
    if (next < n_rows) load_row<VPT, G>(b, xrow(next), chunks, t);
    finish_row<T, VPT, WPR>(a, s, orow(row), chunks, E, eps, t, group,
                            partial, parity);
    row = next;
    if (row >= n_rows) break;
    next = row + step;
    if (next < n_rows) load_row<VPT, G>(a, xrow(next), chunks, t);
    finish_row<T, VPT, WPR>(b, s, orow(row), chunks, E, eps, t, group,
                            partial, parity);
    row = next;
  }
}

// ---------------------------------------------------------------------------
// block: one CTA per row
// ---------------------------------------------------------------------------

template <typename T, int VPT>
__global__ void __launch_bounds__(kBlockMaxThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                     T* __restrict__ out, int E, long long x_stride,
                     long long o_stride, float eps) {
  // up to 4 vectors a thread, scale's loads go out with x's (one round
  // trip); at 8 (rows of 64 to 128 KB, 1024 threads, so at most 64
  // registers a thread) scale is read at the store
  constexpr bool kScaleFirst = VPT <= 4;
  __shared__ float partial[kBlockMaxThreads / 32];
  const int chunks = E / kPerVec<T>;
  const long long row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * x_stride);
  uint4* orow = reinterpret_cast<uint4*>(out + row * o_stride);
  const uint4* s4 = reinterpret_cast<const uint4*>(scale);
  const int n = blockDim.x;

  uint4 v[VPT], s[kScaleFirst ? VPT : 1];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = threadIdx.x + j * n;
    v[j] = c < chunks ? __ldcs(xr + c) : make_uint4(0u, 0u, 0u, 0u);
    if constexpr (kScaleFirst)
      s[j] = c < chunks ? __ldg(s4 + c) : make_uint4(0u, 0u, 0u, 0u);
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) ss = add_squares<T>(v[j], ss);
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  ss = 0.f;
  for (int k = 0; k < n / 32; ++k) ss += partial[k];   // same order in all
  const float r = rsqrtf(ss / static_cast<float>(E) + eps);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = threadIdx.x + j * n;
    if (c < chunks) {
      uint4 sv;
      if constexpr (kScaleFirst)
        sv = s[j];
      else
        sv = __ldg(s4 + c);
      orow[c] = normalize<T>(v[j], sv, r);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// What both vector variants need: 16-byte-aligned bases, rows and row
// strides that are whole 16-byte vectors.
bool vector_layout(const void* x, const void* scale, const void* out, int E,
                   long long x_stride, long long o_stride, int itemsize) {
  return aligned16(x) && aligned16(scale) && aligned16(out) &&
         (static_cast<long long>(E) * itemsize) % 16 == 0 &&
         (x_stride * itemsize) % 16 == 0 && (o_stride * itemsize) % 16 == 0;
}

template <typename T>
int launch_warp(const void* x, const void* scale, void* out,
                long long n_rows, int E, long long x_stride,
                long long o_stride, float eps, int wpr, int vpt,
                int rows_per_cta, int grid, cudaStream_t s) {
  const long long chunks = E / kPerVec<T>;
  if (rows_per_cta < 1 || rows_per_cta * 32 * wpr > kWarpCtaThreads ||
      grid < 1 || chunks > 32LL * wpr * vpt)
    return (int)cudaErrorInvalidValue;
  const dim3 block(32 * wpr * rows_per_cta);
  const size_t smem = chunks * 16;  // scale, at most 16 KB
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* op = static_cast<T*>(out);
#define MXT_WARP(W, V)                                                     \
  if (wpr == W && vpt == V) {                                              \
    rmsnorm_warp_kernel<T, V, W><<<grid, block, smem, s>>>(                \
        xp, sp, op, n_rows, E, x_stride, o_stride, eps);                   \
    return (int)cudaGetLastError();                                        \
  }
  MXT_WARP(1, 1)
  MXT_WARP(1, 2)
  MXT_WARP(1, 4)
  MXT_WARP(1, 8)
  MXT_WARP(2, 8)
  MXT_WARP(4, 8)
#undef MXT_WARP
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_block(const void* x, const void* scale, void* out,
                 long long n_rows, int E, long long x_stride,
                 long long o_stride, float eps, int vpt, int threads,
                 cudaStream_t s) {
  const long long chunks = E / kPerVec<T>;
  if (threads < 32 || threads > kBlockMaxThreads || threads % 32 != 0 ||
      chunks > static_cast<long long>(threads) * vpt)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(n_rows));
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* op = static_cast<T*>(out);
#define MXT_BLOCK(V)                                                       \
  if (vpt == V) {                                                          \
    rmsnorm_block_kernel<T, V><<<grid, threads, 0, s>>>(                   \
        xp, sp, op, E, x_stride, o_stride, eps);                           \
    return (int)cudaGetLastError();                                        \
  }
  MXT_BLOCK(1)
  MXT_BLOCK(2)
  MXT_BLOCK(4)
  MXT_BLOCK(8)
#undef MXT_BLOCK
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Each returns a cudaError_t (0 on
// success); n_rows 0 launches nothing.

// simt: any layout.
int mxt_rmsnorm_simt(const void* x, const void* scale, void* out,
                     long long n_rows, int E, long long x_stride,
                     long long o_stride, float eps, int dtype, void* stream) {
  if (n_rows <= 0) return 0;
  if (E <= 0 || n_rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_rows));
  switch (dtype) {
    case 0:
      rmsnorm_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(scale),
          static_cast<float*>(out), E, x_stride, o_stride, eps);
      break;
    case 1:
      rmsnorm_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(scale),
          static_cast<__nv_bfloat16*>(out), E, x_stride, o_stride, eps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// warp: row groups of `wpr` warps, `vpt` vectors a thread, `rows_per_cta`
// row groups a CTA, a persistent grid of `grid` CTAs.
int mxt_rmsnorm_warp(const void* x, const void* scale, void* out,
                     long long n_rows, int E, long long x_stride,
                     long long o_stride, float eps, int dtype, int wpr,
                     int vpt, int rows_per_cta, int grid, void* stream) {
  if (n_rows <= 0) return 0;
  if (E <= 0 || (dtype != 0 && dtype != 1) ||
      !vector_layout(x, scale, out, E, x_stride, o_stride,
                     dtype == 0 ? 4 : 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_warp<float>(x, scale, out, n_rows, E, x_stride, o_stride,
                              eps, wpr, vpt, rows_per_cta, grid, s);
  return launch_warp<__nv_bfloat16>(x, scale, out, n_rows, E, x_stride,
                                    o_stride, eps, wpr, vpt, rows_per_cta,
                                    grid, s);
}

// block: one CTA of `threads` threads per row, `vpt` vectors a thread.
int mxt_rmsnorm_block(const void* x, const void* scale, void* out,
                      long long n_rows, int E, long long x_stride,
                      long long o_stride, float eps, int dtype, int vpt,
                      int threads, void* stream) {
  if (n_rows <= 0) return 0;
  if (E <= 0 || n_rows > 0x7fffffffLL || (dtype != 0 && dtype != 1) ||
      !vector_layout(x, scale, out, E, x_stride, o_stride,
                     dtype == 0 ? 4 : 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_block<float>(x, scale, out, n_rows, E, x_stride, o_stride,
                               eps, vpt, threads, s);
  return launch_block<__nv_bfloat16>(x, scale, out, n_rows, E, x_stride,
                                     o_stride, eps, vpt, threads, s);
}

const char* mxt_rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
