// Fused softmax cross-entropy, forward and backward, for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the Pallas TPU kernels mxnet_tpu/ops/pallas/layers.py
// `_xent_fwd_kernel` and `_xent_bwd_kernel` (launched by `_xent_pallas_fwd`
// and `_xent_op_bwd`, public `fused_softmax_xent`).  Semantics, kept exactly:
//
//   forward, per row n of logits [N, V] (f32 or bf16):
//     s    = float(logits[n, :])
//     lse  = m + log(sum(exp(s - m)))       online max and sum over V
//     gold = s[label] if 0 <= label < V else 0
//     loss = lse - gold;  both loss and lse written in f32
//   backward:
//     dlogits[n, c] = T((exp(s - lse[n]) - (c == label[n])) * g[n])
//
// The TPU wrapper pads V up to a multiple of its 2048-wide vocab block with
// a copy and masks the pad; here each row is walked only up to V, so there
// is no pad and no copy.  Rows are read through a row stride.
//
// Shape of the kernels: one CTA of 256 threads per row.  In the forward each
// thread streams its strided share of the row with its own running (m, l) —
// one exp per element, a rescale only when the max moves — and the CTA then
// merges the 256 pairs with warp shuffles and one shared-memory hop.  The
// gold logit is one extra load by thread 0.  The backward is one pass:
// read, exp, subtract the one-hot, scale, write.
//
// What bounds them on the card: bytes.  The forward reads N*V logits once
// and writes 8 bytes a row; the backward reads them once more and writes
// N*V gradients.  A few flops and one exp per element keep both far below
// the ridge.  Loads are scalar and coalesced; vector loads are later work.
//
// Plain C interface (no PyTorch headers), called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr float kNeg = -1e30f;

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
  return __float2bfloat16(v);
}

// merge two (max, sum of exp(x - max)) pairs
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(NT)
xent_fwd_kernel(const T* __restrict__ logits, const long long* __restrict__ labels,
                float* __restrict__ loss, float* __restrict__ lse_out, int V,
                long long row_stride) {
  __shared__ float sm[NT / 32], sl[NT / 32];
  const long long n = blockIdx.x;
  const T* row = logits + n * row_stride;

  float m = kNeg, l = 0.f;
  for (int c = threadIdx.x; c < V; c += NT) {
    const float s = to_f32(row[c]);
    if (s > m) {
      l = l * expf(m - s) + 1.f;
      m = s;
    } else {
      l += expf(s - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, m2, l2);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < NT / 32 ? sm[lane] : kNeg;
    l = lane < NT / 32 ? sl[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
      merge(m, l, m2, l2);
    }
    if (lane == 0) {
      const long long label = labels[n];
      const float gold =
          (label >= 0 && label < V) ? to_f32(row[label]) : 0.f;
      const float lse = m + logf(l);
      lse_out[n] = lse;
      loss[n] = lse - gold;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
xent_bwd_kernel(const T* __restrict__ logits, const long long* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ g,
                T* __restrict__ dlogits, int V, long long row_stride,
                long long g_stride, long long out_stride) {
  const long long n = blockIdx.x;
  const T* row = logits + n * row_stride;
  T* orow = dlogits + n * out_stride;
  const float lse_n = lse[n];
  const float g_n = g[n * g_stride];
  const long long label = labels[n];
  for (int c = threadIdx.x; c < V; c += NT) {
    const float p = expf(to_f32(row[c]) - lse_n);
    const float onehot = c == label ? 1.f : 0.f;
    orow[c] = from_f32<T>((p - onehot) * g_n);
  }
}

}  // namespace

extern "C" {

// logits: [N, V] with unit stride on V and row stride `row_stride`
// (elements); labels: int64 [N], contiguous; loss, lse: f32 [N],
// contiguous.  dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
int mxt_xent_fwd(const void* logits, const void* labels, void* loss,
                 void* lse, long long N, int V, long long row_stride,
                 int dtype, void* stream) {
  if (N <= 0) return 0;
  if (V <= 0 || N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(N));
  const long long* lab = static_cast<const long long*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      xent_fwd_kernel<float><<<grid, NT, 0, s>>>(
          static_cast<const float*>(logits), lab, lo, ls, V, row_stride);
      break;
    case 1:
      xent_fwd_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
          static_cast<const __nv_bfloat16*>(logits), lab, lo, ls, V,
          row_stride);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// logits as above; labels int64 [N] and lse f32 [N], contiguous; g: f32,
// element n at g[n * g_stride] (0 for a broadcast cotangent); dlogits:
// [N, V] in the logits dtype, row stride `out_stride`.
int mxt_xent_bwd(const void* logits, const void* labels, const void* lse,
                 const void* g, void* dlogits, long long N, int V,
                 long long row_stride, long long g_stride,
                 long long out_stride, int dtype, void* stream) {
  if (N <= 0) return 0;
  if (V <= 0 || N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(N));
  const long long* lab = static_cast<const long long*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  switch (dtype) {
    case 0:
      xent_bwd_kernel<float><<<grid, NT, 0, s>>>(
          static_cast<const float*>(logits), lab, ls, gg,
          static_cast<float*>(dlogits), V, row_stride, g_stride, out_stride);
      break;
    case 1:
      xent_bwd_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
          static_cast<const __nv_bfloat16*>(logits), lab, ls, gg,
          static_cast<__nv_bfloat16*>(dlogits), V, row_stride, g_stride,
          out_stride);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* mxt_xent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
