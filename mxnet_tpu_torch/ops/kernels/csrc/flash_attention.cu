// Flash-attention forward for Hopper (sm_90a), CUDA C++: the CUDA-core
// ("simt") variant of the forward.
//
// The wrapper (flash_attention.py, _fwd_variant) sends f32 inputs and
// head_dim 16 or 32 here.  f32: the tensor cores have no f32 operand that
// keeps q.k^T exact (tf32 would round q and k).  head_dim 16 or 32: less
// than one 128-byte row of the swizzled tiles that the tensor-core variant
// (flash_attention_wgmma.cu, bf16 with head_dim 64 or 128) reads.  The bf16
// instantiations at head_dim 64 and 128 stay so that the two variants can
// be held against each other on the same inputs.
//
// Replaces the Pallas TPU kernel mxnet_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (launched by `_fwd`, public `flash_attention` and
// `flash_attention_lse`).  Semantics, kept exactly:
//
//   s   = (q . k^T) * scale                  f32 scores
//   s   = -1e30 where (k_pos >= kv_len) or (causal and q_pos < k_pos)
//   online softmax over key tiles with running (m, l, acc), p kept in f32
//   and v upcast to f32 for the P.V product
//   o   = T(acc / l)        (0 where l == 0);  lse = m + log(l)  (f32)
//
// Shape of the kernel: one CTA of 256 threads per (q-tile of 64 rows,
// head, batch).  The q tile is staged in shared memory once, then the CTA
// walks the key tiles (64 keys) in order, which takes the place of the
// TPU's sequential innermost grid dimension: K (transposed) and V tiles go
// through shared memory, each thread owns 4 query rows x 4 keys of the
// score tile and 4 rows x D/16 head dims of the accumulator, and the row
// max / row sum are reduced over the 16 lanes that share a row with warp
// shuffles.  Inputs are read as [B, T, H, D] through their strides, so the
// caller makes no transposed or padded copies; ragged tails are handled by
// bounds checks on load and store plus the kv_len mask.
//
// Key tiles wholly above the causal diagonal are skipped.  For any row that
// has one valid key (key 0 always is, under the causal mask) such a tile
// would add exp(-1e30 - m) = 0 to l and acc with alpha = 1, so skipping it
// is exact.  Heavy (late) q tiles are scheduled first.
//
// What bounds it on the card: operations.  4*D flops per (q, k) pair against
// 2*D bytes per row read once puts attention at T >= 4096 far above the
// ridge.  This variant computes in f32 on the CUDA cores (p stays f32 for
// P.V, as on the TPU), so it runs far below the bf16 tensor-core bound.
//
// Plain C interface (no PyTorch headers), called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // keys per tile
constexpr int NT = 256;      // threads per CTA, laid out 16 x 16
constexpr int RPT = BQ / 16; // query rows per thread
constexpr int CPT = BK / 16; // keys per thread
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

// Shared-memory layout in floats.  Strides are padded so that the access
// patterns below are free of bank conflicts.
template <int D>
struct Layout {
  static constexpr int q_stride = D + 1;    // Qs[r][d]
  static constexpr int kt_stride = BK + 1;  // Kt[d][c] (K transposed)
  static constexpr int v_stride = D;        // Vs[c][d]
  static constexpr int p_stride = BK + 16;  // Ps[r][c]
  static constexpr int q_off = 0;
  static constexpr int kt_off = q_off + BQ * q_stride;
  static constexpr int v_off = kt_off + D * kt_stride;
  static constexpr int p_off = v_off + BK * v_stride;
  static constexpr int floats = p_off + BQ * p_stride;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk,
                 long long q_sb, long long q_st, long long q_sh,
                 long long k_sb, long long k_st, long long k_sh,
                 long long v_sb, long long v_st, long long v_sh,
                 long long o_sb, long long o_st, long long o_sh,
                 float scale, int causal, int kv_len) {
  using L = Layout<D>;
  constexpr int DPT = D / 16;  // head dims per thread
  extern __shared__ float smem[];
  float* Qs = smem + L::q_off;
  float* Kt = smem + L::kt_off;
  float* Vs = smem + L::v_off;
  float* Ps = smem + L::p_off;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    const int qpos = q0 + r;
    Qs[r * L::q_stride + d] =
        qpos < Tq ? to_f32(qb[qpos * q_st + d]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, Tq) - 1;
  const int k_end = causal ? min(kv_len, q_last + 1) : kv_len;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile's readers are done with Kt/Vs/Ps
    for (int e = tid; e < BK * D; e += NT) {
      const int c = e / D, d = e % D;
      const int kpos = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (kpos < Tk) {
        kv = to_f32(kb[kpos * k_st + d]);
        vv = to_f32(vb[kpos * v_st + d]);
      }
      Kt[d * L::kt_stride + c] = kv;
      Vs[c * L::v_stride + d] = vv;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + 16 * i) * L::q_stride + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Kt[d * L::kt_stride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mloc = kNeg;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < kv_len && (!causal || qpos >= kpos);
        s[i][j] = ok ? s[i][j] * scale : kNeg;
        mloc = fmaxf(mloc, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
      const float m_new = fmaxf(m[i], mloc);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * L::p_stride + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + 16 * i) * L::p_stride + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[c * L::v_stride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + b * o_sb + h * o_sh;
  float* lb = lse + ((long long)b * H + h) * Tq;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Tq) continue;
    // fully-masked rows (l == 0) emit 0, not nan
    const float safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      ob[qpos * o_st + tx + 16 * j] = from_f32<T>(acc[i][j] / safe);
    if (tx == 0) lb[qpos] = m[i] + logf(safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Tq, int Tk,
                   const long long* st, float scale, int causal, int kv_len,
                   cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::bytes;
  // above 48 KB of dynamic shared memory needs an explicit opt-in, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Tq, Tk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale, causal, kv_len);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, float* lse, int B, int H, int Tq, int Tk,
                       const long long* st, float scale, int causal,
                       int kv_len, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal,
                           kv_len, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal,
                           kv_len, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal,
                           kv_len, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal,
                            kv_len, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q/k/v/o: [B, T, H, D] with unit stride on D; strides (in elements) are
// given for the B, T and H axes of q, k, v, o in that order.  lse: f32
// [B, H, Tq], contiguous.  dtype: 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t (0 on success).
int mxt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int H, int Tq, int Tk, int D,
                  long long q_sb, long long q_st, long long q_sh,
                  long long k_sb, long long k_st, long long k_sh,
                  long long v_sb, long long v_st, long long v_sh,
                  long long o_sb, long long o_st, long long o_sh,
                  float scale, int causal, int kv_len, int dtype,
                  void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  if (Tk <= 0 || kv_len < 0 || kv_len > Tk || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      return (int)dispatch_d<float>(D, q, k, v, o, l, B, H, Tq, Tk, st, scale,
                                    causal, kv_len, s);
    case 1:
      return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, o, l, B, H, Tq, Tk,
                                            st, scale, causal, kv_len, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mxt_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
