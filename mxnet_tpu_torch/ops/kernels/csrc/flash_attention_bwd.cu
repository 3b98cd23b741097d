// Flash-attention backward for Hopper (sm_90a), CUDA C++: the "simt"
// variant of the backward (two kernels, dQ and dK/dV, on the CUDA cores),
// which the wrapper takes for f32 inputs and for head_dim 16 or 32.  bf16 at
// head_dim 64 or 128 takes the tensor-core variant in
// flash_attention_bwd_wgmma.cu; the launchers here stay callable on those
// inputs, for timing the two variants in turns.
//
// Replaces the Pallas TPU kernels mxnet_tpu/ops/pallas/flash_attention.py
// `_dq_kernel` and `_dkv_kernel` (launched together by `_bwd`, the backward
// of the custom VJPs `_flash` and `_flash_lse`).  Semantics, kept exactly:
//
//   s     = (q . k^T) * scale                f32; masked where k_pos >= Tk
//                                            or (causal and q_pos < k_pos)
//   p     = exp(s - lse)                     recomputed in f32 (0 if masked)
//   dp    = dO . v^T                         dO and v upcast to f32
//   ds    = p * (dp - delta) * scale         delta = rowsum(dO*O) - dlse,
//                                            computed by the caller
//   dQ    = T(sum over key tiles of ds . k)
//   dK    = T(sum over query tiles of ds^T . q)
//   dV    = T(sum over query tiles of p^T . dO)
//
// The TPU split maps onto Hopper without atomics: the dQ kernel runs one
// CTA per (q tile of 64 rows, head, batch) and loops over key tiles; the
// dK/dV kernel runs one CTA per (key tile of 64, head, batch) and loops over
// query tiles.  Each loop takes the place of the TPU's sequential innermost
// grid axis and its VMEM accumulators; no CTA reads what another writes, so
// there is no cross-CTA reduction.  The price is recomputing p in both.
//
// Each CTA has 256 threads laid out 16 x 16; a thread owns 4 rows x 4
// columns of the 64 x 64 score tile and 4 rows x D/16 head dims of its
// accumulators.  The operands of the three (dQ) or four (dK/dV) tile
// products go through padded shared memory; the row operand of each product
// is read as a broadcast and the column operand conflict-free.  Inputs are
// read as [B, T, H, D] through their strides, outputs are written the same
// way.  Ragged tails are bounds-checked: query rows past Tq load as 0 and
// get p = 0, so they add nothing to dK and dV; key rows past Tk likewise.
// With causal Tq < Tk, key tiles that no query row may see run an empty loop
// and store their zero accumulators: every dK/dV row is written.  Tiles
// wholly on the far side of the causal diagonal are skipped (their p is 0).
//
// What bounds it on the card: operations.  dQ does 6*D and dK/dV 8*D flops
// per unmasked (q, k) pair against a few bytes per row, far above the
// ridge.  As the TPU kernel does, p, dO, V, K and Q stay f32 for the
// products, which this variant computes in f32 FMA on the CUDA cores: for
// f32 inputs the tensor cores have no operand that keeps them exact, and
// head_dim 16 or 32 is less than one 128-byte row of the swizzled tiles the
// tensor-core variant reads.
//
// Plain C interface (no PyTorch headers), called through ctypes.  Strides
// come in a host array of int64, read by the launcher before the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per CTA, laid out 16 x 16
constexpr int RPT = 4;        // tile rows per thread (64 / 16)
constexpr int CPT = 4;        // tile columns per thread (64 / 16)
constexpr int TP = 65;        // padded stride of a transposed [D][64] tile
constexpr int SP = 80;        // padded stride of a [64][64] score tile

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

// (batch, time, head) strides in elements of each [B, T, H, D] tensor
struct Strides {
  long long s[18];
};

// ---------------------------------------------------------------------------
// dQ: one CTA per (q tile, head, batch), loop over key tiles
// ---------------------------------------------------------------------------

template <int D>
struct DqLayout {
  static constexpr int q_off = 0;                    // Qs[r][d], stride D+1
  static constexpr int do_off = q_off + BQ * (D + 1);  // dOs[r][d]
  static constexpr int kt_off = do_off + BQ * (D + 1); // Kt[d][c], stride TP
  static constexpr int vt_off = kt_off + D * TP;       // Vt[d][c]
  static constexpr int ds_off = vt_off + D * TP;       // dS[r][c], stride SP
  static constexpr int floats = ds_off + BQ * SP;
  static constexpr size_t bytes = floats * sizeof(float);
};

// st: q (0-2), k (3-5), v (6-8), dO (9-11), dQ (12-14)
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int H,
                int Tq, int Tk, Strides st, float scale, int causal) {
  using L = DqLayout<D>;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem + L::q_off;
  float* dOs = smem + L::do_off;
  float* Kt = smem + L::kt_off;
  float* Vt = smem + L::vt_off;
  float* dS = smem + L::ds_off;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;

  const T* qb = q + b * st.s[0] + h * st.s[2];
  const T* kb = k + b * st.s[3] + h * st.s[5];
  const T* vb = v + b * st.s[6] + h * st.s[8];
  const T* dob = dout + b * st.s[9] + h * st.s[11];
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    const int qpos = q0 + r;
    const bool in = qpos < Tq;
    Qs[r * (D + 1) + d] = in ? to_f32(qb[qpos * st.s[1] + d]) : 0.f;
    dOs[r * (D + 1) + d] = in ? to_f32(dob[qpos * st.s[10] + d]) : 0.f;
  }
  float lse_r[RPT], delta_r[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty + 16 * i;
    lse_r[i] = qpos < Tq ? lb[qpos] : 0.f;
    delta_r[i] = qpos < Tq ? db[qpos] : 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done with Kt/Vt/dS
    for (int e = tid; e < BK * D; e += NT) {
      const int c = e / D, d = e % D;
      const int kpos = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (kpos < Tk) {
        kv = to_f32(kb[kpos * st.s[4] + d]);
        vv = to_f32(vb[kpos * st.s[7] + d]);
      }
      Kt[d * TP + c] = kv;
      Vt[d * TP + c] = vv;
    }
    __syncthreads();

    float sc[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
        ov[i] = dOs[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = Kt[d * TP + tx + 16 * j];
        vv[j] = Vt[d * TP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = qpos < Tq && kpos < Tk && (!causal || qpos >= kpos);
        const float p = ok ? expf(sc[i][j] * scale - lse_r[i]) : 0.f;
        dS[(ty + 16 * i) * SP + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dv[RPT], kv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dv[i] = dS[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kv[j] = Kt[(tx + 16 * j) * TP + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(dv[i], kv[j], acc[i][j]);
    }
  }

  T* dqb = dq + b * st.s[12] + h * st.s[14];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Tq) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      dqb[qpos * st.s[13] + tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one CTA per (key tile, head, batch), loop over query tiles
// ---------------------------------------------------------------------------

template <int D>
struct DkvLayout {
  static constexpr int k_off = 0;                      // Ks[c][d], stride D+1
  static constexpr int v_off = k_off + BK * (D + 1);   // Vs[c][d]
  static constexpr int qt_off = v_off + BK * (D + 1);  // Qt[d][r], stride TP
  static constexpr int dot_off = qt_off + D * TP;      // dOt[d][r]
  static constexpr int p_off = dot_off + D * TP;       // Ps[c][r], stride SP
  static constexpr int ds_off = p_off + BK * SP;       // dSs[c][r]
  static constexpr int lse_off = ds_off + BK * SP;     // lse_s[r]
  static constexpr int delta_off = lse_off + BQ;       // delta_s[r]
  static constexpr int floats = delta_off + BQ;
  static constexpr size_t bytes = floats * sizeof(float);
};

// st: q (0-2), k (3-5), v (6-8), dO (9-11), dK (12-14), dV (15-17)
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int Tq, int Tk, Strides st,
                 float scale, int causal) {
  using L = DkvLayout<D>;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem + L::k_off;
  float* Vs = smem + L::v_off;
  float* Qt = smem + L::qt_off;
  float* dOt = smem + L::dot_off;
  float* Ps = smem + L::p_off;
  float* dSs = smem + L::ds_off;
  float* lse_s = smem + L::lse_off;
  float* delta_s = smem + L::delta_off;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK;   // early key tiles see the most queries
  const int h = blockIdx.y, b = blockIdx.z;

  const T* qb = q + b * st.s[0] + h * st.s[2];
  const T* kb = k + b * st.s[3] + h * st.s[5];
  const T* vb = v + b * st.s[6] + h * st.s[8];
  const T* dob = dout + b * st.s[9] + h * st.s[11];
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;

  for (int e = tid; e < BK * D; e += NT) {
    const int c = e / D, d = e % D;
    const int kpos = k0 + c;
    const bool in = kpos < Tk;
    Ks[c * (D + 1) + d] = in ? to_f32(kb[kpos * st.s[4] + d]) : 0.f;
    Vs[c * (D + 1) + d] = in ? to_f32(vb[kpos * st.s[7] + d]) : 0.f;
  }
  float dk_acc[RPT][DPT], dv_acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: a query tile whose last row precedes k0 sees none of these keys
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;

  for (int q0 = q_begin; q0 < Tq; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done with Qt/dOt/Ps
    for (int e = tid; e < BQ * D; e += NT) {
      const int r = e / D, d = e % D;
      const int qpos = q0 + r;
      float qv = 0.f, ov = 0.f;
      if (qpos < Tq) {
        qv = to_f32(qb[qpos * st.s[1] + d]);
        ov = to_f32(dob[qpos * st.s[10] + d]);
      }
      Qt[d * TP + r] = qv;
      dOt[d * TP + r] = ov;
    }
    if (tid < BQ) {
      const int qpos = q0 + tid;
      lse_s[tid] = qpos < Tq ? lb[qpos] : 0.f;
      delta_s[tid] = qpos < Tq ? db[qpos] : 0.f;
    }
    __syncthreads();

    float sc[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[RPT], vv[RPT], qv[CPT], ov[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        kv[i] = Ks[(ty + 16 * i) * (D + 1) + d];
        vv[i] = Vs[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        qv[j] = Qt[d * TP + tx + 16 * j];
        ov[j] = dOt[d * TP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          sc[i][j] = fmaf(kv[i], qv[j], sc[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int kpos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = tx + 16 * j;
        const int qpos = q0 + r;
        const bool ok = qpos < Tq && kpos < Tk && (!causal || qpos >= kpos);
        const float p = ok ? expf(sc[i][j] * scale - lse_s[r]) : 0.f;
        Ps[(ty + 16 * i) * SP + r] = p;
        dSs[(ty + 16 * i) * SP + r] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[RPT], dsv[RPT], ov[DPT], qv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pv[i] = Ps[(ty + 16 * i) * SP + r];
        dsv[i] = dSs[(ty + 16 * i) * SP + r];
      }
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        ov[j] = dOt[(tx + 16 * j) * TP + r];
        qv[j] = Qt[(tx + 16 * j) * TP + r];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
    }
  }

  T* dkb = dk + b * st.s[12] + h * st.s[14];
  T* dvb = dv + b * st.s[15] + h * st.s[17];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= Tk) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dkb[kpos * st.s[13] + tx + 16 * j] = from_f32<T>(dk_acc[i][j]);
      dvb[kpos * st.s[16] + tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;  // dQ; or dK, dV
  int B, H, Tq, Tk;
  Strides st;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = DqLayout<D>::bytes;
  // above 48 KB of dynamic shared memory needs an explicit opt-in, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.H, a.B);
  flash_dq_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), a.H, a.Tq, a.Tk, a.st, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = DkvLayout<D>::bytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Tk + BK - 1) / BK, a.H, a.B);
  flash_dkv_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.H, a.Tq,
      a.Tk, a.st, a.scale, a.causal);
  return cudaGetLastError();
}

template <bool DKV, typename T>
cudaError_t dispatch_d(int D, const Args& a) {
  switch (D) {
    case 16: return DKV ? launch_dkv<T, 16>(a) : launch_dq<T, 16>(a);
    case 32: return DKV ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
    case 64: return DKV ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128: return DKV ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DKV>
int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* out0, void* out1, int B,
        int H, int Tq, int Tk, int D, const long long* strides, int n_str,
        float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return 0;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), out0, out1, B, H, Tq, Tk, {},
         scale, causal, static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < n_str; ++i) a.st.s[i] = strides[i];
  switch (dtype) {
    case 0: return (int)dispatch_d<DKV, float>(D, a);
    case 1: return (int)dispatch_d<DKV, __nv_bfloat16>(D, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, dout, dq: [B, Tq, H, D]; k, v: [B, Tk, H, D]; unit stride on D.
// strides: 15 int64, the (B, T, H) strides of q, k, v, dout, dq in that
// order.  lse, delta: f32 [B, H, Tq], contiguous.  dtype: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t (0 on success).
int mxt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int H, int Tq, int Tk, int D,
                     const long long* strides, float scale, int causal,
                     int dtype, void* stream) {
  return run<false>(q, k, v, dout, lse, delta, dq, nullptr, B, H, Tq, Tk, D,
                    strides, 15, scale, causal, dtype, stream);
}

// As above; dk, dv: [B, Tk, H, D].  strides: 18 int64, the (B, T, H)
// strides of q, k, v, dout, dk, dv in that order.
int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
                      const long long* strides, float scale, int causal,
                      int dtype, void* stream) {
  return run<true>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, D,
                   strides, 18, scale, causal, dtype, stream);
}

const char* mxt_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
