// Flash attention for head dims above 128 on Hopper (sm_90a), CUDA C++: the
// "wide" variant of the forward, dQ and dK/dV, on the CUDA cores.
//
// The wrapper (flash_attention.py, _variant) sends here, zero-padded along
// D to a multiple of 64 (zero columns add 0 to q.k^T and dO.v^T; `scale`
// stays 1/sqrt of the real head_dim), the f32 forward above head_dim 256,
// the f32 backward above 512 and bf16 above 512 both ways (at 129-256 bf16
// takes the tensor-core wgmma_wide kernels, flash_attention_wgmma_wide.cu
// and flash_attention_bwd_wgmma_wide.cu, and f32 the tensor-core tf32x3
// ones, flash_attention_tf32x3.cu and flash_attention_bwd_tf32x3.cu; bf16
// at 257-512 the tensor-core wgmma_xwide kernels,
// flash_attention_wgmma_xwide.cu and flash_attention_bwd_wgmma_xwide.cu;
// the f32 backward at 257-512 the tensor-core tf32x3_xwide kernels, in
// flash_attention_bwd_tf32x3.cu).  Neither the tensor-core kernels'
// shared-memory tiles nor the simt kernels' (which hold q, k and v whole
// along D) reach these widths.
//
// Replaces, for those head dims, the Pallas TPU kernels
// mxnet_tpu/ops/pallas/flash_attention.py `_fwd_kernel`, `_dq_kernel` and
// `_dkv_kernel`, whose block specs take D whole, and computes the same
// functions as the simt variant (flash_attention.cu,
// flash_attention_bwd.cu), with the same f32 arithmetic in the same order:
//
//   s   = (q . k^T) * scale          f32, summed over d = 0 .. D-1 in order
//   s   = -1e30 where (k_pos >= kv_len) or (causal and q_pos < k_pos)
//   forward: online softmax over key tiles with running (m, l, acc), p and
//   v in f32; o = T(acc / l) (0 where l == 0); lse = m + log(l) (f32)
//   backward: p = exp(s - lse), dp = dO . v^T, ds = p * (dp - delta) * scale;
//   dQ = T(ds . k), dK = T(ds^T . q), dV = T(p^T . dO)
//
// Design.  The f32 score tile is independent of D: every dot product over D
// (q.k^T, and dO.v^T in the backward) walks D in chunks of 64 through
// shared memory, accumulating into the same 4 x 4 scores per thread.  Each
// CTA owns at most 128 output columns (of o, of dQ, or of dK and dV): a
// grid axis runs over the ceil(D / 128) column chunks, and each chunk
// recomputes the scores.  So shared memory and registers are bounded for
// any D (about 86, 120 and 174 KB for the three kernels).  Every chunk
// computes m, l and p with the same arithmetic, so they agree bit for bit,
// and the forward's lse is written by chunk 0 alone.  No atomics: no CTA
// reads what another writes, so the backward stays deterministic.
//
// Otherwise the kernels follow the simt variant: CTAs of 256 threads laid
// out 16 x 16, 64 query rows and 64 keys per tile, each thread owning 4 x 4
// scores and 4 rows x (columns / 16) of its accumulators; inputs read as
// [B, T, H, D] through their strides; ragged tails bounds-checked; tiles
// wholly past the causal diagonal skipped; heavy (late) query tiles first.
//
// What bounds it on the card: operations (4*D flops a (q, k) pair forward,
// 6*D and 8*D in dQ and dK/dV), here on the CUDA cores in f32 FMA, each
// column chunk repeating the score work: far below the tensor-core bound.
//
// Plain C interface (no PyTorch headers), called through ctypes.  Strides
// come in a host array of int64, read by the launcher before the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per CTA, laid out 16 x 16
constexpr int RPT = 4;        // tile rows per thread
constexpr int CPT = 4;        // tile columns per thread
constexpr int DC = 64;        // head dims per chunk of a dot product over D
constexpr int OC = 128;       // output columns per CTA at most
constexpr int OPT = OC / 16;  // output columns per thread at most
constexpr int RS = DC + 1;    // padded stride of a [rows][DC] chunk
constexpr int TP = BK + 1;    // padded stride of a transposed [DC][64] chunk
constexpr int SP = BK + 16;   // padded stride of a [64][64] score tile
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

// (batch, time, head) strides in elements of each [B, T, H, D] tensor
struct Strides {
  long long s[18];
};

// rows x DC values of X (row r at row0 + r, columns d0 ..) as f32 into dst
// [r][RS] (kTransposed: dst[d][TP]); rows at or past `rows_end` load as 0
template <typename T, bool kTransposed>
__device__ __forceinline__ void load_chunk(float* dst, const T* X, int row0,
                                           int rows_end, long long st,
                                           int d0) {
  for (int e = threadIdx.x; e < 64 * DC; e += NT) {
    const int r = e / DC, d = e % DC;
    const int pos = row0 + r;
    const float x = pos < rows_end ? to_f32(X[pos * st + d0 + d]) : 0.f;
    if (kTransposed)
      dst[d * TP + r] = x;
    else
      dst[r * RS + d] = x;
  }
}

// 64 rows x nc columns (c0 ..) of X into dst [r][OC]
template <typename T>
__device__ __forceinline__ void load_cols(float* dst, const T* X, int row0,
                                          int rows_end, long long st, int c0,
                                          int nc) {
  for (int e = threadIdx.x; e < 64 * nc; e += NT) {
    const int r = e / nc, c = e % nc;
    const int pos = row0 + r;
    dst[r * OC + c] = pos < rows_end ? to_f32(X[pos * st + c0 + c]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// forward: one CTA per (q tile, head, batch x column chunk)
// ---------------------------------------------------------------------------

struct FwdLayout {
  static constexpr int q_off = 0;                  // Qc[r][RS]
  static constexpr int kt_off = q_off + BQ * RS;   // Kt[d][TP]
  static constexpr int v_off = kt_off + DC * TP;   // Vs[c][OC]
  static constexpr int p_off = v_off + BK * OC;    // Ps[r][SP]
  static constexpr int floats = p_off + BQ * SP;
  static constexpr size_t bytes = floats * sizeof(float);
};

// st: q (0-2), k (3-5), v (6-8), o (9-11)
template <typename T>
__global__ void __launch_bounds__(NT)
flash_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int H, int Tq, int Tk, int D,
                      int n_chunks, Strides st, float scale, int causal,
                      int kv_len) {
  using L = FwdLayout;
  extern __shared__ float smem[];
  float* Qc = smem + L::q_off;
  float* Kt = smem + L::kt_off;
  float* Vs = smem + L::v_off;
  float* Ps = smem + L::p_off;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_chunks, chunk = blockIdx.z % n_chunks;
  const int c0 = chunk * OC, nc = min(OC, D - c0);

  const T* qb = q + b * st.s[0] + h * st.s[2];
  const T* kb = k + b * st.s[3] + h * st.s[5];
  const T* vb = v + b * st.s[6] + h * st.s[8];

  float m[RPT], l[RPT], acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, Tq) - 1;
  const int k_end = causal ? min(kv_len, q_last + 1) : kv_len;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();  // the previous chunk's (tile's) readers are done
      load_chunk<T, false>(Qc, qb, q0, Tq, st.s[1], d0);
      load_chunk<T, true>(Kt, kb, k0, Tk, st.s[4], d0);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < DC; ++d) {
        float qv[RPT], kv[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) qv[i] = Qc[(ty + 16 * i) * RS + d];
#pragma unroll
        for (int j = 0; j < CPT; ++j) kv[j] = Kt[d * TP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
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
        Ps[(ty + 16 * i) * SP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OPT; ++j) acc[i][j] *= alpha;
    }
    load_cols<T>(Vs, vb, k0, Tk, st.s[7], c0, nc);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[OPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < OPT; ++j) vv[j] = Vs[c * OC + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < OPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + b * st.s[9] + h * st.s[11];
  float* lb = lse + ((long long)b * H + h) * Tq;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Tq) continue;
    // fully-masked rows (l == 0) emit 0, not nan
    const float safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < OPT; ++j)
      if (tx + 16 * j < nc)
        ob[qpos * st.s[10] + c0 + tx + 16 * j] = from_f32<T>(acc[i][j] / safe);
    if (tx == 0 && chunk == 0) lb[qpos] = m[i] + logf(safe);
  }
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (q tile, head, batch x column chunk), loop over key tiles
// ---------------------------------------------------------------------------

struct DqLayout {
  static constexpr int q_off = 0;                   // Qc[r][RS]
  static constexpr int do_off = q_off + BQ * RS;    // dOc[r][RS]
  static constexpr int kt_off = do_off + BQ * RS;   // Kt[d][TP]
  static constexpr int vt_off = kt_off + DC * TP;   // Vt[d][TP]
  static constexpr int ds_off = vt_off + DC * TP;   // dS[r][SP]
  static constexpr int kc_off = ds_off + BQ * SP;   // Kc[c][OC]
  static constexpr int floats = kc_off + BK * OC;
  static constexpr size_t bytes = floats * sizeof(float);
};

// st: q (0-2), k (3-5), v (6-8), dO (9-11), dQ (12-14)
template <typename T>
__global__ void __launch_bounds__(NT)
flash_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int H, int Tq, int Tk, int D, int n_chunks, Strides st,
                     float scale, int causal) {
  using L = DqLayout;
  extern __shared__ float smem[];
  float* Qc = smem + L::q_off;
  float* dOc = smem + L::do_off;
  float* Kt = smem + L::kt_off;
  float* Vt = smem + L::vt_off;
  float* dS = smem + L::ds_off;
  float* Kc = smem + L::kc_off;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_chunks, chunk = blockIdx.z % n_chunks;
  const int c0 = chunk * OC, nc = min(OC, D - c0);

  const T* qb = q + b * st.s[0] + h * st.s[2];
  const T* kb = k + b * st.s[3] + h * st.s[5];
  const T* vb = v + b * st.s[6] + h * st.s[8];
  const T* dob = dout + b * st.s[9] + h * st.s[11];
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;

  float lse_r[RPT], delta_r[RPT], acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty + 16 * i;
    lse_r[i] = qpos < Tq ? lb[qpos] : 0.f;
    delta_r[i] = qpos < Tq ? db[qpos] : 0.f;
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    float sc[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();  // the previous chunk's (tile's) readers are done
      load_chunk<T, false>(Qc, qb, q0, Tq, st.s[1], d0);
      load_chunk<T, false>(dOc, dob, q0, Tq, st.s[10], d0);
      load_chunk<T, true>(Kt, kb, k0, Tk, st.s[4], d0);
      load_chunk<T, true>(Vt, vb, k0, Tk, st.s[7], d0);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < DC; ++d) {
        float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          qv[i] = Qc[(ty + 16 * i) * RS + d];
          ov[i] = dOc[(ty + 16 * i) * RS + d];
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
    load_cols<T>(Kc, kb, k0, Tk, st.s[4], c0, nc);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dv[RPT], kv[OPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dv[i] = dS[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < OPT; ++j) kv[j] = Kc[c * OC + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < OPT; ++j) acc[i][j] = fmaf(dv[i], kv[j], acc[i][j]);
    }
  }

  T* dqb = dq + b * st.s[12] + h * st.s[14];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Tq) continue;
#pragma unroll
    for (int j = 0; j < OPT; ++j)
      if (tx + 16 * j < nc)
        dqb[qpos * st.s[13] + c0 + tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one CTA per (key tile, head, batch x column chunk), loop over
// query tiles
// ---------------------------------------------------------------------------

struct DkvLayout {
  static constexpr int k_off = 0;                    // Kc[c][RS]
  static constexpr int v_off = k_off + BK * RS;      // Vc[c][RS]
  static constexpr int qt_off = v_off + BK * RS;     // Qt[d][TP]
  static constexpr int dot_off = qt_off + DC * TP;   // dOt[d][TP]
  static constexpr int p_off = dot_off + DC * TP;    // Ps[c][SP]
  static constexpr int ds_off = p_off + BK * SP;     // dSs[c][SP]
  static constexpr int lse_off = ds_off + BK * SP;   // lse_s[r]
  static constexpr int delta_off = lse_off + BQ;     // delta_s[r]
  static constexpr int qo_off = delta_off + BQ;      // Qo[r][OC]
  static constexpr int doo_off = qo_off + BQ * OC;   // dOo[r][OC]
  static constexpr int floats = doo_off + BQ * OC;
  static constexpr size_t bytes = floats * sizeof(float);
};

// st: q (0-2), k (3-5), v (6-8), dO (9-11), dK (12-14), dV (15-17)
template <typename T>
__global__ void __launch_bounds__(NT)
flash_wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Tq, int Tk, int D,
                      int n_chunks, Strides st, float scale, int causal) {
  using L = DkvLayout;
  extern __shared__ float smem[];
  float* Kc = smem + L::k_off;
  float* Vc = smem + L::v_off;
  float* Qt = smem + L::qt_off;
  float* dOt = smem + L::dot_off;
  float* Ps = smem + L::p_off;
  float* dSs = smem + L::ds_off;
  float* lse_s = smem + L::lse_off;
  float* delta_s = smem + L::delta_off;
  float* Qo = smem + L::qo_off;
  float* dOo = smem + L::doo_off;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK;   // early key tiles see the most queries
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_chunks, chunk = blockIdx.z % n_chunks;
  const int c0 = chunk * OC, nc = min(OC, D - c0);

  const T* qb = q + b * st.s[0] + h * st.s[2];
  const T* kb = k + b * st.s[3] + h * st.s[5];
  const T* vb = v + b * st.s[6] + h * st.s[8];
  const T* dob = dout + b * st.s[9] + h * st.s[11];
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;

  float dk_acc[RPT][OPT], dv_acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < OPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: a query tile whose last row precedes k0 sees none of these keys
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;

  for (int q0 = q_begin; q0 < Tq; q0 += BQ) {
    float sc[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();  // the previous chunk's (tile's) readers are done
      load_chunk<T, false>(Kc, kb, k0, Tk, st.s[4], d0);
      load_chunk<T, false>(Vc, vb, k0, Tk, st.s[7], d0);
      load_chunk<T, true>(Qt, qb, q0, Tq, st.s[1], d0);
      load_chunk<T, true>(dOt, dob, q0, Tq, st.s[10], d0);
      if (d0 == 0 && tid < BQ) {
        const int qpos = q0 + tid;
        lse_s[tid] = qpos < Tq ? lb[qpos] : 0.f;
        delta_s[tid] = qpos < Tq ? db[qpos] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < DC; ++d) {
        float kv[RPT], vv[RPT], qv[CPT], ov[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          kv[i] = Kc[(ty + 16 * i) * RS + d];
          vv[i] = Vc[(ty + 16 * i) * RS + d];
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
    load_cols<T>(Qo, qb, q0, Tq, st.s[1], c0, nc);
    load_cols<T>(dOo, dob, q0, Tq, st.s[10], c0, nc);
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[RPT], dsv[RPT], ov[OPT], qv[OPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pv[i] = Ps[(ty + 16 * i) * SP + r];
        dsv[i] = dSs[(ty + 16 * i) * SP + r];
      }
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        ov[j] = dOo[r * OC + tx + 16 * j];
        qv[j] = Qo[r * OC + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < OPT; ++j) {
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
    for (int j = 0; j < OPT; ++j) {
      if (tx + 16 * j >= nc) continue;
      const int col = c0 + tx + 16 * j;
      dkb[kpos * st.s[13] + col] = from_f32<T>(dk_acc[i][j]);
      dvb[kpos * st.s[16] + col] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;  // o (and lse), dQ, or dK and dV
  float* lse_out;
  int B, H, Tq, Tk, D;
  Strides st;
  float scale;
  int causal, kv_len;
  cudaStream_t stream;
};

template <typename K>
cudaError_t opt_in(K kernel, size_t bytes) {
  // above 48 KB of dynamic shared memory needs an explicit opt-in
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <Kind kKind, typename T>
cudaError_t launch(const Args& a) {
  const int n_chunks = (a.D + OC - 1) / OC;
  const int tiles = ((kKind == kDkv ? a.Tk : a.Tq) + 63) / 64;
  const dim3 grid(tiles, a.H, a.B * n_chunks);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  if constexpr (kKind == kFwd) {
    static const cudaError_t attr =
        opt_in(flash_wide_fwd_kernel<T>, FwdLayout::bytes);
    if (attr != cudaSuccess) return attr;
    flash_wide_fwd_kernel<T><<<grid, NT, FwdLayout::bytes, a.stream>>>(
        q, k, v, static_cast<T*>(a.out0), a.lse_out, a.H, a.Tq, a.Tk, a.D,
        n_chunks, a.st, a.scale, a.causal, a.kv_len);
  } else if constexpr (kKind == kDq) {
    static const cudaError_t attr =
        opt_in(flash_wide_dq_kernel<T>, DqLayout::bytes);
    if (attr != cudaSuccess) return attr;
    flash_wide_dq_kernel<T><<<grid, NT, DqLayout::bytes, a.stream>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse, a.delta,
        static_cast<T*>(a.out0), a.H, a.Tq, a.Tk, a.D, n_chunks, a.st,
        a.scale, a.causal);
  } else {
    static const cudaError_t attr =
        opt_in(flash_wide_dkv_kernel<T>, DkvLayout::bytes);
    if (attr != cudaSuccess) return attr;
    flash_wide_dkv_kernel<T><<<grid, NT, DkvLayout::bytes, a.stream>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse, a.delta,
        static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.H, a.Tq, a.Tk,
        a.D, n_chunks, a.st, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <Kind kKind>
int run(Args& a, const long long* strides, int n_str, int dtype) {
  if (a.B <= 0 || a.H <= 0 || a.Tq <= 0) return 0;
  const long long chunks = (a.D + OC - 1) / OC;
  if (a.Tk <= 0 || a.D <= 0 || a.D % DC != 0 || a.H > 65535 ||
      a.B * chunks > 65535 || a.kv_len < 0 || a.kv_len > a.Tk)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_str; ++i) a.st.s[i] = strides[i];
  switch (dtype) {
    case 0: return (int)launch<kKind, float>(a);
    case 1: return (int)launch<kKind, __nv_bfloat16>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The forward.  q/o: [B, Tq, H, D]; k/v: [B, Tk, H, D]; unit stride on D,
// D a multiple of 64.  strides: 12 int64, the (B, T, H) strides of q, k, v,
// o in that order.  lse: f32 [B, H, Tq], contiguous.  Keys at and past
// kv_len are masked.  dtype: 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t (0 on success).
int mxt_flash_wide_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Tq, int Tk, int D,
                       const long long* strides, float scale, int causal,
                       int kv_len, int dtype, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr,
         static_cast<float*>(lse), B, H, Tq, Tk, D, {}, scale, causal,
         kv_len, static_cast<cudaStream_t>(stream)};
  return run<kFwd>(a, strides, 12, dtype);
}

// dQ.  As above, plus dout [B, Tq, H, D] and lse, delta f32 [B, H, Tq]
// contiguous; strides: 15 int64 (q, k, v, dout, dq).
int mxt_flash_wide_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int Tq, int Tk, int D,
                      const long long* strides, float scale, int causal,
                      int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr, nullptr, B, H, Tq,
         Tk, D, {}, scale, causal, Tk, static_cast<cudaStream_t>(stream)};
  return run<kDq>(a, strides, 15, dtype);
}

// dK and dV [B, Tk, H, D]; strides: 18 int64 (q, k, v, dout, dk, dv).
// Every row is written (rows no query sees are 0).
int mxt_flash_wide_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
                       const long long* strides, float scale, int causal,
                       int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dk, dv, nullptr, B, H, Tq, Tk, D,
         {}, scale, causal, Tk, static_cast<cudaStream_t>(stream)};
  return run<kDkv>(a, strides, 18, dtype);
}

const char* mxt_flash_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
