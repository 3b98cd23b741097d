// Flash-attention backward on Hopper's tensor cores (sm_90a), CUDA C++: the
// "wgmma" variant of the backward, for bf16 inputs with head_dim 64 or 128.
//
// Replaces the Pallas TPU kernels mxnet_tpu/ops/pallas/flash_attention.py
// `_dq_kernel` and `_dkv_kernel` (launched together by `_bwd`, the backward
// of the custom VJPs `_flash` and `_flash_lse`) and computes the same
// function as the CUDA-core variant in flash_attention_bwd.cu:
//
//   s   = (q . k^T) * scale          f32; masked where k_pos >= Tk or
//                                    (causal and q_pos < k_pos)
//   p   = exp(s - lse)               f32, 0 where masked and in rows past Tq
//   dp  = dO . v^T                   f32
//   ds  = p * (dp - delta) * scale   delta = rowsum(dO*O) - dlse, computed
//                                    by the caller
//   dQ  = T(sum over keys of ds . k), dK = T(sum over queries of ds^T . q),
//   dV  = T(sum over queries of p^T . dO), each rounded once to bf16
//
// What bounds it on the card: operations.  dQ does 6*D and dK/dV 8*D flops
// per unmasked (q, k) pair against a few bytes per row, far above the
// ridge; on Hopper the full tensor-core rate is reached only through wgmma.
//
// Design.  The TPU's split fits Hopper without atomics: two kernels, each
// CTA owning 128 rows of its output (two consumer warpgroups of 64) and
// looping over the other side's rows in tiles of 64.  No CTA reads what
// another writes, so the result is deterministic: two calls on the same
// inputs give the same bits.
//
// * dQ: one CTA per (128 query rows, head, batch), heavy causal tiles
//   first.  Q and dO are loaded once; K and V tiles of 64 keys stream
//   through a ring, up to the causal diagonal.  Per tile and warpgroup:
//   S = Q.K^T and dP = dO.V^T (both operands K-major in shared memory),
//   p and ds in registers, dQ += ds_hi.K + ds_lo.K with A from registers
//   (the S accumulator's layout) and K read MN-major.  lse and delta of the
//   thread's two rows are loaded once.  The dQ product is left in flight:
//   the next tile's S and dP queue behind it on the tensor cores, and its
//   K/V slot is released when they are waited for.
// * dK/dV: one CTA per (128 keys, head, batch).  K and V are loaded once;
//   Q and dO tiles of 64 queries, with their lse and delta (64 floats each,
//   bulk copies), stream through a ring from the causal diagonal to Tq.
//   Per tile and warpgroup: S^T = K.Q^T; p^T; dV += p^T_hi.dO + p^T_lo.dO;
//   dP^T = V.dO^T into S^T's registers; ds^T = (p_hi + p_lo) * (dP^T -
//   delta) * scale; dK += ds^T_hi.Q + ds^T_lo.Q (A from registers, dO and Q
//   read MN-major).  Issuing the dV product before dP^T lets dP^T reuse
//   S^T's registers and p live on only as its bf16 halves: at D = 128 the
//   dK and dV accumulators alone take 128 registers a thread.  The dK
//   product is left in flight behind the next tile's S^T, as dQ's.  Key tiles
//   that no query sees (causal, Tq < Tk) store their zero accumulators:
//   every dK/dV row is written.
// * Products: every product runs on wgmma with f32 accumulation.  The
//   bf16 x bf16 products S and dP are exact in f32, the TPU's
//   preferred_element_type=f32 with v and dO upcast.  The f32 operands p
//   and ds are split into hi = bf16(x) and lo = bf16(x - hi) and each
//   product with them is issued twice, so that they keep f32 accuracy
//   (about 2^-17, where one bf16 leaves 2^-9): 8*D tensor-core flops per
//   pair for dQ and 12*D for dK/dV, where the bound counts 6*D and 8*D.
//   `scale` multiplies dQ and dK once, at the store, not every ds.
// * Copies are TMA loads (4-d maps over [B, T, H, D] through the tensors'
//   strides, so the q/k/v views of a fused qkv product need no copy) into
//   128-byte-swizzled panels of [rows][64] bf16, with a full and an empty
//   mbarrier per ring slot; one thread of a producer warpgroup issues them
//   (setmaxnreg 40), the two consumer warpgroups compute (setmaxnreg 232).
//   Rows past the end of a tensor are filled with zeros by the TMA unit.
//
// Host side: tensor maps are built per launch (hopper.cuh).  Preconditions,
// checked by the Python wrapper: bf16, D in {64, 128}, unit stride on D,
// 16-byte-aligned base addresses and (B, T, H) strides that are multiples
// of 8 elements for q, k, v and dO; lse and delta f32 [B, H, tq_pad] with
// tq_pad a multiple of 64 (zeros past Tq).  Outputs [B, T, H, D] through
// their strides.
//
// Plain C interface (no PyTorch headers), called through ctypes.

#include "hopper.cuh"

namespace {

constexpr int BR = 128;       // output rows per CTA: two warpgroups of 64
constexpr int BT = 64;        // rows of a streamed tile
constexpr int STAGES = 2;     // ring slots (three were slower for dK/dV)
constexpr int NCONS = 256;    // consumer threads (warpgroups 0 and 1)
constexpr int NT = NCONS + 128;  // and the producer warpgroup
// 128 x 40 + 256 x 232 = 64512 of the SM's 65536 registers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int NS = BT / 2;    // registers of a 64 x BT f32 accumulator
constexpr int KS = BT / 16;   // k-steps over a tile's BT rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kErrPad = 100003;   // tq_pad not a multiple of BT or < Tq

// Byte offsets in the (1024-aligned) dynamic shared memory: two resident
// tensors of BR rows (dQ: Q, dO; dK/dV: K, V), a ring of STAGES slots of
// two streamed tiles of BT rows (dQ: K, V; dK/dV: Q, dO) and, for dK/dV,
// the streamed tile's lse and delta; then the barriers full_res,
// full[STAGES], empty[STAGES].  Every tile is D / 64 panels of [rows][64]
// bf16, swizzled by the TMA unit in 1024-byte atoms of 8 rows.
template <int D>
struct Smem {
  static constexpr uint32_t kResBytes = BR * D * 2;
  static constexpr uint32_t kTileBytes = BT * D * 2;
  static constexpr uint32_t kRowBytes = BT * 4;
  static constexpr uint32_t res0 = 0;
  static constexpr uint32_t res1 = kResBytes;
  static constexpr uint32_t ring0 = 2 * kResBytes;
  static constexpr uint32_t ring1 = ring0 + STAGES * kTileBytes;
  static constexpr uint32_t lse = ring1 + STAGES * kTileBytes;
  static constexpr uint32_t delta = lse + STAGES * kRowBytes;
  static constexpr uint32_t bars = delta + STAGES * kRowBytes;
  static constexpr size_t alloc = bars + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) {
  return bars + 8 * (1 + s);
}
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) {
  return bars + 8 * (1 + STAGES + s);
}

// The producer thread: the two resident tensors (rows r_row0..+BR), then
// n_tiles streamed tile pairs (rows t_row0 + j * BT) with, when lse_row is
// given, their lse and delta.
template <int D>
__device__ __forceinline__ void produce(
    const CUtensorMap* tm_r0, const CUtensorMap* tm_r1,
    const CUtensorMap* tm_t0, const CUtensorMap* tm_t1, uint32_t base,
    int r_row0, int t_row0, int h, int b, int n_tiles,
    const float* lse_row, const float* delta_row) {
  using L = Smem<D>;
  const uint32_t bars = base + L::bars;   // bars itself is full_res
  mbar_expect_tx(bars, 2 * L::kResBytes);
#pragma unroll
  for (int p = 0; p < D / PANEL; ++p) {
    tma_load(base + L::res0 + p * BR * 128, tm_r0, bars, p * PANEL, h, r_row0,
             b);
    tma_load(base + L::res1 + p * BR * 128, tm_r1, bars, p * PANEL, h, r_row0,
             b);
  }
  const uint32_t bytes =
      2 * L::kTileBytes + (lse_row != nullptr ? 2 * L::kRowBytes : 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int t = t_row0 + j * BT;
    // slot s last held tile j - STAGES: wait for both warpgroups' release
    if (j >= STAGES) mbar_wait(bar_empty(bars, s), ((j / STAGES) - 1) & 1);
    const uint32_t full = bar_full(bars, s);
    mbar_expect_tx(full, bytes);
#pragma unroll
    for (int p = 0; p < D / PANEL; ++p) {
      tma_load(base + L::ring0 + s * L::kTileBytes + p * BT * 128, tm_t0,
               full, p * PANEL, h, t, b);
      tma_load(base + L::ring1 + s * L::kTileBytes + p * BT * 128, tm_t1,
               full, p * PANEL, h, t, b);
    }
    if (lse_row != nullptr) {
      bulk_load(base + L::lse + s * L::kRowBytes, lse_row + t, L::kRowBytes,
                full);
      bulk_load(base + L::delta + s * L::kRowBytes, delta_row + t,
                L::kRowBytes, full);
    }
  }
}

// d = A.B^T over the D head dims, one committed group: A the warpgroup's 64
// rows of a resident tensor (panels of BR rows), B a streamed tile of BT
// rows, both K-major.
template <int D>
__device__ __forceinline__ void issue_ss(float (&d)[NS], uint32_t a,
                                         uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 head dims = 32 bytes inside a 128-byte swizzled row; every 4
    // k-steps the next 64-column panel
    const uint64_t da =
        desc_sw128(a + (kk >> 2) * (BR * 128) + (kk & 3) * 32, 16, 1024);
    const uint64_t db =
        desc_sw128(bt + (kk >> 2) * (BT * 128) + (kk & 3) * 32, 16, 1024);
    if (kk == 0)
      wgmma_ss_n64_first(d, da, db);
    else
      wgmma_ss_n64(d, da, db);
  }
  wgmma_commit();
}

// d += x_hi.B + x_lo.B over a streamed tile's BT rows, one committed group:
// x from registers, B the tile read MN-major (16 rows of 128 bytes per
// k-step; the leading offset steps from one 64-column panel to the next).
template <int D>
__device__ __forceinline__ void issue_rs(float (&d)[D / 2],
                                         const uint32_t (&hi)[KS][4],
                                         const uint32_t (&lo)[KS][4],
                                         uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t db = desc_sw128(bt + kk * 16 * 128, BT * 128, 1024);
    wgmma_rs<D>(d, hi[kk], db);
    wgmma_rs<D>(d, lo[kk], db);
  }
  wgmma_commit();
}

// Rows r0 and r0 + 8 of a 64 x D accumulator times `mul`, rounded to
// bf16, into out[row] (rows at and past n_rows are not written).
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float mul, __nv_bfloat16* out,
                                           int r0, int n_rows, long long st,
                                           int cq) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + cq;
    if (r0 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + r0 * st + col) =
          __floats2bfloat162_rn(acc[4 * n] * mul, acc[4 * n + 1] * mul);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (r0 + 8) * st + col) =
          __floats2bfloat162_rn(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
  }
}

// A dQ consumer warpgroup: 64 query rows.  S[i] and dP[i] are row r0 if
// (i & 2) == 0 else r0 + 8, key k0 + (i >> 2) * 8 + cq + (i & 1).  The
// tile's dQ product is left in flight: the next tile's S and dP queue
// behind it, and its ring slot is released once they are in.  ds is
// accumulated without `scale`, which multiplies dQ once at the store.
template <int D>
__device__ __forceinline__ void consume_dq(
    uint32_t base, int q0, int n_tiles, const float* __restrict__ lse_row,
    const float* __restrict__ delta_row, __nv_bfloat16* __restrict__ dq,
    long long dq_st, int Tq, int Tk, float scale, int causal) {
  using L = Smem<D>;
  const uint32_t bars = base + L::bars;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int wg_row0 = q0 + wg * 64;
  const int r0 = wg_row0 + warp * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = (lane & 3) * 2;
  const uint32_t q_wg = base + L::res0 + wg * 64 * 128;
  const uint32_t do_wg = base + L::res1 + wg * 64 * 128;
  // rows past Tq: p is not masked there, but dO is 0 and delta 0, so ds
  // is 0, and their dQ is never stored
  const float nl0 = r0 < Tq ? -lse_row[r0] * kLog2e : 0.f;
  const float nl1 = r1 < Tq ? -lse_row[r1] * kLog2e : 0.f;
  const float dl0 = r0 < Tq ? delta_row[r0] : 0.f;
  const float dl1 = r1 < Tq ? delta_row[r1] : 0.f;
  const float f = scale * kLog2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float S[NS], dP[NS];
  uint32_t hi[KS][4], lo[KS][4];
  int held = -1;        // the ring slot the dQ product in flight reads
  mbar_wait(bars, 0);   // Q, dO

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int k0 = j * BT;
    mbar_wait(bar_full(bars, s), (j / STAGES) & 1);
    if (causal && k0 > wg_row0 + 63) {   // no key of the tile is visible
      mbar_arrive(bar_empty(bars, s));
      continue;
    }
    const uint32_t kt = base + L::ring0 + s * L::kTileBytes;
    const uint32_t vt = base + L::ring1 + s * L::kTileBytes;
    wgmma_fence();
    issue_ss<D>(S, q_wg, kt);
    issue_ss<D>(dP, do_wg, vt);
    wgmma_wait<1>();             // the previous tile's dQ product, and S
    pin(S);
    pin(acc);
    pin(hi);
    pin(lo);
    if (held >= 0) mbar_arrive(bar_empty(bars, held));
    const bool masked = k0 + BT > Tk || (causal && k0 + BT - 1 > wg_row0);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float p = ex2(fmaf(S[i], f, (i & 2) ? nl1 : nl0));
      if (masked) {
        const int kpos = k0 + (i >> 2) * 8 + cq + (i & 1);
        const int qpos = (i & 2) ? r1 : r0;
        if (kpos >= Tk || (causal && qpos < kpos)) p = 0.f;
      }
      S[i] = p;
    }
    wgmma_wait<0>();                      // dP too
    pin(dP);
#pragma unroll
    for (int i = 0; i < NS; ++i) S[i] *= dP[i] - ((i & 2) ? dl1 : dl0);
    split_hi_lo(S, hi, lo);
    pin(acc);
    pin(hi);
    pin(lo);
    wgmma_fence();
    issue_rs<D>(acc, hi, lo, kt);
    held = s;
  }
  wgmma_wait<0>();
  pin(acc);
  pin(hi);
  pin(lo);
  if (held >= 0) mbar_arrive(bar_empty(bars, held));
  store_rows<D>(acc, scale, dq, r0, Tq, dq_st, cq);
}

// A dK/dV consumer warpgroup: 64 keys.  S[i] is key row r0 if (i & 2) ==
// 0 else r0 + 8, query qt + (i >> 2) * 8 + cq + (i & 1).  As in dQ, the
// tile's dK product is left in flight behind the next tile's S^T, and ds
// is accumulated without `scale`.
template <int D>
__device__ __forceinline__ void consume_dkv(
    uint32_t base, const unsigned char* smem, int k0, int q_start,
    int n_tiles, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, long long dk_st, long long dv_st, int Tq,
    int Tk, float scale, int causal) {
  using L = Smem<D>;
  const uint32_t bars = base + L::bars;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int wg_k0 = k0 + wg * 64;
  const int r0 = wg_k0 + warp * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = (lane & 3) * 2;
  const uint32_t k_wg = base + L::res0 + wg * 64 * 128;
  const uint32_t v_wg = base + L::res1 + wg * 64 * 128;
  const float f = scale * kLog2e;

  float dK[D / 2], dV[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dK[i] = 0.f;
    dV[i] = 0.f;
  }
  float S[NS];
  uint32_t hi[KS][4], lo[KS][4];
  int held = -1;        // the ring slot the dK product in flight reads
  mbar_wait(bars, 0);   // K, V

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int qt = q_start + j * BT;
    mbar_wait(bar_full(bars, s), (j / STAGES) & 1);
    if (causal && qt + BT - 1 < wg_k0) {   // no query of the tile sees a key
      mbar_arrive(bar_empty(bars, s));
      continue;
    }
    const uint32_t q_t = base + L::ring0 + s * L::kTileBytes;
    const uint32_t do_t = base + L::ring1 + s * L::kTileBytes;
    const float2* lse_t =
        reinterpret_cast<const float2*>(smem + L::lse + s * L::kRowBytes);
    const float2* delta_t =
        reinterpret_cast<const float2*>(smem + L::delta + s * L::kRowBytes);
    wgmma_fence();
    issue_ss<D>(S, k_wg, q_t);
    wgmma_wait<0>();             // the previous tile's dK product, and S^T
    pin(S);
    pin(dK);
    pin(hi);
    pin(lo);
    if (held >= 0) mbar_arrive(bar_empty(bars, held));
    const bool masked = qt + BT > Tq || wg_k0 + 64 > Tk ||
                        (causal && qt < wg_k0 + 63);
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      const float2 l = lse_t[n * 4 + (cq >> 1)];
      const float nl[2] = {-l.x * kLog2e, -l.y * kLog2e};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        float p = ex2(fmaf(S[i], f, nl[e & 1]));
        if (masked) {
          const int qpos = qt + n * 8 + cq + (e & 1);
          const int kpos = (e & 2) ? r1 : r0;
          if (qpos >= Tq || kpos >= Tk || (causal && qpos < kpos)) p = 0.f;
        }
        S[i] = p;
      }
    }
    split_hi_lo(S, hi, lo);
    pin(dV);
    pin(hi);
    pin(lo);
    wgmma_fence();
    issue_rs<D>(dV, hi, lo, do_t);        // dV += p^T.dO
    issue_ss<D>(S, v_wg, do_t);           // dP^T = V.dO^T
    wgmma_wait<0>();
    pin(dV);
    pin(S);
    pin(hi);
    pin(lo);
    // ds^T / scale = p^T * (dP^T - delta), with p^T = p_hi + p_lo
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = (2 * kk + (r >> 1)) * 4 + (r & 1) * 2;
        const float2 dl = delta_t[(i >> 2) * 4 + (cq >> 1)];
        // a bf16 is the high half of the f32 with the same bits
        const uint32_t h2 = hi[kk][r], l2 = lo[kk][r];
        const float p0 = __uint_as_float(h2 << 16) + __uint_as_float(l2 << 16);
        const float p1 = __uint_as_float(h2 & 0xffff0000u) +
                         __uint_as_float(l2 & 0xffff0000u);
        S[i] = p0 * (S[i] - dl.x);
        S[i + 1] = p1 * (S[i + 1] - dl.y);
      }
    }
    split_hi_lo(S, hi, lo);
    pin(dK);
    pin(hi);
    pin(lo);
    wgmma_fence();
    issue_rs<D>(dK, hi, lo, q_t);         // dK += ds^T.Q
    held = s;
  }
  wgmma_wait<0>();
  pin(dK);
  pin(hi);
  pin(lo);
  if (held >= 0) mbar_arrive(bar_empty(bars, held));
  store_rows<D>(dK, scale, dk, r0, Tk, dk_st, cq);
  store_rows<D>(dV, 1.f, dv, r0, Tk, dv_st, cq);
}

__device__ __forceinline__ void init_bars(uint32_t bars) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(bars, s), 1);
      mbar_init(bar_empty(bars, s), NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int H, int Tq, int Tk,
                      int tq_pad, long long dq_sb, long long dq_st,
                      long long dq_sh, float scale, int causal) {
  using L = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_last = min(q0 + BR, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  const int n_tiles = (k_end + BT - 1) / BT;
  init_bars(base + L::bars);

  // one if/else for the two roles, never reconverging, so that ptxas
  // applies each setmaxnreg to its whole branch
  if (threadIdx.x >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == NCONS)
      produce<D>(&tm_q, &tm_do, &tm_k, &tm_v, base, q0, 0, h, b, n_tiles,
                 nullptr, nullptr);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const long long row = ((long long)b * H + h) * tq_pad;
    consume_dq<D>(base, q0, n_tiles, lse + row, delta + row,
                  dq + b * dq_sb + h * dq_sh, dq_st, Tq, Tk, scale, causal);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int H, int Tq, int Tk,
                       int tq_pad, long long dk_sb, long long dk_st,
                       long long dk_sh, long long dv_sb, long long dv_st,
                       long long dv_sh, float scale, int causal) {
  using L = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;

  const int k0 = blockIdx.x * BR;        // early keys (more queries) first
  const int h = blockIdx.y, b = blockIdx.z;
  // under the causal mask no query before k0 sees a key of this CTA
  const int q_start = causal ? k0 : 0;
  const int n_tiles = q_start < Tq ? (Tq - q_start + BT - 1) / BT : 0;
  init_bars(base + L::bars);

  if (threadIdx.x >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == NCONS) {
      const long long row = ((long long)b * H + h) * tq_pad;
      produce<D>(&tm_k, &tm_v, &tm_q, &tm_do, base, k0, q_start, h, b,
                 n_tiles, lse + row, delta + row);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume_dkv<D>(base, smem_raw + (base - raw), k0, q_start, n_tiles,
                   dk + b * dk_sb + h * dk_sh, dv + b * dv_sb + h * dv_sh,
                   dk_st, dv_st, Tq, Tk, scale, causal);
  }
}

// The maps of q, k, v and dO (element strides st[0..11]); resident tensors
// are read in boxes of BR rows, streamed ones in boxes of BT.
template <int D>
int make_maps(CUtensorMap (&m)[4], const void* q, const void* k,
              const void* v, const void* dout, int B, int H, int Tq, int Tk,
              const long long* st, bool queries_resident) {
  const int rq = queries_resident ? BR : BT, rk = queries_resident ? BT : BR;
  int rc = make_map(&m[0], q, B, Tq, H, D, st[0], st[1], st[2], rq);
  if (rc == 0) rc = make_map(&m[1], k, B, Tk, H, D, st[3], st[4], st[5], rk);
  if (rc == 0) rc = make_map(&m[2], v, B, Tk, H, D, st[6], st[7], st[8], rk);
  if (rc == 0)
    rc = make_map(&m[3], dout, B, Tq, H, D, st[9], st[10], st[11], rq);
  return rc;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int Tq, int Tk, int tq_pad, const long long* st, float scale,
              int causal, cudaStream_t stream) {
  constexpr size_t smem = Smem<D>::alloc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap m[4];
  const int rc = make_maps<D>(m, q, k, v, dout, B, H, Tq, Tk, st, true);
  if (rc != 0) return rc;
  const dim3 grid((Tq + BR - 1) / BR, H, B);
  flash_dq_wgmma_kernel<D><<<grid, NT, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dq), H,
      Tq, Tk, tq_pad, st[12], st[13], st[14], scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int Tq, int Tk, int tq_pad, const long long* st,
               float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = Smem<D>::alloc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dkv_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap m[4];
  const int rc = make_maps<D>(m, q, k, v, dout, B, H, Tq, Tk, st, false);
  if (rc != 0) return rc;
  const dim3 grid((Tk + BR - 1) / BR, H, B);
  flash_dkv_wgmma_kernel<D><<<grid, NT, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Tq, Tk, tq_pad, st[12], st[13],
      st[14], st[15], st[16], st[17], scale, causal);
  return (int)cudaGetLastError();
}

int check_sizes(int B, int H, int Tq, int Tk, int tq_pad) {
  if (Tk <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (tq_pad < Tq || tq_pad % BT) return kErrPad;
  return 0;
}

}  // namespace

extern "C" {

// q/k/v/dO: bf16 [B, T, H, D] with unit stride on D, D 64 or 128; `st`
// holds the (B, T, H) element strides of q, k, v, dO and dq in that order
// (a size-1 axis may carry any multiple of 8).  Base addresses 16-byte
// aligned, strides multiples of 8 elements.  lse, delta: f32 [B, H,
// tq_pad], contiguous.  Returns 0 on success, else a cudaError_t or one of
// the codes above (see mxt_flash_bwd_wgmma_error_string).
int mxt_flash_bwd_wgmma_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int B, int H, int Tq,
                           int Tk, int D, int tq_pad, const long long* st,
                           float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  const int rc = check_sizes(B, H, Tq, Tk, tq_pad);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, dout, l, dl, dq, B, H, Tq, Tk, tq_pad, st,
                           scale, causal, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, l, dl, dq, B, H, Tq, Tk, tq_pad,
                            st, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As mxt_flash_bwd_wgmma_dq; `st` holds the strides of q, k, v, dO, dk and
// dv.  Every dK/dV row is written (rows no query sees get 0).
int mxt_flash_bwd_wgmma_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B,
                            int H, int Tq, int Tk, int D, int tq_pad,
                            const long long* st, float scale, int causal,
                            void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  const int rc = check_sizes(B, H, Tq, Tk, tq_pad);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (D) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk,
                            tq_pad, st, scale, causal, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk,
                             tq_pad, st, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mxt_flash_bwd_wgmma_error_string(int code) {
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a q/k/v/dO layout";
  if (code == kErrNoEntryPoint)
    return "the driver has no cuTensorMapEncodeTiled";
  if (code == kErrPad)
    return "lse/delta row length tq_pad is not a multiple of 64 >= Tq";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
