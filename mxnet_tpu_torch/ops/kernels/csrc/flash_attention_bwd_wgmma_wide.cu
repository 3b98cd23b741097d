// Flash-attention backward on Hopper's tensor cores (sm_90a), CUDA C++: the
// "wgmma_wide" variant of the backward, for bf16 inputs at head_dim 192 or
// 256 (the wrapper pads head_dim 129-256 to one of them).
//
// Replaces, at those widths, the Pallas TPU kernels
// mxnet_tpu/ops/pallas/flash_attention.py `_dq_kernel` and `_dkv_kernel`
// (launched together by `_bwd`), and computes the same function as the
// wgmma variant (flash_attention_bwd_wgmma.cu) at head_dim 64 and 128:
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
// per unmasked (q, k) pair against a few bytes per row; on Hopper the full
// tensor-core rate is reached only through wgmma.
//
// Why the wgmma variant's layout does not stretch to D = 256: there each
// CTA owns 128 output rows, 64 per consumer warpgroup, over all D columns.
// At D = 256 the dK and dV accumulators of one warpgroup would take 256
// registers a thread (the cap is 255), and dQ's resident Q and dO (64 KB
// each) beside its K/V ring (128 KB) would take 256 KB of shared memory (a
// block gets 227 KB).
//
// Design.  Each CTA owns 64 output rows, and its two consumer warpgroups
// split the output's columns: warpgroup 0 takes the first ceil(D / 128)
// 64-column panels, warpgroup 1 the rest (128 + 128 at D = 256, 128 + 64 at
// D = 192: both warpgroups issue to the same tensor cores, so the uneven
// split costs little).  The score-sized products, which run over all of D,
// are split along the streamed tile instead: each warpgroup computes them
// for 32 of the tile's 64 rows, once, and the two trade their halves of the
// f32 operand (p^T and ds^T, or ds) through shared memory, where the output
// products read it as a K-major A operand.  No CTA reads what another
// writes and there are no atomics, so two calls on the same inputs give the
// same bits.
//
// * dK/dV: one CTA per (64 keys, head, batch), early keys (more queries)
//   first.  K and V are loaded once; Q and dO tiles of 64 queries, with
//   their lse and delta (64 floats each, bulk copies), stream through a
//   ring from the causal diagonal to Tq.  Per tile, warpgroup w: S^T = K.Q^T
//   and dP^T = V.dO^T for queries 32w .. 32w + 31 (N = 32); p^T and ds^T =
//   p^T * (dP^T - delta) for them; both split into bf16 halves and stored
//   to the exchange; then dV += p^T.dO and dK += ds^T.Q over all 64 queries,
//   on its columns (dO and Q read MN-major).  Key tiles that no query sees
//   (causal, Tq < Tk) store their zero accumulators: every dK/dV row is
//   written.
// * dQ: one CTA per (64 query rows, head, batch), heavy causal tiles first.
//   Q and dO are loaded once; K and V tiles of 64 keys stream through the
//   ring up to the causal diagonal.  Per tile, warpgroup w: S = Q.K^T and dP
//   = dO.V^T for keys 32w .. 32w + 31; ds = p * (dP - delta); its bf16
//   halves to the exchange; dQ += ds.K over all 64 keys, on its columns (K
//   read MN-major).  lse and delta of the thread's two rows are loaded once.
// * Each tile's output products are left in flight: the next tile's score
//   products queue behind them on the tensor cores, and the ring slot they
//   read is released once those are waited for.  Two named barriers of the
//   256 consumer threads guard the exchange: one before it is written (both
//   warpgroups' previous output products are done), one after (both halves
//   are in; the writes are made visible to the tensor cores' reads by
//   fence.proxy.async first).
// * Products: every product runs on wgmma with f32 accumulation.  The bf16
//   x bf16 products S and dP are exact in f32.  The f32 operands p and ds
//   are split into hi = bf16(x) and lo = bf16(x - hi) and each product with
//   them is issued twice, so that they keep f32 accuracy (about 2^-17,
//   where one bf16 leaves 2^-9): 8*D tensor-core flops per pair for dQ and
//   12*D for dK/dV, where the bound counts 6*D and 8*D.  The column split
//   costs no recomputation: each score-sized product is computed once per
//   tile.  `scale` multiplies dQ and dK once, at the store.
// * Copies are TMA loads (4-d maps over [B, T, H, D] through the tensors'
//   strides, so the q/k/v views of a fused qkv product need no copy) into
//   128-byte-swizzled panels of [64 rows][64] bf16, with a full and an
//   empty mbarrier per ring slot; one thread of a producer warpgroup issues
//   them (setmaxnreg 40), the two consumer warpgroups compute (setmaxnreg
//   232).  Rows past the end of a tensor are filled with zeros by the TMA
//   unit.  Shared memory at D = 256: dK/dV 64 KB resident, 128 KB of ring,
//   32 KB of exchange and 1 KB of lse/delta; dQ 64 + 128 + 16 KB.
//
// Head dims above 256 stay on the CUDA-core `wide` variant: a third panel
// per warpgroup would put the dK and dV accumulators at 192 registers.
//
// Host side: tensor maps are built per launch (hopper.cuh).  Preconditions,
// checked by the Python wrapper: bf16, D in {192, 256}, unit stride on D,
// 16-byte-aligned base addresses and (B, T, H) strides that are multiples
// of 8 elements for q, k, v and dO; lse and delta f32 [B, H, tq_pad] with
// tq_pad a multiple of 64 (zeros past Tq).  Outputs [B, T, H, D] through
// their strides.
//
// Plain C interface (no PyTorch headers), called through ctypes.

#include "hopper.cuh"

namespace {

constexpr int BR = 64;        // output rows per CTA
constexpr int BT = 64;        // rows of a streamed tile
constexpr int HALF = BT / 2;  // streamed rows whose scores a warpgroup computes
constexpr int STAGES = 2;     // ring slots
constexpr int NCONS = 256;    // consumer threads (warpgroups 0 and 1)
constexpr int NT = NCONS + 128;  // and the producer warpgroup
// 128 x 40 + 256 x 232 = 64512 of the SM's 65536 registers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int NS = HALF / 2;  // registers of a 64 x HALF f32 accumulator
constexpr int KS = BT / 16;   // k-steps over a tile's BT rows
constexpr uint32_t kXBytes = BR * BT * 2;   // one bf16 [64][64] exchange tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kErrPad = 100003;   // tq_pad not a multiple of BT or < Tq

// The columns of warpgroup 0 (whole 64-column panels, the larger share)
// and of warpgroup 1.
template <int D>
struct Cols {
  static constexpr int c0 = (D / PANEL + 1) / 2 * PANEL;
  static constexpr int c1 = D - c0;
};

// Byte offsets in the (1024-aligned) dynamic shared memory: two resident
// tensors of BR rows (dQ: Q, dO; dK/dV: K, V), a ring of STAGES slots of
// two streamed tiles of BT rows (dQ: K, V; dK/dV: Q, dO), the exchange
// (NX bf16 [64][64] tiles: dQ's ds hi/lo; dK/dV's p^T hi/lo and ds^T
// hi/lo) and, for dK/dV, the streamed tile's lse and delta; then the
// barriers full_res, full[STAGES], empty[STAGES].  Every tensor tile is D /
// 64 panels of [rows][64] bf16, swizzled by the TMA unit in 1024-byte atoms
// of 8 rows; the exchange tiles are written with the same swizzle.
template <int D, int NX>
struct Smem {
  static constexpr uint32_t kResBytes = BR * D * 2;
  static constexpr uint32_t kTileBytes = BT * D * 2;
  static constexpr uint32_t kRowBytes = BT * 4;
  static constexpr uint32_t res0 = 0;
  static constexpr uint32_t res1 = kResBytes;
  static constexpr uint32_t ring0 = 2 * kResBytes;
  static constexpr uint32_t ring1 = ring0 + STAGES * kTileBytes;
  static constexpr uint32_t xch = ring1 + STAGES * kTileBytes;
  static constexpr uint32_t lse = xch + NX * kXBytes;
  static constexpr uint32_t delta = lse + STAGES * kRowBytes;
  static constexpr uint32_t bars = delta + STAGES * kRowBytes;
  static constexpr size_t alloc = bars + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(alloc <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) {
  return bars + 8 * (1 + s);
}
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) {
  return bars + 8 * (1 + STAGES + s);
}

// The 256 consumer threads meet at named barrier `id` (1 or 2; 0 is
// __syncthreads).
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(NCONS) : "memory");
}

// This thread's shared-memory writes, visible to the tensor cores' reads
// (the async proxy) after the next barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// The producer thread: the two resident tensors (rows r_row0..+BR), then
// n_tiles streamed tile pairs (rows t_row0 + j * BT) with, when lse_row is
// given, their lse and delta.
template <int D, int NX>
__device__ __forceinline__ void produce(
    const CUtensorMap* tm_r0, const CUtensorMap* tm_r1,
    const CUtensorMap* tm_t0, const CUtensorMap* tm_t1, uint32_t base,
    int r_row0, int t_row0, int h, int b, int n_tiles,
    const float* lse_row, const float* delta_row) {
  using L = Smem<D, NX>;
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

// d = A.B^T over the D head dims, one committed group: A the 64 rows of a
// resident tensor, B 32 rows of a streamed tile (its address `bt` already
// at row 32w), both K-major.
template <int D>
__device__ __forceinline__ void issue_scores(float (&d)[NS], uint32_t a,
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
      wgmma_n32_first(d, da, db);
    else
      wgmma_n32(d, da, db);
  }
  wgmma_commit();
}

// d += x_hi.B + x_lo.B over a streamed tile's BT rows (not committed): x
// the exchange tiles at hi and hi + kXBytes, [64][BT] K-major; B the NC
// columns of a streamed tile from `bt` on, read MN-major (16 rows of 128
// bytes per k-step; the leading offset steps from one 64-column panel to
// the next).
template <int NC>
__device__ __forceinline__ void issue_out(float (&d)[NC / 2], uint32_t hi,
                                          uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t db = desc_sw128(bt + kk * 16 * 128, BT * 128, 1024);
    wgmma_tb<NC>(d, desc_sw128(hi + kk * 32, 16, 1024), db);
    wgmma_tb<NC>(d, desc_sw128(hi + kXBytes + kk * 32, 16, 1024), db);
  }
}

// A 64 x HALF accumulator x of warpgroup w (rows warp * 16 + lane / 4 and
// + 8, columns 32w + 8n + cq and + 1) -> hi = bf16(x) into the exchange
// tile at `hi`, lo = bf16(x - hi) into the one after it, as [64][BT] bf16
// with the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r & 7)).
// The difference is exact in f32: x_hi + x_lo carries x to about 2^-17.
__device__ __forceinline__ void stash(const float (&x)[NS], uint32_t hi,
                                      int wg, int warp, int lane) {
  const int row = warp * 16 + (lane >> 2);
  const uint32_t cb = (lane & 3) * 4;           // byte of the column pair
#pragma unroll
  for (int n = 0; n < NS / 4; ++n) {
    const uint32_t chunk = ((wg * (HALF / 8) + n) ^ (lane >> 2)) << 4;
#pragma unroll
    for (int e = 0; e < 2; ++e) {                // rows row and row + 8
      const uint32_t off = (row + 8 * e) * 128 + chunk + cb;
      const float a = x[4 * n + 2 * e], c = x[4 * n + 2 * e + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, c);
      const __nv_bfloat162 l =
          __floats2bfloat162_rn(a - __low2float(h), c - __high2float(h));
      st_shared(hi + off, bits(h));
      st_shared(hi + kXBytes + off, bits(l));
    }
  }
}

// Rows r0 and r0 + 8 of a 64 x NC accumulator times `mul`, rounded to
// bf16, into out[row] at columns from `out` on (rows at and past n_rows are
// not written).
template <int NC>
__device__ __forceinline__ void store_rows(const float (&acc)[NC / 2],
                                           float mul, __nv_bfloat16* out,
                                           int r0, int n_rows, long long st,
                                           int cq) {
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
    const int col = n * 8 + cq;
    if (r0 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + r0 * st + col) =
          __floats2bfloat162_rn(acc[4 * n] * mul, acc[4 * n + 1] * mul);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (r0 + 8) * st + col) =
          __floats2bfloat162_rn(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
  }
}

// A dQ consumer warpgroup: the CTA's 64 query rows, on NC columns from c0.
// S[i] and dP[i] are row r0 if (i & 2) == 0 else r0 + 8, key k0 + 32w +
// (i >> 2) * 8 + cq + (i & 1).  ds is accumulated without `scale`, which
// multiplies dQ once at the store.
template <int D, int NC>
__device__ __forceinline__ void consume_dq(
    uint32_t base, int q0, int n_tiles, int c0,
    const float* __restrict__ lse_row, const float* __restrict__ delta_row,
    __nv_bfloat16* __restrict__ dq, long long dq_st, int Tq, int Tk,
    float scale, int causal) {
  using L = Smem<D, 2>;
  const uint32_t bars = base + L::bars;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = q0 + warp * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = (lane & 3) * 2;
  const uint32_t q_res = base + L::res0;
  const uint32_t do_res = base + L::res1;
  const uint32_t xch = base + L::xch;
  // rows past Tq: p is not masked there, but dO is 0 and delta 0, so ds
  // is 0, and their dQ is never stored
  const float nl0 = r0 < Tq ? -lse_row[r0] * kLog2e : 0.f;
  const float nl1 = r1 < Tq ? -lse_row[r1] * kLog2e : 0.f;
  const float dl0 = r0 < Tq ? delta_row[r0] : 0.f;
  const float dl1 = r1 < Tq ? delta_row[r1] : 0.f;
  const float f = scale * kLog2e;

  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  float S[NS], dP[NS];
  int held = -1;        // the ring slot the dQ product in flight reads
  mbar_wait(bars, 0);   // Q, dO

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int k0 = j * BT;
    mbar_wait(bar_full(bars, s), (j / STAGES) & 1);
    const uint32_t kt = base + L::ring0 + s * L::kTileBytes;
    const uint32_t vt = base + L::ring1 + s * L::kTileBytes;
    wgmma_fence();
    issue_scores<D>(S, q_res, kt + wg * HALF * 128);
    issue_scores<D>(dP, do_res, vt + wg * HALF * 128);
    wgmma_wait<0>();       // the previous tile's dQ product, S and dP
    pin(S);
    pin(dP);
    pin(acc);
    if (held >= 0) mbar_arrive(bar_empty(bars, held));
    const int kw = k0 + wg * HALF;
    const bool masked = kw + HALF > Tk || (causal && kw + HALF - 1 > q0);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float p = ex2(fmaf(S[i], f, (i & 2) ? nl1 : nl0));
      if (masked) {
        const int kpos = kw + (i >> 2) * 8 + cq + (i & 1);
        const int qpos = (i & 2) ? r1 : r0;
        if (kpos >= Tk || (causal && qpos < kpos)) p = 0.f;
      }
      S[i] = p * (dP[i] - ((i & 2) ? dl1 : dl0));
    }
    consumers_sync(1);     // both warpgroups' previous dQ products are done
    stash(S, xch, wg, warp, lane);
    fence_async_smem();
    consumers_sync(2);     // both halves of ds are in
    pin(acc);
    wgmma_fence();
    issue_out<NC>(acc, xch, kt + (c0 / PANEL) * BT * 128);
    wgmma_commit();
    held = s;
  }
  wgmma_wait<0>();
  pin(acc);
  if (held >= 0) mbar_arrive(bar_empty(bars, held));
  store_rows<NC>(acc, scale, dq + c0, r0, Tq, dq_st, cq);
}

// A dK/dV consumer warpgroup: the CTA's 64 keys, on NC columns from c0.
// S[i] and dP[i] are key row r0 if (i & 2) == 0 else r0 + 8, query qt + 32w
// + (i >> 2) * 8 + cq + (i & 1).  As in dQ, ds is accumulated without
// `scale`.
template <int D, int NC>
__device__ __forceinline__ void consume_dkv(
    uint32_t base, const unsigned char* smem, int k0, int q_start,
    int n_tiles, int c0, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, long long dk_st, long long dv_st, int Tq,
    int Tk, float scale, int causal) {
  using L = Smem<D, 4>;
  const uint32_t bars = base + L::bars;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = k0 + warp * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = (lane & 3) * 2;
  const uint32_t k_res = base + L::res0;
  const uint32_t v_res = base + L::res1;
  const uint32_t xp = base + L::xch;              // p^T hi, lo
  const uint32_t xs = xp + 2 * kXBytes;           // ds^T hi, lo
  const float f = scale * kLog2e;

  float dK[NC / 2], dV[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) {
    dK[i] = 0.f;
    dV[i] = 0.f;
  }
  float S[NS], dP[NS];
  int held = -1;        // the ring slot the products in flight read
  mbar_wait(bars, 0);   // K, V

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int qt = q_start + j * BT;
    mbar_wait(bar_full(bars, s), (j / STAGES) & 1);
    const uint32_t q_t = base + L::ring0 + s * L::kTileBytes;
    const uint32_t do_t = base + L::ring1 + s * L::kTileBytes;
    const float2* lse_t =
        reinterpret_cast<const float2*>(smem + L::lse + s * L::kRowBytes);
    const float2* delta_t =
        reinterpret_cast<const float2*>(smem + L::delta + s * L::kRowBytes);
    wgmma_fence();
    issue_scores<D>(S, k_res, q_t + wg * HALF * 128);    // S^T = K.Q^T
    issue_scores<D>(dP, v_res, do_t + wg * HALF * 128);  // dP^T = V.dO^T
    wgmma_wait<0>();       // the previous tile's products, S^T and dP^T
    pin(S);
    pin(dP);
    pin(dK);
    pin(dV);
    if (held >= 0) mbar_arrive(bar_empty(bars, held));
    const int qw = qt + wg * HALF;
    const bool masked = qw + HALF > Tq || k0 + BR > Tk ||
                        (causal && qw < k0 + BR - 1);
#pragma unroll
    for (int n = 0; n < NS / 4; ++n) {
      const int c2 = wg * (HALF / 2) + n * 4 + (cq >> 1);   // column pair
      const float2 l = lse_t[c2];
      const float2 dl = delta_t[c2];
      const float nl[2] = {-l.x * kLog2e, -l.y * kLog2e};
      const float dd[2] = {dl.x, dl.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        float p = ex2(fmaf(S[i], f, nl[e & 1]));
        if (masked) {
          const int qpos = qw + n * 8 + cq + (e & 1);
          const int kpos = (e & 2) ? r1 : r0;
          if (qpos >= Tq || kpos >= Tk || (causal && qpos < kpos)) p = 0.f;
        }
        S[i] = p;
        dP[i] = p * (dP[i] - dd[e & 1]);
      }
    }
    consumers_sync(1);     // both warpgroups' previous products are done
    stash(S, xp, wg, warp, lane);
    stash(dP, xs, wg, warp, lane);
    fence_async_smem();
    consumers_sync(2);     // both halves of p^T and ds^T are in
    pin(dK);
    pin(dV);
    wgmma_fence();
    const uint32_t col = (c0 / PANEL) * BT * 128;
    issue_out<NC>(dV, xp, do_t + col);     // dV += p^T.dO
    issue_out<NC>(dK, xs, q_t + col);      // dK += ds^T.Q
    wgmma_commit();
    held = s;
  }
  wgmma_wait<0>();
  pin(dK);
  pin(dV);
  if (held >= 0) mbar_arrive(bar_empty(bars, held));
  store_rows<NC>(dK, scale, dk + c0, r0, Tk, dk_st, cq);
  store_rows<NC>(dV, 1.f, dv + c0, r0, Tk, dv_st, cq);
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
flash_dq_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, int H, int Tq,
                           int Tk, int tq_pad, long long dq_sb,
                           long long dq_st, long long dq_sh, float scale,
                           int causal) {
  using L = Smem<D, 2>;
  using C = Cols<D>;
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
      produce<D, 2>(&tm_q, &tm_do, &tm_k, &tm_v, base, q0, 0, h, b, n_tiles,
                    nullptr, nullptr);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const long long row = ((long long)b * H + h) * tq_pad;
    __nv_bfloat16* out = dq + b * dq_sb + h * dq_sh;
    if (C::c0 == C::c1 || threadIdx.x < 128)
      consume_dq<D, C::c0>(base, q0, n_tiles, (threadIdx.x >> 7) * C::c0,
                           lse + row, delta + row, out, dq_st, Tq, Tk, scale,
                           causal);
    else
      consume_dq<D, C::c1>(base, q0, n_tiles, C::c0, lse + row, delta + row,
                           out, dq_st, Tq, Tk, scale, causal);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_dkv_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int H, int Tq,
                            int Tk, int tq_pad, long long dk_sb,
                            long long dk_st, long long dk_sh, long long dv_sb,
                            long long dv_st, long long dv_sh, float scale,
                            int causal) {
  using L = Smem<D, 4>;
  using C = Cols<D>;
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
      produce<D, 4>(&tm_k, &tm_v, &tm_q, &tm_do, base, k0, q_start, h, b,
                    n_tiles, lse + row, delta + row);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const unsigned char* smem = smem_raw + (base - raw);
    __nv_bfloat16* dk_h = dk + b * dk_sb + h * dk_sh;
    __nv_bfloat16* dv_h = dv + b * dv_sb + h * dv_sh;
    if (C::c0 == C::c1 || threadIdx.x < 128)
      consume_dkv<D, C::c0>(base, smem, k0, q_start, n_tiles,
                            (threadIdx.x >> 7) * C::c0, dk_h, dv_h, dk_st,
                            dv_st, Tq, Tk, scale, causal);
    else
      consume_dkv<D, C::c1>(base, smem, k0, q_start, n_tiles, C::c0, dk_h,
                            dv_h, dk_st, dv_st, Tq, Tk, scale, causal);
  }
}

// The maps of q, k, v and dO (element strides st[0..11]), all read in
// boxes of 64 rows.
template <int D>
int make_maps(CUtensorMap (&m)[4], const void* q, const void* k,
              const void* v, const void* dout, int B, int H, int Tq, int Tk,
              const long long* st) {
  int rc = make_map(&m[0], q, B, Tq, H, D, st[0], st[1], st[2], BT);
  if (rc == 0) rc = make_map(&m[1], k, B, Tk, H, D, st[3], st[4], st[5], BT);
  if (rc == 0) rc = make_map(&m[2], v, B, Tk, H, D, st[6], st[7], st[8], BT);
  if (rc == 0)
    rc = make_map(&m[3], dout, B, Tq, H, D, st[9], st[10], st[11], BT);
  return rc;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int Tq, int Tk, int tq_pad, const long long* st, float scale,
              int causal, cudaStream_t stream) {
  constexpr size_t smem = Smem<D, 2>::alloc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dq_wgmma_wide_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap m[4];
  const int rc = make_maps<D>(m, q, k, v, dout, B, H, Tq, Tk, st);
  if (rc != 0) return rc;
  const dim3 grid((Tq + BR - 1) / BR, H, B);
  flash_dq_wgmma_wide_kernel<D><<<grid, NT, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dq), H,
      Tq, Tk, tq_pad, st[12], st[13], st[14], scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int Tq, int Tk, int tq_pad, const long long* st,
               float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = Smem<D, 4>::alloc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dkv_wgmma_wide_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap m[4];
  const int rc = make_maps<D>(m, q, k, v, dout, B, H, Tq, Tk, st);
  if (rc != 0) return rc;
  const dim3 grid((Tk + BR - 1) / BR, H, B);
  flash_dkv_wgmma_wide_kernel<D><<<grid, NT, smem, stream>>>(
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

// q/k/v/dO: bf16 [B, T, H, D] with unit stride on D, D 192 or 256; `st`
// holds the (B, T, H) element strides of q, k, v, dO and dq in that order
// (a size-1 axis may carry any multiple of 8).  Base addresses 16-byte
// aligned, strides multiples of 8 elements.  lse, delta: f32 [B, H,
// tq_pad], contiguous.  Returns 0 on success, else a cudaError_t or one of
// the codes above (see mxt_flash_bwd_wgmma_wide_error_string).
int mxt_flash_bwd_wgmma_wide_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int Tq, int Tk, int D, int tq_pad,
                                const long long* st, float scale, int causal,
                                void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  const int rc = check_sizes(B, H, Tq, Tk, tq_pad);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (D) {
    case 192:
      return launch_dq<192>(q, k, v, dout, l, dl, dq, B, H, Tq, Tk, tq_pad,
                            st, scale, causal, s);
    case 256:
      return launch_dq<256>(q, k, v, dout, l, dl, dq, B, H, Tq, Tk, tq_pad,
                            st, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As mxt_flash_bwd_wgmma_wide_dq; `st` holds the strides of q, k, v, dO,
// dk and dv.  Every dK/dV row is written (rows no query sees get 0).
int mxt_flash_bwd_wgmma_wide_dkv(const void* q, const void* k, const void* v,
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
    case 192:
      return launch_dkv<192>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk,
                             tq_pad, st, scale, causal, s);
    case 256:
      return launch_dkv<256>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk,
                             tq_pad, st, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mxt_flash_bwd_wgmma_wide_error_string(int code) {
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a q/k/v/dO layout";
  if (code == kErrNoEntryPoint)
    return "libcuda has no cuTensorMapEncodeTiled entry point";
  if (code == kErrPad)
    return "lse/delta row length tq_pad is not a multiple of 64 >= Tq";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
