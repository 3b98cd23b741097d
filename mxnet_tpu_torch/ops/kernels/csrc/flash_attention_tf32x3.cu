// Flash-attention forward for f32 above head_dim 32 on Hopper's tensor
// cores (sm_90a), CUDA C++: the "tf32x3" variant of the forward, for f32
// inputs at head_dim 64 or 128 (the wrapper pads head_dim 33-128 to one of
// them; their own plan, "Narrow widths" below) and at head_dim 192 or 256
// (the wrapper pads head_dim 129-256 to one of them), and the
// "tf32x3_xwide" variant at head_dim 384 or 512 (the wrapper pads head_dim
// 257-384 to 384 and 385-512 to 512): the 192 / 256 kernel run by clusters
// of two CTAs that split D (below).  f32 at head_dim 16 or 32 stays on the
// CUDA cores (simt, flash_attention.cu).
//
// Replaces, at those widths and in f32, the Pallas TPU kernel
// mxnet_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (launched by
// `_fwd`), and computes the same function as the wide variant's forward
// (flash_attention_wide.cu), which runs it on the CUDA cores:
//
//   s   = (q . k^T) * scale          -1e30 where k_pos >= kv_len or (causal
//                                    and q_pos < k_pos)
//   over key tiles, per row: m' = max(m, max(s)), alpha = exp(m - m'),
//   p = exp(s - m') (as 2^(S scale log2(e) - m' log2(e)): one FFMA and one
//   MUFU ex2), l = l * alpha + sum(p), acc = acc * alpha + p . v, m = m'
//   o   = acc / l (0 where l == 0),  lse = m + log(l)            all f32
//
// Split-TF32 products, as in the tf32x3 backward (flash_attention_bwd_
// tf32x3.cu): the tensor cores take no f32 operand, and one TF32 product
// keeps about 2^-11 relative, which f32's 1e-4 would not pass.  Every
// operand x is split into hi (x with its 13 low bits cleared) and lo = x -
// hi (split_tf32), and each product is issued as three TF32 products with
// f32 accumulation (mma_tf32x3), under 3 * 2^-20 relative.  S is summed
// over a half of D on the tensor cores; each key tile's p . v is summed
// there from zero and added to acc in f32 (acc * alpha + pv, _fwd_kernel's
// own formula): the tensor cores' accumulation does not round to nearest,
// and over the 128 tiles of an 8192-key row its bias would reach o.
//
// What bounds it on the card: operations.  4*D flops per unmasked (q, k)
// pair; as three TF32 products, 12*D at the H100's 495 TFLOP/s TF32 peak.
// mma.sync reaches about 318 of them (tf32x3_probe.py), every operand is
// split beside its products on the CUDA cores and read from shared memory
// beside them, so the design counts splits and reads a product.
//
// Design (192 / 256).  CTAs of 8 warps own 64 query rows (heavy causal
// tiles first) and all of D: q resident in shared memory, loaded once,
// and key and value tiles of 64 rows streamed, f32 with rows padded to D +
// 4 words
// (every fragment load below is free of bank conflicts); 16-byte cp.async
// copies, rows past Tk zero-filled.  One buffer a tile: at D 256 three
// 64-row tiles are 195 KB, with the exchange tile 213 KB of 227.  Per key
// tile:
//   * scores: warp w computes rows 16 (w / 2) .. + 15 against all 64 keys
//     over one half of D (w % 2): a q fragment split once for 8 key
//     fragments, 20 values split and read a 24 tensor-core products.  The
//     two halves' warps trade the partial sums of 8 rows each through the
//     exchange tile, and each finishes its 8 rows (one row a quad of
//     lanes): the mask (only on tiles that need it), the running max,
//     alpha, p and the running sum; p goes over what it read there;
//   * output: warp w owns D / 8 columns of all 64 rows (acc: D / 4 floats
//     a thread), multiplied by the rows' alpha and added to the tile's
//     p . v, which reads the value tile with its k index permuted (k-slot t
//     <-> key 2t, t + 4 <-> key 2t + 1) so that p's A fragment is one
//     float2 a row, as the backward's output products do.
// The value tile's copies are issued beside the first half of the score
// products and the next key tile's beside the first half of the output
// products, so that they land while the rest runs and their issue does
// not hold the warps up front: three barriers a tile.  Key tiles past the causal diagonal or kv_len are
// skipped.  No CTA reads what another writes and there are no atomics: two
// calls give the same bits.
//
// tf32x3_xwide: above D 256 one CTA cannot hold the tiles (at D 256 they
// take 213 KB of the 227 a block may use).  So a cluster of two CTAs (CL =
// 2, along grid x) owns each 64-row query tile, and CTA c of the pair takes
// columns c D' .. c D' + D' - 1 of the padded width 2 D' (D' = 192 at 384,
// 256 at 512): each is the kernel above at D', with its shared memory,
// warps and accumulators, and loads only its half of q, k and v.
//   * The score product is split along D across the pair, as the two warp
//     halves split it inside a CTA: once the halves have met, each warp
//     pushes its CTA's partial of its 8 rows into the same rows of the
//     peer's exchange tile (st.async, 16 bytes a lane four times, counted
//     as transaction bytes on the peer warp's `full` mbarrier) and adds the
//     peer's, which arrives the same way (meet_peer).  a + b == b + a in
//     IEEE arithmetic, so both CTAs hold the same bits of S and form the
//     same m, alpha, p and l.  The rows are free once the warp has read its
//     partner's partial there, and it says so to the peer's warp by a
//     remote arrival on that warp's `vacant` mbarrier: the exchange needs
//     no receive buffer (none fits beside D' 256's 213 KB), only two 8-byte
//     mbarriers a warp, and each warp waits for its counterpart alone (the
//     tf32x3_xwide backward's plan, flash_attention_bwd_tf32x3.cu).
//   * P.V needs only the CTA's own columns of V: each CTA keeps acc for its
//     D' columns of o and stores them; rank 0 alone writes lse.  No score
//     work is repeated: a pair does the flops of one CTA over all of D.
//   * Both CTAs walk the same key tiles, each warp meeting its counterpart
//     once a tile, with a cluster barrier after the mbarriers'
//     initialisation and one at the end (neither CTA's shared memory is
//     reached before it starts or after it ends).  No atomics: two calls
//     give the same bits.
// A 2-CTA cluster at 213 KB a CTA needs two SMs of one GPC free at once;
// the launcher checks once that one fits (cudaOccupancyMaxActiveClusters)
// and returns kErrCluster if not.
//
// Narrow widths (64 and 128).  The plan above does not carry over: warp
// w's D / 8 output columns are one n8 tile at D 64, and each score warp's
// half of D is four k-steps between the exchange's barriers, so the
// exchange tile, its three barriers a tile and the split of every value
// the output product reads weigh four times as much per flop as at 256.
// So at 64 and 128 each warp owns 16 query rows over all of D, as
// FlashAttention-2 splits the forward (and as the tf32x3 backward's narrow
// plan does, flash_attention_bwd_tf32x3.cu):
//   * scores: the warp computes S for its 16 rows against all BS keys of
//     the tile over all of D (score_rows), q's fragments split once into
//     registers (QR 1) or as they load from shared memory; no partial sum
//     crosses a warp and there is no exchange tile.  The row max and row
//     sum of rows g and g + 8 come from shuffles within the lane quad;
//   * P.V: p is formed in the score registers, and those registers are the
//     product's A operand as they stand: an m16n8 accumulator fragment
//     holds columns 2t and 2t + 1, which mma's A fragment reads as k slots
//     t and t + 4 when V's rows are read in that order (frag_b_perm).
//     Each tile's p . v is summed from zero on the tensor cores, NC
//     n-blocks at a time, and added in f32 as acc * alpha + pv.
// The only barriers are the key / value tiles': two a tile (in, and no
// longer read), with the next tile's copies (16-byte cp.async, two stages)
// issued before the wait for this one.  A warp whose rows all precede the
// tile's keys (causal) or lie past Tq skips the tile, and only tiles that
// cross kv_len or the warp's diagonal compute the mask.  Heavy causal
// tiles first; no atomics: two calls give the same bits.  The plan
// (NarrowFwd: warps W, keys a tile BS, n-blocks a chunk NC, q in registers
// QR) was chosen by timing five sets of candidates in turns
// (tf32x3_probe.py --narrow; H100 80GB HBM3, 700 W).  At 64: 4 warps,
// key tiles of 64, q in registers: 87,040 B and 226 registers, two CTAs
// an SM; 8 warps came within 3 % (faster at [2, 1024, 8, 64], slower at
// the f32 long-context leg's [1, 8192, 16, 64]), tiles of 32 keys 9-12 %
// slower, q split as it loads 2-3 % slower.  At 128: 8 warps, key tiles
// of 64, q split as it loads: 202,752 B and 239 registers (no spill), one
// CTA an SM, 8-9 % faster than tiles of 32 keys.  At [1, 8192, 16, 64]
// the score products take 34 % of the time, P.V 34 %, the softmax 11 %,
// the tiles' copies and barriers 22 % (tf32x3_probe.py's phases).
//
// Plain C interface (no PyTorch headers), called through ctypes.

#include "hopper.cuh"

namespace {

constexpr int BR = 64;             // query rows a CTA
constexpr int BS = 64;             // key / value rows a tile
constexpr int NS = BS / 8;         // 8-key blocks of a tile
constexpr int NT = 256;            // threads a CTA: 8 warps
constexpr int XS = BS + 8;         // row stride (words) of the exchange tile
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// (batch, time, head) strides in elements of q, k, v and o
struct Strides {
  long long s[12];
};

// A tile of BS rows copied by all NT threads, D / 4 16-byte pieces a row,
// spread over the first kSteps steps of a loop of tensor-core products
// (copy_step, called at each step): the copy issue runs beside the
// products instead of before them
struct TileCopy {
  float* dst;
  const float* src;
  long long ld;
  int row0, end;
};

template <int D, int kSteps>
__device__ __forceinline__ void copy_step(const TileCopy& c, int step) {
  constexpr int kPieces = BS * (D / 4) / NT;     // this thread's pieces
  static_assert(kPieces % kSteps == 0, "whole pieces a step");
  if (step >= kSteps) return;
#pragma unroll
  for (int i = 0; i < kPieces / kSteps; ++i)
    copy_piece<D>(c.dst, c.src, c.ld, c.row0, c.end,
                  threadIdx.x + NT * (step * (kPieces / kSteps) + i));
}

// Shared memory, in floats: q [BR][LD], the key and the value tile [BS][LD], the exchange tile [BR][XS]
// (partial scores, then p), the rows' alpha and l, and in a cluster (CL 2)
// two mbarriers a warp (8 bytes each: full, then vacant).  LD % 32 == 4.
template <int D, int CL = 1>
struct Smem {
  static constexpr int LD = D + 4;
  static constexpr int q = 0;
  static constexpr int k = q + BR * LD;
  static constexpr int v = k + BS * LD;
  static constexpr int x = v + BS * LD;
  static constexpr int alpha = x + BR * XS;
  static constexpr int l = alpha + BR;
  static constexpr int bars = l + BR;            // full[8], vacant[8]
  static constexpr int floats = bars + (CL == 2 ? 2 * 2 * NT / 32 : 0);
  static constexpr size_t bytes = floats * sizeof(float);
  static_assert(bytes <= 232448, "a block has 227 KB of shared memory");
};

// One warp's partial scores: s[n] = Q[16 rows] . K[8n .. 8n + 7]^T over
// D / 2 columns, Q and K from this warp's half of D, split as their
// fragments load; the copy `vc` issued over the first half of the steps
template <int D>
__device__ __forceinline__ void score_half(const float* Q, const float* K,
                                           int g, int t, const TileCopy& vc,
                                           float (&s)[NS][4]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D / 2; d += 8) {
    uint32_t ah[4], al[4];
    frag_a(Q + d, LD, g, t, ah, al);
    copy_step<D, D / 32>(vc, d / 8);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      uint32_t bh[2], bl[2];
      frag_bt(K + 8 * n * LD + d, LD, g, t, bh, bl);
      mma_tf32x3(s[n], ah, al, bh, bl);
    }
  }
}

// acc[m][nb] = acc[m][nb] * alpha(row) + P[16m .., :] . V[:, 8nb ..] over
// the tile's BS keys: all 64 rows of p in the exchange tile P against D /
// 64 n-blocks of the value tile V from this warp's first column, the
// tile's products summed on the tensor cores from zero and then added in
// f32.  p's A fragment reads columns 2t and 2t + 1 as k-slots t and t + 4,
// V's B fragment (frag_b_perm) rows in the same order.  With `copy`, the
// copy `kc` issued over the first half of the steps.
template <int D>
__device__ __forceinline__ void out_product(const float* P, const float* V,
                                            const float* alpha, int g, int t,
                                            bool copy, const TileCopy& kc,
                                            float (&acc)[4][D / 64][4]) {
  constexpr int NB = D / 64, LD = D + 4;
  float tile[4][NB][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) tile[m][nb][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < BS; kk += 8) {
    if (copy) copy_step<D, BS / 16>(kc, kk / 8);
    uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      frag_b_perm(V + kk * LD + 8 * nb, LD, g, t, bh[nb], bl[nb]);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float2 u =
          *reinterpret_cast<const float2*>(P + (16 * m + g) * XS + kk + 2 * t);
      const float2 w = *reinterpret_cast<const float2*>(
          P + (16 * m + g + 8) * XS + kk + 2 * t);
      uint32_t ah[4], al[4];
      split_tf32(u.x, ah[0], al[0]);
      split_tf32(w.x, ah[1], al[1]);
      split_tf32(u.y, ah[2], al[2]);
      split_tf32(w.y, ah[3], al[3]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        mma_tf32x3(tile[m][nb], ah, al, bh[nb], bl[nb]);
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float a0 = alpha[16 * m + g], a1 = alpha[16 * m + g + 8];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[m][nb][i] = acc[m][nb][i] * (i < 2 ? a0 : a1) + tile[m][nb][i];
  }
}

// st: q (0-2), k (3-5), v (6-8), o (9-11).  D: the columns of one CTA; CL:
// the CTAs of a cluster, which share a tile of query rows and split the
// head's CL * D columns
template <int D, int CL>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int H, int Tq, int Tk,
                        Strides st, float scale, int causal, int kv_len) {
  using L = Smem<D, CL>;
  constexpr int LD = L::LD, NB = D / 64;
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* Qs = smem + L::q;
  float* Ks = smem + L::k;
  float* Vs = smem + L::v;
  float* X = smem + L::x;
  float* alpha_s = smem + L::alpha;
  float* l_s = smem + L::l;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rb = warp >> 1, wd = warp & 1;
  // heavy tiles first
  const int q0 = (gridDim.x / CL - 1 - blockIdx.x / CL) * BR;
  const int h = blockIdx.y, b = blockIdx.z;
  // this CTA's first column
  const int cd = column_half<CL>() * D;

  const float* qb = q + b * st.s[0] + h * st.s[2] + cd;
  const float* kb = k + b * st.s[3] + h * st.s[5] + cd;
  const float* vb = v + b * st.s[6] + h * st.s[8] + cd;

  // the row this thread (its quad) finishes: wd 0 the upper 8 of the warp's
  // 16, wd 1 the lower 8
  const int r = 16 * rb + 8 * wd + g;
  const int qpos = q0 + r;
  const float sl2 = scale * kLog2e;
  float m_run = kNeg, l_run = 0.f;
  float acc[4][NB][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][nb][i] = 0.f;

  const int q_last = min(q0 + BR, Tq) - 1;
  const int k_end = causal ? min(kv_len, q_last + 1) : kv_len;

  const float* Qw = Qs + 16 * rb * LD + wd * (D / 2);
  const float* Kw = Ks + wd * (D / 2);
  const int c0 = warp * (D / 8);          // this warp's output columns

  if (k_end > 0) {
    copy_rows<D>(Qs, qb, st.s[1], q0, BR, Tq, threadIdx.x, NT);
    copy_rows<D>(Ks, kb, st.s[4], 0, BS, Tk, threadIdx.x, NT);
    cp_async_commit();
  }
  // this warp's full and vacant mbarriers (CL 2)
  const uint32_t full =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem + L::bars)) +
      8 * warp;
  init_cluster_bars<CL>(full - 8 * warp, 2 * NT / 32);
  for (int k0 = 0; k0 < k_end; k0 += BS) {
    const bool more = k0 + BS < k_end;
    cp_async_wait<0>();
    __syncthreads();          // the key tile is in; the last tile's output
                              // product no longer reads V, X or alpha
    float s[NS][4];
    score_half<D>(Qw, Kw, g, t, {Vs, vb, st.s[7], k0, Tk}, s);
    cp_async_commit();        // the value tile
    // trade halves: hand the partner the partial sums of its 8 rows
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float* xo = X + (16 * rb + 8 * (1 - wd) + g) * XS + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(xo) =
          wd ? make_float2(s[n][0], s[n][1]) : make_float2(s[n][2], s[n][3]);
    }
    __syncthreads();          // partials are in; K is no longer read
    float* xr = X + r * XS + 2 * t;
    float f[NS][2];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 u = *reinterpret_cast<const float2*>(xr + 8 * n);
      f[n][0] = (wd ? s[n][2] : s[n][0]) + u.x;
      f[n][1] = (wd ? s[n][3] : s[n][1]) + u.y;
    }
    if constexpr (CL == 2)
      meet_peer(X + (16 * rb + 8 * wd) * XS, full, full + 64, (k0 / BS) & 1,
                lane, f);
    // a tile needs the mask where it reaches kv_len or, causal, keys past
    // the first row; elsewhere max(S) * scale is max(s) (scale > 0) and s
    // is never formed
    const bool masked = k0 + BS > kv_len || (causal && k0 + BS - 1 > q0) ||
                        !(scale > 0.f);
    float mx = kNeg;
    if (masked) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kpos = k0 + 8 * n + 2 * t + j;
          const bool ok = kpos < kv_len && (!causal || qpos >= kpos);
          f[n][j] = ok ? f[n][j] * scale : kNeg;
          mx = fmaxf(mx, f[n][j]);
        }
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(f[n][0], f[n][1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (!masked) mx *= scale;
    const float m_new = fmaxf(m_run, mx);
    const float alpha = ex2((m_run - m_new) * kLog2e);
    const float fs = masked ? kLog2e : sl2, bias = -m_new * kLog2e;
    float rs = 0.f;
    if constexpr (CL == 2) __syncwarp();    // every lane has read Xw
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float p0 = ex2(fmaf(f[n][0], fs, bias));
      const float p1 = ex2(fmaf(f[n][1], fs, bias));
      rs += p0 + p1;
      *reinterpret_cast<float2*>(xr + 8 * n) = make_float2(p0, p1);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_run = l_run * alpha + rs;
    m_run = m_new;
    if (t == 0) alpha_s[r] = alpha;
    cp_async_wait<0>();
    __syncthreads();          // p, alpha and the value tile are in
    out_product<D>(X, Vs + c0, alpha_s, g, t, more,
                   {Ks, kb, st.s[4], k0 + BS, Tk}, acc);
    cp_async_commit();        // the next key tile
  }

  // the rows' l to every warp; lse from the finishing quads (of rank 0:
  // both CTAs of a cluster hold the same m and l)
  const float safe = l_run == 0.f ? 1.f : l_run;
  if (t == 0) {
    l_s[r] = safe;
    if (qpos < Tq && cd == 0)
      lse[((long long)b * H + h) * Tq + qpos] = m_run + logf(safe);
  }
  if constexpr (CL == 2) cluster_sync();  // no access to a finished peer
  __syncthreads();
  float* ob = o + b * st.s[9] + h * st.s[11] + cd;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * m + g + 8 * half;
      if (q0 + row >= Tq) continue;
      const float den = l_s[row];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        *reinterpret_cast<float2*>(ob + (q0 + row) * st.s[10] + c0 + 8 * nb +
                                   2 * t) =
            make_float2(acc[m][nb][2 * half] / den,
                        acc[m][nb][2 * half + 1] / den);
    }
}

// ---------------------------------------------------------------------------
// tf32x3 at head_dim 64 and 128: the narrow plan (header, "Narrow widths")
// ---------------------------------------------------------------------------

// The plan of the narrow forward: W warps a CTA, each owning 16 query rows
// over all of D (16 W rows a CTA), key and value tiles of BS rows in two
// stages, P.V's n-blocks taken NC at a time, and q's fragments split once
// into registers (QR 1) or split as they load from shared memory (QR 0)
template <int W_, int BS_, int NC_, int QR_>
struct FwdPlan {
  static constexpr int W = W_, BS = BS_, NC = NC_, QR = QR_;
  static_assert(BS % 8 == 0, "key tiles of 8-key blocks");
};
// the plan at each width; tf32x3_probe.py times the candidates in turns by
// editing these lines
template <int D>
struct NarrowFwd;
template <>
struct NarrowFwd<64> : FwdPlan<4, 64, 8, 1> {};
template <>
struct NarrowFwd<128> : FwdPlan<8, 64, 8, 0> {};

// Shared memory, in floats: the CTA's q rows [R][LD] and two stages of a
// key and a value tile [BS][LD].  LD % 32 == 4, as above
template <int D, class P>
struct NarrowSmem {
  static constexpr int LD = D + 4;
  static constexpr int R = 16 * P::W;
  static constexpr int NT = 32 * P::W;
  static constexpr int q = 0;
  static constexpr int str = R * LD;             // stage s: k, v
  static constexpr int stage = 2 * P::BS * LD;
  static constexpr size_t bytes = (str + 2 * stage) * sizeof(float);
  static_assert(bytes <= 232448, "a block has 227 KB of shared memory");
};

// One warp's scores: s[n] = Q[16 rows] . K[8n .. 8n + 7]^T over all of D,
// summed on the tensor cores from zero, Q the warp's rows of q and K the
// key tile.  QR: q's fragments as split once (qh, ql, one a k-step); else
// split as they load from Q
template <int D, int BS, int QR>
__device__ __forceinline__ void score_rows(const float* Q, const float* K,
                                           int g, int t,
                                           const uint32_t (&qh)[D / 8][4],
                                           const uint32_t (&ql)[D / 8][4],
                                           float (&s)[BS / 8][4]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int n = 0; n < BS / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
  if constexpr (QR) {
#pragma unroll
    for (int d = 0; d < D; d += 8)
#pragma unroll
      for (int n = 0; n < BS / 8; ++n) {
        uint32_t bh[2], bl[2];
        frag_bt(K + 8 * n * LD + d, LD, g, t, bh, bl);
        mma_tf32x3(s[n], qh[d / 8], ql[d / 8], bh, bl);
      }
  } else {
#pragma unroll 2
    for (int d = 0; d < D; d += 8) {
      uint32_t ah[4], al[4];
      frag_a(Q + d, LD, g, t, ah, al);
#pragma unroll
      for (int n = 0; n < BS / 8; ++n) {
        uint32_t bh[2], bl[2];
        frag_bt(K + 8 * n * LD + d, LD, g, t, bh, bl);
        mma_tf32x3(s[n], ah, al, bh, bl);
      }
    }
  }
}

// acc[nb] = acc[nb] * alpha(row) + P . V[:, 8nb ..] for one warp's 16 rows
// over a tile's BS keys: P the warp's p as it stands in the score
// registers, the A operand of k-step kk being fragment kk with k permuted
// as frag_b_perm reads V (the fragment's columns 2t and 2t + 1 are A's k
// slots t and t + 4), V the value tile.  NC n-blocks at a time, each
// block's products over the tile summed on the tensor cores from zero and
// then added to acc * alpha in f32; a0, a1: alpha of rows g and g + 8
template <int D, int BS, int NC>
__device__ __forceinline__ void pv_rows(const float (&p)[BS / 8][4],
                                        const float* V, float a0, float a1,
                                        int g, int t,
                                        float (&acc)[D / 8][4]) {
  constexpr int LD = D + 4;
  static_assert((D / 8) % NC == 0, "n-blocks in whole chunks");
#pragma unroll
  for (int c = 0; c < D / 8; c += NC) {
    float tile[NC][4];
#pragma unroll
    for (int nb = 0; nb < NC; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) tile[nb][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BS / 8; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(p[kk][0], ah[0], al[0]);
      split_tf32(p[kk][2], ah[1], al[1]);
      split_tf32(p[kk][1], ah[2], al[2]);
      split_tf32(p[kk][3], ah[3], al[3]);
#pragma unroll
      for (int nb = 0; nb < NC; ++nb) {
        uint32_t bh[2], bl[2];
        frag_b_perm(V + 8 * kk * LD + 8 * (c + nb), LD, g, t, bh, bl);
        mma_tf32x3(tile[nb], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int nb = 0; nb < NC; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[c + nb][i] = acc[c + nb][i] * (i < 2 ? a0 : a1) + tile[nb][i];
  }
}

// st: q (0-2), k (3-5), v (6-8), o (9-11)
template <int D>
__global__ void __launch_bounds__(NarrowSmem<D, NarrowFwd<D>>::NT, 1)
flash_fwd_tf32x3_narrow_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, float* __restrict__ lse,
                               int H, int Tq, int Tk, Strides st, float scale,
                               int causal, int kv_len) {
  using P = NarrowFwd<D>;
  using L = NarrowSmem<D, P>;
  constexpr int LD = L::LD, BS = P::BS, R = L::R, NT = L::NT;
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;     // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * st.s[3] + h * st.s[5];
  const float* vb = v + b * st.s[6] + h * st.s[8];
  const int w0 = q0 + 16 * warp;      // this warp's first row
  const int r0 = w0 + g;              // this thread's rows r0 and r0 + 8
  const float sl2 = scale * kLog2e;
  const int q_last = min(q0 + R, Tq) - 1;
  const int k_end = causal ? min(kv_len, q_last + 1) : kv_len;
  // the keys this warp's rows see: the tiles past them are skipped, as
  // are all where its rows lie past Tq
  const int w_end = w0 >= Tq ? 0 : causal ? min(k_end, w0 + 16) : k_end;

  if (k_end > 0) {
    copy_rows<D>(smem + L::q, q + b * st.s[0] + h * st.s[2], st.s[1], q0, R,
                 Tq, threadIdx.x, NT);
    copy_rows<D>(smem + L::str, kb, st.s[4], 0, BS, Tk, threadIdx.x, NT);
    copy_rows<D>(smem + L::str + BS * LD, vb, st.s[7], 0, BS, Tk,
                 threadIdx.x, NT);
    cp_async_commit();
  }
  const float* Qw = smem + L::q + 16 * warp * LD;
  // q's fragments, split once (QR): D / 8 k-steps of 4 + 4 registers
  uint32_t qh[D / 8][4], ql[D / 8][4];
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nb][i] = 0.f;

  int s = 0;
  for (int k0 = 0; k0 < k_end; k0 += BS, s ^= 1) {
    const float* Ks = smem + L::str + s * L::stage;
    const float* Vs = Ks + BS * LD;
    if (k0 + BS < k_end) {            // the next tile into the other stage
      float* nk = smem + L::str + (s ^ 1) * L::stage;
      copy_rows<D>(nk, kb, st.s[4], k0 + BS, BS, Tk, threadIdx.x, NT);
      copy_rows<D>(nk + BS * LD, vb, st.s[7], k0 + BS, BS, Tk, threadIdx.x,
                   NT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                  // this tile is in, every thread's part
    if constexpr (P::QR) {
      if (k0 == 0) {                  // q came in with the first tile
#pragma unroll
        for (int d = 0; d < D; d += 8)
          frag_a(Qw + d, LD, g, t, qh[d / 8], ql[d / 8]);
      }
    }
    if (k0 < w_end) {
      float f[BS / 8][4];
      score_rows<D, BS, P::QR>(Qw, Ks, g, t, qh, ql, f);
      // a tile needs the mask where it reaches kv_len or, causal, keys past
      // the warp's first row; elsewhere max(S) * scale is max(s) (scale >
      // 0) and s is never formed
      const bool masked = k0 + BS > kv_len || (causal && k0 + BS - 1 > w0) ||
                          !(scale > 0.f);
      float mx[2] = {kNeg, kNeg};
      if (masked) {
#pragma unroll
        for (int n = 0; n < BS / 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kpos = k0 + 8 * n + 2 * t + (i & 1);
            const int qpos = r0 + 8 * (i >> 1);
            const bool ok = kpos < kv_len && (!causal || qpos >= kpos);
            f[n][i] = ok ? f[n][i] * scale : kNeg;
            mx[i >> 1] = fmaxf(mx[i >> 1], f[n][i]);
          }
      } else {
#pragma unroll
        for (int n = 0; n < BS / 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], f[n][i]);
      }
      float alpha[2], bias[2], rs[2] = {0.f, 0.f};
      const float fs = masked ? kLog2e : sl2;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
        if (!masked) mx[j] *= scale;
        const float m_new = fmaxf(m_run[j], mx[j]);
        alpha[j] = ex2((m_run[j] - m_new) * kLog2e);
        bias[j] = -m_new * kLog2e;
        m_run[j] = m_new;
      }
#pragma unroll
      for (int n = 0; n < BS / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          f[n][i] = ex2(fmaf(f[n][i], fs, bias[i >> 1]));
          rs[i >> 1] += f[n][i];
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 1);
        rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 2);
        l_run[j] = l_run[j] * alpha[j] + rs[j];
      }
      pv_rows<D, BS, P::NC>(f, Vs, alpha[0], alpha[1], g, t, acc);
    }
    __syncthreads();                  // this stage is no longer read
  }

  // o = acc / l (0 where l == 0), lse = m + log(l): rows r0 and r0 + 8
  float* ob = o + b * st.s[9] + h * st.s[11];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = r0 + 8 * j;
    if (r >= Tq) continue;
    const float safe = l_run[j] == 0.f ? 1.f : l_run[j];
    if (t == 0) lse[((long long)b * H + h) * Tq + r] = m_run[j] + logf(safe);
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<float2*>(ob + r * st.s[10] + 8 * nb + 2 * t) =
          make_float2(acc[nb][2 * j] / safe, acc[nb][2 * j + 1] / safe);
  }
}

template <int D>
int launch_narrow(const float* q, const float* k, const float* v, float* o,
                  float* lse, int B, int H, int Tq, int Tk,
                  const long long* st, float scale, int causal, int kv_len,
                  cudaStream_t stream) {
  using L = NarrowSmem<D, NarrowFwd<D>>;
  Strides s{};
  for (int i = 0; i < 12; ++i) s.s[i] = st[i];
  return launch_ex<flash_fwd_tf32x3_narrow_kernel<D>, 1>(
      dim3((Tq + L::R - 1) / L::R, H, B), L::NT, L::bytes, stream, q, k, v,
      o, lse, H, Tq, Tk, s, scale, causal, kv_len);
}

template <int D, int CL>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int H, int Tq, int Tk, const long long* st,
           float scale, int causal, int kv_len, cudaStream_t stream) {
  Strides s{};
  for (int i = 0; i < 12; ++i) s.s[i] = st[i];
  return launch_ex<flash_fwd_tf32x3_kernel<D, CL>, CL>(
      dim3(CL * ((Tq + BR - 1) / BR), H, B), NT, Smem<D, CL>::bytes, stream,
      q, k, v, o, lse, H, Tq, Tk, s, scale, causal, kv_len);
}

// The forward at `D` columns: tf32x3 at 64 / 128 (the narrow plan) and at
// 192 / 256 (one CTA a query tile), tf32x3_xwide at 384 / 512 (a cluster
// of two CTAs, 192 / 256 columns each); any other width, or one of the
// other variant's, is refused
int fwd_any(bool xwide, const void* q, const void* k, const void* v, void* o,
            void* lse, int B, int H, int Tq, int Tk, int D,
            const long long* st, float scale, int causal, int kv_len,
            void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  if (Tk <= 0 || kv_len < 0 || kv_len > Tk || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float *fo = static_cast<float*>(o), *fl = static_cast<float*>(lse);
  switch (xwide ? -D : D) {
    case 64:
      return launch_narrow<64>(fq, fk, fv, fo, fl, B, H, Tq, Tk, st, scale,
                               causal, kv_len, s);
    case 128:
      return launch_narrow<128>(fq, fk, fv, fo, fl, B, H, Tq, Tk, st, scale,
                                causal, kv_len, s);
    case 192:
      return launch<192, 1>(fq, fk, fv, fo, fl, B, H, Tq, Tk, st, scale,
                            causal, kv_len, s);
    case 256:
      return launch<256, 1>(fq, fk, fv, fo, fl, B, H, Tq, Tk, st, scale,
                            causal, kv_len, s);
    case -384:
      return launch<192, 2>(fq, fk, fv, fo, fl, B, H, Tq, Tk, st, scale,
                            causal, kv_len, s);
    case -512:
      return launch<256, 2>(fq, fk, fv, fo, fl, B, H, Tq, Tk, st, scale,
                            causal, kv_len, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int code) {
  if (code == kErrCluster)
    return "no cluster of two 213 KB CTAs fits on this device";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace

extern "C" {

// q/k/v/o: f32 [B, T, H, D] with unit stride on D, D 64, 128, 192 or 256;
// `st` holds the (B, T, H) element strides of q, k, v and o in that order.
// Base addresses 16-byte aligned, q/k/v strides multiples of 4 elements
// (the 16-byte copies).  lse: f32 [B, H, Tq], contiguous.  Keys at and past
// kv_len are masked.  Returns 0 on success, else a cudaError_t.
int mxt_flash_tf32x3_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int H, int Tq, int Tk,
                         int D, const long long* st, float scale, int causal,
                         int kv_len, void* stream) {
  return fwd_any(false, q, k, v, o, lse, B, H, Tq, Tk, D, st, scale, causal,
                 kv_len, stream);
}

const char* mxt_flash_tf32x3_error_string(int code) {
  return error_string(code);
}

// tf32x3_xwide: as mxt_flash_tf32x3_fwd at D 384 or 512, each query tile
// run by a cluster of two CTAs (D / 2 columns each); also returns
// kErrCluster (see mxt_flash_tf32x3_xwide_error_string)
int mxt_flash_tf32x3_xwide_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int H, int Tq,
                               int Tk, int D, const long long* st,
                               float scale, int causal, int kv_len,
                               void* stream) {
  return fwd_any(true, q, k, v, o, lse, B, H, Tq, Tk, D, st, scale, causal,
                 kv_len, stream);
}

const char* mxt_flash_tf32x3_xwide_error_string(int code) {
  return error_string(code);
}

}  // extern "C"
