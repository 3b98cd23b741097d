// Flash-attention backward for f32 above head_dim 32 on Hopper's tensor
// cores (sm_90a), CUDA C++: the "tf32x3" variant of dQ and dK/dV, for f32
// inputs at head_dim 64 or 128 (the wrapper pads head_dim 33-128 to one of
// them; their own plan, "Narrow widths" below) and at head_dim 192 or 256
// (the wrapper pads head_dim 129-256 to one of them), and the
// "tf32x3_xwide" variant at head_dim 384 or 512 (the wrapper pads head_dim
// 257-384 to 384 and 385-512 to 512): the 192 / 256 kernels run by
// clusters of two CTAs that split D (below).  f32 at head_dim 16 or 32
// stays on the CUDA cores (simt, flash_attention_bwd.cu); so does the f32
// forward up to head_dim 128 (flash_attention.cu).
//
// Replaces, at those widths and in f32, the Pallas TPU kernels
// mxnet_tpu/ops/pallas/flash_attention.py `_dq_kernel` and `_dkv_kernel`
// (launched together by `_bwd`), and computes the same function as the
// wide variant (flash_attention_wide.cu), which runs them on the CUDA
// cores:
//
//   s   = (q . k^T) * scale          masked where k_pos >= Tk or (causal
//                                    and q_pos < k_pos)
//   p   = exp(s - lse)               0 where masked and in rows past Tq;
//                                    as 2^(S scale log2(e) - lse log2(e)):
//                                    one FFMA and one MUFU ex2
//   dp  = dO . v^T
//   ds  = p * (dp - delta) * scale   delta = rowsum(dO*O) - dlse, computed
//                                    by the caller
//   dQ  = ds . k,  dK = ds^T . q,  dV = p^T . dO           all f32
//
// Split-TF32 products.  The tensor cores take no f32 operand, and one TF32
// product keeps 11 of f32's 24 significant bits (about 2^-11 relative),
// which the f32 gradients' 1e-4 would not pass.  Every operand x of a
// product that feeds an output is split into hi (x with its 13 low bits
// cleared, a TF32 value) and lo = x - hi (exact in f32, read by the tensor
// cores at 11 bits; split_tf32), and the product is issued as three TF32
// products with f32 accumulation, lo_a.hi_b + hi_a.lo_b + hi_a.hi_b
// (mma_tf32x3): the dropped lo_a.lo_b and the truncation of lo leave under
// 3 * 2^-20 relative a product.  S and dP are split so, and so are dQ, dK
// and dV, with p and ds split in registers as they are read.
//
// What bounds it on the card: operations.  dQ does 6*D and dK/dV 8*D
// flops per unmasked (q, k) pair; as three TF32 products, 18*D and 24*D
// at the H100's 495 TFLOP/s TF32 peak.  mma.sync reaches about 318 of
// them there (tf32x3_probe.py), and every product needs its operands split
// beside it (two ops a value on the CUDA cores, issued from the same warp
// schedulers), so the design counts splits.
//
// Why mma.sync and not wgmma: wgmma reads TF32 operands from shared memory
// only K-major, and dQ's K and dK/dV's Q and dO are MN-major there (the
// reduction runs over their rows).  mma.sync.m16n8k8 loads its fragments
// from shared memory by address in any layout, and the split happens as
// they load.
//
// Design (192 / 256).  CTAs of 8 warps own 64 resident rows (queries for
// dQ, keys for dK/dV), loaded once, and stream the other side in tiles of
// 32 rows, f32 in shared memory with rows padded to D + 4 words (every
// fragment load below is free of bank conflicts).  Per tile:
//   * scores: warp w computes 32 rows (32 ((w / 2) % 2) ..) x all 32
//     streamed rows of one product (w < 4: S, or S^T; else dP, or dP^T)
//     over one half of D (w % 2): 16 values split for 24 tensor-core
//     products a k-step.  The two halves' warps trade partial sums of one
//     16-row block each through an exchange tile in shared memory, and
//     each finishes its block, p or dp - delta, in place there;
//   * output: warp w owns D / 8 output columns (32 at D 256, 24 at 192) of
//     all 64 rows, over the 32 streamed rows: dQ += ds . K, or dV += p^T .
//     dO and dK += ds^T . Q, with ds = p * (dp - delta) * scale formed as
//     the exchange is read; accumulators in registers (D / 4 floats a
//     thread, twice that for dK/dV), to which each tile's products are
//     added in f32 after summing on the tensor cores from zero: their own
//     accumulation does not round to nearest, and over the 3072 steps of
//     an 8192-row sequence it drifted 1e-4 of dK and dV's largest entry
//     from dense autograd.  Each streamed value is split by one warp.
//     These products read the streamed tile with their k index permuted
//     (k-slot t <-> row 2t, t + 4 <-> row 2t + 1), which the exchange's A
//     fragment follows (a float2 a row pair).
// dQ: one CTA per (64 queries, head, batch), heavy causal tiles first, key
// tiles up to the diagonal.  dK/dV: one CTA per (64 keys, head, batch),
// early keys (more queries) first, query tiles from the diagonal to Tq;
// key tiles that no query sees store their zero accumulators, so every
// dK/dV row is written.  Copies are 16-byte cp.async (rows past the end
// zero-filled); one buffer a tile: shared memory at D 256 is 130 KB
// resident, 65 KB streamed and 20 KB of exchange (215 KB of 227).  The
// streamed tile that the first output product does not read (V in dQ,
// dO in dK/dV) is refilled while it runs; the other after it, by the four
// warps whose scores read it, which wait for it at their own barrier while
// the other four start the next tile's scores.  No CTA reads what another
// writes and there are no atomics: two calls give the same bits.
//
// tf32x3_xwide: above D 256 a CTA cannot hold 64 resident rows of two f32
// tensors over all of D (at 320 the resident and streamed tiles alone take
// 248,832 B of the 232,448 a block may use; at 512 the resident pair alone
// 264,192 B), nor dK/dV's 2 * D / 4 accumulators a thread (255 registers
// at D 256 already).  So a cluster of two CTAs (CL = 2, along grid x) owns
// each tile of rows and CTA c of the pair takes columns c D' .. c D' + D'
// - 1 of the padded width 2 D' (D' = 192 at 384, 256 at 512): each is the
// kernel above at D', with its shared memory, warps and accumulators.
//   * The score products are split along their reduction axis across the
//     pair, as the two warp halves split them inside a CTA: after the two
//     halves meet, each warp pushes its CTA's partial of its 16-row block
//     into the same block of the peer's exchange tile (st.async, 16 bytes
//     a lane four times, counted as transaction bytes on the peer warp's
//     `full` mbarrier) and adds the peer's, which arrives the same way
//     into its own tile (meet_peer).  a + b == b + a in IEEE arithmetic,
//     so both CTAs hold the same bits of S and dP and form the same p and
//     ds.  The block is free once the warp has read its partner's partial
//     there, and it says so to the peer's warp by a remote arrival on that
//     warp's `vacant` mbarrier; so the exchange needs no shared memory of
//     its own (16 KB of receive buffers would not fit beside D' 256's
//     215 KB), only two 8-byte mbarriers a warp, and each warp waits for
//     its counterpart alone.  The first plan read the peer's block in place
//     (ld.shared::cluster) between two cluster barriers a tile; that
//     exchange took 22 % of dQ's and 17 % of dK/dV's time at [2, 8192, 2,
//     512], most of it the barrier's release and the remote loads'
//     latency (tf32x3_probe.py times both plans in turns).
//   * The output products need only the CTA's own columns: dQ[:, own] +=
//     ds . K[:, own], dK[:, own] += ds^T . Q[:, own], dV[:, own] += p^T .
//     dO[:, own], so a CTA never loads the peer's half of any tile.  No
//     score work is repeated: a pair does the flops of one CTA over all
//     of D.
//   * Both CTAs walk the same tiles in the same order, each warp meeting
//     its counterpart once a tile (a cluster barrier after the mbarriers'
//     initialisation and one at the end, so that neither CTA's shared
//     memory is reached before it starts or after it ends); key tiles no
//     query sees store zero dK/dV in both.  No atomics: two calls give
//     the same bits.
// A 2-CTA cluster at 215 KB a CTA needs two SMs of one GPC free at once;
// the launcher checks once that one fits (cudaOccupancyMaxActiveClusters)
// and returns kErrCluster if not.
//
// Narrow widths (64 and 128).  The plan above does not carry over: warp w's
// D / 8 output columns are one n8 tile at D 64, so every warp forms and
// splits all of ds for one tile of products; each score warp's half of D
// is four k-steps, so the two half-barriers, the exchange tile and the
// split of every streamed value weigh four times as much per flop as at
// 256; and its 72,704 B of shared memory at D 64 leave most of the SM
// idle under (256, 1) launch bounds.  So at 64 and 128 each warp owns M
// blocks of 16 resident rows over all of D, in both products, as
// FlashAttention-2's backward splits its work:
//   * scores: the warp computes S (or S^T) and dP (or dP^T) for its rows
//     against all BS streamed rows over all of D (score_rows), so no
//     partial sum crosses a warp and there is no exchange tile;
//   * p and ds = p * (dp - delta) * scale are formed in the accumulators'
//     registers, and those registers are the A operand of the output
//     products as they stand: an m16n8 accumulator fragment holds columns
//     2t and 2t + 1, which mma's A fragment reads as k slots t and t + 4
//     when the streamed tile's rows are read in that order (frag_b_perm,
//     the permutation the plan above applies to its exchange tile);
//   * output: dQ += ds . K, or dV += p^T . dO and dK += ds^T . Q, for the
//     warp's rows and all D columns (out_rows), NC n-blocks at a time,
//     each block's products over the tile summed from zero on the tensor
//     cores and added in f32, as above.
// The only barriers are the streamed tiles': two a tile (in, and no longer
// read), with the next tile's copies (16-byte cp.async, two stages) issued
// before the wait for this one.  dQ issues dP right after S, so that p's
// exponentials run beside dP's last products.  A warp whose rows no key
// (dQ) or query (dK/dV) of the tile reaches under the causal mask skips the
// tile, and only tiles that cross Tq, Tk or the diagonal compute masks.  dQ
// runs its heavy causal tiles first, dK/dV its early keys first; key tiles
// no query sees store zero dK/dV.  No atomics: two calls give the same
// bits.  Each kernel's plan (NarrowDq, NarrowDkv: warps W, 16-row blocks
// M, streamed rows BS, n-blocks a chunk NC) was chosen by timing five sets
// of candidates in turns (tf32x3_probe.py --narrow; H100 80GB HBM3,
// 700 W).  At 64 both kernels take 4 warps of one block (64 rows a CTA)
// and 64-row tiles: 104,448 B and 171 (dQ) / 198 (dK/dV) registers, so
// two CTAs share an SM.  At 128, 8 warps of one block (128 rows) and
// 32-row tiles, dK/dV's output in chunks of 4 n-blocks: 202,752 B and
// 197 / 255 registers (no spill), one CTA an SM.  Two blocks a warp (each
// streamed fragment split once for two mma rows) did not pay: dQ at 64
// within the timing's spread, dK/dV at 64 3-19 % slower, dQ at 128 32-50 %
// slower; nor did 8 warps with 32-row tiles at 64 (11 %), nor 4 warps or
// 16-row tiles at 128 (15-24 %).  At the f32 long-context leg's [1, 8192,
// 16, 64] the tiles' copies and barriers take 14 % of dQ's and 11 % of
// dK/dV's time,
// the products and the softmax the rest (tf32x3_probe.py's phases); two
// libraries of the same dK/dV code timed 4.87 and 5.15 ms there in one
// call, so plans within about 6 % are not told apart.
//
// Plain C interface (no PyTorch headers), called through ctypes.

#include "hopper.cuh"

namespace {

constexpr int BR = 64;             // resident rows a CTA
constexpr int BS = 32;             // streamed rows a tile
constexpr int NT = 256;            // threads a CTA: 8 warps
constexpr int XS = BS + 8;         // row stride (words) of an exchange tile
constexpr int kErrPad = 100003;    // tq_pad not a multiple of BR or < Tq
constexpr float kLog2e = 1.4426950408889634f;

// (batch, time, head) strides in elements of each [B, T, H, D] tensor
struct Strides {
  long long s[18];
};

// The plan at head_dim 192 and 256 (tf32x3) and, a CTA's half, at 384 and
// 512 (tf32x3_xwide); 64 and 128 take the narrow plan (NarrowDq and
// NarrowDkv, below).
// Shared memory, in floats: two resident [BR][LD] tiles, two streamed
// [BS][LD] tiles and two [BR][XS] exchange tiles, and in a cluster (CL 2)
// two mbarriers a warp (8 bytes each: full, then vacant).  LD % 32 == 4.
template <int D, int CL = 1>
struct Smem {
  static constexpr int LD = D + 4;
  static constexpr int res0 = 0;                 // q | k
  static constexpr int res1 = res0 + BR * LD;    // dO | v
  static constexpr int str0 = res1 + BR * LD;    // k | q
  static constexpr int str1 = str0 + BS * LD;    // v | dO
  static constexpr int x0 = str1 + BS * LD;      // p | p^T
  static constexpr int x1 = x0 + BR * XS;        // dp - delta (by row | col)
  static constexpr int bars = x1 + BR * XS;      // full[8], vacant[8]
  static constexpr int floats = bars + (CL == 2 ? 2 * 2 * NT / 32 : 0);
  static constexpr size_t bytes = floats * sizeof(float);
  static_assert(bytes <= 232448, "a block has 227 KB of shared memory");
};

// The barrier of one product's four warps (the scores' halves of the CTA):
// this thread's copies have landed and those of its half are visible
__device__ __forceinline__ void half_ready(int wp) {
  cp_async_wait_all();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wp) : "memory");
}

// A fragment (16 x 8), split, of an exchange tile with k permuted as
// frag_b_perm (columns 2t and 2t + 1 are one float2): p from P, or with
// kDs, ds = p * (dp - delta) * scale from P and Dd (dp - delta)
template <bool kDs>
__device__ __forceinline__ void frag_x(const float* P, const float* Dd,
                                       float scale, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  float2 u = *reinterpret_cast<const float2*>(P + g * XS + 2 * t);
  float2 w = *reinterpret_cast<const float2*>(P + (g + 8) * XS + 2 * t);
  if (kDs) {
    const float2 du = *reinterpret_cast<const float2*>(Dd + g * XS + 2 * t);
    const float2 dw =
        *reinterpret_cast<const float2*>(Dd + (g + 8) * XS + 2 * t);
    u = make_float2(u.x * du.x * scale, u.y * du.y * scale);
    w = make_float2(w.x * dw.x * scale, w.y * dw.y * scale);
  }
  split_tf32(u.x, hi[0], lo[0]);
  split_tf32(w.x, hi[1], lo[1]);
  split_tf32(u.y, hi[2], lo[2]);
  split_tf32(w.y, hi[3], lo[3]);
}

// One scores warp's partial products: acc[m][n] = A[16m .. 16m + 15] .
// B[8n .. 8n + 7]^T over D / 2 columns, A 32 rows of a resident tile and B
// the 32 rows of the streamed tile, both from this warp's half of D
template <int D>
__device__ __forceinline__ void score_half(const float* A, const float* B,
                                           int g, int t,
                                           float (&acc)[2][4][4]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D / 2; d += 8) {
    uint32_t ah[2][4], al[2][4];
    frag_a(A + d, LD, g, t, ah[0], al[0]);
    frag_a(A + 16 * LD + d, LD, g, t, ah[1], al[1]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      uint32_t bh[2], bl[2];
      frag_bt(B + 8 * n * LD + d, LD, g, t, bh, bl);
      mma_tf32x3(acc[0][n], ah[0], al[0], bh, bl);
      mma_tf32x3(acc[1][n], ah[1], al[1], bh, bl);
    }
  }
}

// 16 rows of score fragments (n-blocks of 8 columns) to / from an exchange
// tile at X
__device__ __forceinline__ void put(float* X, int g, int t,
                                   const float (&f)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float* x = X + g * XS + 8 * n + 2 * t;
    *reinterpret_cast<float2*>(x) = make_float2(f[n][0], f[n][1]);
    *reinterpret_cast<float2*>(x + 8 * XS) = make_float2(f[n][2], f[n][3]);
  }
}

__device__ __forceinline__ void add_from(const float* X, int g, int t,
                                         float (&f)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float* x = X + g * XS + 8 * n + 2 * t;
    const float2 u = *reinterpret_cast<const float2*>(x);
    const float2 w = *reinterpret_cast<const float2*>(x + 8 * XS);
    f[n][0] += u.x;
    f[n][1] += u.y;
    f[n][2] += w.x;
    f[n][3] += w.y;
  }
}

// The two D halves' partial scores meet: each warp of the pair hands the
// other its partial of one 16-row block (wd = 0 hands block 1, wd = 1 block
// 0) through the exchange tile X (its 32 rows), and returns in f the full
// sums of the other block, 16 rows from 16 wd (a + b == b + a: the pair
// agrees bit for bit).  Contains the CTA barrier.
__device__ __forceinline__ void meet_halves(float* X, int wd, int g, int t,
                                            const float (&s)[2][4][4],
                                            float (&f)[4][4]) {
  float h[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[n][i] = wd ? s[0][n][i] : s[1][n][i];
      f[n][i] = wd ? s[1][n][i] : s[0][n][i];
    }
  put(X + 16 * (1 - wd) * XS, g, t, h);
  __syncthreads();
  add_from(X + 16 * wd * XS, g, t, f);
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[4][D / 64][4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][nb][i] = 0.f;
}

// acc[m][nb] += X[16m .., :] . M[:, 8nb ..] over the tile's BS streamed
// rows: all 64 exchange rows (p, or ds with kDs) against D / 64 n-blocks of
// the streamed tile M from this warp's first output column.  The tile's
// products accumulate on the tensor cores from zero (12 steps) and are
// then added to acc in f32: the tensor cores' own accumulation does not
// round to nearest, and over the thousands of steps of a long sequence
// its bias reaches 1e-4 of dK and dV
template <int D, bool kDs>
__device__ __forceinline__ void out_product(const float* P, const float* Dd,
                                            float scale, const float* M,
                                            int g, int t,
                                            float (&acc)[4][D / 64][4]) {
  constexpr int NB = D / 64, LD = D + 4;
  float tile[4][NB][4];
  zero<D>(tile);
#pragma unroll
  for (int kk = 0; kk < BS; kk += 8) {
    uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      frag_b_perm(M + kk * LD + 8 * nb, LD, g, t, bh[nb], bl[nb]);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t ah[4], al[4];
      frag_x<kDs>(P + 16 * m * XS + kk, Dd + 16 * m * XS + kk, scale, g, t,
                  ah, al);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        mma_tf32x3(tile[m][nb], ah, al, bh[nb], bl[nb]);
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][nb][i] += tile[m][nb][i];
}

// this warp's output fragments: rows r0 + 16m + g (+ 8), those at or past
// `end` not stored; columns c0 + 8nb + 2t and the next
template <int D>
__device__ __forceinline__ void store(float* out, long long ld, int r0,
                                      int end, int c0, int g, int t,
                                      const float (&acc)[4][D / 64][4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 16 * m + g + 8 * half;
      if (r >= end) continue;
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb)
        *reinterpret_cast<float2*>(out + r * ld + c0 + 8 * nb + 2 * t) =
            make_float2(acc[m][nb][2 * half], acc[m][nb][2 * half + 1]);
    }
}

// st: q (0-2), k (3-5), v (6-8), dO (9-11), dQ (12-14).  D: the columns
// of one CTA; CL: the CTAs of a cluster, which share a tile of rows and
// split the head's CL * D columns
template <int D, int CL>
__global__ void __launch_bounds__(NT, 1)
flash_dq_tf32x3_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dq, int H, int Tq, int Tk,
                       int tq_pad, Strides st, float scale, int causal) {
  using L = Smem<D, CL>;
  constexpr int LD = L::LD;
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* Ks = smem + L::str0;
  float* Vs = smem + L::str1;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wp = warp >> 2, wr = (warp >> 1) & 1, wd = warp & 1;
  // heavy tiles first
  const int q0 = (gridDim.x / CL - 1 - blockIdx.x / CL) * BR;
  const int h = blockIdx.y, b = blockIdx.z;
  // this CTA's first column (read again for the store: one register less
  // across the tile loop)
  const int cd = column_half<CL>() * D;

  const float* qb = q + b * st.s[0] + h * st.s[2] + cd;
  const float* kb = k + b * st.s[3] + h * st.s[5] + cd;
  const float* vb = v + b * st.s[6] + h * st.s[8] + cd;
  const float* dob = dout + b * st.s[9] + h * st.s[11] + cd;
  // the rows this warp finishes, r0 and r0 + 8, and their lse (wp 0) or
  // delta (wp 1)
  const int r0 = q0 + 32 * wr + 16 * wd + g;
  const float* rv = (wp ? delta : lse) + ((long long)b * H + h) * tq_pad;
  const float row[2] = {rv[r0] * (wp ? 1.f : kLog2e),
                        rv[r0 + 8] * (wp ? 1.f : kLog2e)};
  const float sl2 = scale * kLog2e;

  const int q_last = min(q0 + BR, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;

  copy_rows<D>(smem + L::res0, qb, st.s[1], q0, BR, Tq, threadIdx.x, NT);
  copy_rows<D>(smem + L::res1, dob, st.s[10], q0, BR, Tq, threadIdx.x, NT);
  copy_rows<D>(Ks, kb, st.s[4], 0, BS, Tk, threadIdx.x, NT);
  copy_rows<D>(Vs, vb, st.s[7], 0, BS, Tk, threadIdx.x, NT);
  // this warp's full and vacant mbarriers (CL 2)
  const uint32_t full =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem + L::bars)) +
      8 * warp;
  init_cluster_bars<CL>(full - 8 * warp, 2 * NT / 32);
  cp_async_wait_all();
  __syncthreads();

  // scores: S = Q.K^T (wp 0) or dP = dO.V^T (wp 1), rows 32 wr .., D half
  // wd; the two halves meet in the product's exchange tile
  const float* A = smem + (wp ? L::res1 : L::res0) + 32 * wr * LD +
                   wd * (D / 2);
  const float* Bt = smem + (wp ? L::str1 : L::str0) + wd * (D / 2);
  float* X = smem + (wp ? L::x1 : L::x0) + 32 * wr * XS;
  const float* Xp = smem + L::x0;
  const float* Xd = smem + L::x1;
  const int c0 = warp * (D / 8);          // this warp's output columns
  float acc[4][D / 64][4];
  zero<D>(acc);

  // the dP warps (wp 1, threads 128 ..) copy V, the S warps K: each half
  // waits at its own barrier for what its scores read, so the dP scores
  // of a tile run while its K tile is still on its way
  const int ht = threadIdx.x & 127;
  for (int k0 = 0; k0 < k_end; k0 += BS) {
    const bool more = k0 + BS < k_end;
    float s[2][4][4], f[4][4];
    half_ready(wp);
    score_half<D>(A, Bt, g, t, s);
    meet_halves(X, wd, g, t, s, f);  // barrier: V is no longer read
    if constexpr (CL == 2)
      meet_peer(X + 16 * wd * XS, full, full + 64, (k0 / BS) & 1, lane, f);
    if (more && wp) copy_rows<D>(Vs, vb, st.s[7], k0 + BS, BS, Tk, ht, 128);
    if (wp) {                                          // dp - delta
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) f[n][i] -= row[i >> 1];
    } else {                                           // p
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qpos = r0 + 8 * (i >> 1);
          const int kpos = k0 + 8 * n + 2 * t + (i & 1);
          const bool ok = qpos < Tq && kpos < Tk && (!causal || qpos >= kpos);
          f[n][i] = ok ? ex2(fmaf(f[n][i], sl2, -row[i >> 1])) : 0.f;
        }
    }
    if constexpr (CL == 2) __syncwarp();    // every lane has read Xw
    put(X + 16 * wd * XS, g, t, f);
    __syncthreads();              // p and dp - delta are in
    out_product<D, true>(Xp, Xd, scale, Ks + c0, g, t, acc);
    __syncthreads();              // K and the exchange are no longer read
    if (more && !wp) copy_rows<D>(Ks, kb, st.s[4], k0 + BS, BS, Tk, ht, 128);
  }
  if constexpr (CL == 2) cluster_sync();  // no access to a finished peer
  store<D>(dq + b * st.s[12] + h * st.s[14] + column_half<CL>() * D,
           st.s[13], q0, Tq, c0, g, t, acc);
}

// st: q (0-2), k (3-5), v (6-8), dO (9-11), dK (12-14), dV (15-17).  D,
// CL: as in dQ
template <int D, int CL>
__global__ void __launch_bounds__(NT, 1)
flash_dkv_tf32x3_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, int H,
                        int Tq, int Tk, int tq_pad, Strides st, float scale,
                        int causal) {
  using L = Smem<D, CL>;
  constexpr int LD = L::LD;
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* Qs = smem + L::str0;
  float* dOs = smem + L::str1;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wp = warp >> 2, wr = (warp >> 1) & 1, wd = warp & 1;
  // early keys see the most queries
  const int k0 = blockIdx.x / CL * BR;
  const int h = blockIdx.y, b = blockIdx.z;
  // this CTA's first column (read again for the store: one register less
  // across the tile loop)
  const int cd = column_half<CL>() * D;

  const float* qb = q + b * st.s[0] + h * st.s[2] + cd;
  const float* kb = k + b * st.s[3] + h * st.s[5] + cd;
  const float* vb = v + b * st.s[6] + h * st.s[8] + cd;
  const float* dob = dout + b * st.s[9] + h * st.s[11] + cd;
  // lse (wp 0) or delta (wp 1) by query
  const float* cv = (wp ? delta : lse) + ((long long)b * H + h) * tq_pad;
  const int r0 = k0 + 32 * wr + 16 * wd + g;   // this warp's keys r0, r0 + 8

  // causal: a query tile whose last row precedes k0 sees none of these keys
  const int q_begin = causal ? (k0 / BS) * BS : 0;

  copy_rows<D>(smem + L::res0, kb, st.s[4], k0, BR, Tk, threadIdx.x, NT);
  copy_rows<D>(smem + L::res1, vb, st.s[7], k0, BR, Tk, threadIdx.x, NT);
  if (q_begin < Tq) {
    copy_rows<D>(Qs, qb, st.s[1], q_begin, BS, Tq, threadIdx.x, NT);
    copy_rows<D>(dOs, dob, st.s[10], q_begin, BS, Tq, threadIdx.x, NT);
  }
  // this warp's full and vacant mbarriers (CL 2)
  const uint32_t full =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem + L::bars)) +
      8 * warp;
  init_cluster_bars<CL>(full - 8 * warp, 2 * NT / 32);
  cp_async_wait_all();
  __syncthreads();

  // scores: S^T = K.Q^T (wp 0) or dP^T = V.dO^T (wp 1)
  const float* A = smem + (wp ? L::res1 : L::res0) + 32 * wr * LD +
                   wd * (D / 2);
  const float* Bt = smem + (wp ? L::str1 : L::str0) + wd * (D / 2);
  float* X = smem + (wp ? L::x1 : L::x0) + 32 * wr * XS;
  const float* Xp = smem + L::x0;
  const float* Xd = smem + L::x1;
  const int c0 = warp * (D / 8);
  float dk_acc[4][D / 64][4], dv_acc[4][D / 64][4];
  zero<D>(dk_acc);
  zero<D>(dv_acc);

  // the dP^T warps (wp 1) copy dO, the S^T warps Q, each half waiting at
  // its own barrier (as in dQ)
  const int ht = threadIdx.x & 127;
  for (int q0 = q_begin; q0 < Tq; q0 += BS) {
    const bool more = q0 + BS < Tq;
    float s[2][4][4], f[4][4];
    half_ready(wp);
    score_half<D>(A, Bt, g, t, s);
    meet_halves(X, wd, g, t, s, f);
    if constexpr (CL == 2)
      meet_peer(X + 16 * wd * XS, full, full + 64, ((q0 - q_begin) / BS) & 1,
                lane, f);
    float2 c2[4];                 // lse or delta of queries q0 + 8n + 2t, + 1
#pragma unroll
    for (int n = 0; n < 4; ++n)
      c2[n] = *reinterpret_cast<const float2*>(cv + q0 + 8 * n + 2 * t);
    const float sl2 = scale * kLog2e;
    if (wp) {                                          // dp - delta
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) f[n][i] -= (i & 1) ? c2[n].y : c2[n].x;
    } else {                                           // p
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = r0 + 8 * (i >> 1);
          const int qpos = q0 + 8 * n + 2 * t + (i & 1);
          const bool ok = qpos < Tq && kpos < Tk && (!causal || qpos >= kpos);
          const float l2 = ((i & 1) ? c2[n].y : c2[n].x) * kLog2e;
          f[n][i] = ok ? ex2(fmaf(f[n][i], sl2, -l2)) : 0.f;
        }
    }
    if constexpr (CL == 2) __syncwarp();    // every lane has read Xw
    put(X + 16 * wd * XS, g, t, f);
    __syncthreads();              // p^T and dp^T - delta are in
    out_product<D, false>(Xp, Xd, scale, dOs + c0, g, t, dv_acc);
    __syncthreads();              // dO is no longer read
    if (more && wp)
      copy_rows<D>(dOs, dob, st.s[10], q0 + BS, BS, Tq, ht, 128);
    out_product<D, true>(Xp, Xd, scale, Qs + c0, g, t, dk_acc);
    __syncthreads();              // Q and the exchange are no longer read
    if (more && !wp) copy_rows<D>(Qs, qb, st.s[1], q0 + BS, BS, Tq, ht, 128);
  }
  if constexpr (CL == 2) cluster_sync();  // no access to a finished peer
  store<D>(dk + b * st.s[12] + h * st.s[14] + column_half<CL>() * D,
           st.s[13], k0, Tk, c0, g, t, dk_acc);
  store<D>(dv + b * st.s[15] + h * st.s[17] + column_half<CL>() * D,
           st.s[16], k0, Tk, c0, g, t, dv_acc);
}

// ---------------------------------------------------------------------------
// tf32x3 at head_dim 64 and 128: the narrow plan (header, "Narrow widths")
// ---------------------------------------------------------------------------

// The plan of one narrow kernel: W warps a CTA, each owning M blocks of 16
// resident rows over all of D (R = 16 M W rows a CTA), streamed tiles of
// BS rows in two stages, and the output products' n-blocks taken NC at a
// time, each block's tile sum in registers
template <int W_, int M_, int BS_, int NC_>
struct Plan {
  static constexpr int W = W_, M = M_, BS = BS_, NC = NC_;
  static_assert(BS % 8 == 0, "streamed tiles of 8-row blocks");
};
// each kernel's plan at each width; tf32x3_probe.py times the candidates in
// turns by editing these lines
template <int D>
struct NarrowDq;
template <int D>
struct NarrowDkv;
template <>
struct NarrowDq<64> : Plan<4, 1, 64, 8> {};
template <>
struct NarrowDkv<64> : Plan<4, 1, 64, 8> {};
template <>
struct NarrowDq<128> : Plan<8, 1, 32, 8> {};
template <>
struct NarrowDkv<128> : Plan<8, 1, 32, 4> {};

// Shared memory, in floats: two resident [R][LD] tiles and two stages of
// two streamed [BS][LD] tiles.  LD % 32 == 4, as above
template <int D, class P>
struct NarrowSmem {
  static constexpr int LD = D + 4;
  static constexpr int R = 16 * P::M * P::W;
  static constexpr int NT = 32 * P::W;
  static constexpr int res0 = 0;                 // q | k
  static constexpr int res1 = R * LD;            // dO | v
  static constexpr int str = 2 * R * LD;         // stage s: k, v | q, dO
  static constexpr int stage = 2 * P::BS * LD;
  static constexpr size_t bytes = (str + 2 * stage) * sizeof(float);
  static_assert(bytes <= 232448, "a block has 227 KB of shared memory");
};

// One warp's M blocks of 16 rows of a score product over all of D:
// acc[m][n] = A[16m ..] . B[8n .. 8n + 7]^T, A the warp's rows of a
// resident tile, B the BS rows of a streamed tile; summed on the tensor
// cores from zero.  Each B fragment, split once, serves the M blocks
template <int D, int BS, int M>
__device__ __forceinline__ void score_rows(const float* A, const float* B,
                                           int g, int t,
                                           float (&acc)[M][BS / 8][4]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < BS / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 8) {
    uint32_t ah[M][4], al[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
      frag_a(A + 16 * m * LD + d, LD, g, t, ah[m], al[m]);
#pragma unroll
    for (int n = 0; n < BS / 8; ++n) {
      uint32_t bh[2], bl[2];
      frag_bt(B + 8 * n * LD + d, LD, g, t, bh, bl);
#pragma unroll
      for (int m = 0; m < M; ++m)
        mma_tf32x3(acc[m][n], ah[m], al[m], bh, bl);
    }
  }
}

// acc[m][nb] += X[m] . S[:, 8nb ..] for one warp's M blocks of 16 rows,
// over a tile's BS streamed rows: X the warp's score fragments (p, or ds)
// as they stand in registers, the A operand of k-step kk being fragment kk
// with k permuted as frag_b_perm reads S (the fragment's columns 2t and
// 2t + 1 are A's k slots t and t + 4), S the streamed tile.  NC n-blocks
// at a time, each block's products over the tile summed on the tensor
// cores from zero and then added to acc in f32
template <int D, int BS, int NC, int M>
__device__ __forceinline__ void out_rows(const float (&x)[M][BS / 8][4],
                                         const float* S, int g, int t,
                                         float (&acc)[M][D / 8][4]) {
  constexpr int LD = D + 4;
  static_assert((D / 8) % NC == 0, "n-blocks in whole chunks");
#pragma unroll
  for (int c = 0; c < D / 8; c += NC) {
    float tile[M][NC][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int nb = 0; nb < NC; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) tile[m][nb][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BS / 8; ++kk) {
      uint32_t ah[M][4], al[M][4];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        split_tf32(x[m][kk][0], ah[m][0], al[m][0]);
        split_tf32(x[m][kk][2], ah[m][1], al[m][1]);
        split_tf32(x[m][kk][1], ah[m][2], al[m][2]);
        split_tf32(x[m][kk][3], ah[m][3], al[m][3]);
      }
#pragma unroll
      for (int nb = 0; nb < NC; ++nb) {
        uint32_t bh[2], bl[2];
        frag_b_perm(S + 8 * kk * LD + 8 * (c + nb), LD, g, t, bh, bl);
#pragma unroll
        for (int m = 0; m < M; ++m)
          mma_tf32x3(tile[m][nb], ah[m], al[m], bh, bl);
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int nb = 0; nb < NC; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][c + nb][i] += tile[m][nb][i];
  }
}

template <int D, int M>
__device__ __forceinline__ void zero_rows(float (&acc)[M][D / 8][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][nb][i] = 0.f;
}

// One warp's output rows: this thread's rows r0 + 16m and r0 + 16m + 8,
// those at or past `end` not stored; columns 8nb + 2t and the next
template <int D, int M>
__device__ __forceinline__ void store_rows(float* out, long long ld, int r0,
                                           int end, int t,
                                           const float (&acc)[M][D / 8][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 16 * m + 8 * half;
      if (r >= end) continue;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
        *reinterpret_cast<float2*>(out + r * ld + 8 * nb + 2 * t) =
            make_float2(acc[m][nb][2 * half], acc[m][nb][2 * half + 1]);
    }
}

// st: q (0-2), k (3-5), v (6-8), dO (9-11), dQ (12-14)
template <int D>
__global__ void __launch_bounds__(NarrowSmem<D, NarrowDq<D>>::NT, 1)
flash_dq_tf32x3_narrow_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dq, int H, int Tq, int Tk,
                              int tq_pad, Strides st, float scale,
                              int causal) {
  using P = NarrowDq<D>;
  using L = NarrowSmem<D, P>;
  constexpr int LD = L::LD, BS = P::BS, M = P::M, R = L::R, NT = L::NT;
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;     // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * st.s[3] + h * st.s[5];
  const float* vb = v + b * st.s[6] + h * st.s[8];
  const int w0 = q0 + 16 * M * warp;  // this warp's first row
  const int r0 = w0 + g;              // this thread's rows r0 + 16m (+ 8)
  const long long rows = ((long long)b * H + h) * tq_pad;
  float l2[M][2], dl[M][2];           // their lse (times log2 e) and delta
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 16 * m + 8 * i;
      l2[m][i] = r < Tq ? lse[rows + r] * kLog2e : 0.f;
      dl[m][i] = r < Tq ? delta[rows + r] : 0.f;
    }
  const float sl2 = scale * kLog2e;
  const int q_last = min(q0 + R, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;

  copy_rows<D>(smem + L::res0, q + b * st.s[0] + h * st.s[2], st.s[1], q0, R,
               Tq, threadIdx.x, NT);
  copy_rows<D>(smem + L::res1, dout + b * st.s[9] + h * st.s[11], st.s[10],
               q0, R, Tq, threadIdx.x, NT);
  copy_rows<D>(smem + L::str, kb, st.s[4], 0, BS, Tk, threadIdx.x, NT);
  copy_rows<D>(smem + L::str + BS * LD, vb, st.s[7], 0, BS, Tk, threadIdx.x,
               NT);
  cp_async_commit();
  const float* Qw = smem + L::res0 + 16 * M * warp * LD;
  const float* Ow = smem + L::res1 + 16 * M * warp * LD;
  float acc[M][D / 8][4];
  zero_rows<D, M>(acc);

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
    // a warp whose rows all precede the tile's keys (causal) or lie past Tq
    // adds nothing: p = 0 there
    if (w0 < Tq && (!causal || w0 + 16 * M - 1 >= k0)) {
      float p[M][BS / 8][4], ds[M][BS / 8][4];
      score_rows<D, BS, M>(Qw, Ks, g, t, p);
      // dP first: p's exponentials then run beside its last products
      score_rows<D, BS, M>(Ow, Vs, g, t, ds);
      // masks only where the tile crosses Tk, Tq or the diagonal
      const bool edge = k0 + BS > Tk || w0 + 16 * M > Tq ||
                        (causal && k0 + BS - 1 > w0);
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int n = 0; n < BS / 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float e = ex2(fmaf(p[m][n][i], sl2, -l2[m][i >> 1]));
            const int qpos = r0 + 16 * m + 8 * (i >> 1);
            const int kpos = k0 + 8 * n + 2 * t + (i & 1);
            const bool ok = !edge || (qpos < Tq && kpos < Tk &&
                                      (!causal || qpos >= kpos));
            p[m][n][i] = ok ? e : 0.f;
          }
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int n = 0; n < BS / 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            ds[m][n][i] =
                p[m][n][i] * (ds[m][n][i] - dl[m][i >> 1]) * scale;
      out_rows<D, BS, P::NC, M>(ds, Ks, g, t, acc);
    }
    __syncthreads();                  // this stage is no longer read
  }
  store_rows<D, M>(dq + b * st.s[12] + h * st.s[14], st.s[13], r0, Tq, t,
                   acc);
}

// st: q (0-2), k (3-5), v (6-8), dO (9-11), dK (12-14), dV (15-17)
template <int D>
__global__ void __launch_bounds__(NarrowSmem<D, NarrowDkv<D>>::NT, 1)
flash_dkv_tf32x3_narrow_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv,
                               int H, int Tq, int Tk, int tq_pad, Strides st,
                               float scale, int causal) {
  using P = NarrowDkv<D>;
  using L = NarrowSmem<D, P>;
  constexpr int LD = L::LD, BS = P::BS, M = P::M, R = L::R, NT = L::NT;
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * R;      // early keys (the most queries) first
  const int h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * st.s[0] + h * st.s[2];
  const float* dob = dout + b * st.s[9] + h * st.s[11];
  const int w0 = k0 + 16 * M * warp;  // this warp's first key
  const int r0 = w0 + g;              // this thread's keys r0 + 16m (+ 8)
  const long long rows = ((long long)b * H + h) * tq_pad;
  const float* lr = lse + rows;       // by query
  const float* dr = delta + rows;
  const float sl2 = scale * kLog2e;
  // causal: a query tile whose last row precedes k0 sees none of these keys
  const int q_begin = causal ? (k0 / BS) * BS : 0;

  copy_rows<D>(smem + L::res0, k + b * st.s[3] + h * st.s[5], st.s[4], k0, R,
               Tk, threadIdx.x, NT);
  copy_rows<D>(smem + L::res1, v + b * st.s[6] + h * st.s[8], st.s[7], k0, R,
               Tk, threadIdx.x, NT);
  if (q_begin < Tq) {
    copy_rows<D>(smem + L::str, qb, st.s[1], q_begin, BS, Tq, threadIdx.x,
                 NT);
    copy_rows<D>(smem + L::str + BS * LD, dob, st.s[10], q_begin, BS, Tq,
                 threadIdx.x, NT);
  }
  cp_async_commit();
  const float* Kw = smem + L::res0 + 16 * M * warp * LD;
  const float* Vw = smem + L::res1 + 16 * M * warp * LD;
  float dk_acc[M][D / 8][4], dv_acc[M][D / 8][4];
  zero_rows<D, M>(dk_acc);
  zero_rows<D, M>(dv_acc);

  int s = 0;
  for (int q0 = q_begin; q0 < Tq; q0 += BS, s ^= 1) {
    const float* Qs = smem + L::str + s * L::stage;
    const float* dOs = Qs + BS * LD;
    if (q0 + BS < Tq) {               // the next tile into the other stage
      float* nq = smem + L::str + (s ^ 1) * L::stage;
      copy_rows<D>(nq, qb, st.s[1], q0 + BS, BS, Tq, threadIdx.x, NT);
      copy_rows<D>(nq + BS * LD, dob, st.s[10], q0 + BS, BS, Tq, threadIdx.x,
                   NT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                  // this tile is in, every thread's part
    // a warp whose keys all follow the tile's queries (causal) or lie past
    // Tk adds nothing: p = 0 there
    if (w0 < Tk && (!causal || q0 + BS - 1 >= w0)) {
      float p[M][BS / 8][4], ds[M][BS / 8][4];
      score_rows<D, BS, M>(Kw, Qs, g, t, p);              // S^T = K . Q^T
      const bool edge = q0 + BS > Tq || w0 + 16 * M > Tk ||
                        (causal && q0 < w0 + 16 * M - 1);
#pragma unroll
      for (int n = 0; n < BS / 8; ++n) {
        const int qc = q0 + 8 * n + 2 * t;  // queries qc and qc + 1
        // tq_pad is even: qc < Tq puts qc + 1 inside the row too
        const float2 l = qc < Tq ? *reinterpret_cast<const float2*>(lr + qc)
                                 : make_float2(0.f, 0.f);
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float l2 = ((i & 1) ? l.y : l.x) * kLog2e;
            const float e = ex2(fmaf(p[m][n][i], sl2, -l2));
            const int kpos = r0 + 16 * m + 8 * (i >> 1);
            const int qpos = qc + (i & 1);
            const bool ok = !edge || (qpos < Tq && kpos < Tk &&
                                      (!causal || qpos >= kpos));
            p[m][n][i] = ok ? e : 0.f;
          }
      }
      out_rows<D, BS, P::NC, M>(p, dOs, g, t, dv_acc);    // dV += p^T . dO
      score_rows<D, BS, M>(Vw, dOs, g, t, ds);            // dP^T = V . dO^T
#pragma unroll
      for (int n = 0; n < BS / 8; ++n) {
        const int qc = q0 + 8 * n + 2 * t;
        const float2 d = qc < Tq ? *reinterpret_cast<const float2*>(dr + qc)
                                 : make_float2(0.f, 0.f);
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            ds[m][n][i] = p[m][n][i] *
                          (ds[m][n][i] - ((i & 1) ? d.y : d.x)) * scale;
      }
      out_rows<D, BS, P::NC, M>(ds, Qs, g, t, dk_acc);    // dK += ds^T . Q
    }
    __syncthreads();                  // this stage is no longer read
  }
  cp_async_wait<0>();                 // no copy in flight at exit
  store_rows<D, M>(dk + b * st.s[12] + h * st.s[14], st.s[13], r0, Tk, t,
                   dk_acc);
  store_rows<D, M>(dv + b * st.s[15] + h * st.s[17], st.s[16], r0, Tk, t,
                   dv_acc);
}

Strides copy_strides(const long long* st, int n) {
  Strides s{};
  for (int i = 0; i < n; ++i) s.s[i] = st[i];
  return s;
}

template <int D, int CL>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, int B, int H, int Tq, int Tk, int tq_pad,
              const long long* st, float scale, int causal,
              cudaStream_t stream) {
  return launch_ex<flash_dq_tf32x3_kernel<D, CL>, CL>(
      dim3(CL * ((Tq + BR - 1) / BR), H, B), NT, Smem<D, CL>::bytes, stream,
      q, k, v, dout, lse, delta, dq, H, Tq, Tk, tq_pad, copy_strides(st, 15),
      scale, causal);
}

template <int D, int CL>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, int B, int H, int Tq, int Tk,
               int tq_pad, const long long* st, float scale, int causal,
               cudaStream_t stream) {
  return launch_ex<flash_dkv_tf32x3_kernel<D, CL>, CL>(
      dim3(CL * ((Tk + BR - 1) / BR), H, B), NT, Smem<D, CL>::bytes, stream,
      q, k, v, dout, lse, delta, dk, dv, H, Tq, Tk, tq_pad,
      copy_strides(st, 18), scale, causal);
}

template <int D>
int launch_dq_narrow(const float* q, const float* k, const float* v,
                     const float* dout, const float* lse, const float* delta,
                     float* dq, int B, int H, int Tq, int Tk, int tq_pad,
                     const long long* st, float scale, int causal,
                     cudaStream_t stream) {
  using L = NarrowSmem<D, NarrowDq<D>>;
  return launch_ex<flash_dq_tf32x3_narrow_kernel<D>, 1>(
      dim3((Tq + L::R - 1) / L::R, H, B), L::NT, L::bytes, stream, q, k, v,
      dout, lse, delta, dq, H, Tq, Tk, tq_pad, copy_strides(st, 15), scale,
      causal);
}

template <int D>
int launch_dkv_narrow(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse,
                      const float* delta, float* dk, float* dv, int B, int H,
                      int Tq, int Tk, int tq_pad, const long long* st,
                      float scale, int causal, cudaStream_t stream) {
  using L = NarrowSmem<D, NarrowDkv<D>>;
  return launch_ex<flash_dkv_tf32x3_narrow_kernel<D>, 1>(
      dim3((Tk + L::R - 1) / L::R, H, B), L::NT, L::bytes, stream, q, k, v,
      dout, lse, delta, dk, dv, H, Tq, Tk, tq_pad, copy_strides(st, 18),
      scale, causal);
}

int check_sizes(int B, int H, int Tq, int Tk, int tq_pad) {
  if (Tk <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (tq_pad < Tq || tq_pad % BR) return kErrPad;
  return 0;
}

// dQ of `D` columns: tf32x3 at 64 / 128 (the narrow plan) and 192 / 256
// (one CTA a row tile), tf32x3_xwide at 384 / 512 (a cluster of two CTAs,
// 192 / 256 columns each); any other width, or one of the other variant's,
// is refused
int dq_any(bool xwide, const void* q, const void* k, const void* v,
           const void* dout, const void* lse, const void* delta, void* dq,
           int B, int H, int Tq, int Tk, int D, int tq_pad,
           const long long* st, float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  const int rc = check_sizes(B, H, Tq, Tk, tq_pad);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v),
              *fo = static_cast<const float*>(dout),
              *fl = static_cast<const float*>(lse),
              *fd = static_cast<const float*>(delta);
  float* out = static_cast<float*>(dq);
  switch (xwide ? -D : D) {
    case 64:
      return launch_dq_narrow<64>(fq, fk, fv, fo, fl, fd, out, B, H, Tq, Tk,
                                  tq_pad, st, scale, causal, s);
    case 128:
      return launch_dq_narrow<128>(fq, fk, fv, fo, fl, fd, out, B, H, Tq, Tk,
                                   tq_pad, st, scale, causal, s);
    case 192:
      return launch_dq<192, 1>(fq, fk, fv, fo, fl, fd, out, B, H, Tq, Tk,
                               tq_pad, st, scale, causal, s);
    case 256:
      return launch_dq<256, 1>(fq, fk, fv, fo, fl, fd, out, B, H, Tq, Tk,
                               tq_pad, st, scale, causal, s);
    case -384:
      return launch_dq<192, 2>(fq, fk, fv, fo, fl, fd, out, B, H, Tq, Tk,
                               tq_pad, st, scale, causal, s);
    case -512:
      return launch_dq<256, 2>(fq, fk, fv, fo, fl, fd, out, B, H, Tq, Tk,
                               tq_pad, st, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dK/dV, as dq_any
int dkv_any(bool xwide, const void* q, const void* k, const void* v,
            const void* dout, const void* lse, const void* delta, void* dk,
            void* dv, int B, int H, int Tq, int Tk, int D, int tq_pad,
            const long long* st, float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  const int rc = check_sizes(B, H, Tq, Tk, tq_pad);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v),
              *fo = static_cast<const float*>(dout),
              *fl = static_cast<const float*>(lse),
              *fd = static_cast<const float*>(delta);
  float *ok = static_cast<float*>(dk), *ov = static_cast<float*>(dv);
  switch (xwide ? -D : D) {
    case 64:
      return launch_dkv_narrow<64>(fq, fk, fv, fo, fl, fd, ok, ov, B, H, Tq,
                                   Tk, tq_pad, st, scale, causal, s);
    case 128:
      return launch_dkv_narrow<128>(fq, fk, fv, fo, fl, fd, ok, ov, B, H, Tq,
                                    Tk, tq_pad, st, scale, causal, s);
    case 192:
      return launch_dkv<192, 1>(fq, fk, fv, fo, fl, fd, ok, ov, B, H, Tq, Tk,
                                tq_pad, st, scale, causal, s);
    case 256:
      return launch_dkv<256, 1>(fq, fk, fv, fo, fl, fd, ok, ov, B, H, Tq, Tk,
                                tq_pad, st, scale, causal, s);
    case -384:
      return launch_dkv<192, 2>(fq, fk, fv, fo, fl, fd, ok, ov, B, H, Tq, Tk,
                                tq_pad, st, scale, causal, s);
    case -512:
      return launch_dkv<256, 2>(fq, fk, fv, fo, fl, fd, ok, ov, B, H, Tq, Tk,
                                tq_pad, st, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int code) {
  if (code == kErrPad)
    return "lse/delta row length tq_pad is not a multiple of 64 >= Tq";
  if (code == kErrCluster)
    return "no cluster of two 215 KB CTAs fits on this device";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace

extern "C" {

// q/k/v/dO: f32 [B, T, H, D] with unit stride on D, D 64, 128, 192 or 256;
// `st` holds the (B, T, H) element strides of q, k, v, dO and dq in that
// order.
// Base addresses 16-byte aligned, strides multiples of 4 elements (the
// 16-byte copies).  lse, delta: f32 [B, H, tq_pad], contiguous.  Returns 0
// on success, else a cudaError_t or kErrPad (see
// mxt_flash_bwd_tf32x3_error_string).
int mxt_flash_bwd_tf32x3_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int H, int Tq,
                            int Tk, int D, int tq_pad, const long long* st,
                            float scale, int causal, void* stream) {
  return dq_any(false, q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, D,
                tq_pad, st, scale, causal, stream);
}

// As mxt_flash_bwd_tf32x3_dq; `st` holds the strides of q, k, v, dO, dk
// and dv.  Every dK/dV row is written (rows no query sees get 0).
int mxt_flash_bwd_tf32x3_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int H, int Tq, int Tk, int D, int tq_pad,
                             const long long* st, float scale, int causal,
                             void* stream) {
  return dkv_any(false, q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, D,
                 tq_pad, st, scale, causal, stream);
}

const char* mxt_flash_bwd_tf32x3_error_string(int code) {
  return error_string(code);
}

// tf32x3_xwide: as mxt_flash_bwd_tf32x3_dq / _dkv at D 384 or 512, each
// row tile run by a cluster of two CTAs (D / 2 columns each); also returns
// kErrCluster (see mxt_flash_bwd_tf32x3_xwide_error_string)
int mxt_flash_bwd_tf32x3_xwide_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, int B, int H, int Tq, int Tk,
                                  int D, int tq_pad, const long long* st,
                                  float scale, int causal, void* stream) {
  return dq_any(true, q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, D, tq_pad,
                st, scale, causal, stream);
}

int mxt_flash_bwd_tf32x3_xwide_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int H, int Tq,
                                   int Tk, int D, int tq_pad,
                                   const long long* st, float scale,
                                   int causal, void* stream) {
  return dkv_any(true, q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, D,
                 tq_pad, st, scale, causal, stream);
}

const char* mxt_flash_bwd_tf32x3_xwide_error_string(int code) {
  return error_string(code);
}

}  // extern "C"
