// Flash-attention forward on Hopper's tensor cores (sm_90a), CUDA C++: the
// "wgmma" variant of the forward, for bf16 inputs with head_dim 64 or 128.
//
// Replaces the Pallas TPU kernel mxnet_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (launched by `_fwd`; public `flash_attention` and
// `flash_attention_lse`) and computes the same function as the CUDA-core
// variant in flash_attention.cu:
//
//   s   = (q . k^T) * scale                  f32 scores
//   s   = -1e30 where (k_pos >= kv_len) or (causal and q_pos < k_pos)
//   online softmax over key tiles with running (m, l, acc), p kept to f32
//   accuracy for the P.V product
//   o   = T(acc / l)        (0 where l == 0);  lse = m + log(l)  (f32)
//
// What bounds it on the card: operations.  4*D flops per (q, k) pair
// against 2*D bytes per row read once puts attention at T >= 4096 far above
// the ridge, so the products have to run on the tensor cores, and on Hopper
// their full rate is reached only through wgmma.
//
// Design.
//
// * One CTA of 384 threads per (128 query rows, head, batch): two consumer
//   warpgroups own 64 query rows each, and one thread of a producer
//   warpgroup issues every copy.  setmaxnreg moves registers from the
//   producer (40 a thread) to the consumers (232), which hold the scores,
//   the accumulator and the split p at once.  Heavy (late) q tiles are
//   scheduled first.
// * Copies are TMA loads (cp.async.bulk.tensor, 4-d maps over [B, T, H, D]
//   through the tensors' own strides, so the q/k/v slices of a fused qkv
//   product go in without a copy) into 128-byte-swizzled panels of
//   [rows][64] bf16.  Q is loaded once per CTA; K and V tiles of 128 keys
//   go through a ring of STAGES slots, each with a "full" mbarrier per
//   operand (the TMA's byte count) and an "empty" one per operand (the 256
//   consumer threads' arrivals): a K slot is released as soon as its
//   scores are in registers, a V slot once its product is done, so the
//   next tiles' copies overlap this tile's products.  Rows past the end of
//   a tensor are filled with zeros by the TMA unit; the kv_len mask then
//   drops the keys.
// * Each consumer warpgroup is pipelined by one tile: the scores of tile j
//   and the P.V product of tile j - 1 are issued together, and the softmax
//   of tile j runs on the CUDA cores while that product is in flight.
//   Past the tensor cores, the kernel is bound by the per-score work of
//   the softmax and the split (about 7 instructions a score), so that work
//   is kept small: tiles that need no mask never form s = S * scale (the
//   row max of S times scale is max(s) exactly), and p = exp(s - m) is one
//   FFMA (scale * log2(e) folded in) and one MUFU ex2.
// * S = Q.K^T: wgmma m64n128k16, bf16 operands from shared memory (both
//   K-major), f32 accumulation: the TPU's dot_general(...,
//   preferred_element_type=f32), since bf16 x bf16 products are exact in
//   f32.  `scale` multiplies the f32 scores, as JAX does.
// * P.V with p to f32 accuracy: each f32 p splits into p_hi = bf16(p) and
//   p_lo = bf16(p - p_hi) (the difference is exact in f32), and
//   acc += p_hi.V + p_lo.V by two wgmmas whose A operand comes from
//   registers and whose B operand, V, is read MN-major (transposed) from
//   shared memory.  p_hi + p_lo carries p to about 2^-16 relative, where one
//   bf16 would leave 2^-9 (the TPU kernel upcasts v and keeps p in f32);
//   the price is 1.5x the tensor-core work of a single-bf16 flash kernel.
//   The accumulator layout of the S wgmma is the A-from-registers layout of
//   the P.V wgmma (row, pairs of adjacent columns), so p never goes
//   through shared memory.
// * Key tiles wholly above the causal diagonal are skipped.  Every row has
//   one valid key in the first tile (key 0 under the causal mask), so its
//   running max is finite from then on and a fully masked tile would add
//   exp(-1e30 - m) = 0 to l and acc with alpha = 1: skipping it is exact.
//   Tiles that cross the diagonal or kv_len are masked; the rest are not.
//
// Host side: the tensor maps are built per launch by cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint (no link against libcuda), and
// passed as __grid_constant__ parameters.  Preconditions, checked by the
// Python wrapper: bf16, D in {64, 128}, unit stride on D, 16-byte-aligned
// base addresses and (B, T, H) strides that are multiples of 8 elements.
//
// Plain C interface (no PyTorch headers), called through ctypes.

#include "hopper.cuh"

namespace {

constexpr int BQ = 128;       // query rows per CTA: two warpgroups of 64
constexpr int BK = 128;       // keys per tile
constexpr int STAGES = 2;     // K/V ring slots
constexpr int NCONS = 256;    // consumer threads (warpgroups 0 and 1)
constexpr int NT = NCONS + 128;  // and the producer warpgroup
// registers per thread after the split: 128 x 40 + 256 x 232 = 64512 of
// the SM's 65536; at launch every thread holds 65536 / 384 rounded down
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kNeg = -1e30f;

// Byte offsets in the (1024-aligned) dynamic shared memory.  Every tile is
// D / 64 panels of [rows][64] bf16, 128 bytes a row, swizzled by the TMA
// unit in 1024-byte atoms of 8 rows.
template <int D>
struct Smem {
  static constexpr uint32_t kQBytes = BQ * D * 2;
  static constexpr uint32_t kTileBytes = BK * D * 2;   // one K or V tile
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = q + kQBytes;
  static constexpr uint32_t v = k + STAGES * kTileBytes;
  // full_q, full_k[STAGES], full_v[STAGES], empty_k[STAGES],
  // empty_v[STAGES]
  static constexpr uint32_t bars = v + STAGES * kTileBytes;
  static constexpr size_t alloc = bars + 8 * (1 + 4 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t bar_k(uint32_t bars, int s) {
  return bars + 8 * (1 + s);
}
__device__ __forceinline__ uint32_t bar_v(uint32_t bars, int s) {
  return bars + 8 * (1 + STAGES + s);
}
__device__ __forceinline__ uint32_t bar_empty_k(uint32_t bars, int s) {
  return bars + 8 * (1 + 2 * STAGES + s);
}
__device__ __forceinline__ uint32_t bar_empty_v(uint32_t bars, int s) {
  return bars + 8 * (1 + 3 * STAGES + s);
}

template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v,
                                        uint32_t base, int q0, int h, int b,
                                        int n_tiles) {
  using L = Smem<D>;
  const uint32_t sq = base + L::q, sk = base + L::k, sv = base + L::v;
  const uint32_t bars = base + L::bars;   // bars itself is full_q
  mbar_expect_tx(bars, L::kQBytes);
#pragma unroll
  for (int p = 0; p < D / PANEL; ++p)
    tma_load(sq + p * BQ * 128, tm_q, bars, p * PANEL, h, q0, b);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    // slot s last held tile j - STAGES: wait for its release (K's as soon
    // as its scores are in registers, V's once its product is done)
    const uint32_t parity = ((j / STAGES) - 1) & 1;
    const uint32_t kt = sk + s * L::kTileBytes, vt = sv + s * L::kTileBytes;
    if (j >= STAGES) mbar_wait(bar_empty_k(bars, s), parity);
    mbar_expect_tx(bar_k(bars, s), L::kTileBytes);
#pragma unroll
    for (int p = 0; p < D / PANEL; ++p)
      tma_load(kt + p * BK * 128, tm_k, bar_k(bars, s), p * PANEL, h, j * BK,
               b);
    if (j >= STAGES) mbar_wait(bar_empty_v(bars, s), parity);
    mbar_expect_tx(bar_v(bars, s), L::kTileBytes);
#pragma unroll
    for (int p = 0; p < D / PANEL; ++p)
      tma_load(vt + p * BK * 128, tm_v, bar_v(bars, s), p * PANEL, h, j * BK,
               b);
  }
}

// The scores of one tile, S = Q.K^T in f32: KQ k-steps of wgmma
// m64n128k16 over 16 head dims each, issued and committed as one group.
template <int D>
__device__ __forceinline__ void issue_scores(float (&S)[BK / 2],
                                             uint32_t q_wg, uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 head dims = 32 bytes inside a 128-byte swizzled row; every 4
    // k-steps the next 64-column panel
    const uint64_t da = desc_sw128(q_wg + (kk >> 2) * (BQ * 128) + (kk & 3) * 32,
                                   16, 1024);
    const uint64_t db = desc_sw128(kt + (kk >> 2) * (BK * 128) + (kk & 3) * 32,
                                   16, 1024);
    if (kk == 0)
      wgmma_ss_n128_first(S, da, db);
    else
      wgmma_ss_n128(S, da, db);
  }
  wgmma_commit();
}

// acc += p_hi.V + p_lo.V over the tile's BK keys, issued and committed as
// one group.  V is MN-major: 16 keys (rows of 128 bytes) per k-step.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&ph)[BK / 16][4],
                                         const uint32_t (&pl)[BK / 16][4],
                                         uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = desc_sw128(vt + kk * 16 * 128, BK * 128, 1024);
    wgmma_rs<D>(acc, ph[kk], dv);
    wgmma_rs<D>(acc, pl[kk], dv);
  }
  wgmma_commit();
}

// A consumer warpgroup: 64 query rows.  Software-pipelined by one tile:
// the scores of tile j and the P.V product of tile j - 1 are issued
// together, and the softmax of tile j runs while that product is in
// flight; acc is rescaled and p overwritten only after it completes.
template <int D>
__device__ __forceinline__ void consume(uint32_t base, int q0, int h, int b,
                                        int n_tiles,
                                        __nv_bfloat16* __restrict__ o,
                                        float* __restrict__ lse, int H,
                                        int Tq, long long o_sb,
                                        long long o_st, long long o_sh,
                                        float scale, int causal,
                                        int kv_len) {
  using L = Smem<D>;
  constexpr int NO = D / 2;    // accumulator registers per thread
  constexpr int KP = BK / 16;  // k-steps of P.V
  const uint32_t sk = base + L::k, sv = base + L::v;
  const uint32_t bars = base + L::bars;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  // wgmma's accumulator layout: this thread holds rows r0 and r0 + 8 of
  // the warpgroup's 64, and in each 8-column group the columns cq, cq + 1
  const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = (lane & 3) * 2;
  const int wg_row0 = q0 + wg * 64;
  const uint32_t q_wg = base + L::q + wg * 64 * 128;   // this warpgroup's rows
  // a tile needs the mask where it crosses kv_len or, under the causal
  // mask, holds a key past this warpgroup's first row
  auto masked = [&](int k0) {
    return k0 + BK > kv_len || (causal && k0 + BK - 1 > wg_row0);
  };

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f, al0, al1;
  float S[BK / 2];
  uint32_t ph[KP][4], pl[KP][4];
  mbar_wait(bars, 0);   // Q

  if (n_tiles > 0) {
    mbar_wait(bar_k(bars, 0), 0);
    wgmma_fence();
    issue_scores<D>(S, q_wg, sk);
    wgmma_wait<0>();
    pin(S);
    mbar_arrive(bar_empty_k(bars, 0));
    softmax_step(S, masked(0), 0, r0, r1, cq, scale, causal, kv_len, m0, m1,
                 l0, l1, al0, al1);
    split_hi_lo(S, ph, pl);
  }
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % STAGES, sp = (j - 1) % STAGES;
    mbar_wait(bar_k(bars, s), (j / STAGES) & 1);
    mbar_wait(bar_v(bars, sp), ((j - 1) / STAGES) & 1);
    pin(acc);
    pin(ph);
    pin(pl);
    wgmma_fence();
    issue_scores<D>(S, q_wg, sk + s * L::kTileBytes);
    issue_pv<D>(acc, ph, pl, sv + sp * L::kTileBytes);
    wgmma_wait<1>();                          // the scores are in
    pin(S);
    mbar_arrive(bar_empty_k(bars, s));
    softmax_step(S, masked(j * BK), j * BK, r0, r1, cq, scale, causal,
                 kv_len, m0, m1, l0, l1, al0, al1);
    wgmma_wait<0>();                          // tile j - 1's product too
    pin(acc);
    pin(ph);
    pin(pl);
    mbar_arrive(bar_empty_v(bars, sp));
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= (i & 2) ? al1 : al0;
    split_hi_lo(S, ph, pl);
  }
  if (n_tiles > 0) {
    const int sp = (n_tiles - 1) % STAGES;
    mbar_wait(bar_v(bars, sp), ((n_tiles - 1) / STAGES) & 1);
    pin(acc);
    pin(ph);
    pin(pl);
    wgmma_fence();
    issue_pv<D>(acc, ph, pl, sv + sp * L::kTileBytes);
    wgmma_wait<0>();
    pin(acc);
    pin(ph);
    pin(pl);
    mbar_arrive(bar_empty_v(bars, sp));
  }

  // o = acc / l (0 where l == 0), lse = m + log(l)
  const float safe0 = l0 == 0.f ? 1.f : l0;
  const float safe1 = l1 == 0.f ? 1.f : l1;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + cq;
    if (r0 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * o_st + col) =
          __floats2bfloat162_rn(acc[4 * n] / safe0, acc[4 * n + 1] / safe0);
    if (r1 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * o_st + col) =
          __floats2bfloat162_rn(acc[4 * n + 2] / safe1,
                                acc[4 * n + 3] / safe1);
  }
  if ((lane & 3) == 0) {
    float* lb = lse + ((long long)b * H + h) * Tq;
    if (r0 < Tq) lb[r0] = m0 + logf(safe0);
    if (r1 < Tq) lb[r1] = m1 + logf(safe1);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int H, int Tq, long long o_sb, long long o_st,
                       long long o_sh, float scale, int causal, int kv_len) {
  using L = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + L::bars;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_last = min(q0 + BQ, Tq) - 1;
  const int k_end = causal ? min(kv_len, q_last + 1) : kv_len;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k(bars, s), 1);
      mbar_init(bar_v(bars, s), 1);
      mbar_init(bar_empty_k(bars, s), NCONS);
      mbar_init(bar_empty_v(bars, s), NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if/else for the two roles, never reconverging, so that ptxas
  // applies each setmaxnreg to its whole branch
  if (threadIdx.x >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == NCONS)
      produce<D>(&tm_q, &tm_k, &tm_v, base, q0, h, b, n_tiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<D>(base, q0, h, b, n_tiles, o, lse, H, Tq, o_sb, o_st, o_sh,
               scale, causal, kv_len);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Tq, int Tk, const long long* st, float scale,
           int causal, int kv_len, cudaStream_t stream) {
  constexpr size_t smem = Smem<D>::alloc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, q, B, Tq, H, D, st[0], st[1], st[2], BQ);
  if (rc == 0) rc = make_map(&mk, k, B, Tk, H, D, st[3], st[4], st[5], BK);
  if (rc == 0) rc = make_map(&mv, v, B, Tk, H, D, st[6], st[7], st[8], BK);
  if (rc != 0) return rc;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_wgmma_kernel<D><<<grid, NT, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, H, Tq, st[9], st[10],
      st[11], scale, causal, kv_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v/o: bf16 [B, T, H, D] with unit stride on D, D 64 or 128; `st`
// holds the (B, T, H) element strides of q, k, v and o in that order (a
// size-1 axis may carry any multiple of 8).  Base addresses 16-byte
// aligned, strides multiples of 8 elements.  lse: f32 [B, H, Tq],
// contiguous.  Returns 0 on success, else a cudaError_t or one of the
// codes above (see mxt_flash_wgmma_error_string).
int mxt_flash_wgmma_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int H, int Tq, int Tk, int D,
                        const long long* st, float scale, int causal,
                        int kv_len, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  if (Tk <= 0 || kv_len < 0 || kv_len > Tk || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, l, B, H, Tq, Tk, st, scale, causal,
                        kv_len, s);
    case 128:
      return launch<128>(q, k, v, o, l, B, H, Tq, Tk, st, scale, causal,
                         kv_len, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mxt_flash_wgmma_error_string(int code) {
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a q/k/v layout";
  if (code == kErrNoEntryPoint)
    return "the driver has no cuTensorMapEncodeTiled";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
