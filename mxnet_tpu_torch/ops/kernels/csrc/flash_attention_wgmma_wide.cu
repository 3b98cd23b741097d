// Flash-attention forward on Hopper's tensor cores (sm_90a), CUDA C++: the
// "wgmma_wide" variant of the forward, for bf16 inputs at head_dim 192 or
// 256 (the wrapper pads head_dim 129-256 to one of them).
//
// Replaces, at those widths, the Pallas TPU kernel
// mxnet_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (launched by `_fwd`;
// public `flash_attention` and `flash_attention_lse`), and computes the same
// function as the wgmma variant (flash_attention_wgmma.cu) at head_dim 64
// and 128:
//
//   s   = (q . k^T) * scale                  f32 scores
//   s   = -1e30 where (k_pos >= kv_len) or (causal and q_pos < k_pos)
//   online softmax over key tiles with running (m, l, acc), p kept to f32
//   accuracy for the P.V product
//   o   = bf16(acc / l)     (0 where l == 0);  lse = m + log(l)  (f32)
//
// What bounds it on the card: operations.  4*D flops per (q, k) pair
// against 2*D bytes per row read once puts attention at T >= 4096 far above
// the ridge, so the products have to run on the tensor cores, and on Hopper
// their full rate is reached only through wgmma.
//
// Why the wgmma variant's layout needs shorter key tiles at D = 256: there
// a consumer warpgroup owns 64 query rows over all of D and streams key
// tiles of 128; at D = 256 its accumulator (128 registers a thread), the
// scores of a tile (64) and the split p (64) would take 256 registers, over
// the 232 that setmaxnreg can give a consumer thread.
//
// Design: the wgmma variant's, with key tiles of 64.
//
// * One CTA of 384 threads per (128 query rows, head, batch): two consumer
//   warpgroups own 64 query rows each over all D columns, and one thread of
//   a producer warpgroup issues every copy (setmaxnreg 40 / 232).  A
//   consumer thread holds acc (D / 2 registers: 128 at 256, 96 at 192), the
//   scores of one tile of 64 keys (32) and p split into two bf16 terms (32):
//   192 / 160.  Heavy (late) q tiles are scheduled first.
// * Copies are TMA loads (4-d maps over [B, T, H, D] through the tensors'
//   own strides, so the q/k/v slices of a fused qkv product go in without a
//   copy) into 128-byte-swizzled panels of [rows][64] bf16.  Q stays
//   resident (64 KB at D = 256); K and V tiles of 64 keys go through a ring
//   of as many slots as the 227 KB hold (2 at D = 256: 64 + 128 KB; 3 at
//   192: 48 + 144 KB), each with a "full" mbarrier per operand (the TMA's
//   byte count) and an "empty" one per operand (the 256 consumer threads'
//   arrivals): a K slot is released as soon as its scores are in registers,
//   a V slot once its product is done.  Rows past the end of a tensor are
//   filled with zeros by the TMA unit; the kv_len mask then drops the keys.
// * Each consumer warpgroup is pipelined by one tile: the scores of tile j
//   and the P.V product of tile j - 1 are issued together, and the softmax
//   of tile j runs on the CUDA cores while that product is in flight.  Tiles
//   that need no mask never form s = S * scale, and p = exp(s - m) is one
//   FFMA and one MUFU ex2.
// * S = Q.K^T: wgmma m64n64k16 over D / 16 k-steps, both operands K-major
//   in shared memory, f32 accumulation (bf16 x bf16 products are exact in
//   f32).  `scale` multiplies the f32 scores, as JAX does.
// * P.V with p to f32 accuracy: p_hi = bf16(p), p_lo = bf16(p - p_hi), and
//   acc += p_hi.V + p_lo.V with the A operand from registers (the scores'
//   accumulator layout is the A-from-registers layout) and V read MN-major.
//   N is split over V's panels with the same A fragments: m64n128k16 on
//   columns 0-127, then m64n128k16 (D = 256) or m64n64k16 (D = 192) on the
//   rest.  6*D issued flops a pair where the function needs 4*D.
// * Key tiles wholly above the causal diagonal are skipped.  Every row has
//   one valid key in the first tile (key 0 under the causal mask), so its
//   running max is finite from then on and a fully masked tile adds
//   exp(-1e30 - m) = 0 to l and acc with alpha = 1: skipping it is exact.
//   (The first warpgroup computes the CTA's last tile, which lies above its
//   own diagonal, and adds those zeros; the other warpgroup needs it.)
//
// Head dims 257-512 take the wgmma_xwide forward
// (flash_attention_wgmma_xwide.cu): a third 128-column panel pair would put
// the accumulator alone at 192 registers, so there the two warpgroups
// split D instead of the query rows.
//
// Host side: the tensor maps are built per launch (hopper.cuh).
// Preconditions, checked by the Python wrapper: bf16, D in {192, 256}, unit
// stride on D, 16-byte-aligned base addresses and (B, T, H) strides that
// are multiples of 8 elements.
//
// Plain C interface (no PyTorch headers), called through ctypes.

#include "hopper.cuh"

namespace {

constexpr int BQ = 128;       // query rows per CTA: two warpgroups of 64
constexpr int BK = 64;        // keys per tile
constexpr int NCONS = 256;    // consumer threads (warpgroups 0 and 1)
constexpr int NT = NCONS + 128;  // and the producer warpgroup
// 128 x 40 + 256 x 232 = 64512 of the SM's 65536 registers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int NS = BK / 2;    // score registers per thread
constexpr int KP = BK / 16;   // k-steps of P.V
constexpr float kNeg = -1e30f;
constexpr uint32_t kSmemMax = 232448;   // the 227 KB a block may use

// Byte offsets in the (1024-aligned) dynamic shared memory: Q, then the K
// ring and the V ring, then the barriers full_q, full_k[ST], full_v[ST],
// empty_k[ST], empty_v[ST].  Every tile is D / 64 panels of [rows][64]
// bf16, 128 bytes a row, swizzled by the TMA unit in 1024-byte atoms of 8
// rows.
template <int D>
struct Smem {
  static constexpr uint32_t kQBytes = BQ * D * 2;
  static constexpr uint32_t kTileBytes = BK * D * 2;   // one K or V tile
  static constexpr uint32_t kSlack = 1024 + 256;       // alignment, barriers
  static constexpr int ST =
      (kSmemMax - kSlack - kQBytes) / (2 * kTileBytes) > 4
          ? 4
          : (kSmemMax - kSlack - kQBytes) / (2 * kTileBytes);
  static_assert(ST >= 2, "the K/V ring needs two slots");
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = q + kQBytes;
  static constexpr uint32_t v = k + ST * kTileBytes;
  static constexpr uint32_t bars = v + ST * kTileBytes;
  static constexpr size_t alloc = bars + 8 * (1 + 4 * ST) + 1024;
  static_assert(alloc <= kSmemMax, "over the 227 KB a block may use");

  __device__ static uint32_t full_k(uint32_t b, int s) { return b + 8 * (1 + s); }
  __device__ static uint32_t full_v(uint32_t b, int s) {
    return b + 8 * (1 + ST + s);
  }
  __device__ static uint32_t empty_k(uint32_t b, int s) {
    return b + 8 * (1 + 2 * ST + s);
  }
  __device__ static uint32_t empty_v(uint32_t b, int s) {
    return b + 8 * (1 + 3 * ST + s);
  }
};

template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v,
                                        uint32_t base, int q0, int h, int b,
                                        int n_tiles) {
  using L = Smem<D>;
  constexpr int ST = L::ST;
  const uint32_t sq = base + L::q, sk = base + L::k, sv = base + L::v;
  const uint32_t bars = base + L::bars;   // bars itself is full_q
  mbar_expect_tx(bars, L::kQBytes);
#pragma unroll
  for (int p = 0; p < D / PANEL; ++p)
    tma_load(sq + p * BQ * 128, tm_q, bars, p * PANEL, h, q0, b);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % ST;
    // slot s last held tile j - ST: wait for its release (K's as soon as
    // its scores are in registers, V's once its product is done)
    const uint32_t parity = ((j / ST) - 1) & 1;
    const uint32_t kt = sk + s * L::kTileBytes, vt = sv + s * L::kTileBytes;
    if (j >= ST) mbar_wait(L::empty_k(bars, s), parity);
    mbar_expect_tx(L::full_k(bars, s), L::kTileBytes);
#pragma unroll
    for (int p = 0; p < D / PANEL; ++p)
      tma_load(kt + p * BK * 128, tm_k, L::full_k(bars, s), p * PANEL, h,
               j * BK, b);
    if (j >= ST) mbar_wait(L::empty_v(bars, s), parity);
    mbar_expect_tx(L::full_v(bars, s), L::kTileBytes);
#pragma unroll
    for (int p = 0; p < D / PANEL; ++p)
      tma_load(vt + p * BK * 128, tm_v, L::full_v(bars, s), p * PANEL, h,
               j * BK, b);
  }
}

// The scores of one tile, S = Q.K^T in f32: D / 16 k-steps of wgmma
// m64n64k16 over 16 head dims each, issued and committed as one group.
template <int D>
__device__ __forceinline__ void issue_scores(float (&S)[NS], uint32_t q_wg,
                                             uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 head dims = 32 bytes inside a 128-byte swizzled row; every 4
    // k-steps the next 64-column panel
    const uint64_t da = desc_sw128(q_wg + (kk >> 2) * (BQ * 128) + (kk & 3) * 32,
                                   16, 1024);
    const uint64_t db = desc_sw128(kt + (kk >> 2) * (BK * 128) + (kk & 3) * 32,
                                   16, 1024);
    if (kk == 0)
      wgmma_ss_n64_first(S, da, db);
    else
      wgmma_ss_n64(S, da, db);
  }
  wgmma_commit();
}

// acc += p_hi.V + p_lo.V over the tile's BK keys, issued and committed as
// one group: columns 0-127 into acc_a, the other D - 128 into acc_b, with
// the same A fragments.  V is MN-major: 16 keys (rows of 128 bytes) per
// k-step; the leading offset steps from one 64-column panel to the next.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc_a)[64],
                                         float (&acc_b)[(D - 128) / 2],
                                         const uint32_t (&ph)[KP][4],
                                         const uint32_t (&pl)[KP][4],
                                         uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < KP; ++kk) {
    const uint64_t da = desc_sw128(vt + kk * 16 * 128, BK * 128, 1024);
    const uint64_t db =
        desc_sw128(vt + 2 * BK * 128 + kk * 16 * 128, BK * 128, 1024);
    wgmma_rs<128>(acc_a, ph[kk], da);
    wgmma_rs<128>(acc_a, pl[kk], da);
    wgmma_rs<D - 128>(acc_b, ph[kk], db);
    wgmma_rs<D - 128>(acc_b, pl[kk], db);
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
  constexpr int ST = L::ST;
  constexpr int NB = (D - 128) / 2;   // acc registers past column 127
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

  float acc_a[64], acc_b[NB];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_a[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i) acc_b[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f, al0, al1;
  float S[NS];
  uint32_t ph[KP][4], pl[KP][4];
  mbar_wait(bars, 0);   // Q

  if (n_tiles > 0) {
    mbar_wait(L::full_k(bars, 0), 0);
    wgmma_fence();
    issue_scores<D>(S, q_wg, sk);
    wgmma_wait<0>();
    pin(S);
    mbar_arrive(L::empty_k(bars, 0));
    softmax_step(S, masked(0), 0, r0, r1, cq, scale, causal, kv_len, m0, m1,
                 l0, l1, al0, al1);
    split_hi_lo(S, ph, pl);
  }
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % ST, sp = (j - 1) % ST;
    mbar_wait(L::full_k(bars, s), (j / ST) & 1);
    mbar_wait(L::full_v(bars, sp), ((j - 1) / ST) & 1);
    pin(acc_a);
    pin(acc_b);
    pin(ph);
    pin(pl);
    wgmma_fence();
    issue_scores<D>(S, q_wg, sk + s * L::kTileBytes);
    issue_pv<D>(acc_a, acc_b, ph, pl, sv + sp * L::kTileBytes);
    wgmma_wait<1>();                          // the scores are in
    pin(S);
    mbar_arrive(L::empty_k(bars, s));
    softmax_step(S, masked(j * BK), j * BK, r0, r1, cq, scale, causal,
                 kv_len, m0, m1, l0, l1, al0, al1);
    wgmma_wait<0>();                          // tile j - 1's product too
    pin(acc_a);
    pin(acc_b);
    pin(ph);
    pin(pl);
    mbar_arrive(L::empty_v(bars, sp));
    rescale(acc_a, al0, al1);
    rescale(acc_b, al0, al1);
    split_hi_lo(S, ph, pl);
  }
  if (n_tiles > 0) {
    const int sp = (n_tiles - 1) % ST;
    mbar_wait(L::full_v(bars, sp), ((n_tiles - 1) / ST) & 1);
    pin(acc_a);
    pin(acc_b);
    pin(ph);
    pin(pl);
    wgmma_fence();
    issue_pv<D>(acc_a, acc_b, ph, pl, sv + sp * L::kTileBytes);
    wgmma_wait<0>();
    pin(acc_a);
    pin(acc_b);
    pin(ph);
    pin(pl);
    mbar_arrive(L::empty_v(bars, sp));
  }

  // o = acc / l (0 where l == 0), lse = m + log(l)
  const float safe0 = l0 == 0.f ? 1.f : l0;
  const float safe1 = l1 == 0.f ? 1.f : l1;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
  store_o_rows(ob, acc_a, 0, cq, r0, r1, Tq, o_st, safe0, safe1);
  store_o_rows(ob, acc_b, 128, cq, r0, r1, Tq, o_st, safe0, safe1);
  if ((lane & 3) == 0) {
    float* lb = lse + ((long long)b * H + h) * Tq;
    if (r0 < Tq) lb[r0] = m0 + logf(safe0);
    if (r1 < Tq) lb[r1] = m1 + logf(safe1);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int H, int Tq,
                            long long o_sb, long long o_st, long long o_sh,
                            float scale, int causal, int kv_len) {
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
    for (int s = 0; s < L::ST; ++s) {
      mbar_init(L::full_k(bars, s), 1);
      mbar_init(L::full_v(bars, s), 1);
      mbar_init(L::empty_k(bars, s), NCONS);
      mbar_init(L::empty_v(bars, s), NCONS);
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
      flash_fwd_wgmma_wide_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, q, B, Tq, H, D, st[0], st[1], st[2], BQ);
  if (rc == 0) rc = make_map(&mk, k, B, Tk, H, D, st[3], st[4], st[5], BK);
  if (rc == 0) rc = make_map(&mv, v, B, Tk, H, D, st[6], st[7], st[8], BK);
  if (rc != 0) return rc;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_wgmma_wide_kernel<D><<<grid, NT, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, H, Tq, st[9], st[10],
      st[11], scale, causal, kv_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v/o: bf16 [B, T, H, D] with unit stride on D, D 192 or 256; `st`
// holds the (B, T, H) element strides of q, k, v and o in that order (a
// size-1 axis may carry any multiple of 8).  Base addresses 16-byte
// aligned, strides multiples of 8 elements.  lse: f32 [B, H, Tq],
// contiguous.  Returns 0 on success, else a cudaError_t or one of the
// codes of hopper.cuh (see mxt_flash_wgmma_wide_error_string).
int mxt_flash_wgmma_wide_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Tq, int Tk,
                             int D, const long long* st, float scale,
                             int causal, int kv_len, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  if (Tk <= 0 || kv_len < 0 || kv_len > Tk || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 192:
      return launch<192>(q, k, v, o, l, B, H, Tq, Tk, st, scale, causal,
                         kv_len, s);
    case 256:
      return launch<256>(q, k, v, o, l, B, H, Tq, Tk, st, scale, causal,
                         kv_len, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mxt_flash_wgmma_wide_error_string(int code) {
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a q/k/v layout";
  if (code == kErrNoEntryPoint)
    return "libcuda has no cuTensorMapEncodeTiled";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
