// Flash-attention forward on Hopper's tensor cores (sm_90a), CUDA C++: the
// "wgmma_xwide" variant of the forward, for bf16 inputs at head_dim 320,
// 384, 448 or 512 (the wrapper pads head_dim 257-512 to one of them), and
// the "wgmma_xxwide" variant at head_dim 640, 768, 896 or 1024 (the wrapper
// pads head_dim 513-1024 to one of them): the same kernel run by clusters
// of two CTAs that split D (below).  wgmma_xwide's backward sibling is
// flash_attention_bwd_wgmma_xwide.cu (dQ and dK/dV).
//
// Replaces, at those widths, the Pallas TPU kernel
// mxnet_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (launched by `_fwd`;
// public `flash_attention` and `flash_attention_lse`), and computes the same
// function as the wgmma_wide forward (flash_attention_wgmma_wide.cu) at 192
// and 256:
//
//   s   = (q . k^T) * scale                  f32 scores
//   s   = -1e30 where (k_pos >= kv_len) or (causal and q_pos < k_pos)
//   online softmax over key tiles with running (m, l, acc), p kept to f32
//   accuracy for the P.V product
//   o   = bf16(acc / l)     (0 where l == 0);  lse = m + log(l)  (f32)
//
// What bounds it on the card: operations.  4*D flops per (q, k) pair
// against 2*D bytes per row read once puts attention at T >= 4096 far above
// the ridge, so the products have to run on the tensor cores.
//
// Why the wgmma_wide forward does not stretch to these widths: there a
// consumer warpgroup owns 64 query rows over all of D, and at D = 512 its
// f32 accumulator alone would take 256 registers a thread, over the 232
// that setmaxnreg can give a consumer.  So D is cut across the warpgroups,
// as the wgmma_xwide dQ kernel cuts it.
//
// Design.
//
// * One CTA of 384 threads per (64 query rows, head, batch), heavy (late)
//   causal tiles first: one thread of a producer warpgroup issues every
//   copy (setmaxnreg 40), and two consumer warpgroups (232) own the same 64
//   rows.  They split o's n = D / 64 column panels ceil(n / 2) + floor(n /
//   2) (3 + 2, 3 + 3, 4 + 3, 4 + 4): at most 256 columns, 128 accumulator
//   registers a thread, beside the scores of a tile of BK keys (BK / 2)
//   and p split into two bf16 terms (BK / 2): 192 at BK = 64, the
//   wgmma_wide forward's count at 256.
// * S = Q.K^T is split along its reduction axis D: each warpgroup issues
//   the k-steps of its own panels of Q and K (wgmma m64nBKk16, both
//   operands K-major) into a 64 x BK f32 partial, stores it at its own
//   fragment positions into its half of an f32 exchange in shared memory,
//   and after a named barrier of the 256 consumer threads adds the other
//   warpgroup's partial, read at the same positions (the two accumulators
//   have one fragment layout).  IEEE addition commutes, so both
//   warpgroups hold bit-identical S, and each runs the same online softmax
//   (m, l, alpha, p hi / lo) in its own registers: no p exchange, no
//   cross-warpgroup row max, and each warpgroup reads only its half of Q
//   and K from shared memory for S.  A second named barrier, before the
//   next tile's partial is stored, keeps a warpgroup from overwriting its
//   half before the other has read it.  The exchange is stored in 16-byte
//   pieces, piece c of thread t at (c * 128 + t) * 16 of its half: a warp
//   stores and loads 512 contiguous bytes, free of bank conflicts.
// * P.V with p to f32 accuracy: p_hi = bf16(p), p_lo = bf16(p - p_hi), and
//   acc += p_hi.V + p_lo.V with the A operand from registers (the scores'
//   accumulator layout is the A-from-registers layout) on the warpgroup's
//   own column panels of V, read MN-major (one m64nNCk16 a k-step and
//   term, N = 128, 192 or 256).  2*D flops a pair for S and 4*D for P.V:
//   6*D issued tensor-core flops a pair, as the wgmma and wgmma_wide
//   forwards issue, where the function needs 4*D.
// * Each consumer warpgroup is pipelined by one tile, as in wgmma_wide:
//   the partial scores of tile j and the P.V product of tile j - 1 are
//   issued together, and the exchange and the softmax of tile j run on the
//   CUDA cores while that product is in flight.  Tiles that need no mask
//   never form s = S * scale, and p = exp(s - m) is one FFMA and one MUFU
//   ex2.  Only warpgroup 0 writes lse; each warpgroup stores its own
//   columns of o.
// * Shared memory and the ring (Plan, per width): resident Q takes 128 * D
//   bytes, a K + V slot of BK keys 4 * BK * D, the exchange 2 x 64 x BK x 4
//   (of the 227 KB, one slot of 64 keys fits at every width, two of 32 at
//   448 and 512, three at 384, four at 320).  On an H100, two slots of 32
//   keys took about 2 % less time than one of 64 at 448 and 512 (within
//   0.5 % at [1, 4096, 16, 512]), and one of 64 up to 7 % less than three
//   of 32 at 320 and 384 (xwide_plan_probe.py): narrower score products
//   re-read their A operand more often a flop, and one slot overlaps fewer
//   copies.  K and V have separate full / empty mbarriers, as in the
//   wgmma_wide forward: a K slot is released as soon as the partial scores
//   are in registers, a V slot once its product is done, so even with one
//   slot the next K tile loads under P.V.  Rows past the end of a tensor
//   are filled with zeros by the TMA unit; the kv_len mask then drops the
//   keys.
// * Copies are TMA loads (4-d maps over [B, T, H, D] through the tensors'
//   own strides, so the q/k/v slices of a fused qkv product go in without a
//   copy) into 128-byte-swizzled panels of [rows][64] bf16.  `scale`
//   multiplies the f32 scores, as JAX does.  No atomics: two calls on the
//   same inputs give the same bits.
// * Key tiles wholly above the causal diagonal are skipped.  Every row has
//   one valid key in the first tile (key 0 under the causal mask), so its
//   running max is finite from then on and a fully masked tile adds
//   exp(-1e30 - m) = 0 to l and acc with alpha = 1: skipping it is exact.
//
// wgmma_xxwide: above D 512 one CTA holds neither o's 64 x D f32
// accumulator (at 640, 160 registers a consumer thread beside the scores
// and p) nor the tiles (Q and one K + V slot of 32 keys: 240 KB).  So a
// cluster of two CTAs (CL = 2, along grid x) owns each 64-row query tile,
// and CTA c of the pair takes columns c D' .. c D' + D' - 1 of the padded
// width 2 D' (D' = 320, 384, 448 or 512): each is the kernel above at D',
// with its Plan, shared memory, warpgroups and accumulators, its TMA boxes
// on its own half of q, k and v.
//   * After the two warpgroups' partial scores have met (both hold the
//     CTA's half of S, the own warpgroup's term first), each consumer warp
//     pushes that half into the same fragment positions of the peer's
//     exchange, in the other warpgroup's half, where this warp has just read
//     its partner's partial (st.async, 16 bytes a thread NS / 4 times,
//     counted as transaction bytes on the peer warp's `full` mbarrier), and
//     adds the peer's half, which arrives the same way
//     (meet_peer_scores): S = own + peer.  a + b == b + a in IEEE arithmetic, so both CTAs hold the
//     same bits of S and form the same m, alpha, p and l.  The positions
//     are free once the warp has read its partner's partial there, and it
//     says so to the peer's warp by a remote arrival on that warp's
//     `vacant` mbarrier; so the exchange needs no receive buffer, only two
//     8-byte mbarriers a consumer warp, and each warp waits for its
//     counterpart alone (the tf32x3_xwide kernels' plan).  The partner
//     warpgroup stores its next partial there only after barrier 2 of the
//     next tile, which this warp reaches after it has read the peer's.
//   * P.V needs only the CTA's own panels of V: each CTA keeps acc for its
//     D' columns of o and stores them; warpgroup 0 of rank 0 alone writes
//     lse.  No score work is repeated: a pair does the flops of one CTA over
//     all of D.
//   * Both CTAs walk the same key tiles; a cluster barrier after the
//     mbarriers' initialisation and one at the end keep either CTA's
//     shared memory from being reached before it starts or after it ends.
//     No atomics: two calls give the same bits.
// A 2-CTA cluster at up to 209 KB a CTA needs two SMs of one GPC free at
// once; the launcher checks once that one fits
// (cudaOccupancyMaxActiveClusters) and returns kErrCluster if not.
//
// Host side: the tensor maps are built per launch (hopper.cuh), over the
// whole head width; a CTA's boxes start at its first column.
// Preconditions, checked by the Python wrapper: bf16, D in {320, 384, 448,
// 512} (wgmma_xwide) or {640, 768, 896, 1024} (wgmma_xxwide), unit stride
// on D, 16-byte-aligned base addresses and (B, T, H) strides that are
// multiples of 8 elements.
//
// Plain C interface (no PyTorch headers), called through ctypes.

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per CTA, both consumer warpgroups
constexpr int NCONS = 256;    // consumer threads (warpgroups 0 and 1)
constexpr int NT = NCONS + 128;  // and the producer warpgroup
// 128 x 40 + 256 x 232 = 64512 of the SM's 65536 registers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kNeg = -1e30f;
constexpr uint32_t kSmemMax = 232448;   // the 227 KB a block may use

// Keys per tile (BK) and ring slots (ST) per padded width: two slots of 32
// keys at 448 and 512, one slot of 64 at 320 and 384, the faster of the
// two at each width (xwide_plan_probe.py times the other against it).
template <int D>
struct Plan {
  static constexpr int BK = D >= 448 ? 32 : 64;
  static constexpr int ST = D >= 448 ? 2 : 1;
};

// The first column of warpgroup 1's share of D's 64-column panels (the
// larger share to warpgroup 0), and the widths of the two shares.
template <int D>
struct Cols {
  static constexpr int c0 = (D / PANEL + 1) / 2 * PANEL;
  static constexpr int c1 = D - c0;
};

// Byte offsets in the (1024-aligned) dynamic shared memory: Q, the K ring
// and the V ring, the exchange (two f32 [64][BK] partials, one a
// warpgroup), then the barriers full_q, full_k[ST], full_v[ST],
// empty_k[ST], empty_v[ST] and, in a cluster (CL 2), two a consumer warp
// (full[8], vacant[8]).  Every tensor tile is D / 64 panels of [rows][64]
// bf16, 128 bytes a row, swizzled by the TMA unit in 1024-byte atoms of 8
// rows.
template <int D, int CL = 1>
struct Smem {
  static constexpr int BK = Plan<D>::BK;
  static constexpr int ST = Plan<D>::ST;
  static constexpr uint32_t kQBytes = BQ * D * 2;
  static constexpr uint32_t kTileBytes = BK * D * 2;   // one K or V tile
  static constexpr uint32_t kXBytes = BQ * BK * 4;     // one partial
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = q + kQBytes;
  static constexpr uint32_t v = k + ST * kTileBytes;
  static constexpr uint32_t xch = v + ST * kTileBytes;
  static constexpr uint32_t bars = xch + 2 * kXBytes;
  static constexpr uint32_t peer_bars = bars + 8 * (1 + 4 * ST);
  static constexpr size_t alloc =
      peer_bars + (CL == 2 ? 8 * 2 * NCONS / 32 : 0) + 1024;
  static_assert(alloc <= kSmemMax, "over the 227 KB a block may use");
  static_assert(BK == 32 || BK == 64, "a tile is 32 or 64 keys");

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

// d += A.B, A [64 x 16] bf16 in registers (the accumulator layout of
// wgmma, packed in pairs), B [16 x 192] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A.B, A [64 x 16] bf16 in registers (the accumulator layout of
// wgmma, packed in pairs), B [16 x 256] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n192(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n256(d, a, db);
}

// d (= if first, else +=) A.B, A [64 x 16] and B [16 x BK], both K-major in
// shared memory: one k-step of the partial scores
template <int BK>
__device__ __forceinline__ void score_step(float (&d)[BK / 2], uint64_t da,
                                           uint64_t db, bool first);
template <>
__device__ __forceinline__ void score_step<32>(float (&d)[16], uint64_t da,
                                               uint64_t db, bool first) {
  if (first)
    wgmma_n32_first(d, da, db);
  else
    wgmma_n32(d, da, db);
}
template <>
__device__ __forceinline__ void score_step<64>(float (&d)[32], uint64_t da,
                                               uint64_t db, bool first) {
  if (first)
    wgmma_ss_n64_first(d, da, db);
  else
    wgmma_ss_n64(d, da, db);
}

// The 256 consumer threads meet at named barrier `id` (1 or 2; 0 is
// __syncthreads); shared-memory writes before it are visible after it.
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(NCONS) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, float a, float b,
                                             float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// The producer: every copy of the CTA, its columns from cd
template <int D, int CL>
__device__ __forceinline__ void produce(const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v,
                                        uint32_t base, int q0, int h, int b,
                                        int n_tiles, int cd) {
  using L = Smem<D, CL>;
  constexpr int ST = L::ST, BK = L::BK;
  const uint32_t sq = base + L::q, sk = base + L::k, sv = base + L::v;
  const uint32_t bars = base + L::bars;   // bars itself is full_q
  mbar_expect_tx(bars, L::kQBytes);
#pragma unroll
  for (int p = 0; p < D / PANEL; ++p)
    tma_load(sq + p * BQ * 128, tm_q, bars, cd + p * PANEL, h, q0, b);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % ST;
    // slot s last held tile j - ST: wait for its release (K's as soon as
    // its partial scores are in registers, V's once its product is done)
    const uint32_t parity = ((j / ST) - 1) & 1;
    const uint32_t kt = sk + s * L::kTileBytes, vt = sv + s * L::kTileBytes;
    if (j >= ST) mbar_wait(L::empty_k(bars, s), parity);
    mbar_expect_tx(L::full_k(bars, s), L::kTileBytes);
#pragma unroll
    for (int p = 0; p < D / PANEL; ++p)
      tma_load(kt + p * BK * 128, tm_k, L::full_k(bars, s), cd + p * PANEL,
               h, j * BK, b);
    if (j >= ST) mbar_wait(L::empty_v(bars, s), parity);
    mbar_expect_tx(L::full_v(bars, s), L::kTileBytes);
#pragma unroll
    for (int p = 0; p < D / PANEL; ++p)
      tma_load(vt + p * BK * 128, tm_v, L::full_v(bars, s), cd + p * PANEL,
               h, j * BK, b);
  }
}

// This warpgroup's partial scores of one tile, over its NC head dims: NC /
// 16 k-steps of wgmma m64nBKk16, issued and committed as one group.  q and
// kt point at the warpgroup's first panel of Q and of the K tile.
template <int BK, int NC>
__device__ __forceinline__ void issue_scores(float (&S)[BK / 2], uint32_t q,
                                             uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < NC / 16; ++kk) {
    // 16 head dims = 32 bytes inside a 128-byte swizzled row; every 4
    // k-steps the next 64-column panel
    const uint64_t da =
        desc_sw128(q + (kk >> 2) * (BQ * 128) + (kk & 3) * 32, 16, 1024);
    const uint64_t db =
        desc_sw128(kt + (kk >> 2) * (BK * 128) + (kk & 3) * 32, 16, 1024);
    score_step<BK>(S, da, db, kk == 0);
  }
  wgmma_commit();
}

// acc += p_hi.V + p_lo.V over the tile's BK keys on this warpgroup's NC
// columns of V (vt: its first panel), issued and committed as one group.
// V is MN-major: 16 keys (rows of 128 bytes) per k-step; the leading
// offset steps from one 64-column panel to the next.
template <int BK, int NC>
__device__ __forceinline__ void issue_pv(float (&acc)[NC / 2],
                                         const uint32_t (&ph)[BK / 16][4],
                                         const uint32_t (&pl)[BK / 16][4],
                                         uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = desc_sw128(vt + kk * 16 * 128, BK * 128, 1024);
    wgmma_rs<NC>(acc, ph[kk], db);
    wgmma_rs<NC>(acc, pl[kk], db);
  }
  wgmma_commit();
}

// S := this warpgroup's partial + the other's, through the exchange:
// store the own partial (mine), meet the other warpgroup, add its partial
// (other) read at the same fragment positions.  `wait_read`: first meet
// the other warpgroup at barrier 2, after it has read this warpgroup's
// previous partial.
template <int NS>
__device__ __forceinline__ void exchange(float (&S)[NS], uint32_t mine,
                                         uint32_t other, int t,
                                         bool wait_read) {
  if (wait_read) consumers_sync(2);
#pragma unroll
  for (int c = 0; c < NS / 4; ++c)
    st_shared_v4(mine + (c * 128 + t) * 16, S[4 * c], S[4 * c + 1],
                 S[4 * c + 2], S[4 * c + 3]);
  consumers_sync(1);
#pragma unroll
  for (int c = 0; c < NS / 4; ++c) {
    float a, b, x, y;
    ld_shared_v4(other + (c * 128 + t) * 16, a, b, x, y);
    S[4 * c] += a;
    S[4 * c + 1] += b;
    S[4 * c + 2] += x;
    S[4 * c + 3] += y;
  }
}

// The two CTAs of a cluster meet (wgmma_xxwide), after exchange: S holds
// this CTA's half of the scores, and this warp's positions of `other` (the
// other warpgroup's half of the exchange; t: this thread's number in its
// warpgroup) are free, read in exchange.  The warp's lane 0 arms its `full`
// mbarrier for the peer's NS * 128 bytes and tells the peer's warp that
// they are free (a remote arrival on its `vacant`); once the peer's are
// free, each lane pushes its S to the same positions of the peer's
// exchange (st.async, counted on the peer's `full`); once its own `full`
// completes, S += the peer's half (the peer adds this CTA's: a + b == b +
// a, the same bits in both).  Each barrier completes once a tile: `parity`
// is the tile's count mod 2
template <int NS>
__device__ __forceinline__ void meet_peer_scores(float (&S)[NS],
                                                 uint32_t other, int t,
                                                 uint32_t full,
                                                 uint32_t vacant,
                                                 uint32_t parity) {
  const uint32_t peer = cluster_ctarank() ^ 1u;
  __syncwarp();                   // every lane has read the partner's partial
  if ((t & 31) == 0) {
    mbar_expect_tx(full, NS * 128);
    mbar_arrive_remote(cluster_map(vacant, peer));
  }
  mbar_wait_cluster(vacant, parity);  // the peer's positions are free
  const uint32_t dst = cluster_map(other, peer);
  const uint32_t bar = cluster_map(full, peer);
#pragma unroll
  for (int c = 0; c < NS / 4; ++c)
    st_async_v4(dst + (c * 128 + t) * 16, S[4 * c], S[4 * c + 1],
                S[4 * c + 2], S[4 * c + 3], bar);
  mbar_wait_cluster(full, parity);    // the peer's half is in
#pragma unroll
  for (int c = 0; c < NS / 4; ++c) {
    float a, b, x, y;
    ld_shared_v4(other + (c * 128 + t) * 16, a, b, x, y);
    S[4 * c] += a;
    S[4 * c + 1] += b;
    S[4 * c + 2] += x;
    S[4 * c + 3] += y;
  }
}

// A consumer warpgroup: the CTA's 64 query rows on its NC columns from c0
// (also its share of the score product's head dims); cd: the CTA's first
// column of the head (CL 2).  Software-pipelined
// by one tile: the partial scores of tile j and the P.V product of tile j
// - 1 are issued together, and the exchange and the softmax of tile j run
// while that product is in flight; acc is rescaled and p overwritten only
// after it completes.
template <int D, int CL, int NC>
__device__ __forceinline__ void consume(uint32_t base, int q0, int h, int b,
                                        int n_tiles, int c0, int cd,
                                        __nv_bfloat16* __restrict__ o,
                                        float* __restrict__ lse, int H,
                                        int Tq, long long o_sb,
                                        long long o_st, long long o_sh,
                                        float scale, int causal,
                                        int kv_len) {
  using L = Smem<D, CL>;
  constexpr int ST = L::ST, BK = L::BK;
  constexpr int NS = BK / 2;    // score registers per thread
  constexpr int KP = BK / 16;   // k-steps of P.V
  const uint32_t bars = base + L::bars;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  // wgmma's accumulator layout: this thread holds rows r0 and r0 + 8 of
  // the CTA's 64, and in each 8-column group the columns cq, cq + 1
  const int r0 = q0 + warp * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = (lane & 3) * 2;
  // this warpgroup's first panel of Q, and of a K or V tile
  const uint32_t q_wg = base + L::q + (c0 / PANEL) * (BQ * 128);
  const uint32_t col = (c0 / PANEL) * (BK * 128);
  const uint32_t sk = base + L::k + col, sv = base + L::v + col;
  const uint32_t mine = base + L::xch + wg * L::kXBytes;
  const uint32_t other = base + L::xch + (wg ^ 1) * L::kXBytes;
  // this warp's full and vacant mbarriers (CL 2)
  const uint32_t full = base + L::peer_bars + 8 * (tid >> 5);
  // a tile needs the mask where it crosses kv_len or, under the causal
  // mask, holds a key past the CTA's first row
  auto masked = [&](int k0) {
    return k0 + BK > kv_len || (causal && k0 + BK - 1 > q0);
  };

  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f, al0, al1;
  float S[NS];
  uint32_t ph[KP][4], pl[KP][4];
  mbar_wait(bars, 0);   // Q

  if (n_tiles > 0) {
    mbar_wait(L::full_k(bars, 0), 0);
    wgmma_fence();
    issue_scores<BK, NC>(S, q_wg, sk);
    wgmma_wait<0>();
    pin(S);
    mbar_arrive(L::empty_k(bars, 0));
    exchange(S, mine, other, tid & 127, false);
    if constexpr (CL == 2)
      meet_peer_scores(S, other, tid & 127, full, full + 64, 0);
    softmax_step(S, masked(0), 0, r0, r1, cq, scale, causal, kv_len, m0, m1,
                 l0, l1, al0, al1);
    split_hi_lo(S, ph, pl);
  }
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % ST, sp = (j - 1) % ST;
    mbar_wait(L::full_k(bars, s), (j / ST) & 1);
    mbar_wait(L::full_v(bars, sp), ((j - 1) / ST) & 1);
    pin(acc);
    pin(ph);
    pin(pl);
    wgmma_fence();
    issue_scores<BK, NC>(S, q_wg, sk + s * L::kTileBytes);
    issue_pv<BK, NC>(acc, ph, pl, sv + sp * L::kTileBytes);
    wgmma_wait<1>();                          // the partial scores are in
    pin(S);
    mbar_arrive(L::empty_k(bars, s));
    exchange(S, mine, other, tid & 127, true);
    if constexpr (CL == 2)
      meet_peer_scores(S, other, tid & 127, full, full + 64, j & 1);
    softmax_step(S, masked(j * BK), j * BK, r0, r1, cq, scale, causal,
                 kv_len, m0, m1, l0, l1, al0, al1);
    wgmma_wait<0>();                          // tile j - 1's product too
    pin(acc);
    pin(ph);
    pin(pl);
    mbar_arrive(L::empty_v(bars, sp));
    rescale(acc, al0, al1);
    split_hi_lo(S, ph, pl);
  }
  if (n_tiles > 0) {
    const int sp = (n_tiles - 1) % ST;
    mbar_wait(L::full_v(bars, sp), ((n_tiles - 1) / ST) & 1);
    pin(acc);
    pin(ph);
    pin(pl);
    wgmma_fence();
    issue_pv<BK, NC>(acc, ph, pl, sv + sp * L::kTileBytes);
    wgmma_wait<0>();
    pin(acc);
    pin(ph);
    pin(pl);
    mbar_arrive(L::empty_v(bars, sp));
  }

  // o = acc / l (0 where l == 0), lse = m + log(l); both warpgroups hold
  // the same m and l
  const float safe0 = l0 == 0.f ? 1.f : l0;
  const float safe1 = l1 == 0.f ? 1.f : l1;
  store_o_rows(o + b * o_sb + h * o_sh + cd, acc, c0, cq, r0, r1, Tq, o_st,
               safe0, safe1);
  if (wg == 0 && cd == 0 && (lane & 3) == 0) {
    float* lb = lse + ((long long)b * H + h) * Tq;
    if (r0 < Tq) lb[r0] = m0 + logf(safe0);
    if (r1 < Tq) lb[r1] = m1 + logf(safe1);
  }
}

// D: the columns of one CTA; CL: the CTAs of a cluster, which share a tile
// of query rows and split the head's CL * D columns
template <int D, int CL>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma_xwide_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ o,
                             float* __restrict__ lse, int H, int Tq,
                             long long o_sb, long long o_st, long long o_sh,
                             float scale, int causal, int kv_len) {
  using L = Smem<D, CL>;
  using C = Cols<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + L::bars;

  // heavy tiles first
  const int q0 = (gridDim.x / CL - 1 - blockIdx.x / CL) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int cd = column_half<CL>() * D;   // this CTA's first column
  const int q_last = min(q0 + BQ, Tq) - 1;
  const int k_end = causal ? min(kv_len, q_last + 1) : kv_len;
  const int n_tiles = (k_end + L::BK - 1) / L::BK;

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
  init_cluster_bars<CL>(base + L::peer_bars, 2 * NCONS / 32);

  // one if/else for the two roles, never reconverging, so that ptxas
  // applies each setmaxnreg to its whole branch
  if (threadIdx.x >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == NCONS)
      produce<D, CL>(&tm_q, &tm_k, &tm_v, base, q0, h, b, n_tiles, cd);
    if constexpr (CL == 2) {                // no access to a finished peer
      __syncwarp();
      cluster_sync();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    if (C::c0 == C::c1 || threadIdx.x < 128)
      consume<D, CL, C::c0>(base, q0, h, b, n_tiles,
                            (threadIdx.x >> 7) * C::c0, cd, o, lse, H, Tq,
                            o_sb, o_st, o_sh, scale, causal, kv_len);
    else
      consume<D, CL, C::c1>(base, q0, h, b, n_tiles, C::c0, cd, o, lse, H,
                            Tq, o_sb, o_st, o_sh, scale, causal, kv_len);
    if constexpr (CL == 2) {
      __syncwarp();
      cluster_sync();
    }
  }
}

template <int D, int CL>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Tq, int Tk, const long long* st, float scale,
           int causal, int kv_len, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  constexpr int BK = Smem<D, CL>::BK;
  int rc = make_map(&mq, q, B, Tq, H, CL * D, st[0], st[1], st[2], BQ);
  if (rc == 0)
    rc = make_map(&mk, k, B, Tk, H, CL * D, st[3], st[4], st[5], BK);
  if (rc == 0)
    rc = make_map(&mv, v, B, Tk, H, CL * D, st[6], st[7], st[8], BK);
  if (rc != 0) return rc;
  return launch_ex<flash_fwd_wgmma_xwide_kernel<D, CL>, CL>(
      dim3(CL * ((Tq + BQ - 1) / BQ), H, B), NT, Smem<D, CL>::alloc, stream,
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, H, Tq, st[9], st[10],
      st[11], scale, causal, kv_len);
}

// The forward at `D` columns: wgmma_xwide at 320-512 (one CTA a query
// tile), wgmma_xxwide at 640-1024 (a cluster of two CTAs, D / 2 columns
// each); any other width, or one of the other variant's, is refused
int fwd_any(bool xxwide, const void* q, const void* k, const void* v,
            void* o, void* lse, int B, int H, int Tq, int Tk, int D,
            const long long* st, float scale, int causal, int kv_len,
            void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  if (Tk <= 0 || kv_len < 0 || kv_len > Tk || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (xxwide ? -D : D) {
    case 320:
      return launch<320, 1>(q, k, v, o, l, B, H, Tq, Tk, st, scale, causal,
                            kv_len, s);
    case 384:
      return launch<384, 1>(q, k, v, o, l, B, H, Tq, Tk, st, scale, causal,
                            kv_len, s);
    case 448:
      return launch<448, 1>(q, k, v, o, l, B, H, Tq, Tk, st, scale, causal,
                            kv_len, s);
    case 512:
      return launch<512, 1>(q, k, v, o, l, B, H, Tq, Tk, st, scale, causal,
                            kv_len, s);
    case -640:
      return launch<320, 2>(q, k, v, o, l, B, H, Tq, Tk, st, scale, causal,
                            kv_len, s);
    case -768:
      return launch<384, 2>(q, k, v, o, l, B, H, Tq, Tk, st, scale, causal,
                            kv_len, s);
    case -896:
      return launch<448, 2>(q, k, v, o, l, B, H, Tq, Tk, st, scale, causal,
                            kv_len, s);
    case -1024:
      return launch<512, 2>(q, k, v, o, l, B, H, Tq, Tk, st, scale, causal,
                            kv_len, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int code) {
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a q/k/v layout";
  if (code == kErrNoEntryPoint)
    return "libcuda has no cuTensorMapEncodeTiled";
  if (code == kErrCluster)
    return "no cluster of two wgmma_xxwide CTAs fits on this device";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace

extern "C" {

// q/k/v/o: bf16 [B, T, H, D] with unit stride on D, D 320, 384, 448 or 512;
// `st` holds the (B, T, H) element strides of q, k, v and o in that order
// (a size-1 axis may carry any multiple of 8).  Base addresses 16-byte
// aligned, strides multiples of 8 elements.  lse: f32 [B, H, Tq],
// contiguous.  Returns 0 on success, else a cudaError_t or one of the
// codes of hopper.cuh (see mxt_flash_wgmma_xwide_error_string).
int mxt_flash_wgmma_xwide_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int Tq,
                              int Tk, int D, const long long* st, float scale,
                              int causal, int kv_len, void* stream) {
  return fwd_any(false, q, k, v, o, lse, B, H, Tq, Tk, D, st, scale, causal,
                 kv_len, stream);
}

const char* mxt_flash_wgmma_xwide_error_string(int code) {
  return error_string(code);
}

// wgmma_xxwide: as mxt_flash_wgmma_xwide_fwd at D 640, 768, 896 or 1024,
// each query tile run by a cluster of two CTAs (D / 2 columns each); also
// returns kErrCluster (see mxt_flash_wgmma_xxwide_error_string)
int mxt_flash_wgmma_xxwide_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int H, int Tq,
                               int Tk, int D, const long long* st,
                               float scale, int causal, int kv_len,
                               void* stream) {
  return fwd_any(true, q, k, v, o, lse, B, H, Tq, Tk, D, st, scale, causal,
                 kv_len, stream);
}

const char* mxt_flash_wgmma_xxwide_error_string(int code) {
  return error_string(code);
}

}  // extern "C"
