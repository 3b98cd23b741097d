// Flash-attention backward on Hopper's tensor cores (sm_90a), CUDA C++: the
// "wgmma_xwide" variant of the backward, for bf16 inputs at head_dim 320,
// 384, 448 or 512 (the wrapper pads head_dim 257-512 to one of them), and
// the "wgmma_xxwide" variant at head_dim 640, 768, 896 or 1024 (the wrapper
// pads head_dim 513-1024 to one of them): the same kernels run by clusters
// of two CTAs that split D (below).  Its forward sibling is
// flash_attention_wgmma_xwide.cu.
//
// Replaces, at those widths, the Pallas TPU kernels
// mxnet_tpu/ops/pallas/flash_attention.py `_dq_kernel` and `_dkv_kernel`
// (launched together by `_bwd`), and computes the same function as the
// wgmma_wide variant (flash_attention_bwd_wgmma_wide.cu) at 192 and 256:
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
// per unmasked (q, k) pair against a few bytes per row.
//
// Why the wgmma_wide layout does not stretch to these widths: there each
// CTA's two consumer warpgroups split the output's columns, so at D = 512
// each would hold 4 + 4 64-column panels of dK and dV (256 registers a
// thread, over the cap of 255), and dQ's resident Q and dO (128 KB) beside a
// 64-row K/V slot (128 KB) would take 256 KB of shared memory (a block gets
// 227 KB).
//
// Design.  As the wgmma_wide kernels: one TMA producer warpgroup
// (setmaxnreg 40) and two consumer warpgroups (232); 4-d TMA maps over [B,
// T, H, D] through the tensors' strides (the q/k/v views of a fused qkv
// product need no copy) into 128-byte-swizzled panels of [rows][64] bf16;
// a full and an empty mbarrier per ring slot; the f32 operands p and ds
// split into hi = bf16(x) and lo = bf16(x - hi) and traded through a
// swizzled exchange in shared memory, where each output product reads them
// as a K-major A operand twice (hi, lo), so that they keep about 2^-17 of
// f32 accuracy where one bf16 leaves 2^-9.  No CTA of wgmma_xwide reads
// what another writes and there are no atomics, so two calls on the same
// inputs give the same bits.  `scale` multiplies dQ and dK once, at the
// store.  Causal tiles that no query of a CTA sees are not visited.
//
// * The score products split by product, not by rows: per streamed tile,
//   warpgroup 0 computes the product with Q or K (S, S^T) and warpgroup 1
//   the one with dO or V (dP, dP^T), each over all of the tile's BT rows
//   (N = BT).  A score product's A operand, 64 resident rows, is read from
//   shared memory by every wgmma, so halving the number of such products
//   a tile (where the wgmma_wide kernels split each of them by rows)
//   halves those reads, which bound the score products at N <= 32.
//   Warpgroup 0 forms p and stashes its halves; warpgroup 1 reads p back
//   (hi + lo, at the same positions of its own accumulator) to form ds.
// * The streamed tile and the ring (Plan, per width and kernel): resident
//   tensors take 256 * D bytes and a ring slot 4 * BT * D bytes, so a
//   64-row tile fits only at D = 320 (one slot, dK/dV's plan there); dQ at
//   320 and both at 384 take two slots of 32 rows, 448 and 512 one slot of
//   32.  Narrower tiles narrow the score products, which costs more than
//   their copies overlapping the products gains (xwide_plan_probe.py times
//   two slots at every width, of 16 rows at 448 and 512, against these).
//   With one slot, a tile's output products are waited for, and the slot
//   released (one arrival a consumer warp), before the next tile is
//   awaited.
// * dQ: one CTA per (64 query rows, head, batch), heavy causal tiles first.
//   Q and dO are loaded once; K and V tiles stream up to the causal
//   diagonal.  The consumers split dQ's D / 64 panels ceil(n / 2) + floor(n
//   / 2) (3 + 2, 3 + 3, 4 + 3, 4 + 4): at most 256 columns, 128 accumulator
//   registers a thread.  Per tile: S = Q.K^T (warpgroup 0) and dP = dO.V^T
//   (1); p = exp(s - lse) to the exchange; ds = p * (dP - delta) over it;
//   dQ += ds.K over all BT keys, each warpgroup on its columns (K read
//   MN-major).  8 * D tensor-core flops a pair, where the bound counts 6 *
//   D.
// * dK/dV: one CTA per (64 keys, column window, head, batch), early keys
//   (more queries) first.  The 2n accumulator panels of dK and dV do not
//   fit two warpgroups, so the output's columns are cut into two windows
//   on a grid axis: window 0 holds the first ceil(n / 2) panels of dK and
//   of dV, window 1 the rest.  In a window's CTA, warpgroup 0 accumulates
//   dK and warpgroup 1 dV over the window's columns (at most 256, 128
//   registers a thread; the split is even at every width).  K and V are
//   loaded once at full D; Q and dO tiles with their lse and delta (bulk
//   copies) stream from the causal diagonal to Tq.  Per tile: S^T = K.Q^T
//   (warpgroup 0) and dP^T = V.dO^T (1); p^T to the exchange; warpgroup 1
//   issues dV += p^T.dO and forms ds^T = p^T * (dP^T - delta) into the
//   exchange, then warpgroup 0 issues dK += ds^T.Q, both over all BT
//   queries on the window's columns (Q and dO read MN-major).  Both
//   windows' CTAs compute S^T and dP^T over all of D: the window cut
//   recomputes them, 16 * D tensor-core flops a pair (the wgmma_wide kernel
//   does 12 * D), where the bound counts 8 * D.  (The two windows' CTAs
//   as one cluster, each Q / dO tile multicast to both, was slower; PERF.md
//   has the figures.)  Key tiles that no query sees (causal, Tq < Tk)
//   store their zero accumulators: every dK/dV row is written.
// * Three named barriers of the 256 consumer threads order the exchange:
//   one before it is written (both warpgroups' previous output products are
//   done), one when p is in, one when ds is in (each writer makes its
//   writes visible to the tensor cores' reads by fence.proxy.async first).
//   The exchange tiles are [64][64] bf16 with 128-byte rows; a tile of BT <
//   64 columns uses the first BT of each row.
//
// wgmma_xxwide: above D 512 one CTA holds neither the resident tensors and
// a streamed slot (at 640, 160 KB + 80 KB for one 32-row slot) nor dQ's or
// a window's accumulators.  So a cluster of two CTAs (CL = 2, along grid
// x) takes the place of each CTA above, and CTA c of the pair takes
// columns c D' .. c D' + D' - 1 of the padded width 2 D' (D' = 320, 384,
// 448 or 512): each is the kernel above at D', with its Plan, shared
// memory, warpgroups, windows and accumulators, its TMA boxes on its own
// half of every tensor.  dK/dV's clusters of one key tile stay two, one a
// column window (of the CTA's half): four CTAs a key tile.
//   * Each warpgroup's score product (S or S^T in warpgroup 0, dP or dP^T
//     in 1) is then a partial over the CTA's half of D.  Each consumer warp
//     pushes its 16 rows of the partial into its counterpart warp's receive
//     block in the peer CTA (st.async, 16 bytes a lane BT / 8 times,
//     counted as transaction bytes on that warp's `full` mbarrier, once it
//     has said the block is free by a remote arrival on this warp's
//     `vacant`) and adds the peer's, pushed the same way (meet_peer):
//     a + b == b + a in IEEE arithmetic, so both CTAs hold the same bits of
//     S and dP and form the same p and ds (and their hi / lo terms).  No
//     barrier spans the cluster inside the loop: a warp waits for its
//     counterpart alone (the tf32x3_xwide kernels' plan).
//   * The output products need only the CTA's own columns: dQ[:, own] +=
//     ds . K[:, own], dK[:, own] += ds^T . Q[:, own], dV[:, own] += p^T .
//     dO[:, own].  No score work is repeated across the pair: the flops a
//     pair are those of the one-CTA kernels (dQ 8 * D, dK/dV 16 * D).
//   * Receive blocks.  dQ has room for its own: 16 KB, a warp's 2 KB at
//     rx, beside at most 214 KB.  dK/dV (up to 230 KB a CTA) has not, so a
//     warp receives in its own rows of the exchange, free from named
//     barrier 1 (both warpgroups' previous output products are done) until
//     the warp itself overwrites them: warpgroup 0's warp w in its rows of
//     the p^T tiles, where it stashes p^T after reading the peer's S^T,
//     warpgroup 1's warp w in its rows of the ds^T tiles, where it stashes
//     ds^T after reading the peer's dP^T.  So dK/dV meets after barrier 1,
//     dQ before it.
//   * Both CTAs of a pair walk the same tiles; a cluster barrier after the
//     mbarriers' initialisation and one at the end keep either CTA's
//     shared memory from being reached before it starts or after it ends.
//     No atomics: two calls give the same bits.
// A 2-CTA cluster at up to 226 KB a CTA needs two SMs of one GPC free at
// once; the launcher checks once that one fits
// (cudaOccupancyMaxActiveClusters) and returns kErrCluster if not.
//
// Host side: tensor maps are built per launch (hopper.cuh), over the whole
// head width; a CTA's boxes start at its first column.  Preconditions,
// checked by the Python wrapper: bf16, D in {320, 384, 448, 512}
// (wgmma_xwide) or {640, 768, 896, 1024} (wgmma_xxwide), unit stride on D,
// 16-byte-aligned base addresses and (B, T, H) strides that are multiples
// of 8 elements for q, k, v and dO; lse and delta f32 [B, H, tq_pad] with
// tq_pad a multiple of 64 (zeros past Tq).  Outputs [B, T, H, D] through
// their strides.
//
// Plain C interface (no PyTorch headers), called through ctypes.

#include "hopper.cuh"

namespace {

constexpr int BR = 64;        // output rows per CTA
constexpr int NCONS = 256;    // consumer threads (warpgroups 0 and 1)
constexpr int NT = NCONS + 128;  // and the producer warpgroup
// 128 x 40 + 256 x 232 = 64512 of the SM's 65536 registers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr uint32_t kXBytes = BR * PANEL * 2;  // one bf16 [64][64] exchange tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kErrPad = 100003;   // tq_pad not a multiple of 64 or < Tq

// Rows of a streamed tile (BT) and ring slots (STAGES) per padded width,
// for dQ (KV false) and dK/dV (KV true): one slot of 32 rows at 448 and
// 512, two slots of 32 at 384 and for dQ at 320, one slot of 64 for dK/dV
// at 320.
template <int D, bool KV>
struct Plan {
  static constexpr int BT = D == 320 && KV ? 64 : 32;
  static constexpr int STAGES = D == 384 || (D == 320 && !KV) ? 2 : 1;
};

// The first column of the second half of D's 64-column panels (the larger
// share first): dQ's warpgroup 1 and dK/dV's window 1 start there.
template <int D>
struct Cols {
  static constexpr int c0 = (D / PANEL + 1) / 2 * PANEL;
  static constexpr int c1 = D - c0;
};

// Byte offsets in the (1024-aligned) dynamic shared memory: two resident
// tensors of BR rows (dQ: Q, dO; dK/dV: K, V), a ring of STAGES slots of
// two streamed tiles of BT rows (dQ: K, V; dK/dV: Q, dO), the exchange
// (NX bf16 [64][64] tiles: dQ's ds hi/lo; dK/dV's p^T hi/lo and ds^T
// hi/lo) and, for dK/dV (NX = 4), the streamed tile's lse and delta; then,
// for dQ in a cluster (CL 2), the receive blocks of the peer's partials
// (BT * 64 bytes a consumer warp); then the barriers full_res, full[STAGES],
// empty[STAGES] and, in a cluster, two a consumer warp (full[8],
// vacant[8]).  Every tensor tile is D / 64 panels of [rows][64] bf16,
// swizzled by the TMA unit in 1024-byte atoms of 8 rows; the exchange
// tiles are written with the same swizzle.
template <int D, int NX, int CL = 1>
struct Smem {
  static constexpr int BT = Plan<D, NX == 4>::BT;
  static constexpr int STAGES = Plan<D, NX == 4>::STAGES;
  static constexpr uint32_t kResBytes = BR * D * 2;
  static constexpr uint32_t kTileBytes = BT * D * 2;
  static constexpr uint32_t kRowBytes = NX == 4 ? BT * 4 : 0;
  static constexpr uint32_t res0 = 0;
  static constexpr uint32_t res1 = kResBytes;
  static constexpr uint32_t ring0 = 2 * kResBytes;
  static constexpr uint32_t ring1 = ring0 + STAGES * kTileBytes;
  static constexpr uint32_t xch = ring1 + STAGES * kTileBytes;
  static constexpr uint32_t lse = xch + NX * kXBytes;
  static constexpr uint32_t delta = lse + STAGES * kRowBytes;
  static constexpr uint32_t rx = delta + STAGES * kRowBytes;
  static constexpr uint32_t bars =
      rx + (CL == 2 && NX == 2 ? NCONS / 32 * BT * 64 : 0);
  static constexpr uint32_t peer_bars = bars + 8 * (1 + 2 * STAGES);
  static constexpr size_t alloc =
      peer_bars + (CL == 2 ? 8 * 2 * NCONS / 32 : 0) + 1024;
  static_assert(alloc <= 232448, "over the 227 KB a block may use");
  static_assert(BT % 16 == 0 && BT <= 64, "a tile is whole k-steps");
  static_assert(NX == 4 || BT <= 32, "dQ receives one piece a warp");
};

template <int STAGES>
__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) {
  return bars + 8 * (1 + s);
}
template <int STAGES>
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) {
  return bars + 8 * (1 + STAGES + s);
}

// The 256 consumer threads meet at named barrier `id` (1, 2 or 3; 0 is
// __syncthreads): consumers_sync waits for all of them, consumers_arrive
// signals this thread's arrival (its earlier shared-memory writes visible
// to those that wait) and goes on.
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(NCONS) : "memory");
}
__device__ __forceinline__ void consumers_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(NCONS) : "memory");
}

// This thread's shared-memory writes, visible to the tensor cores' reads
// (the async proxy) after the next barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A consumer warp's release of ring slot `bar` (an empty mbarrier): one
// arrival a warp, once all its threads are done with the slot.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// d = A.B (d written, not read): A [64 x 16] and B [16 x 16], both K-major
// in shared memory
__device__ __forceinline__ void wgmma_n16_first(float (&d)[8], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
      : "l"(da), "l"(db), "r"(0));
}

// d += A.B, operands as wgmma_n16_first
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// d += A.B, A [64 x 16] K-major and B [16 x 192] MN-major, both in shared
// memory
__device__ __forceinline__ void wgmma_tb_n192(float (&d)[96], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
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
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// d += A.B, A [64 x 16] K-major and B [16 x 256] MN-major, both in shared
// memory
__device__ __forceinline__ void wgmma_tb_n256(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
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
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tb<192>(float (&d)[96], uint64_t da,
                                              uint64_t db) {
  wgmma_tb_n192(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_tb<256>(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  wgmma_tb_n256(d, da, db);
}

// d (= if first, else +=) A.B with both operands K-major and N = 16, 32
// or 64: the score products over a streamed tile of N rows
template <int N>
__device__ __forceinline__ void wgmma_k(float (&d)[N / 2], uint64_t da,
                                        uint64_t db, bool first);
template <>
__device__ __forceinline__ void wgmma_k<16>(float (&d)[8], uint64_t da,
                                            uint64_t db, bool first) {
  if (first)
    wgmma_n16_first(d, da, db);
  else
    wgmma_n16(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_k<32>(float (&d)[16], uint64_t da,
                                            uint64_t db, bool first) {
  if (first)
    wgmma_n32_first(d, da, db);
  else
    wgmma_n32(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_k<64>(float (&d)[32], uint64_t da,
                                            uint64_t db, bool first) {
  if (first)
    wgmma_ss_n64_first(d, da, db);
  else
    wgmma_ss_n64(d, da, db);
}

// The producer thread: the two resident tensors (rows r_row0..+BR), then
// n_tiles streamed tile pairs (rows t_row0 + j * BT) with, for dK/dV (NX =
// 4), their lse and delta; every tile's D columns from cd.
template <int D, int NX, int CL>
__device__ __forceinline__ void produce(
    const CUtensorMap* tm_r0, const CUtensorMap* tm_r1,
    const CUtensorMap* tm_t0, const CUtensorMap* tm_t1, uint32_t base,
    int r_row0, int t_row0, int h, int b, int n_tiles,
    const float* lse_row, const float* delta_row, int cd) {
  using L = Smem<D, NX, CL>;
  constexpr int BT = L::BT, STAGES = L::STAGES;
  const uint32_t bars = base + L::bars;   // bars itself is full_res
  mbar_expect_tx(bars, 2 * L::kResBytes);
#pragma unroll
  for (int p = 0; p < D / PANEL; ++p) {
    tma_load(base + L::res0 + p * BR * 128, tm_r0, bars, cd + p * PANEL, h,
             r_row0, b);
    tma_load(base + L::res1 + p * BR * 128, tm_r1, bars, cd + p * PANEL, h,
             r_row0, b);
  }
  const uint32_t bytes = 2 * L::kTileBytes + 2 * L::kRowBytes;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int t = t_row0 + j * BT;
    // slot s last held tile j - STAGES: wait for the consumers' release
    if (j >= STAGES)
      mbar_wait(bar_empty<STAGES>(bars, s), ((j / STAGES) - 1) & 1);
    const uint32_t full = bar_full<STAGES>(bars, s);
    mbar_expect_tx(full, bytes);
    const uint32_t t0 = base + L::ring0 + s * L::kTileBytes;
    const uint32_t t1 = base + L::ring1 + s * L::kTileBytes;
#pragma unroll
    for (int p = 0; p < D / PANEL; ++p) {
      tma_load(t0 + p * BT * 128, tm_t0, full, cd + p * PANEL, h, t, b);
      tma_load(t1 + p * BT * 128, tm_t1, full, cd + p * PANEL, h, t, b);
    }
    if (NX == 4) {
      bulk_load(base + L::lse + s * L::kRowBytes, lse_row + t, L::kRowBytes,
                full);
      bulk_load(base + L::delta + s * L::kRowBytes, delta_row + t,
                L::kRowBytes, full);
    }
  }
}

// d = A.B^T over the D head dims, one committed group: A the 64 rows of a
// resident tensor, B the BT rows of a streamed tile at `bt`, both K-major.
template <int D, int BT>
__device__ __forceinline__ void issue_scores(float (&d)[BT / 2], uint32_t a,
                                             uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 head dims = 32 bytes inside a 128-byte swizzled row; every 4
    // k-steps the next 64-column panel
    const uint64_t da =
        desc_sw128(a + (kk >> 2) * (BR * 128) + (kk & 3) * 32, 16, 1024);
    const uint64_t db =
        desc_sw128(bt + (kk >> 2) * (BT * 128) + (kk & 3) * 32, 16, 1024);
    wgmma_k<BT>(d, da, db, kk == 0);
  }
  wgmma_commit();
}

// d += x_hi.B + x_lo.B over a streamed tile's BT rows (not committed): x
// the exchange tiles at hi and hi + kXBytes, [64][BT] K-major; B the NC
// columns of a streamed tile from `bt` on, read MN-major (16 rows of 128
// bytes per k-step; the leading offset steps from one 64-column panel to
// the next).
template <int NC, int BT>
__device__ __forceinline__ void issue_out(float (&d)[NC / 2], uint32_t hi,
                                          uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    const uint64_t db = desc_sw128(bt + kk * 16 * 128, BT * 128, 1024);
    wgmma_tb<NC>(d, desc_sw128(hi + kk * 32, 16, 1024), db);
    wgmma_tb<NC>(d, desc_sw128(hi + kXBytes + kk * 32, 16, 1024), db);
  }
}

// Byte offset, in an exchange tile, of this thread's entry pair 4n + 2e of
// a 64 x BT accumulator (rows warp * 16 + lane / 4 + 8e, columns 8n + cq
// and + 1): [64][64] bf16 with the 128-byte swizzle (16-byte chunk c of
// row r at chunk c ^ (r & 7)).
__device__ __forceinline__ uint32_t xoff(int n, int e, int warp, int lane) {
  const int row = warp * 16 + (lane >> 2) + 8 * e;
  return row * 128 + ((n ^ (lane >> 2)) << 4) + (lane & 3) * 4;
}

// A 64 x BT accumulator x -> hi = bf16(x) into the exchange tile at `hi`,
// lo = bf16(x - hi) into the one after it.  The difference is exact in
// f32: x_hi + x_lo carries x to about 2^-17.
template <int BT>
__device__ __forceinline__ void stash(const float (&x)[BT / 2], uint32_t hi,
                                      int warp, int lane) {
#pragma unroll
  for (int n = 0; n < BT / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {                // rows row and row + 8
      const uint32_t off = hi + xoff(n, e, warp, lane);
      const float a = x[4 * n + 2 * e], c = x[4 * n + 2 * e + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, c);
      const __nv_bfloat162 l =
          __floats2bfloat162_rn(a - __low2float(h), c - __high2float(h));
      st_shared(off, bits(h));
      st_shared(off + kXBytes, bits(l));
    }
  }
}

// x = hi + lo of the entries stash wrote for this thread's positions (the
// other warpgroup's, at the same positions of its accumulator)
template <int BT>
__device__ __forceinline__ void unstash(float (&x)[BT / 2], uint32_t hi,
                                        int warp, int lane) {
#pragma unroll
  for (int n = 0; n < BT / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t off = hi + xoff(n, e, warp, lane);
      const uint32_t h = ld_shared(off), l = ld_shared(off + kXBytes);
      x[4 * n + 2 * e] = __uint_as_float(h << 16) + __uint_as_float(l << 16);
      x[4 * n + 2 * e + 1] = __uint_as_float(h & 0xffff0000u) +
                             __uint_as_float(l & 0xffff0000u);
    }
  }
}

// The two CTAs of a cluster meet (wgmma_xxwide): X holds this warp's 16
// rows of its CTA's partial score product (over the CTA's half of D).  The
// warp's receive block is free here: NS * 128 bytes of f32 in pieces of
// up to 2 KB, piece i at rx + i * kXBytes (a second piece only at BT =
// 64), lane l's chunk c (16 bytes) in piece c / 4 at (c % 4 * 32 + l) *
// 16.  Lane 0 arms the warp's `full` mbarrier for the peer's NS * 128
// bytes and tells the peer's counterpart warp that the block is free (a
// remote arrival on its `vacant`); once the peer's block is free, each
// lane pushes its X there (st.async, counted on the peer's `full`); once
// its own `full` completes, X += the peer's partial (the peer adds this
// CTA's: a + b == b + a, the same bits in both).  Each barrier completes
// once a tile: `parity` is the tile's count mod 2.
template <int NS>
__device__ __forceinline__ void meet_peer(float (&X)[NS], uint32_t rx,
                                          int lane, uint32_t full,
                                          uint32_t vacant, uint32_t parity) {
  const uint32_t peer = cluster_ctarank() ^ 1u;
  __syncwarp();                   // every lane is done with the block
  if (lane == 0) {
    mbar_expect_tx(full, NS * 128);
    mbar_arrive_remote(cluster_map(vacant, peer));
  }
  mbar_wait_cluster(vacant, parity);  // the peer's block is free
  const uint32_t dst = cluster_map(rx, peer);
  const uint32_t bar = cluster_map(full, peer);
#pragma unroll
  for (int c = 0; c < NS / 4; ++c)
    st_async_v4(dst + (c >> 2) * kXBytes + ((c & 3) * 32 + lane) * 16,
                X[4 * c], X[4 * c + 1], X[4 * c + 2], X[4 * c + 3], bar);
  mbar_wait_cluster(full, parity);    // the peer's partial is in
#pragma unroll
  for (int c = 0; c < NS / 4; ++c) {
    float a, b, x, y;
    ld_shared_v4(rx + (c >> 2) * kXBytes + ((c & 3) * 32 + lane) * 16, a, b,
                 x, y);
    X[4 * c] += a;
    X[4 * c + 1] += b;
    X[4 * c + 2] += x;
    X[4 * c + 3] += y;
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
// Per tile, warpgroup 0 computes S = Q.K^T and p from it, warpgroup 1 dP =
// dO.V^T and, from p read back out of the exchange, ds; X[i] is row r0 if
// (i & 2) == 0 else r0 + 8, key k0 + (i >> 2) * 8 + cq + (i & 1) in both.
// ds is accumulated without `scale`, which multiplies dQ once at the
// store.  In a cluster (CL 2) S and dP are met with the peer CTA's
// partials (meet_peer, in the warp's own receive block) before barrier 1.
template <int D, int CL, int NC>
__device__ __forceinline__ void consume_dq(
    uint32_t base, int q0, int n_tiles, int c0,
    const float* __restrict__ lse_row, const float* __restrict__ delta_row,
    __nv_bfloat16* __restrict__ dq, long long dq_st, int Tq, int Tk,
    float scale, int causal) {
  using L = Smem<D, 2, CL>;
  constexpr int BT = L::BT, STAGES = L::STAGES;
  const uint32_t bars = base + L::bars;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = q0 + warp * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = (lane & 3) * 2;
  const uint32_t xch = base + L::xch;
  // warpgroup 0: S from Q and the K tile, and -lse * log2(e); warpgroup 1:
  // dP from dO and the V tile, and delta.  Rows past Tq: p is not masked
  // there, but dO is 0 and delta 0, so ds is 0, and their dQ is never
  // stored
  const uint32_t a_res = base + (wg == 0 ? L::res0 : L::res1);
  const uint32_t b_ring = base + (wg == 0 ? L::ring0 : L::ring1);
  const float* row = wg == 0 ? lse_row : delta_row;
  const float mul = wg == 0 ? -kLog2e : 1.f;
  const float c_0 = r0 < Tq ? row[r0] * mul : 0.f;
  const float c_1 = r1 < Tq ? row[r1] * mul : 0.f;
  const float f = scale * kLog2e;
  // this warp's receive block and its full and vacant mbarriers (CL 2)
  const uint32_t rx = base + L::rx + (tid >> 5) * (BT * 64);
  const uint32_t full = base + L::peer_bars + 8 * (tid >> 5);

  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  float X[BT / 2];
  int held = -1;        // the ring slot the dQ product in flight reads
  mbar_wait(bars, 0);   // Q, dO

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int k0 = j * BT;
    if (STAGES == 1 && held >= 0) {   // the one slot is awaited next
      wgmma_wait<0>();
      pin(acc);
      release(bar_empty<STAGES>(bars, held), lane);
      held = -1;
    }
    mbar_wait(bar_full<STAGES>(bars, s), (j / STAGES) & 1);
    const uint32_t kt = base + L::ring0 + s * L::kTileBytes;
    wgmma_fence();
    issue_scores<D, BT>(X, a_res, b_ring + s * L::kTileBytes);
    wgmma_wait<0>();       // the previous tile's dQ product, S or dP
    pin(X);
    pin(acc);
    if (held >= 0) release(bar_empty<STAGES>(bars, held), lane);
    if constexpr (CL == 2) meet_peer(X, rx, lane, full, full + 64, j & 1);
    consumers_sync(1);     // both warpgroups' previous dQ products are done
    if (wg == 0) {         // p = exp(s - lse), masked, to the exchange
      const bool masked = k0 + BT > Tk || (causal && k0 + BT - 1 > q0);
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) {
        float p = ex2(fmaf(X[i], f, (i & 2) ? c_1 : c_0));
        if (masked) {
          const int kpos = k0 + (i >> 2) * 8 + cq + (i & 1);
          const int qpos = (i & 2) ? r1 : r0;
          if (kpos >= Tk || (causal && qpos < kpos)) p = 0.f;
        }
        X[i] = p;
      }
      stash<BT>(X, xch, warp, lane);
      fence_async_smem();
      consumers_arrive(2);
      consumers_sync(3);   // ds is in
    } else {               // ds = p * (dP - delta), over p in place
      float P[BT / 2];
      consumers_sync(2);   // p is in
      unstash<BT>(P, xch, warp, lane);
#pragma unroll
      for (int i = 0; i < BT / 2; ++i)
        X[i] = P[i] * (X[i] - ((i & 2) ? c_1 : c_0));
      stash<BT>(X, xch, warp, lane);
      fence_async_smem();
      consumers_arrive(3);
    }
    pin(acc);
    wgmma_fence();
    issue_out<NC, BT>(acc, xch, kt + (c0 / PANEL) * BT * 128);
    wgmma_commit();
    held = s;
  }
  wgmma_wait<0>();
  pin(acc);
  if (held >= 0) release(bar_empty<STAGES>(bars, held), lane);
  store_rows<NC>(acc, scale, dq + c0, r0, Tq, dq_st, cq);
}

// A dK/dV consumer warpgroup of a window's CTA: the CTA's 64 keys, on the
// NW columns of the window from c0.  Per tile, warpgroup 0 computes S^T =
// K.Q^T and p^T from it, then dK += ds^T.Q (times `scale` at the store);
// warpgroup 1 computes dP^T = V.dO^T, then dV += p^T.dO and, from p^T read
// back out of the exchange, ds^T = p^T * (dP^T - delta).  X[i] is key row
// r0 if (i & 2) == 0 else r0 + 8, query qt + (i >> 2) * 8 + cq + (i & 1).
// In a cluster (CL 2) S^T and dP^T are met with the peer CTA's partials
// (meet_peer) after barrier 1, in the warp's own rows of the p^T tiles
// (warpgroup 0) or the ds^T tiles (1), which it overwrites next.
template <int D, int CL, int NW>
__device__ __forceinline__ void consume_dkv(
    uint32_t base, const unsigned char* smem, int k0, int q_start,
    int n_tiles, int c0, __nv_bfloat16* __restrict__ out, long long out_st,
    int Tq, int Tk, float scale, int causal) {
  using L = Smem<D, 4, CL>;
  constexpr int BT = L::BT, STAGES = L::STAGES;
  const uint32_t bars = base + L::bars;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = k0 + warp * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = (lane & 3) * 2;
  const uint32_t xp = base + L::xch;              // p^T hi, lo
  const uint32_t xs = xp + 2 * kXBytes;           // ds^T hi, lo
  // warpgroup 0: S^T from K and the Q tile, then dK from ds^T and the Q
  // tile; warpgroup 1: dP^T from V and the dO tile, then dV from p^T and
  // the dO tile
  const uint32_t a_res = base + (wg == 0 ? L::res0 : L::res1);
  const uint32_t b_ring = base + (wg == 0 ? L::ring0 : L::ring1);
  const uint32_t x_out = wg == 0 ? xs : xp;
  const uint32_t col = (c0 / PANEL) * BT * 128;
  const float f = scale * kLog2e;
  // this warp's receive block, its rows of the p^T or the ds^T tiles, and
  // its full and vacant mbarriers (CL 2)
  const uint32_t rx = (wg == 0 ? xp : xs) + warp * (16 * 128);
  const uint32_t full = base + L::peer_bars + 8 * (tid >> 5);

  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  float X[BT / 2];
  int held = -1;        // the ring slot the product in flight reads
  mbar_wait(bars, 0);   // K, V

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int qt = q_start + j * BT;
    if (STAGES == 1 && held >= 0) {   // the one slot is awaited next
      wgmma_wait<0>();
      pin(acc);
      release(bar_empty<STAGES>(bars, held), lane);
      held = -1;
    }
    mbar_wait(bar_full<STAGES>(bars, s), (j / STAGES) & 1);
    const uint32_t tile = b_ring + s * L::kTileBytes;
    const float2* rows = reinterpret_cast<const float2*>(
        smem + (wg == 0 ? L::lse : L::delta) + s * L::kRowBytes);
    wgmma_fence();
    issue_scores<D, BT>(X, a_res, tile);   // S^T or dP^T
    wgmma_wait<0>();       // the previous tile's product, S^T or dP^T
    pin(X);
    pin(acc);
    if (held >= 0) release(bar_empty<STAGES>(bars, held), lane);
    consumers_sync(1);     // both warpgroups' previous products are done
    if constexpr (CL == 2) meet_peer(X, rx, lane, full, full + 64, j & 1);
    if (wg == 0) {         // p^T = exp(s^T - lse), masked, to the exchange
      const bool masked = qt + BT > Tq || k0 + BR > Tk ||
                          (causal && qt < k0 + BR - 1);
#pragma unroll
      for (int n = 0; n < BT / 8; ++n) {
        const float2 l = rows[n * 4 + (cq >> 1)];  // the column pair's lse
        const float nl[2] = {-l.x * kLog2e, -l.y * kLog2e};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(X[4 * n + e], f, nl[e & 1]));
          if (masked) {
            const int qpos = qt + n * 8 + cq + (e & 1);
            const int kpos = (e & 2) ? r1 : r0;
            if (qpos >= Tq || kpos >= Tk || (causal && qpos < kpos))
              p = 0.f;
          }
          X[4 * n + e] = p;
        }
      }
      stash<BT>(X, xp, warp, lane);
      fence_async_smem();
      consumers_arrive(2);
      consumers_sync(3);   // ds^T is in
      pin(acc);
      wgmma_fence();
      issue_out<NW, BT>(acc, x_out, tile + col);   // dK += ds^T.Q
    } else {
      float P[BT / 2];
      consumers_sync(2);   // p^T is in
      pin(acc);
      wgmma_fence();
      issue_out<NW, BT>(acc, x_out, tile + col);   // dV += p^T.dO
      unstash<BT>(P, xp, warp, lane);
#pragma unroll
      for (int n = 0; n < BT / 8; ++n) {
        const float2 dl = rows[n * 4 + (cq >> 1)];  // the pair's delta
        const float dd[2] = {dl.x, dl.y};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          X[4 * n + e] = P[4 * n + e] * (X[4 * n + e] - dd[e & 1]);
      }
      stash<BT>(X, xs, warp, lane);
      fence_async_smem();
      consumers_arrive(3);
    }
    wgmma_commit();
    held = s;
  }
  wgmma_wait<0>();
  pin(acc);
  if (held >= 0) release(bar_empty<STAGES>(bars, held), lane);
  store_rows<NW>(acc, wg == 0 ? scale : 1.f, out + c0, r0, Tk, out_st, cq);
}

// The barriers: full_res and each slot's full (one producer arrival and
// the copies' bytes) and empty (one arrival from each consumer warp).
template <int STAGES>
__device__ __forceinline__ void init_bars(uint32_t bars) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full<STAGES>(bars, s), 1);
      mbar_init(bar_empty<STAGES>(bars, s), NCONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// D: the columns of one CTA; CL: the CTAs of a cluster, which share a tile
// of query rows and split the head's CL * D columns
template <int D, int CL>
__global__ void __launch_bounds__(NT, 1)
flash_dq_wgmma_xwide_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, int H, int Tq,
                            int Tk, int tq_pad, long long dq_sb,
                            long long dq_st, long long dq_sh, float scale,
                            int causal) {
  using L = Smem<D, 2, CL>;
  using C = Cols<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;

  // heavy tiles first
  const int q0 = (gridDim.x / CL - 1 - blockIdx.x / CL) * BR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int cd = column_half<CL>() * D;   // this CTA's first column
  const int q_last = min(q0 + BR, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  const int n_tiles = (k_end + L::BT - 1) / L::BT;
  init_bars<L::STAGES>(base + L::bars);
  init_cluster_bars<CL>(base + L::peer_bars, 2 * NCONS / 32);

  // one if/else for the two roles, never reconverging, so that ptxas
  // applies each setmaxnreg to its whole branch
  if (threadIdx.x >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == NCONS)
      produce<D, 2, CL>(&tm_q, &tm_do, &tm_k, &tm_v, base, q0, 0, h, b,
                        n_tiles, nullptr, nullptr, cd);
    if constexpr (CL == 2) {                // no access to a finished peer
      __syncwarp();
      cluster_sync();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const long long row = ((long long)b * H + h) * tq_pad;
    __nv_bfloat16* out = dq + b * dq_sb + h * dq_sh + cd;
    if (C::c0 == C::c1 || threadIdx.x < 128)
      consume_dq<D, CL, C::c0>(base, q0, n_tiles, (threadIdx.x >> 7) * C::c0,
                               lse + row, delta + row, out, dq_st, Tq, Tk,
                               scale, causal);
    else
      consume_dq<D, CL, C::c1>(base, q0, n_tiles, C::c0, lse + row,
                               delta + row, out, dq_st, Tq, Tk, scale,
                               causal);
    if constexpr (CL == 2) {
      __syncwarp();
      cluster_sync();
    }
  }
}

// D, CL: as in dQ; the CTAs of a cluster share a key tile and a column
// window of their own halves
template <int D, int CL>
__global__ void __launch_bounds__(NT, 1)
flash_dkv_wgmma_xwide_kernel(const __grid_constant__ CUtensorMap tm_q,
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
  using L = Smem<D, 4, CL>;
  using C = Cols<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;

  // (key tile, window) pairs: early keys (more queries) first, the two
  // windows of a key tile side by side
  const int tile = blockIdx.x / CL;
  const int k0 = (tile >> 1) * BR;
  const int window = tile & 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int cd = column_half<CL>() * D;   // this CTA's first column
  // under the causal mask no query before k0 sees a key of this CTA
  const int q_start = causal ? k0 : 0;
  const int n_tiles = q_start < Tq ? (Tq - q_start + L::BT - 1) / L::BT : 0;
  init_bars<L::STAGES>(base + L::bars);
  init_cluster_bars<CL>(base + L::peer_bars, 2 * NCONS / 32);

  if (threadIdx.x >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == NCONS) {
      const long long row = ((long long)b * H + h) * tq_pad;
      produce<D, 4, CL>(&tm_k, &tm_v, &tm_q, &tm_do, base, k0, q_start, h, b,
                        n_tiles, lse + row, delta + row, cd);
    }
    if constexpr (CL == 2) {                // no access to a finished peer
      __syncwarp();
      cluster_sync();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const unsigned char* smem = smem_raw + (base - raw);
    const bool is_dk = threadIdx.x < 128;
    __nv_bfloat16* out = (is_dk ? dk + b * dk_sb + h * dk_sh
                                : dv + b * dv_sb + h * dv_sh) + cd;
    const long long out_st = is_dk ? dk_st : dv_st;
    if (C::c0 == C::c1 || window == 0)
      consume_dkv<D, CL, C::c0>(base, smem, k0, q_start, n_tiles,
                                window * C::c0, out, out_st, Tq, Tk, scale,
                                causal);
    else
      consume_dkv<D, CL, C::c1>(base, smem, k0, q_start, n_tiles, C::c0, out,
                                out_st, Tq, Tk, scale, causal);
    if constexpr (CL == 2) {
      __syncwarp();
      cluster_sync();
    }
  }
}

// The maps of q, k, v and dO (element strides st[0..11]) over W columns:
// q and dO in boxes of q_rows rows, k and v in boxes of kv_rows.
int make_maps(CUtensorMap (&m)[4], const void* q, const void* k,
              const void* v, const void* dout, int B, int H, int Tq, int Tk,
              int W, const long long* st, int q_rows, int kv_rows) {
  int rc = make_map(&m[0], q, B, Tq, H, W, st[0], st[1], st[2], q_rows);
  if (rc == 0)
    rc = make_map(&m[1], k, B, Tk, H, W, st[3], st[4], st[5], kv_rows);
  if (rc == 0)
    rc = make_map(&m[2], v, B, Tk, H, W, st[6], st[7], st[8], kv_rows);
  if (rc == 0)
    rc = make_map(&m[3], dout, B, Tq, H, W, st[9], st[10], st[11], q_rows);
  return rc;
}

template <int D, int CL>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int Tq, int Tk, int tq_pad, const long long* st, float scale,
              int causal, cudaStream_t stream) {
  using L = Smem<D, 2, CL>;
  CUtensorMap m[4];
  const int rc = make_maps(m, q, k, v, dout, B, H, Tq, Tk, CL * D, st, BR,
                           L::BT);
  if (rc != 0) return rc;
  return launch_ex<flash_dq_wgmma_xwide_kernel<D, CL>, CL>(
      dim3(CL * ((Tq + BR - 1) / BR), H, B), NT, L::alloc, stream, m[0],
      m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dq), H, Tq,
      Tk, tq_pad, st[12], st[13], st[14], scale, causal);
}

template <int D, int CL>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int Tq, int Tk, int tq_pad, const long long* st,
               float scale, int causal, cudaStream_t stream) {
  using L = Smem<D, 4, CL>;
  CUtensorMap m[4];
  const int rc = make_maps(m, q, k, v, dout, B, H, Tq, Tk, CL * D, st, L::BT,
                           BR);
  if (rc != 0) return rc;
  return launch_ex<flash_dkv_wgmma_xwide_kernel<D, CL>, CL>(
      dim3(CL * 2 * ((Tk + BR - 1) / BR), H, B), NT, L::alloc, stream, m[0],
      m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Tq, Tk, tq_pad, st[12], st[13],
      st[14], st[15], st[16], st[17], scale, causal);
}

int check_sizes(int B, int H, int Tq, int Tk, int tq_pad) {
  if (Tk <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (tq_pad < Tq || tq_pad % BR) return kErrPad;
  return 0;
}

// dQ at `D` columns: wgmma_xwide at 320-512 (one CTA a query tile),
// wgmma_xxwide at 640-1024 (a cluster of two CTAs, D / 2 columns each);
// any other width, or one of the other variant's, is refused
int dq_any(bool xxwide, const void* q, const void* k, const void* v,
           const void* dout, const void* lse, const void* delta, void* dq,
           int B, int H, int Tq, int Tk, int D, int tq_pad,
           const long long* st, float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  const int rc = check_sizes(B, H, Tq, Tk, tq_pad);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (xxwide ? -D : D) {
#define MXT_DQ(W, DC, CL)                                                    \
  case W:                                                                    \
    return launch_dq<DC, CL>(q, k, v, dout, l, dl, dq, B, H, Tq, Tk, tq_pad, \
                             st, scale, causal, s);
    MXT_DQ(320, 320, 1)
    MXT_DQ(384, 384, 1)
    MXT_DQ(448, 448, 1)
    MXT_DQ(512, 512, 1)
    MXT_DQ(-640, 320, 2)
    MXT_DQ(-768, 384, 2)
    MXT_DQ(-896, 448, 2)
    MXT_DQ(-1024, 512, 2)
#undef MXT_DQ
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dK/dV at `D` columns, as dq_any
int dkv_any(bool xxwide, const void* q, const void* k, const void* v,
            const void* dout, const void* lse, const void* delta, void* dk,
            void* dv, int B, int H, int Tq, int Tk, int D, int tq_pad,
            const long long* st, float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  const int rc = check_sizes(B, H, Tq, Tk, tq_pad);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (xxwide ? -D : D) {
#define MXT_DKV(W, DC, CL)                                                  \
  case W:                                                                   \
    return launch_dkv<DC, CL>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk,   \
                              tq_pad, st, scale, causal, s);
    MXT_DKV(320, 320, 1)
    MXT_DKV(384, 384, 1)
    MXT_DKV(448, 448, 1)
    MXT_DKV(512, 512, 1)
    MXT_DKV(-640, 320, 2)
    MXT_DKV(-768, 384, 2)
    MXT_DKV(-896, 448, 2)
    MXT_DKV(-1024, 512, 2)
#undef MXT_DKV
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int code) {
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a q/k/v/dO layout";
  if (code == kErrNoEntryPoint)
    return "libcuda has no cuTensorMapEncodeTiled entry point";
  if (code == kErrPad)
    return "lse/delta row length tq_pad is not a multiple of 64 >= Tq";
  if (code == kErrCluster)
    return "no cluster of two wgmma_xxwide backward CTAs fits on this device";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace

extern "C" {

// q/k/v/dO: bf16 [B, T, H, D] with unit stride on D, D 320, 384, 448 or
// 512; `st` holds the (B, T, H) element strides of q, k, v, dO and dq in
// that order (a size-1 axis may carry any multiple of 8).  Base addresses
// 16-byte aligned, strides multiples of 8 elements.  lse, delta: f32 [B,
// H, tq_pad], contiguous.  Returns 0 on success, else a cudaError_t or one
// of the codes above (see mxt_flash_bwd_wgmma_xwide_error_string).
int mxt_flash_bwd_wgmma_xwide_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int H,
                                 int Tq, int Tk, int D, int tq_pad,
                                 const long long* st, float scale, int causal,
                                 void* stream) {
  return dq_any(false, q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, D,
                tq_pad, st, scale, causal, stream);
}

// As mxt_flash_bwd_wgmma_xwide_dq; `st` holds the strides of q, k, v, dO,
// dk and dv.  Every dK/dV row is written (rows no query sees get 0).
int mxt_flash_bwd_wgmma_xwide_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int H, int Tq,
                                  int Tk, int D, int tq_pad,
                                  const long long* st, float scale,
                                  int causal, void* stream) {
  return dkv_any(false, q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, D,
                 tq_pad, st, scale, causal, stream);
}

const char* mxt_flash_bwd_wgmma_xwide_error_string(int code) {
  return error_string(code);
}

// wgmma_xxwide: as the two above at D 640, 768, 896 or 1024, each tile of
// rows (and, for dK/dV, column window) run by a cluster of two CTAs (D / 2
// columns each); also returns kErrCluster (see
// mxt_flash_bwd_wgmma_xxwide_error_string)
int mxt_flash_bwd_wgmma_xxwide_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, int B, int H, int Tq, int Tk,
                                  int D, int tq_pad, const long long* st,
                                  float scale, int causal, void* stream) {
  return dq_any(true, q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, D, tq_pad,
                st, scale, causal, stream);
}

int mxt_flash_bwd_wgmma_xxwide_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int H, int Tq,
                                   int Tk, int D, int tq_pad,
                                   const long long* st, float scale,
                                   int causal, void* stream) {
  return dkv_any(true, q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, D,
                 tq_pad, st, scale, causal, stream);
}

const char* mxt_flash_bwd_wgmma_xxwide_error_string(int code) {
  return error_string(code);
}

}  // extern "C"
