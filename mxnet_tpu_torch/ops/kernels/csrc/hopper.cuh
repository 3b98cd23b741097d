// Hopper (sm_90a) building blocks shared by the tensor-core kernels: the
// bf16 flash kernels (flash_attention_wgmma.cu, the forward;
// flash_attention_bwd_wgmma.cu, dQ and dK/dV; their wgmma_wide twins at
// head_dim 192 and 256; the wgmma_xwide forward, dQ and dK/dV at head_dim
// 320-512, and wgmma_xxwide, the forward at 640-1024 in 2-CTA clusters),
// the f32 flash kernels at head_dim 192 and 256
// (tf32x3: the forward, flash_attention_tf32x3.cu; dQ and dK/dV,
// flash_attention_bwd_tf32x3.cu; each source also holds tf32x3_xwide, its
// kernels at 384 and 512 in 2-CTA clusters) and the int8 matmul
// (int8_matmul.cu).
// mbarriers, TMA loads, 16-byte cp.async copies, 128-byte-swizzled wgmma
// descriptors, the wgmma shapes the kernels issue (bf16 with f32
// accumulation; s8 with s32 accumulation), the flash kernels' hi / lo
// split of an f32 operand (two bf16 terms; two TF32 terms with mma.sync's
// TF32 product, and the tf32x3 kernels' split fragment loads and f32 row
// copies), a cluster's rank, barrier, remote mbarrier arrivals and
// distributed shared memory stores (st.async), the bf16 forwards' online-softmax step and epilogue, and the
// host side: a launch with a cluster dimension (launch_ex), the tensor
// maps over [B, T, H, D] bf16 tensors and over [rows, K] int8 matrices.  Included by each source; everything sits in an anonymous
// namespace, so each library keeps its own copy.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: no link against libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PANEL = 64;     // bf16 columns of one 128-byte swizzled row
// returned when cuTensorMapEncodeTiled refuses a layout (not a cudaError_t)
constexpr int kErrTensorMap = 100001;
constexpr int kErrNoEntryPoint = 100002;


__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of the 4-d map (D, H, T, B) at (c0, c1, c2, c3) into shared
// memory, completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// L2 cache policies for TMA loads: data read once (evict first) and data
// that other CTAs read again (evict last).
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// One box of a 2-d map (inner coordinate c0, row c1) into shared memory,
// completing `bar`'s transaction bytes, under the L2 cache policy `policy`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "l"(policy)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from global into shared memory, completing `bar`'s transaction
// bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  K-major
// operands: the leading offset is unused and the stride offset is 1024 (one
// 8-row atom).  MN-major operands: the leading offset steps from one
// 64-column panel to the next along MN, the stride offset from one 8-row
// group to the next along K.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are pending
// (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers at this point of the program: the compiler may neither
// move their reads and writes across it nor reuse them before it.  Used
// around the asynchronous wgmmas, which read and write registers after the
// instruction that issued them.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x by the MUFU unit alone (results below 2^-126 flush to 0: a p that
// small is below every rounding of the outputs)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// An f32 wgmma accumulator x (NS = N / 2 registers of a 64 x N tile) ->
// x_hi = bf16(x), x_lo = bf16(x - x_hi) (the difference is exact in f32),
// packed in the A-operand layout of a wgmma over those N columns: register
// r of k-step kk holds the pair of entries (2kk + (r >> 1)) * 4 + (r & 1) *
// 2 and the next one.  x_hi + x_lo carries x to about 2^-17 relative.
template <int NS>
__device__ __forceinline__ void split_hi_lo(const float (&x)[NS],
                                            uint32_t (&hi)[NS / 8][4],
                                            uint32_t (&lo)[NS / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = (2 * kk + (r >> 1)) * 4 + (r & 1) * 2;
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[i], x[i + 1]);
      const __nv_bfloat162 l = __floats2bfloat162_rn(
          x[i] - __low2float(h), x[i + 1] - __high2float(h));
      hi[kk][r] = bits(h);
      lo[kk][r] = bits(l);
    }
  }
}

// x -> hi + lo, the operand split of the split-TF32 products: hi is x with
// its 13 low significand bits cleared (a TF32 value), lo = x - hi, exact in
// f32 (|lo| < 2^-10 |x|).  lo goes to the tensor cores as it is: a TF32
// operand's 13 low bits are not read (ptxas itself drops a mask of them
// before an HMMA.TF32), so the product sees lo truncated to 11 significant
// bits, and |x - hi - tf32(lo)| < 2^-20 |x|.  Two ops a value, one of them
// on the integer pipe: the splits run beside every tensor-core product,
// and longer ones (cvt.rna.tf32.f32, 16 results a clock an SM; integer
// rounding; a Veltkamp split of lo) bound the kernels in place of the
// tensor cores.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// d += A·B, TF32 operands and f32 accumulation, in mma.sync's m16n8k8
// fragments (g = lane / 4, t = lane % 4): A [16 x 8] at (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B [8 x 8] at (t, g), (t + 4, g); d [16 x 8]
// at (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A·B to about f32 accuracy on split operands (split_tf32): three
// TF32 products, the small ones first; lo_a·lo_b (under 2^-20 of the
// product) is dropped
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// 16 bytes from global to shared memory by cp.async (cached in L2 only);
// `src_bytes` 0 zero-fills the 16 bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tf32x3 kernels' f32 row copies, by 16-byte cp.async: piece e of
// rows row0 .. of X (row stride ld_x elements, D contiguous floats a row),
// row e / (D / 4), into dst [rows][D + 4]; rows at or past `end` are zeros
template <int D>
__device__ __forceinline__ void copy_piece(float* dst, const float* X,
                                           long long ld_x, int row0, int end,
                                           int e) {
  const int r = e / (D / 4), c = (e % (D / 4)) * 4;
  const int pos = row0 + r;
  const bool in = pos < end;
  cp_async16(dst + r * (D + 4) + c, X + (in ? pos : 0) * ld_x + c,
             in ? 16 : 0);
}

// rows row0 .. row0 + n - 1, by the `nth` threads numbered from threadIdx.x
// - tid (tid: this thread's number among them)
template <int D>
__device__ __forceinline__ void copy_rows(float* dst, const float* X,
                                          long long ld_x, int row0, int n,
                                          int end, int tid, int nth) {
  for (int e = tid; e < n * (D / 4); e += nth)
    copy_piece<D>(dst, X, ld_x, row0, end, e);
}

// The tf32x3 kernels' fragment loads, split as they load (split_tf32), in
// mma.sync's m16n8k8 layout (g = lane / 4, t = lane % 4).  A (16 x 8) of
// a row-major [rows][k] tile at m
__device__ __forceinline__ void frag_a(const float* m, int ld, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(m[g * ld + t], hi[0], lo[0]);
  split_tf32(m[(g + 8) * ld + t], hi[1], lo[1]);
  split_tf32(m[g * ld + t + 4], hi[2], lo[2]);
  split_tf32(m[(g + 8) * ld + t + 4], hi[3], lo[3]);
}

// B (8 x 8) of N^T for a row-major [n][k] tile N at m
__device__ __forceinline__ void frag_bt(const float* m, int ld, int g, int t,
                                        uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split_tf32(m[g * ld + t], hi[0], lo[0]);
  split_tf32(m[g * ld + t + 4], hi[1], lo[1]);
}

// B (8 x 8) of a row-major [k][n] tile at m with k permuted: slot t reads
// row 2t, slot t + 4 row 2t + 1 (the order in which an A fragment read as
// one float2 a row holds columns 2t and 2t + 1)
__device__ __forceinline__ void frag_b_perm(const float* m, int ld, int g,
                                            int t, uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  split_tf32(m[2 * t * ld + g], hi[0], lo[0]);
  split_tf32(m[(2 * t + 1) * ld + g], hi[1], lo[1]);
}

// Thread-block clusters (tf32x3_xwide and wgmma_xxwide: two CTAs that split
// D).
// This CTA's rank in its cluster
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address (shared::cluster window) of the shared::cta address `a`'s
// counterpart in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ uint32_t cluster_map(uint32_t a, uint32_t rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(a), "r"(rank));
  return d;
}

// 16 bytes into another CTA's shared memory at `addr`, counted as
// transaction bytes on its mbarrier `bar` (both shared::cluster addresses):
// the data is visible to a thread that sees the barrier's phase complete
__device__ __forceinline__ void st_async_v4(uint32_t addr, float a, float b,
                                            float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

// 16 bytes of this CTA's shared memory at `addr`
__device__ __forceinline__ void ld_shared_v4(uint32_t addr, float& a,
                                             float& b, float& c, float& d) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(a), "=f"(b), "=f"(c), "=f"(d)
               : "r"(addr)
               : "memory");
}

// An arrival on another CTA's mbarrier (shared::cluster address), ordered
// after this thread's earlier memory accesses (release, cluster scope)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               ::"r"(bar)
               : "memory");
}

// mbar_wait for a barrier that another CTA's threads arrive on: acquire at
// cluster scope
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Makes this thread's mbarrier initialisations visible to the cluster
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The cluster barrier in two halves: arrive publishes this thread's earlier
// writes (release), wait returns once every thread of the cluster has
// arrived and makes their writes visible (acquire).  Each thread
// alternates them; every thread of a warp takes the same one (.aligned)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Both halves: every thread of the cluster is here
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// CL == 2: `n` mbarriers of one arrival each from shared address `bars`
// (8 bytes apart), initialised and made visible to the peer CTA before
// either uses them, by a cluster barrier that every thread of the CTA
// takes
template <int CL>
__device__ __forceinline__ void init_cluster_bars(uint32_t bars, int n) {
  if constexpr (CL == 2) {
    if ((int)threadIdx.x < n) {
      mbar_init(bars + 8 * threadIdx.x, 1);
      fence_mbarrier_init();
    }
    cluster_sync();
  }
}

// This CTA's column half of a width split across a cluster of CL CTAs (0
// unless CL == 2)
template <int CL>
__device__ __forceinline__ int column_half() {
  if constexpr (CL == 2) return (int)cluster_ctarank();
  return 0;
}

// The two CTAs of a cluster meet (the tf32x3_xwide kernels).  f: this
// thread's 16 partial sums of its CTA (A x B, row-major: chunk i is flat
// values 4i .. 4i + 3), Xw: the warp's 512-float block of its exchange
// tile, free here (the warp has read its partner's partial there, and
// nothing else reads it before the caller overwrites it).  The warp's lane
// 0 arms its `full` mbarrier for the peer's 2048 bytes and tells the
// peer's warp that Xw is free (a remote arrival on its `vacant`); once the
// peer's block is free, each lane pushes its 16 values there (st.async,
// counted on the peer's `full`), thread-major (chunk i of lane l at 4 l +
// 128 i); once its own `full` completes it adds the peer's values, f +=
// peer (the peer adds this CTA's: a + b == b + a, the same bits in both).
// Each barrier completes once a tile: `parity` is the tile's count mod 2.
// No cluster-wide barrier: a warp waits for its counterpart alone.  The
// caller syncs the warp before Xw is written again
template <int A, int B>
__device__ __forceinline__ void meet_peer(float* Xw, uint32_t full,
                                          uint32_t vacant, uint32_t parity,
                                          int lane, float (&f)[A][B]) {
  static_assert(A * B == 16 && B % 2 == 0, "16 values, pairs in a row");
  const uint32_t peer = cluster_ctarank() ^ 1u;
  __syncwarp();                   // every lane has read the partner's partial
  if (lane == 0) {
    mbar_expect_tx(full, 2048);
    mbar_arrive_remote(cluster_map(vacant, peer));
  }
  mbar_wait_cluster(vacant, parity);  // the peer's block is free
  const uint32_t dst = cluster_map(
      static_cast<uint32_t>(__cvta_generic_to_shared(Xw)), peer);
  const uint32_t bar = cluster_map(full, peer);
#define MXT_F(k) f[(k) / B][(k) % B]
#pragma unroll
  for (int i = 0; i < 4; ++i)
    st_async_v4(dst + 16u * (lane + 32 * i), MXT_F(4 * i), MXT_F(4 * i + 1),
                MXT_F(4 * i + 2), MXT_F(4 * i + 3), bar);
  mbar_wait_cluster(full, parity);    // the peer's block is in
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 u = *reinterpret_cast<const float4*>(Xw + 4 * lane + 128 * i);
    MXT_F(4 * i) += u.x;
    MXT_F(4 * i + 1) += u.y;
    MXT_F(4 * i + 2) += u.z;
    MXT_F(4 * i + 3) += u.w;
  }
#undef MXT_F
}

// One key tile's online-softmax step of the tensor-core flash forwards,
// on the raw scores S = q.k of an f32 wgmma accumulator (NS registers:
// rows r0 and r1 of this thread, keys from k0): s = S * scale, masked to
// -1e30 where (k_pos >= kv_len) or (causal and q_pos < k_pos) if the tile
// needs the mask; the new running max; alpha = exp(m_old - m_new) per row;
// S := p = exp(s - m_new) in place (f32); l := l * alpha + rowsum(p); m :=
// m_new.  On a tile without the mask, s is never formed: max(S) * scale is
// max(s) exactly (scale > 0), and exp(s - m_new) is 2^(S * scale * log2(e)
// - m_new * log2(e)), one FFMA and one MUFU.  S[i] is row r0 if (i & 2) ==
// 0 else r1, key k0 + (i >> 2) * 8 + cq + (i & 1).  The 4 lanes of a quad
// share a row.
template <int NS>
__device__ __forceinline__ void softmax_step(
    float (&S)[NS], bool masked, int k0, int r0, int r1, int cq,
    float scale, int causal, int kv_len, float& m0, float& m1, float& l0,
    float& l1, float& al0, float& al1) {
  constexpr float kNegS = -1e30f;
  constexpr float kLog2eS = 1.4426950408889634f;
  if (masked) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kpos = k0 + (i >> 2) * 8 + cq + (i & 1);
      const int qpos = (i & 2) ? r1 : r0;
      const bool ok = kpos < kv_len && (!causal || qpos >= kpos);
      S[i] = ok ? S[i] * scale : kNegS;
    }
  }
  float mx0 = kNegS, mx1 = kNegS;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (i & 2)
      mx1 = fmaxf(mx1, S[i]);
    else
      mx0 = fmaxf(mx0, S[i]);
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  if (!masked) {
    mx0 *= scale;
    mx1 *= scale;
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  al0 = ex2((m0 - mn0) * kLog2eS);
  al1 = ex2((m1 - mn1) * kLog2eS);
  const float f = masked ? kLog2eS : scale * kLog2eS;
  const float b0 = -mn0 * kLog2eS, b1 = -mn1 * kLog2eS;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (i & 2) {
      S[i] = ex2(fmaf(S[i], f, b1));
      rs1 += S[i];
    } else {
      S[i] = ex2(fmaf(S[i], f, b0));
      rs0 += S[i];
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
  }
  l0 = l0 * al0 + rs0;
  l1 = l1 * al1 + rs1;
  m0 = mn0;
  m1 = mn1;
}

// The bf16 forwards' epilogue helpers (flash_attention_wgmma_wide.cu,
// flash_attention_wgmma_xwide.cu), on f32 wgmma accumulators of rows r0
// and r1 = r0 + 8: acc *= alpha of its row (register i holds row r0 if (i
// & 2) == 0) ...
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], float al0,
                                        float al1) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= (i & 2) ? al1 : al0;
}

// ... and o's columns c0 .. c0 + 2N - 1 of rows r0 and r1 from acc [N] /
// l, rows at and past Tq not written
template <int N>
__device__ __forceinline__ void store_o_rows(__nv_bfloat16* ob,
                                             const float (&acc)[N], int c0,
                                             int cq, int r0, int r1, int Tq,
                                             long long o_st, float safe0,
                                             float safe1) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    const int col = c0 + n * 8 + cq;
    if (r0 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * o_st + col) =
          __floats2bfloat162_rn(acc[4 * n] / safe0, acc[4 * n + 1] / safe0);
    if (r1 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * o_st + col) =
          __floats2bfloat162_rn(acc[4 * n + 2] / safe1,
                                acc[4 * n + 3] / safe1);
  }
}

// The wide backwards' products (flash_attention_bwd_wgmma_wide.cu,
// flash_attention_bwd_wgmma_xwide.cu): score products with N = 32 and
// output products whose B operand is read MN-major.
// d = A.B (d written, not read): A [64 x 16] and B [16 x 32], both K-major
// in shared memory
__device__ __forceinline__ void wgmma_n32_first(float (&d)[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "l"(da), "l"(db), "r"(0));
}

// d += A.B, operands as wgmma_n32_first
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d += A.B, A [64 x 16] K-major and B [16 x 64] MN-major, both in shared
// memory
__device__ __forceinline__ void wgmma_tb_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d += A.B, A [64 x 16] K-major and B [16 x 128] MN-major, both in shared
// memory
__device__ __forceinline__ void wgmma_tb_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d += A.B with B MN-major over N = 64 or 128 columns
template <int N>
__device__ __forceinline__ void wgmma_tb(float (&d)[N / 2], uint64_t da,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_tb<64>(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  wgmma_tb_n64(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_tb<128>(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  wgmma_tb_n128(d, da, db);
}

// d = A·B (d is written, not read), operands as wgmma_ss_n128
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d += A·B, A [64 x 16] and B [16 x 128] both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d += A·B, A [64 x 16] bf16 in registers (the accumulator layout of
// wgmma, packed in pairs), B [16 x 64] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A·B, A [64 x 16] bf16 in registers (the accumulator layout of
// wgmma, packed in pairs), B [16 x 128] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A·B with N = 64 or 128: wgmma_rs_n64 or wgmma_rs_n128
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

// d = A·B (d is written, not read), operands as wgmma_ss_n64
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// d += A·B, A [64 x 16] and B [16 x 64] both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}


// d += A·B in int32 (wrapping), A [64 x 32] and B [32 x 64] int8, both
// K-major in shared memory
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d += A·B in int32 (wrapping), A [64 x 32] and B [32 x 128] int8, both
// K-major in shared memory
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d += A·B in int32 (wrapping), A [64 x 32] and B [32 x 256] int8, both
// K-major in shared memory
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
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
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


// d += A·B over 32 K bytes with N = 64, 128 or 256
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da,
                                             uint64_t db) {
  wgmma_s8_n64(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da,
                                              uint64_t db) {
  wgmma_s8_n128(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da,
                                              uint64_t db) {
  wgmma_s8_n256(d, da, db);
}

// returned when no cluster of the kernel's CTAs fits on the device
constexpr int kErrCluster = 100004;

// Launch kKernel on `grid` CTAs of `threads` threads with `smem` bytes of
// dynamic shared memory, CL CTAs a cluster along x (cudaLaunchKernelEx with
// a cluster dimension; CL 1: an ordinary launch).  The shared-memory
// attribute is set, and with CL > 1 a cluster's fit checked
// (cudaOccupancyMaxActiveClusters; kErrCluster if none fits), once per
// kernel.  Returns the launch's cudaError_t.
template <auto kKernel, int CL, typename... Args>
int launch_ex(dim3 grid, int threads, size_t smem, cudaStream_t stream,
              Args... args) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = CL;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  if (CL > 1) {
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    static const int fits = [&] {
      int n = 0;
      const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kKernel, &cfg);
      return e == cudaSuccess ? n : -(int)e;
    }();
    if (fits < 0) return -fits;
    if (fits == 0) return kErrCluster;
  }
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kKernel, args...);
  const cudaError_t last = cudaGetLastError();
  return (int)(rc != cudaSuccess ? rc : last);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The map of one [B, T, H, D] bf16 tensor as the 4-d (D, H, T, B) with
// element strides (sh, st, sb), boxes of 64 x 1 x rows x 1.
int make_map(CUtensorMap* map, const void* ptr, int B, int T, int H, int D,
             long long sb, long long st, long long sh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEntryPoint;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {PANEL, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// The map of one [rows, K] int8 matrix (row stride `ld` bytes, a multiple
// of 16; base 16-byte aligned) as the 2-d (K, rows), boxes of 128 bytes of
// K x `box_rows` rows, 128-byte swizzled.  Boxes past the end of either
// dimension are filled with zeros.
int make_map_2d_s8(CUtensorMap* map, const void* ptr, int rows, int K,
                   long long ld, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEntryPoint;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

}  // namespace
