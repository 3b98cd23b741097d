// Greedy non-maximum suppression for Hopper (sm_90a), CUDA C++.
//
// Replaces no TPU kernel: the JAX package runs greedy NMS as a
// `lax.fori_loop` over every box (mxnet_tpu/ops/detection.py:292 in
// MultiBoxDetection, :386 in Proposal; mxnet_tpu/ops/contrib_ops.py:153 in
// box_nms), which XLA keeps on the device.  In eager PyTorch that loop is
// one step of several launches per box (8732 steps for one SSD-300
// decode), so the port runs it here.  Semantics, kept exactly:
//
//   boxes [B, N, 4] (x1, y1, x2, y2), f32, already sorted by score;
//   valid [B, N]; optional class ids [B, N] (f32);
//   keep[i] = valid[i] and no j < i with keep[j], (ids[j] == ids[i] when
//             classes are compared) and pred(iou(box j, box i))
//   pred: iou >= t (MultiBoxDetection) or iou > t (Proposal, box_nms);
//   iou:  `_pair_iou` (detection.py:91: unclamped areas, 0 where the
//         union is not positive) or `_iou_corner` (contrib_ops.py:86:
//         areas clamped at 0, union at least 1e-12).
//
// Each loop suppresses, for i in order, the later boxes that a still-kept
// box i overlaps; suppressing an already suppressed box changes nothing,
// so the loop's result is this keep mask.
//
// Shape of the kernels: `nms_mask_kernel`, a grid of CTAs of 64 threads
// over (column tile, row tile, image), writes the upper-triangular
// suppression bitmask: row i, 64-bit word w, bit k set when box
// j = 64 w + k, j > i, satisfies the predicate against box i.  Only tiles
// on or above the diagonal run, and only rows of valid boxes are written
// (the scan reads no other row).  Then `nms_scan_kernel`, one warp per
// image, walks the rows in order: the `removed` bitset lives in shared
// memory; a row whose box is valid and not yet removed is kept, and its
// words are ORed into `removed` (the diagonal word in a register).
//
// Exactness: every IoU is computed with __fsub_rn / __fadd_rn /
// __fmul_rn / __fdiv_rn in the plain version's order, so no FMA
// contraction can move a box across the threshold, and min / max
// propagate NaN as torch.minimum / torch.maximum do; the keep mask is bit
// for bit the plain version's.
//
// What bounds it on the card: the IoU evaluations of the mask (N^2 / 2 per
// image, about 20 f32 operations each) and the scan's dependent loads of
// the kept rows; the bytes that must move (boxes, masks, ids, the keep
// mask) are a few hundred KB.  The bitmask (N * ceil(N/64) * 8 bytes an
// image: 9.6 MB at N = 8732) is written once and read only for kept rows.
//
// Plain C interface (no PyTorch headers), called through ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr unsigned kFull = 0xffffffffu;

// torch.maximum / torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// IOU 0: detection.py `_pair_iou`; IOU 1: contrib_ops.py `_iou_corner`.
// a is the row's box (i), b the column's (j).
template <int IOU>
__device__ __forceinline__ float box_iou(const float4 a, const float4 b) {
  const float iw = nmax(__fsub_rn(nmin(a.z, b.z), nmax(a.x, b.x)), 0.f);
  const float ih = nmax(__fsub_rn(nmin(a.w, b.w), nmax(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  if (IOU == 0) {
    const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
    const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
    const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
    return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
  }
  const float area_a = __fmul_rn(nmax(__fsub_rn(a.z, a.x), 0.f),
                                 nmax(__fsub_rn(a.w, a.y), 0.f));
  const float area_b = __fmul_rn(nmax(__fsub_rn(b.z, b.x), 0.f),
                                 nmax(__fsub_rn(b.w, b.y), 0.f));
  const float uni = nmax(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-12f);
  return __fdiv_rn(inter, uni);
}

template <int IOU, bool GE, bool CLASSES>
__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes,
                const unsigned char* __restrict__ valid,
                const float* __restrict__ ids,
                unsigned long long* __restrict__ mask, int N, int words,
                float thresh) {
  const int rb = blockIdx.y, cb = blockIdx.x;
  if (cb < rb) return;                          // below the diagonal
  __shared__ float4 cbox[kTile];
  __shared__ float cid[kTile];
  const long long base = static_cast<long long>(blockIdx.z) * N;
  const int col0 = cb * kTile;
  const int ncols = min(kTile, N - col0);
  if (threadIdx.x < ncols) {
    cbox[threadIdx.x] = boxes[base + col0 + threadIdx.x];
    if (CLASSES) cid[threadIdx.x] = ids[base + col0 + threadIdx.x];
  }
  __syncthreads();
  const int i = rb * kTile + threadIdx.x;
  if (i >= N || !valid[base + i]) return;       // a row the scan never reads
  const float4 a = boxes[base + i];
  const float ai = CLASSES ? ids[base + i] : 0.f;
  unsigned long long bits = 0;
  for (int k = (cb == rb) ? threadIdx.x + 1 : 0; k < ncols; ++k) {
    if (CLASSES && cid[k] != ai) continue;
    const float v = box_iou<IOU>(a, cbox[k]);
    if (GE ? v >= thresh : v > thresh) bits |= 1ull << k;
  }
  mask[(base + i) * words + cb] = bits;
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const unsigned long long* __restrict__ mask,
                const unsigned char* __restrict__ valid,
                unsigned char* __restrict__ keep, int N, int words) {
  extern __shared__ unsigned long long removed[];
  const int lane = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * N;
  for (int w = lane; w < words; w += 32) removed[w] = 0ull;
  __syncwarp();
  for (int w = 0; w < words; ++w) {
    const int i0 = w * kTile;
    const bool v0 = i0 + lane < N && valid[base + i0 + lane];
    const bool v1 = i0 + 32 + lane < N && valid[base + i0 + 32 + lane];
    const unsigned long long vbits =
        static_cast<unsigned long long>(__ballot_sync(kFull, v0)) |
        (static_cast<unsigned long long>(__ballot_sync(kFull, v1)) << 32);
    unsigned long long cur = removed[w], kept = 0ull;
    const int nrows = min(kTile, N - i0);
    for (int r = 0; r < nrows; ++r) {
      if (!((vbits >> r) & 1ull) || ((cur >> r) & 1ull)) continue;
      kept |= 1ull << r;
      const unsigned long long* row = mask + (base + i0 + r) * words;
      cur |= row[w];                            // the same word in every lane
      for (int x = w + 1 + lane; x < words; x += 32) removed[x] |= row[x];
    }
    __syncwarp();
    if (i0 + lane < N) keep[base + i0 + lane] = (kept >> lane) & 1ull;
    if (i0 + 32 + lane < N)
      keep[base + i0 + 32 + lane] = (kept >> (32 + lane)) & 1ull;
  }
}

template <int IOU, bool GE, bool CLASSES>
void launch_mask(const float4* boxes, const unsigned char* valid,
                 const float* ids, unsigned long long* mask, int B, int N,
                 int words, float thresh, cudaStream_t s) {
  const dim3 grid(words, words, B);
  nms_mask_kernel<IOU, GE, CLASSES><<<grid, kTile, 0, s>>>(
      boxes, valid, ids, mask, N, words, thresh);
}

template <int IOU, bool GE>
void launch_mask_ids(const float4* boxes, const unsigned char* valid,
                     const float* ids, unsigned long long* mask, int B, int N,
                     int words, float thresh, cudaStream_t s) {
  if (ids != nullptr)
    launch_mask<IOU, GE, true>(boxes, valid, ids, mask, B, N, words, thresh,
                               s);
  else
    launch_mask<IOU, GE, false>(boxes, valid, ids, mask, B, N, words, thresh,
                                s);
}

}  // namespace

extern "C" {

// boxes: f32 [B, N, 4], contiguous, 16-byte aligned; valid: uint8 [B, N]
// (0 / 1), contiguous; ids: f32 [B, N], contiguous, or null (classes not
// compared); mask: scratch of B * N * ceil(N / 64) 64-bit words; keep:
// uint8 [B, N] written 0 / 1.  iou: 0 = `_pair_iou`, 1 = `_iou_corner`;
// ge: 1 for iou >= thresh, 0 for iou > thresh.  N <= 65536, B <= 65535.
// Returns a cudaError_t.
int mxt_greedy_nms(const void* boxes, const void* valid, const void* ids,
                   void* mask, void* keep, int B, int N, float thresh,
                   int iou, int ge, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (N > 65536 || B > 65535 || iou < 0 || iou > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (N + kTile - 1) / kTile;
  const float4* b4 = static_cast<const float4*>(boxes);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  const float* c = static_cast<const float*>(ids);
  unsigned long long* m = static_cast<unsigned long long*>(mask);
  if (iou == 0) {
    if (ge) launch_mask_ids<0, true>(b4, v, c, m, B, N, words, thresh, s);
    else launch_mask_ids<0, false>(b4, v, c, m, B, N, words, thresh, s);
  } else {
    if (ge) launch_mask_ids<1, true>(b4, v, c, m, B, N, words, thresh, s);
    else launch_mask_ids<1, false>(b4, v, c, m, B, N, words, thresh, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<B, 32, words * sizeof(unsigned long long), s>>>(
      m, v, static_cast<unsigned char*>(keep), N, words);
  return (int)cudaGetLastError();
}

const char* mxt_greedy_nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
