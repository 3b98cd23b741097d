"""Detection operators: SSD's MultiBoxPrior, MultiBoxTarget and
MultiBoxDetection, R-CNN's Proposal (``MultiProposal``) and PSROIPooling,
DeformableConvolution and DeformablePSROIPooling.

Counterpart of ``mxnet_tpu/ops/detection.py`` (reference
``src/operator/contrib/multibox_*.cc``, ``proposal.cc``,
``psroi_pooling.cc``, ``deformable_*``), under the same names, inputs and
outputs, batched where the JAX package maps a function over the batch.
The matching and mining loops run as short PyTorch loops over the labels;
the greedy NMS of MultiBoxDetection (``iou >= t``, same class unless
``force_suppress``) and Proposal (``iou > t``) is the ``greedy_nms``
kernel (``ops/kernels/nms.py``): the JAX package's ``lax.fori_loop`` over
every box.  Every sort is stable (``torch.sort(..., stable=True)``), so
ties keep the order ``jnp.argsort`` and ``lax.top_k`` give them (the lower
index first), which ``torch.topk`` does not promise on the card.  The
target and NMS ops give constants (the JAX package marks them
``no_grad``); PSROIPooling and the deformable ops differentiate through
autograd.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .contrib_ops import constant
from .kernels.nms import greedy_nms, iou_row
from .registry import register
from .spatial import c_round, div_const

__all__ = []


def _stable_desc(x, k=None):
    """``(values, indices)`` of ``x`` sorted descending along its last
    axis, ties in index order, cut to the first ``k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return (vals, idx) if k is None else (vals[..., :k], idx[..., :k])


def _take_rows(x, idx):
    """``x`` [B, N, K] at rows ``idx`` [B, M] -> [B, M, K]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


# ---------------------------------------------------------------------------
# MultiBoxPrior
# ---------------------------------------------------------------------------
@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",),
          no_grad=True)
@constant
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchors [1, H·W·A, 4] of feature map ``data`` [B, C, H, W]: at each
    location all ``sizes`` at ratio 1, then ``ratios[1:]`` at
    ``sizes[0]`` (A = len(sizes) - 1 + len(ratios))."""
    sizes = tuple(float(s) for s in (sizes if hasattr(sizes, "__len__")
                                     else (sizes,)))
    ratios = tuple(float(r) for r in (ratios if hasattr(ratios, "__len__")
                                      else (ratios,)))
    h, w = int(data.shape[2]), int(data.shape[3])
    step_y = float(steps[0]) if steps[0] > 0 else 1.0 / h
    step_x = float(steps[1]) if steps[1] > 0 else 1.0 / w
    dev = data.device
    cy = (torch.arange(h, dtype=torch.float32, device=dev)
          + float(offsets[0])) * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev)
          + float(offsets[1])) * step_x
    half_w = [s * h / w / 2.0 for s in sizes]
    half_h = [s / 2.0 for s in sizes]
    for r in ratios[1:]:
        sr = math.sqrt(r)
        half_w.append(sizes[0] * h / w * sr / 2.0)
        half_h.append(sizes[0] / sr / 2.0)
    hw = torch.tensor(half_w, dtype=torch.float32, device=dev)
    hh = torch.tensor(half_h, dtype=torch.float32, device=dev)
    CY, CX = torch.meshgrid(cy, cx, indexing="ij")
    CX, CY = CX[:, :, None], CY[:, :, None]
    boxes = torch.stack([CX - hw, CY - hh, CX + hw, CY + hh], dim=-1)
    out = boxes.reshape(1, h * w * hw.shape[0], 4)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out.to(data.dtype)


def _encode_loc(anchors, gt, variances):
    """SSD box encoding (multibox_target.cc AssignLocTargets)."""
    vx, vy, vw, vh = variances
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    eps = 1e-8
    return torch.stack([
        div_const((gx - ax) / (aw + eps), vx),
        div_const((gy - ay) / (ah + eps), vy),
        div_const(torch.log(torch.clamp(gw / (aw + eps), min=eps)), vw),
        div_const(torch.log(torch.clamp(gh / (ah + eps), min=eps)), vh),
    ], dim=-1)


def _decode_loc(anchors, pred, variances, clip):
    """The inverse transform (multibox_detection.cc TransformLocations)."""
    vx, vy, vw, vh = variances
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    ox = pred[..., 0] * vx * aw + ax
    oy = pred[..., 1] * vy * ah + ay
    ow = torch.exp(pred[..., 2] * vw) * aw * 0.5
    oh = torch.exp(pred[..., 3] * vh) * ah * 0.5
    out = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    return torch.clamp(out, 0.0, 1.0) if clip else out


# ---------------------------------------------------------------------------
# MultiBoxTarget
# ---------------------------------------------------------------------------
@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",),
          input_names=("anchor", "label", "cls_pred"), no_grad=True,
          num_outputs=3)
@constant
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5, minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """Anchor-to-ground-truth matching and target encoding.

    anchor [1, N, 4]; label [B, M, >=5] rows (class, x1, y1, x2, y2, ...),
    class -1 for padding; cls_pred [B, C, N].  Returns (loc_target
    [B, 4N], loc_mask [B, 4N], cls_target [B, N]).  Stage 1 is the greedy
    bipartite match (M rounds, each the best remaining anchor-gt pair over
    the whole batch row); stage 2 matches the rest above
    ``overlap_threshold``; stage 3 mines the hardest negatives (lowest
    background probability, stable ranking) up to ``ratio`` per
    positive."""
    anchors = anchor.reshape(-1, 4)
    N = anchors.shape[0]
    B, M = label.shape[0], label.shape[1]
    variances = tuple(float(v) for v in variances)
    dev = anchor.device
    ar = torch.arange(B, device=dev)
    gt_valid = label[:, :, 0] >= 0                            # [B, M]
    gt_boxes = label[:, :, 1:5]
    iou = iou_row(anchors[None, :, None, :], gt_boxes[:, None, :, :], "pair")
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)         # [B, N, M]

    # stage 1: greedy bipartite matching, one gt a round
    a_pos = torch.zeros((B, N), dtype=torch.bool, device=dev)
    g_matched = torch.zeros((B, M), dtype=torch.bool, device=dev)
    match_gt = torch.full((B, N), -1, dtype=torch.long, device=dev)
    match_iou = torch.full((B, N), -1.0, dtype=iou.dtype, device=dev)
    for _ in range(M):
        masked = torch.where(a_pos[:, :, None] | g_matched[:, None, :], -1.0,
                             iou).reshape(B, -1)
        flat = masked.argmax(1)
        bi, bk = flat // M, flat % M
        best = masked[ar, flat]
        ok = best > 1e-6
        a_pos[ar, bi] = a_pos[ar, bi] | ok
        g_matched[ar, bk] = g_matched[ar, bk] | ok
        match_gt[ar, bi] = torch.where(ok, bk, match_gt[ar, bi])
        match_iou[ar, bi] = torch.where(ok, best, match_iou[ar, bi])

    # stage 2: threshold matching for the rest
    best_iou = iou.amax(2)
    best_gt = iou.argmax(2)                      # the first of equal maxima
    thr_pos = (~a_pos) & (best_iou > overlap_threshold) \
        & (overlap_threshold > 0)
    match_gt = torch.where(a_pos, match_gt, best_gt)
    match_iou = torch.where(a_pos, match_iou, best_iou)
    positive = a_pos | thr_pos
    num_pos = positive.sum(1)

    # stage 3: negatives, mined or all
    if negative_mining_ratio > 0:
        logits = cls_pred.transpose(1, 2)                       # [B, N, C]
        m = logits.amax(2, keepdim=True)
        prob_bg = (torch.exp(logits[:, :, 0] - m[:, :, 0])
                   / torch.exp(logits - m).sum(2))
        cand = (~positive) & (match_iou < negative_mining_thresh)
        score = torch.where(cand, -prob_bg, float("-inf"))
        order = torch.argsort(-score, dim=1, stable=True)      # hardest first
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(N, device=dev).expand(B, N))
        num_neg = torch.minimum(
            (num_pos * negative_mining_ratio).to(torch.int32), N - num_pos)
        num_neg = torch.clamp(num_neg, min=int(minimum_negative_samples))
        negative = cand & (rank < num_neg[:, None])
    else:
        negative = ~positive

    gt_cls = torch.gather(label[:, :, 0], 1, match_gt)
    cls_target = torch.where(
        positive, gt_cls + 1.0,
        torch.where(negative, 0.0, float(ignore_label)).to(gt_cls.dtype))
    gt_box = _take_rows(gt_boxes, match_gt)
    loc = _encode_loc(anchors[None], gt_box, variances)
    loc_target = torch.where(positive[..., None], loc, 0.0).reshape(B, -1)
    loc_mask = positive[..., None].expand(B, N, 4).reshape(B, -1)
    dt = anchor.dtype
    return loc_target.to(dt), loc_mask.to(dt), cls_target.to(dt)


# ---------------------------------------------------------------------------
# MultiBoxDetection
# ---------------------------------------------------------------------------
@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",),
          input_names=("cls_prob", "loc_pred", "anchor"), no_grad=True)
@constant
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                        threshold=0.01, background_id=0, nms_threshold=0.5,
                        force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                        nms_topk=-1):
    """Decode and per-class NMS.  cls_prob [B, C, N]; loc_pred [B, 4N];
    anchor [1, N, 4].  Output [B, N, 6] rows (class_id, score, x1, y1,
    x2, y2), sorted by score; suppressed and low-score rows have class_id
    -1.  ``background_id`` selects the background row (the declared
    parameter, as in the JAX package; the reference kernel hard-codes 0):
    class ids are positions among the other rows."""
    bg = int(background_id)
    anchors = anchor.reshape(-1, 4)
    N = anchors.shape[0]
    B, C = cls_prob.shape[0], cls_prob.shape[1]
    variances = tuple(float(v) for v in variances)
    dev = cls_prob.device
    nonbg = (torch.arange(C, device=dev) != bg)[None, :, None]
    scores_all = torch.where(nonbg, cls_prob, float("-inf"))
    score = scores_all.amax(1)
    row = scores_all.argmax(1)                   # the first of equal maxima
    cid = (row - (row > bg).long()).to(torch.float32)
    cid = torch.where(score >= threshold, cid, -1.0)
    boxes = _decode_loc(anchors[None], loc_pred.reshape(B, N, 4), variances,
                        clip)
    order = torch.argsort(-torch.where(cid >= 0, score, float("-inf")), dim=1,
                          stable=True)
    cid = torch.gather(cid, 1, order)
    score = torch.gather(score, 1, order)
    boxes = _take_rows(boxes, order)
    if nms_topk > 0:
        cid = torch.where(torch.arange(N, device=dev) < nms_topk, cid, -1.0)
    if 0 < nms_threshold <= 1:
        keep = greedy_nms(boxes, cid >= 0, None if force_suppress else cid,
                          nms_threshold, iou="pair", cmp="ge")
        cid = torch.where(keep, cid, -1.0)
    out = torch.cat([cid[..., None].to(boxes.dtype),
                     score[..., None].to(boxes.dtype), boxes], dim=-1)
    return out.to(cls_prob.dtype)


# ---------------------------------------------------------------------------
# Proposal
# ---------------------------------------------------------------------------
def _gen_base_anchors(base_size, scales, ratios):
    """proposal-inl.h GenerateAnchors: the ratio enumeration, then the
    scale enumeration (Python's ``round``, as the JAX package uses)."""
    px, py = (base_size - 1.0) * 0.5, (base_size - 1.0) * 0.5
    out = []
    for r in ratios:
        size = base_size * base_size / r
        ws = round(math.sqrt(size))
        hs = round(ws * r)
        for s in scales:
            w, h = ws * s, hs * s
            out.append([px - 0.5 * (w - 1), py - 0.5 * (h - 1),
                        px + 0.5 * (w - 1), py + 0.5 * (h - 1)])
    return out


@register("_contrib_Proposal",
          aliases=("Proposal", "_contrib_MultiProposal", "MultiProposal"),
          input_names=("cls_prob", "bbox_pred", "im_info"), no_grad=True)
@constant
def _proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
              rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
              scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
              output_score=False, iou_loss=False):
    """RPN proposals: anchor grid, bbox deltas, clip, min-size filter,
    pre-NMS top-K, NMS (``iou > threshold``), post-NMS top-K.  Output
    [B·post, 5] rows (batch_idx, x1, y1, x2, y2); a short image pads with
    its best surviving box."""
    B, twoA, H, W = cls_prob.shape
    A = twoA // 2
    dev = cls_prob.device
    base = torch.tensor(_gen_base_anchors(float(feature_stride),
                                          [float(s) for s in scales],
                                          [float(r) for r in ratios]),
                        dtype=torch.float32, device=dev)       # [A, 4]
    sx = torch.arange(W, dtype=torch.float32, device=dev) * feature_stride
    sy = torch.arange(H, dtype=torch.float32, device=dev) * feature_stride
    SY, SX = torch.meshgrid(sy, sx, indexing="ij")
    shift = torch.stack([SX, SY, SX, SY], dim=-1)               # [H, W, 4]
    anchors = (shift[:, :, None, :] + base[None, None]).reshape(-1, 4)
    fg = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(B, -1)
    deltas = bbox_pred.permute(0, 2, 3, 1).reshape(B, -1, 4)
    if iou_loss:
        x1 = anchors[:, 0] + deltas[..., 0]
        y1 = anchors[:, 1] + deltas[..., 1]
        x2 = anchors[:, 2] + deltas[..., 2]
        y2 = anchors[:, 3] + deltas[..., 3]
    else:
        aw = anchors[:, 2] - anchors[:, 0] + 1.0
        ah = anchors[:, 3] - anchors[:, 1] + 1.0
        ax = anchors[:, 0] + aw * 0.5
        ay = anchors[:, 1] + ah * 0.5
        px = deltas[..., 0] * aw + ax
        py = deltas[..., 1] * ah + ay
        pw = torch.exp(torch.clamp(deltas[..., 2], -10, 10)) * aw
        ph = torch.exp(torch.clamp(deltas[..., 3], -10, 10)) * ah
        x1 = px - 0.5 * (pw - 1.0)
        y1 = py - 0.5 * (ph - 1.0)
        x2 = px + 0.5 * (pw - 1.0)
        y2 = py + 0.5 * (ph - 1.0)
    # clip to the image: im_info rows (height, width, scale)
    hi_x = (im_info[:, 1] - 1.0)[:, None]
    hi_y = (im_info[:, 0] - 1.0)[:, None]
    x1 = torch.minimum(torch.clamp(x1, min=0), hi_x)
    y1 = torch.minimum(torch.clamp(y1, min=0), hi_y)
    x2 = torch.minimum(torch.clamp(x2, min=0), hi_x)
    y2 = torch.minimum(torch.clamp(y2, min=0), hi_y)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    ms = (rpn_min_size * im_info[:, 2])[:, None]
    ok = ((x2 - x1 + 1.0) >= ms) & ((y2 - y1 + 1.0) >= ms)
    fg = torch.where(ok, fg, float("-inf"))
    K = min(int(rpn_pre_nms_top_n), boxes.shape[1])
    fg_k, idx = _stable_desc(fg, K)
    boxes_k = _take_rows(boxes, idx)
    alive = greedy_nms(boxes_k, fg_k > float("-inf"), None, threshold,
                       iou="pair", cmp="gt")
    P = int(rpn_post_nms_top_n)
    kept_scores, keep = _stable_desc(
        torch.where(alive, fg_k, float("-inf")), min(P, K))
    surv = kept_scores > float("-inf")
    out_boxes = torch.where(surv[..., None], _take_rows(boxes_k, keep),
                            _take_rows(boxes_k, keep[:, :1]))
    out_scores = torch.where(surv, torch.gather(fg_k, 1, keep), 0.0)
    if P > K:
        out_boxes = torch.cat([out_boxes,
                               out_boxes[:, :1].expand(B, P - K, 4)], 1)
        out_scores = torch.cat([out_scores, out_scores.new_zeros(B, P - K)],
                               1)
    bidx = torch.arange(B, dtype=torch.float32, device=dev) \
        .repeat_interleave(P)[:, None]
    rois = torch.cat([bidx, out_boxes.reshape(B * P, 4)], 1) \
        .to(cls_prob.dtype)
    if output_score:
        return rois, out_scores.reshape(B * P, 1).to(cls_prob.dtype)
    return rois


# ---------------------------------------------------------------------------
# PSROIPooling
# ---------------------------------------------------------------------------
@register("_contrib_PSROIPooling", aliases=("PSROIPooling",),
          input_names=("data", "rois"))
def _psroi_pooling(data, rois, spatial_scale=1.0, output_dim=1,
                   pooled_size=7, group_size=0):
    """R-FCN position-sensitive average pooling: bin (i, j) of output
    channel c averages input channel c·g² + gi·g + gj inside the bin; the
    ROI snapped with C rounding, the far edge + 1 after rounding."""
    g = int(group_size) if group_size else int(pooled_size)
    p, od = int(pooled_size), int(output_dim)
    _, _, H, W = data.shape
    dev = data.device
    b = rois[:, 0].long()
    x1 = (c_round(rois[:, 1]) * spatial_scale)[:, None, None]
    y1 = (c_round(rois[:, 2]) * spatial_scale)[:, None, None]
    x2 = (c_round(rois[:, 3]) + 1.0) * spatial_scale
    y2 = (c_round(rois[:, 4]) + 1.0) * spatial_scale
    bin_w = div_const(torch.clamp(x2[:, None, None] - x1, min=0.1), p)
    bin_h = div_const(torch.clamp(y2[:, None, None] - y1, min=0.1), p)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    c = torch.arange(od, device=dev)
    rows = []
    for i in range(p):
        hstart = torch.floor(y1 + i * bin_h)
        hend = torch.ceil(y1 + (i + 1) * bin_h)
        row = []
        for j in range(p):
            wstart = torch.floor(x1 + j * bin_w)
            wend = torch.ceil(x1 + (j + 1) * bin_w)
            inside = ((ys >= hstart) & (ys < hend) & (xs >= wstart)
                      & (xs < wend))                          # [R, H, W]
            chan = c * g * g + ((i * g) // p) * g + (j * g) // p
            vals = torch.where(inside[:, None], data[b[:, None], chan[None]],
                               0.0)
            cnt = inside.sum((1, 2))
            mean = vals.sum((2, 3)) / torch.clamp(cnt, min=1)[:, None]
            row.append(torch.where((cnt > 0)[:, None], mean, 0.0))
        rows.append(torch.stack(row, -1))
    return torch.stack(rows, -2).to(data.dtype)


# ---------------------------------------------------------------------------
# DeformableConvolution
# ---------------------------------------------------------------------------
@register("_contrib_DeformableConvolution",
          aliases=("DeformableConvolution",),
          input_names=("data", "offset", "weight", "bias"))
def _deformable_conv(data, offset, weight, bias=None, kernel=(3, 3),
                     stride=(1, 1), dilate=(1, 1), pad=(0, 0), num_filter=1,
                     num_group=1, num_deformable_group=1, workspace=1024,
                     no_bias=False, layout="NCHW"):
    """Deformable convolution v1: the im2col sampling grid displaced by the
    learned per-position offsets ([B, 2·DG·kh·kw, OH, OW], (y, x) pairs
    per kernel position), sampled bilinearly (0 outside the padded
    image), then one product per group.  Differentiable in data, offsets
    and weight through autograd."""
    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = int(stride[0]), int(stride[1])
    dh, dw = int(dilate[0]), int(dilate[1])
    ph, pw = int(pad[0]), int(pad[1])
    B, C, H, W = data.shape
    OH = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    OW = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    DG, G, Fo = int(num_deformable_group), int(num_group), int(num_filter)
    x = F.pad(data, (pw, pw, ph, ph))
    Hp, Wp = H + 2 * ph, W + 2 * pw
    f32 = dict(dtype=torch.float32, device=data.device)
    # base sampling grid [kh, kw, OH, OW] in padded coordinates
    base_y = (torch.arange(kh, **f32)[:, None, None, None] * dh
              + torch.arange(OH, **f32)[None, None, :, None] * sh)
    base_x = (torch.arange(kw, **f32)[None, :, None, None] * dw
              + torch.arange(OW, **f32)[None, None, None, :] * sw)
    off = offset.reshape(B, DG, kh * kw, 2, OH, OW)
    y = base_y.expand(kh, kw, OH, OW) + off[:, :, :, 0].reshape(
        B, DG, kh, kw, OH, OW)
    xx = base_x.expand(kh, kw, OH, OW) + off[:, :, :, 1].reshape(
        B, DG, kh, kw, OH, OW)
    y0, x0 = torch.floor(y), torch.floor(xx)
    wy, wx = (y - y0)[:, :, None], (xx - x0)[:, :, None]
    y0i = torch.clamp(y0.long(), 0, Hp - 1)
    y1i = torch.clamp(y0i + 1, 0, Hp - 1)
    x0i = torch.clamp(x0.long(), 0, Wp - 1)
    x1i = torch.clamp(x0i + 1, 0, Wp - 1)
    inb = ((y > -1.0) & (y < Hp) & (xx > -1.0) & (xx < Wp))[:, :, None]
    Cg = C // DG
    flat = x.reshape(B, DG, Cg, Hp * Wp)
    L = kh * kw * OH * OW

    def gather(yi, xi):
        idx = (yi * Wp + xi).reshape(B, DG, 1, L).expand(B, DG, Cg, L)
        return flat.gather(3, idx).reshape(B, DG, Cg, kh, kw, OH, OW)

    val = (gather(y0i, x0i) * (1 - wy) * (1 - wx)
           + gather(y0i, x1i) * (1 - wy) * wx
           + gather(y1i, x0i) * wy * (1 - wx)
           + gather(y1i, x1i) * wy * wx)
    cols = torch.where(inb, val, 0.0).reshape(
        B, G, (C // G) * kh * kw, OH * OW)
    wg = weight.reshape(G, Fo // G, (C // G) * kh * kw)
    out = torch.einsum("bgkp,gfk->bgfp", cols, wg).reshape(B, Fo, OH, OW)
    out = out.to(data.dtype)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1).to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# DeformablePSROIPooling
# ---------------------------------------------------------------------------
@register("_contrib_DeformablePSROIPooling",
          aliases=("DeformablePSROIPooling",),
          input_names=("data", "rois", "trans"))
def _deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                              output_dim=1, group_size=1, pooled_size=1,
                              part_size=0, sample_per_part=1, trans_std=0.0,
                              no_trans=False):
    """R-FCN deformable position-sensitive pooling: each bin's window
    displaced by its part's learned offset (``trans``, times
    ``trans_std``, in ROI widths), averaged over ``sample_per_part``²
    bilinear taps (clip-to-edge) that fall within half a pixel of the
    image.  Differentiable in data and trans."""
    p, sp, od, g = (int(pooled_size), int(sample_per_part), int(output_dim),
                    int(group_size))
    ps = int(part_size) or p
    _, _, H, W = data.shape
    dev = data.device
    n_cls = 1 if (no_trans or trans is None) else trans.shape[1] // 2
    ch_each = od // n_cls
    R = rois.shape[0]

    def col(t):                                   # [R] -> [R, 1, 1, 1]
        return t.reshape(R, 1, 1, 1)

    x1 = c_round(rois[:, 1]) * spatial_scale - 0.5
    y1 = c_round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (c_round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (c_round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_w, bin_h = div_const(rw, p), div_const(rh, p)
    sub_w, sub_h = div_const(bin_w, sp), div_const(bin_h, sp)
    ii = torch.arange(p, device=dev)[:, None].expand(p, p)
    jj = torch.arange(p, device=dev)[None, :].expand(p, p)
    part_h = torch.floor(div_const(ii.to(torch.float32), p) * ps).long()
    part_w = torch.floor(div_const(jj.to(torch.float32), p) * ps).long()
    gh = torch.clamp((ii * g) // p, 0, g - 1)
    gw = torch.clamp((jj * g) // p, 0, g - 1)
    c = torch.arange(od, device=dev)[None, :, None, None]  # [1, od, 1, 1]
    if no_trans or trans is None:
        tx = ty = 0.0
    else:
        r_idx = torch.arange(R, device=dev)[:, None, None, None]
        cls = c // ch_each
        tx = trans[r_idx, cls * 2, part_h, part_w] * trans_std
        ty = trans[r_idx, cls * 2 + 1, part_h, part_w] * trans_std
    ws = jj * col(bin_w) + col(x1) + tx * col(rw)         # [R, od, p, p]
    hs = ii * col(bin_h) + col(y1) + ty * col(rh)
    ws, hs = torch.broadcast_tensors(ws, hs)
    k = torch.arange(sp, device=dev)
    WW = ws[..., None, None] + (k * sub_w[:, None]).reshape(R, 1, 1, 1, 1, sp)
    HH = hs[..., None, None] + (k * sub_h[:, None]).reshape(R, 1, 1, 1, sp, 1)
    WW, HH = torch.broadcast_tensors(WW, HH)       # [R, od, p, p, sp, sp]
    ok = (WW >= -0.5) & (WW <= W - 0.5) & (HH >= -0.5) & (HH <= H - 0.5)
    wq = torch.clamp(WW, 0.0, W - 1.0)
    hq = torch.clamp(HH, 0.0, H - 1.0)
    chan = ((c * g + gh) * g + gw)[..., None, None]       # [1, od, p, p, 1, 1]
    bb = rois[:, 0].long().reshape(R, 1, 1, 1, 1, 1)
    y0 = torch.floor(hq).long()
    x0 = torch.floor(wq).long()
    y1i = torch.clamp(y0 + 1, 0, H - 1)
    x1i = torch.clamp(x0 + 1, 0, W - 1)
    y0 = torch.clamp(y0, 0, H - 1)
    x0 = torch.clamp(x0, 0, W - 1)
    dy = hq - torch.floor(hq)
    dx = wq - torch.floor(wq)
    val = (data[bb, chan, y0, x0] * (1 - dy) * (1 - dx)
           + data[bb, chan, y0, x1i] * (1 - dy) * dx
           + data[bb, chan, y1i, x0] * dy * (1 - dx)
           + data[bb, chan, y1i, x1i] * dy * dx)
    cnt = ok.sum((-2, -1))
    mean = torch.where(ok, val, 0.0).sum((-2, -1)) / torch.clamp(cnt, min=1)
    return torch.where(cnt > 0, mean, 0.0).to(data.dtype)
