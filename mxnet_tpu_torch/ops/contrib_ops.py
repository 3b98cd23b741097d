"""Contrib operators: ROIAlign, box_iou, box_nms, bipartite_matching,
AdaptiveAvgPooling2D, BilinearResize2D, boolean_mask, index_copy,
index_array, quadratic, fft / ifft, div_sqrt_dim, gradientmultiplier,
allclose, arange_like and count_sketch.

Counterpart of ``mxnet_tpu/ops/contrib_ops.py`` (reference
``src/operator/contrib/``), registered under the same ``_contrib_*`` names
and short aliases, so ``nd.contrib.*``, ``sym.contrib.*`` and Gluon's
``F.contrib.*`` reach them.  Gradients come from autograd, except
gradientmultiplier's, which is the JAX package's custom one; the ops the
JAX package marks ``no_grad`` give constants.  ``box_nms``'s greedy loop
is the ``greedy_nms`` kernel (``ops/kernels/nms.py``) with
``_iou_corner``'s formula and a strict comparison.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .kernels.nms import greedy_nms
from .registry import register
from .spatial import div_const

__all__ = []


def constant(fn):
    """Run an op without building a graph: the JAX package records no
    gradient for the ops it marks ``no_grad``."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.no_grad():
            return fn(*args, **kwargs)

    return wrapper


def _coef(values, ref):
    """Python numbers as a float tensor beside ``ref``: each rounded once
    from double, as the JAX package's weakly typed constants are."""
    return torch.tensor(values, dtype=ref.dtype, device=ref.device)


# ---------------------------------------------------------------------------
# ROIAlign
# ---------------------------------------------------------------------------
@register("_contrib_ROIAlign", aliases=("ROIAlign",),
          input_names=("data", "rois"))
def _roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
               sample_ratio=2, position_sensitive=False, aligned=False):
    """Average of ``sample_ratio``² bilinear samples per bin (Mask R-CNN's
    ROIAlign); ``position_sensitive`` pools bin (py, px) from its own
    channel group (PSROIAlign, C / (ph·pw) output channels)."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    sr = max(int(sample_ratio), 1)
    n, c, h, w = data.shape
    off = 0.5 if aligned else 0.0
    bi = rois[:, 0].long()[:, None, None]
    x1 = rois[:, 1] * spatial_scale - off
    y1 = rois[:, 2] * spatial_scale - off
    x2 = rois[:, 3] * spatial_scale - off
    y2 = rois[:, 4] * spatial_scale - off
    low = 1e-6 if aligned else 1.0
    rh = torch.clamp(y2 - y1, min=low)[:, None, None]
    rw = torch.clamp(x2 - x1, min=low)[:, None, None]
    y1, x1 = y1[:, None, None], x1[:, None, None]
    if position_sensitive:
        if c % (ph * pw):
            raise ValueError("ROIAlign: position_sensitive needs channels "
                             "divisible by ph*pw")
        src = data.reshape(n, c // (ph * pw), ph, pw, h, w)
        py = torch.arange(ph, device=data.device)[None, :, None]
        px = torch.arange(pw, device=data.device)[None, None, :]
    zero = torch.zeros((), dtype=data.dtype, device=data.device)

    def tap(yi, xi):                                  # (R, ph, pw, C)
        inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        v = src[bi, :, py, px, yc, xc] if position_sensitive \
            else data[bi, :, yc, xc]
        return torch.where(inside[..., None], v, zero)

    acc = 0.0
    for iy in range(sr):
        for ix in range(sr):
            cy = _coef([[p + (iy + 0.5) / sr] for p in range(ph)], data)
            cx = _coef([[p + (ix + 0.5) / sr for p in range(pw)]], data)
            y = y1 + div_const(cy * rh, ph)            # (R, ph, 1)
            x = x1 + div_const(cx * rw, pw)            # (R, 1, pw)
            y, x = torch.broadcast_tensors(y, x)
            y0, x0 = torch.floor(y), torch.floor(x)
            dy, dx = (y - y0)[..., None], (x - x0)[..., None]
            acc = acc + (tap(y0, x0) * (1 - dy) * (1 - dx)
                         + tap(y0, x0 + 1) * (1 - dy) * dx
                         + tap(y0 + 1, x0) * dy * (1 - dx)
                         + tap(y0 + 1, x0 + 1) * dy * dx)
    return div_const(acc, sr * sr).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Bounding boxes
# ---------------------------------------------------------------------------
def _iou_corner(a, b):
    """IoU of corner boxes, broadcasting; areas clamped at 0, the union at
    least 1e-12 (bounding_box.cc)."""
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


def _center_to_corner(b):
    xy, wh = b[..., :2], b[..., 2:4] / 2
    return torch.cat([xy - wh, xy + wh], -1)


@register("_contrib_box_iou", aliases=("box_iou",))
def _box_iou(lhs, rhs, format="corner"):
    """Pairwise IoU: lhs [..., N, 4] x rhs [..., M, 4] -> [..., N, M]."""
    if format == "center":
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    return _iou_corner(lhs[..., :, None, :], rhs[..., None, :, :])


@register("_contrib_box_nms", aliases=("box_nms",), no_grad=True)
@constant
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1, background_id=-1,
             force_suppress=False, in_format="corner", out_format="corner"):
    """Greedy NMS (bounding_box.cc): rows sorted by score (stable, so ties
    keep their order), suppressed rows' scores set to -1, the layout
    otherwise the input's."""
    shape = data.shape
    b = data.reshape((-1,) + tuple(shape[-2:]))        # (B, N, K)
    n = b.shape[1]
    order = torch.argsort(-b[:, :, score_index], dim=1, stable=True)
    bs = torch.gather(b, 1, order[..., None].expand_as(b))
    s = bs[:, :, score_index]
    valid = s > valid_thresh
    if topk > 0:
        valid = valid & (torch.arange(n, device=b.device) < topk)
    if id_index >= 0 and background_id >= 0:
        # background-class boxes never survive NMS
        valid = valid & (bs[:, :, id_index] != background_id)
    coords = bs[:, :, coord_start:coord_start + 4]
    if in_format == "center":
        coords = _center_to_corner(coords)
    ids = bs[:, :, id_index] if not force_suppress and id_index >= 0 \
        else None
    keep = greedy_nms(coords, valid, ids, overlap_thresh, iou="corner",
                      cmp="gt")
    out = bs.clone()
    out[:, :, score_index] = torch.where(keep, s, -1.0)
    if out_format != in_format:
        if out_format == "center":
            coords = torch.cat([(coords[..., :2] + coords[..., 2:4]) / 2,
                                coords[..., 2:4] - coords[..., :2]], -1)
        out[:, :, coord_start:coord_start + 4] = coords
    return out.reshape(shape)


@register("_contrib_bipartite_matching", aliases=("bipartite_matching",),
          num_outputs=2, no_grad=True)
@constant
def _bipartite_matching(data, threshold=0.5, is_ascend=False, topk=-1):
    """Greedy bipartite matching over a (..., N, M) score matrix: the
    best remaining pair first, up to min(N, M) (or ``topk``) pairs.
    Returns (row_match [..., N], col_match [..., M]), -1 where unmatched."""
    shape = data.shape
    d = data.reshape((-1,) + tuple(shape[-2:])).clone()
    B, n, m = d.shape
    k = min(n, m) if topk <= 0 else min(topk, n, m)
    big = float("inf") if is_ascend else float("-inf")
    rows = torch.full((B, n), -1.0, device=d.device)
    cols = torch.full((B, m), -1.0, device=d.device)
    ar = torch.arange(B, device=d.device)
    for _ in range(k):
        flat = d.reshape(B, -1)
        idx = flat.argmin(1) if is_ascend else flat.argmax(1)
        i, j = idx // m, idx % m
        v = flat[ar, idx]
        ok = (v <= threshold) if is_ascend else (v >= threshold)
        r_i, c_j = rows[ar, i], cols[ar, j]
        rows[ar, i] = torch.where(ok & (r_i < 0), j.float(), r_i)
        cols[ar, j] = torch.where(ok & (c_j < 0), i.float(), c_j)
        d[ar, i, :] = big
        d[ar, :, j] = big
    return (rows.reshape(shape[:-1]),
            cols.reshape(tuple(shape[:-2]) + (shape[-1],)))


# ---------------------------------------------------------------------------
# Adaptive pooling / bilinear resize
# ---------------------------------------------------------------------------
@register("_contrib_AdaptiveAvgPooling2D", aliases=("AdaptiveAvgPooling2D",))
def _adaptive_avg_pool(data, output_size=(1, 1)):
    """Bin (py, px) averages rows [py·H/oh floor, (py+1)·H/oh ceil) and the
    like columns."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    return F.adaptive_avg_pool2d(data, (int(output_size[0]),
                                        int(output_size[1])))


@register("_contrib_BilinearResize2D", aliases=("BilinearResize2D",))
def _bilinear_resize(data, height=1, width=1, scale_height=None,
                     scale_width=None, mode="size"):
    """Bilinear resize with aligned corners to (height, width), or by
    ``scale_height`` / ``scale_width`` (truncated shape rule;
    bilinear_resize-inl.h).  Only ``mode="size"``, as in the JAX
    package."""
    if mode != "size":
        raise NotImplementedError(
            "BilinearResize2D mode=%r: only the size/scale surface "
            "(bilinear_resize-inl.h:50-63); compute the target size "
            "explicitly" % mode)
    _, _, h, w = data.shape
    if scale_height is not None:
        if scale_width is None:
            scale_width = scale_height
        height = int(h * float(scale_height))
        width = int(w * float(scale_width))
    oh, ow = int(height), int(width)
    ys = torch.linspace(0, h - 1, oh, dtype=data.dtype, device=data.device)
    xs = torch.linspace(0, w - 1, ow, dtype=data.dtype, device=data.device)
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    dy = (ys - y0)[None, None, :, None]
    dx = (xs - x0)[None, None, None, :]
    yi0, xi0, yi1, xi1 = y0.long(), x0.long(), y1.long(), x1.long()
    v00 = data[:, :, yi0][:, :, :, xi0]
    v01 = data[:, :, yi0][:, :, :, xi1]
    v10 = data[:, :, yi1][:, :, :, xi0]
    v11 = data[:, :, yi1][:, :, :, xi1]
    return (v00 * (1 - dy) * (1 - dx) + v01 * (1 - dy) * dx
            + v10 * dy * (1 - dx) + v11 * dy * dx)


# ---------------------------------------------------------------------------
# boolean_mask / index ops
# ---------------------------------------------------------------------------
@register("_contrib_boolean_mask", aliases=("boolean_mask",), no_grad=True)
def _boolean_mask(data, index, axis=0):
    """Slices of ``data`` along ``axis`` where ``index != 0``.  The output's
    shape depends on the mask (one read of it on the host); the
    selection is a gather, so the gradient reaches the selected slices,
    as through the JAX package's ``nd.contrib.boolean_mask``."""
    idx = torch.nonzero(index.reshape(-1) != 0).reshape(-1)
    return data.index_select(int(axis), idx.to(data.device))


@register("_contrib_index_copy", aliases=("index_copy",),
          input_names=("old_tensor", "index_vector", "new_tensor"))
def _index_copy(old_tensor, index_vector, new_tensor):
    return old_tensor.index_copy(0, index_vector.long(),
                                 new_tensor.to(old_tensor.dtype))


@register("_contrib_index_array", aliases=("index_array",), no_grad=True)
@constant
def _index_array(data, axes=None):
    """Each element's coordinates along ``axes`` (all by default), in the
    caller's order, as the last axis (int32)."""
    shp = tuple(data.shape)
    axes = tuple(range(len(shp))) if axes is None else tuple(axes)
    planes = []
    for a in axes:
        view = [1] * len(shp)
        view[a] = shp[a]
        planes.append(torch.arange(shp[a], device=data.device)
                      .reshape(view).expand(shp))
    return torch.stack(planes, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# quadratic, fft, scaling helpers
# ---------------------------------------------------------------------------
@register("_contrib_quadratic", aliases=("quadratic",))
def _quadratic(data, a=0.0, b=0.0, c=0.0):
    return a * data * data + b * data + c


@register("_contrib_fft", aliases=("fft",))
def _fft(data, compute_size=128):
    """FFT along the last axis; real and imaginary parts interleaved (the
    last axis doubled), f32."""
    f = torch.fft.fft(data.to(torch.complex64), dim=-1)
    out = torch.stack([f.real, f.imag], dim=-1)
    return out.reshape(tuple(data.shape[:-1]) + (2 * data.shape[-1],)) \
        .to(torch.float32)


@register("_contrib_ifft", aliases=("ifft",))
def _ifft(data, compute_size=128):
    """The inverse of :func:`_fft`'s layout, scaled by n (the reference's
    unnormalized inverse)."""
    n = data.shape[-1] // 2
    ri = data.reshape(tuple(data.shape[:-1]) + (n, 2)).to(torch.float32)
    comp = torch.complex(ri[..., 0], ri[..., 1])
    return torch.fft.ifft(comp, dim=-1).real.to(torch.float32) * n


@register("_contrib_div_sqrt_dim", aliases=("div_sqrt_dim",))
def _div_sqrt_dim(x):
    """``x / sqrt(last dim)`` as ``x · (1 / sqrt(d))`` in x's dtype (the
    attention-logit scaling helper)."""
    d = torch.full((), float(x.shape[-1]), dtype=x.dtype, device=x.device)
    return x * (1.0 / torch.sqrt(d))


class _GradientMultiplier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        s = ctx.scalar
        s = s.to(g.dtype) if torch.is_tensor(s) else s
        return g * s, None


@register("_contrib_gradientmultiplier", aliases=("gradientmultiplier",))
def _gradient_multiplier(x, scalar=1.0):
    """Identity forward, the gradient scaled by ``scalar`` on the way back
    (gradient reversal when negative)."""
    return _GradientMultiplier.apply(x, scalar)


@register("_contrib_allclose", aliases=("allclose",), no_grad=True)
@constant
def _allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=True):
    """1.0 where every ``|a - b| <= atol + rtol·|b|``, else 0.0 (f32
    scalar, computed on the device)."""
    return torch.isclose(a, b.to(a.dtype), rtol=rtol, atol=atol,
                         equal_nan=bool(equal_nan)).all().to(torch.float32)


@register("_contrib_arange_like", aliases=("arange_like",), no_grad=True)
@constant
def _arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    rep = max(int(repeat), 1)

    def seq(n):
        vals = torch.arange(n, dtype=data.dtype, device=data.device) // rep
        return start + step * vals

    if axis is None:
        return seq(data.numel()).reshape(data.shape)
    return seq(data.shape[int(axis)])


@register("_contrib_count_sketch", aliases=("count_sketch",),
          input_names=("data", "h", "s"))
def _count_sketch(data, h, s, out_dim=1, processing_batch_size=32):
    """Count-sketch projection: ``out[n, h[i]] += s[i] · data[n, i]`` (one
    scatter-add; compact bilinear pooling's building block)."""
    lead = tuple(data.shape[:-1])
    d = data.reshape(-1, data.shape[-1])
    out = torch.zeros((d.shape[0], int(out_dim)), dtype=data.dtype,
                      device=data.device)
    out = out.index_add(1, h.reshape(-1).long(),
                        d * s.reshape(-1).to(data.dtype)[None, :])
    return out.reshape(lead + (int(out_dim),))
