"""Spatial and warping operators: UpSampling, GridGenerator,
BilinearSampler, SpatialTransformer, ROIPooling, Crop, MakeLoss, SVMOutput
and Correlation.

Counterpart of ``mxnet_tpu/ops/spatial.py`` (reference ``upsampling.cc``,
``grid_generator.cc``, ``bilinear_sampler.cc``, ``spatial_transformer.cc``,
``roi_pooling.cc``, ``crop.cc``, ``make_loss.cc``, ``svm_output.cc``,
``correlation.cc``), with the same names, inputs and arithmetic: NCHW at
the API, grids in the reference's normalized [-1, 1] coordinates.  The
JAX package writes these as gathers and weighted sums for XLA and has no
kernel for them; here they are the same gathers in PyTorch, and the
gradients come from autograd, except where the JAX package defines its
own (MakeLoss, SVMOutput, and ROIPooling's, whose memory form differs:
see :func:`_roi_pooling`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["c_round", "div_const"]


def div_const(x, n):
    """``x / n`` for a constant ``n`` as the JAX package computes it under
    ``jit`` (XLA turns a division by a constant into a product with the
    constant's f32 reciprocal) and as PyTorch computes it on the card (a
    division by a CPU scalar): ``x · f32(1 / f32(n))``, the same bits on
    both devices.  A bin edge that depends on it (``floor`` / ``ceil``)
    then lands where the JAX package puts it."""
    if x.dtype == torch.float64:
        return x * (1.0 / n)
    return x * float(np.float32(1.0) / np.float32(n))


def c_round(x):
    """C ``round()``: half away from zero, exact for either sign (the
    reference snaps ROI coordinates with it; ``torch.round`` is
    half-to-even, which differs exactly at halves)."""
    return torch.trunc(x + torch.where(x >= 0, 0.5, -0.5).to(x.dtype))


# ---------------------------------------------------------------------------
# UpSampling
# ---------------------------------------------------------------------------
@register("UpSampling", input_names=("data",))
def _upsampling(data, scale=2, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat", workspace=None):
    """Nearest repeats pixels; bilinear is the half-pixel linear resize
    (``jax.image.resize(..., "linear")`` up by an integer factor: the edge
    rows and columns take their nearest pixel)."""
    scale = int(scale)
    if sample_type == "nearest":
        return data.repeat_interleave(scale, 2).repeat_interleave(scale, 3)
    return F.interpolate(data, scale_factor=scale, mode="bilinear",
                         align_corners=False)


# ---------------------------------------------------------------------------
# GridGenerator
# ---------------------------------------------------------------------------
def _base_grid(h, w, dtype, device):
    ys = torch.linspace(-1.0, 1.0, h, dtype=dtype, device=device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx, gy                                   # (H, W) each


@register("GridGenerator", input_names=("data",))
def _grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """affine: (N, 6) parameters -> (N, 2, H, W) sampling grid; warp:
    (N, 2, H, W) flow in pixels added to the identity grid."""
    if transform_type == "affine":
        h, w = int(target_shape[0]), int(target_shape[1])
        theta = data.reshape(-1, 2, 3)
        gx, gy = _base_grid(h, w, data.dtype, data.device)
        coords = torch.stack([gx.reshape(-1), gy.reshape(-1),
                              torch.ones_like(gx).reshape(-1)])  # (3, HW)
        return torch.einsum("nij,jk->nik", theta, coords).reshape(-1, 2, h, w)
    _, _, h, w = data.shape
    gx, gy = _base_grid(h, w, data.dtype, data.device)
    fx = data[:, 0] * 2.0 / max(w - 1, 1)
    fy = data[:, 1] * 2.0 / max(h - 1, 1)
    return torch.stack([gx[None] + fx, gy[None] + fy], dim=1)


# ---------------------------------------------------------------------------
# BilinearSampler / SpatialTransformer
# ---------------------------------------------------------------------------
def _tap(flat, yi, xi, h, w):
    """``flat`` (N, C, H*W) read at integer-valued float coordinates
    ``yi``, ``xi`` (N, Ho, Wo); 0 outside the image."""
    n, c, _ = flat.shape
    inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long())
    v = flat.gather(2, idx.reshape(n, 1, -1).expand(n, c, -1))
    v = v.reshape((n, c) + tuple(yi.shape[1:]))
    return torch.where(inside[:, None], v, torch.zeros((), dtype=v.dtype,
                                                       device=v.device))


@register("BilinearSampler", input_names=("data", "grid"))
def _bilinear_sampler(data, grid, cudnn_off=None):
    """``data`` (N, C, H, W) sampled at ``grid`` (N, 2, Ho, Wo) in [-1, 1]
    with zero padding outside."""
    _, _, h, w = data.shape
    x = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    y = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = x - x0, y - y0
    flat = data.reshape(data.shape[0], data.shape[1], -1)
    v00 = _tap(flat, y0, x0, h, w)
    v01 = _tap(flat, y0, x0 + 1, h, w)
    v10 = _tap(flat, y0 + 1, x0, h, w)
    v11 = _tap(flat, y0 + 1, x0 + 1, h, w)
    wx0, wx1 = (1 - dx)[:, None], dx[:, None]
    wy0, wy1 = (1 - dy)[:, None], dy[:, None]
    return v00 * wy0 * wx0 + v01 * wy0 * wx1 + \
        v10 * wy1 * wx0 + v11 * wy1 * wx1


@register("SpatialTransformer", input_names=("data", "loc"))
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=None):
    return _bilinear_sampler(data, _grid_generator(loc, "affine",
                                                   target_shape))


# ---------------------------------------------------------------------------
# ROIPooling
# ---------------------------------------------------------------------------
_ROI_CHUNK_BYTES = 1 << 28      # a masked temporary's bytes, at most


def _roi_bins(rois, pooled_size, spatial_scale):
    """Each ROI's bins as integer-valued float bounds: ``(bi, ys0, ye,
    xs0, xe)``, ``bi`` (R,), the others (R, ph) and (R, pw); a bin covers
    rows ``[ys0, ye)`` and columns ``[xs0, xe)``."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    x1 = c_round(rois[:, 1] * spatial_scale)
    y1 = c_round(rois[:, 2] * spatial_scale)
    x2 = c_round(rois[:, 3] * spatial_scale)
    y2 = c_round(rois[:, 4] * spatial_scale)
    rh = torch.clamp(y2 - y1 + 1.0, min=1.0)[:, None]
    rw = torch.clamp(x2 - x1 + 1.0, min=1.0)[:, None]
    py = torch.arange(ph, device=rois.device)
    px = torch.arange(pw, device=rois.device)
    ys0 = torch.floor(y1[:, None] + div_const(py * rh, ph))
    ye = torch.ceil(y1[:, None] + div_const((py + 1) * rh, ph))
    xs0 = torch.floor(x1[:, None] + div_const(px * rw, pw))
    xe = torch.ceil(x1[:, None] + div_const((px + 1) * rw, pw))
    return rois[:, 0].long(), ys0, ye, xs0, xe


def _roi_chunks(n_rois, plane_elems, itemsize):
    step = max(1, _ROI_CHUNK_BYTES // max(plane_elems * itemsize, 1))
    return [(s, min(s + step, n_rois)) for s in range(0, n_rois, step)]


def _roi_pool_forward(data, bi, ys0, ye, xs0, xe):
    """The bins' maxima, (R, C, ph, pw); 0 for an empty bin.  A bin's
    rectangle max is the max over its rows of each row's max over its
    columns, so the masked temporaries are pw of (R, C, H, W) and ph of
    (R, C, H), not ph·pw of (R, C, H, W), in ROI chunks of at most 256
    MB each."""
    _, c, h, w = data.shape
    R, ph, pw = bi.shape[0], ys0.shape[1], xs0.shape[1]
    out = data.new_zeros((R, c, ph, pw))
    ys = torch.arange(h, device=data.device)
    xs = torch.arange(w, device=data.device)
    ninf = torch.full((), float("-inf"), dtype=data.dtype, device=data.device)
    for s, e in _roi_chunks(R, c * h * w, data.element_size()):
        img = data[bi[s:e]]                                  # (r, C, H, W)
        for px in range(pw):
            cm = (xs >= xs0[s:e, px, None]) & (xs < xe[s:e, px, None])
            rowmax = torch.where(cm[:, None, None, :], img, ninf).amax(3)
            for py in range(ph):
                rm = (ys >= ys0[s:e, py, None]) & (ys < ye[s:e, py, None])
                v = torch.where(rm[:, None, :], rowmax, ninf).amax(2)
                out[s:e, :, py, px] = torch.where(torch.isfinite(v), v, 0.0)
    return out


class _ROIPool(torch.autograd.Function):
    """ROIPooling with the JAX package's gradient: each bin's cotangent
    split evenly over the positions that hold its max (``amax``'s rule;
    an empty bin's goes nowhere), accumulated into the ROI's image.  The
    backward walks the bins one at a time, in ROI chunks."""

    @staticmethod
    def forward(ctx, data, rois, pooled_size, spatial_scale):
        bi, ys0, ye, xs0, xe = _roi_bins(rois, pooled_size, spatial_scale)
        out = _roi_pool_forward(data, bi, ys0, ye, xs0, xe)
        ctx.save_for_backward(data, out, bi, ys0, ye, xs0, xe)
        return out

    @staticmethod
    def backward(ctx, g):
        data, out, bi, ys0, ye, xs0, xe = ctx.saved_tensors
        _, c, h, w = data.shape
        R, ph, pw = bi.shape[0], ys0.shape[1], xs0.shape[1]
        ys = torch.arange(h, device=data.device)
        xs = torch.arange(w, device=data.device)
        gin = torch.zeros_like(data)
        for s, e in _roi_chunks(R, c * h * w, data.element_size()):
            img = data[bi[s:e]]
            acc = torch.zeros_like(img)
            for py in range(ph):
                rm = (ys >= ys0[s:e, py, None]) & (ys < ye[s:e, py, None])
                for px in range(pw):
                    cm = (xs >= xs0[s:e, px, None]) & (xs < xe[s:e, px, None])
                    m = rm[:, :, None] & cm[:, None, :]      # (r, H, W)
                    v = out[s:e, :, py, px]
                    hit = m[:, None] & (img == v[:, :, None, None])
                    cnt = hit.sum((2, 3))
                    share = torch.where(cnt > 0, g[s:e, :, py, px]
                                        / cnt.clamp(min=1), 0.0)
                    acc += hit * share[:, :, None, None]
            gin.index_add_(0, bi[s:e], acc)
        return gin, None, None, None


@register("ROIPooling", input_names=("data", "rois"))
def _roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """Max-pool each ROI into a (ph, pw) grid; ``rois`` (R, 5) rows of
    [batch_idx, x1, y1, x2, y2] in image coordinates, snapped with C
    rounding.  The same function as the JAX package's masked max per bin,
    computed separably (see :func:`_roi_pool_forward`): at Faster R-CNN's
    size ([1, 512, 38, 50], 300 ROIs) its form holds a 1.2 GB temporary
    per bin."""
    return _ROIPool.apply(data, rois, pooled_size, spatial_scale)


# ---------------------------------------------------------------------------
# Crop
# ---------------------------------------------------------------------------
@register("Crop", input_names=("data", "crop_like"))
def _crop(data, crop_like=None, offset=(0, 0), h_w=(0, 0), num_args=1,
          center_crop=False):
    if crop_like is not None:
        th, tw = crop_like.shape[2], crop_like.shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    h, w = data.shape[2], data.shape[3]
    if center_crop:
        oy, ox = (h - th) // 2, (w - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    return data[:, :, oy:oy + th, ox:ox + tw]


# ---------------------------------------------------------------------------
# MakeLoss / SVMOutput
# ---------------------------------------------------------------------------
class _MakeLoss(torch.autograd.Function):
    """Identity forward; the backward is ``grad_scale`` (normalized),
    whatever the head gradient."""

    @staticmethod
    def forward(ctx, x, grad_scale, valid_thresh, normalization):
        ctx.save_for_backward(x)
        ctx.args = (grad_scale, valid_thresh, normalization)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        grad_scale, valid_thresh, normalization = ctx.args
        if normalization == "batch":
            scale = torch.tensor(grad_scale / x.shape[0], dtype=x.dtype)
        elif normalization == "valid":
            n_valid = torch.clamp((x > valid_thresh).sum(), min=1)
            scale = grad_scale / n_valid.to(x.dtype)
        else:
            scale = torch.tensor(grad_scale, dtype=x.dtype)
        return (scale.to(x.device).expand(x.shape).clone(), None, None,
                None)


@register("MakeLoss", input_names=("data",))
def _make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """Identity forward whose backward is ``grad_scale`` (make_loss.cc:
    turns any symbol into a loss head)."""
    return _MakeLoss.apply(data, grad_scale, valid_thresh, normalization)


class _SVMOutput(torch.autograd.Function):
    """Identity on the scores; the backward is the one-vs-all (squared)
    hinge gradient, whatever the head gradient."""

    @staticmethod
    def forward(ctx, x, label, margin, coef, use_linear):
        ctx.save_for_backward(x, label)
        ctx.args = (margin, coef, use_linear)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        x, label = ctx.saved_tensors
        margin, coef, use_linear = ctx.args
        sign = 2 * F.one_hot(label.long(), x.shape[1]).to(x.dtype) - 1
        viol = torch.clamp(margin - sign * x, min=0.0)
        if use_linear:
            grad = torch.where(viol > 0, -sign, 0.0)
        else:
            grad = -2.0 * viol * sign
        return grad * coef, torch.zeros_like(label), None, None, None


@register("SVMOutput", input_names=("data", "label"))
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False):
    """Hinge-loss output head (svm_output.cc)."""
    return _SVMOutput.apply(data, label, margin, regularization_coefficient,
                            use_linear)


# ---------------------------------------------------------------------------
# Correlation
# ---------------------------------------------------------------------------
@register("Correlation", input_names=("data1", "data2"))
def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's cost volume (correlation.cc): for each of the (2r+1)^2
    displacements, the channel sum of ``data1 · shifted data2`` (or of
    ``|data1 - shifted data2|``) summed over a k×k window, over
    ``k·k·C``.  Output (B, (2r+1)^2, top_h, top_w)."""
    k, md = int(kernel_size), int(max_displacement)
    s1, s2, p = int(stride1), int(stride2), int(pad_size)
    mult = str(is_multiply).lower() in ("true", "1")
    if k % 2 != 1:
        raise ValueError("Correlation: kernel size should be odd")
    _, C, H, W = data1.shape
    rad = md // s2
    gw = 2 * rad + 1
    border = md + (k - 1) // 2
    ph, pw = H + 2 * p, W + 2 * p
    top_h = -(-(ph - 2 * border) // s1)
    top_w = -(-(pw - 2 * border) // s1)
    if top_h < 1 or top_w < 1:
        raise ValueError("Correlation: input too small for "
                         "max_displacement/kernel")
    p1 = F.pad(data1, (p, p, p, p))
    p2 = F.pad(data2, (p, p, p, p))
    ones = torch.ones((1, 1, k, k), dtype=data1.dtype, device=data1.device)
    outs = []
    for tc in range(gw * gw):
        sx = (tc % gw - rad) * s2
        sy = (tc // gw - rad) * s2
        shifted = torch.roll(p2, (-sy, -sx), dims=(2, 3))
        corr = ((p1 * shifted) if mult else (p1 - shifted).abs()).sum(1)
        win = F.conv2d(corr[:, None], ones)[:, 0]    # k×k window sums
        sl = win[:, md:md + top_h * s1:s1, md:md + top_w * s1:s1]
        outs.append(sl / (k * k * C))
    return torch.stack(outs, dim=1)
