"""Fused layer kernels: RMSNorm and softmax cross-entropy.

Counterpart of ``mxnet_tpu/ops/pallas/layers.py``.  Each public function is
differentiable (a :class:`torch.autograd.Function`, the counterpart of the
JAX custom VJP) and runs its hand-written CUDA kernel on a CUDA tensor and
its plain PyTorch version on a CPU tensor:

* :func:`fused_rmsnorm` — forward ``csrc/rmsnorm.cu``, in the variant
  :func:`plan_rmsnorm` picks from the shape and layout (``warp``: rows to
  warps on a persistent grid, for many rows; ``block``: one CTA a row, for
  few rows or rows of 16-128 KB; ``simt``: the scalar kernel, for layouts
  the 16-byte vectors cannot read); each launch counts as
  ``kernels.launch.fused_rmsnorm`` and as
  ``kernels.launch.fused_rmsnorm.<variant>``.
  The backward is the plain math of ``_rmsnorm_op_bwd``, which is lax math
  and no Pallas kernel in JAX either, so it is the same torch code on both
  devices;
* :func:`fused_softmax_xent` — forward ``csrc/softmax_xent.cu``
  (``xent_fwd_kernel``), backward the same file's ``xent_bwd_kernel``.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from . import _build
from .common import count_launch, register_impl, select_impl, sm_count

__all__ = ["fused_rmsnorm", "fused_rmsnorm_reference", "plan_rmsnorm",
           "rmsnorm_bwd_reference", "fused_softmax_xent",
           "softmax_xent_reference", "softmax_xent_bwd_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def fused_rmsnorm_reference(x, scale, eps=1e-6):
    """Plain PyTorch RMSNorm with the TPU kernel's rounding: the variance in
    f32, ``x·rsqrt(mean(x²)+eps)`` rounded to the model dtype, then
    multiplied by ``scale`` in the model dtype (a second rounding)."""
    xf = x.float()
    var = (xf * xf).sum(-1, keepdim=True) / x.shape[-1]
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rmsnorm_bwd_reference(x, scale, g, eps=1e-6):
    """The gradient of RMSNorm, as ``_rmsnorm_op_bwd`` computes it: in f32,
    ``dx = g·s·r − x·mean(g·s·x)·r³`` and ``dscale = Σ_rows g·x·r``, cast
    to the dtypes of ``x`` and ``scale``.  x, g: [..., E]; scale: [E]."""
    E = x.shape[-1]
    xf = x.reshape(-1, E).float()
    g2 = g.reshape(-1, E).float()
    gf = g2 * scale.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    dx = gf * r - xf * ((gf * xf).sum(-1, keepdim=True) / E) * r ** 3
    dscale = (g2 * xf * r).sum(0)
    return dx.to(x.dtype).reshape(x.shape), dscale.to(scale.dtype)


_VEC_BYTES = 16           # one vector access: 8 bf16 or 4 f32 values
_MAX_VEC = 8              # vectors of a row a thread holds: 32 registers
_WARP_CTA_WARPS = 8       # warp variant: at most 8 warps (256 threads) a CTA
_WARP_MAX_WPR = 4         # ... and at most 4 warps on one row (16 KB)
_BLOCK_MAX_THREADS = 1024
_CTAS_PER_SM = 2          # the warp variant's persistent grid
_SIMT_THREADS = 256
_MAX_GRID = 2 ** 31 - 1


class RMSNormPlan(collections.namedtuple(
        "RMSNormPlan", "variant warps_per_row rows_per_cta vec_per_thread "
        "threads grid")):
    """How one RMSNorm call runs on the card.  ``variant``: ``"warp"``,
    ``"block"`` or ``"simt"``; ``warps_per_row``: the warps that share one
    row; ``rows_per_cta``: the rows a CTA works on at once;
    ``vec_per_thread``: the 16-byte vectors of a row each thread holds in
    registers (0 for simt's scalar loads); ``threads``: a CTA's threads;
    ``grid``: its CTAs (persistent for warp: each row group walks the rows
    ``grid · rows_per_cta`` apart)."""


def _cdiv(a, b):
    return -(-a // b)


def _pow2_at_least(n):
    p = 1
    while p < n:
        p *= 2
    return p


def _warp_plan(n_rows, chunks, num_sms):
    """The warp variant for rows of ``chunks`` 16-byte vectors, or None for
    rows wider than ``_WARP_MAX_WPR`` warps hold (16 KB).  The fewest warps
    a row whose threads hold at most ``_MAX_VEC`` vectors each (rows up to
    4 KB on one warp, so no barrier on the row); as many rows a CTA as
    fill every SM (up to 8 warps), and at most ``_CTAS_PER_SM`` CTAs per
    SM, persistent."""
    wpr = _pow2_at_least(_cdiv(chunks, 32 * _MAX_VEC))
    if wpr > _WARP_MAX_WPR:
        return None
    vpt = _pow2_at_least(_cdiv(chunks, 32 * wpr))
    rows = max(1, min(_WARP_CTA_WARPS // wpr, n_rows // num_sms))
    grid = min(_cdiv(n_rows, rows), _CTAS_PER_SM * num_sms)
    return RMSNormPlan("warp", wpr, rows, vpt, 32 * wpr * rows, grid)


def _block_plan(n_rows, chunks):
    """The block variant (one CTA a row), or None for rows wider than
    ``_BLOCK_MAX_THREADS · _MAX_VEC`` vectors (128 KB).  The fewest vectors
    a thread that keep the CTA within 1024 threads."""
    vpt = _pow2_at_least(_cdiv(chunks, _BLOCK_MAX_THREADS))
    if vpt > _MAX_VEC:
        return None
    threads = 32 * _cdiv(_cdiv(chunks, vpt), 32)
    return RMSNormPlan("block", threads // 32, 1, vpt, threads, n_rows)


def _simt_plan(n_rows):
    return RMSNormPlan("simt", _SIMT_THREADS // 32, 1, 0, _SIMT_THREADS,
                       n_rows)


def _vector_chunks(E, itemsize, row_stride, base_align):
    """The 16-byte vectors of a row when the vector variants can read it
    (the row, its stride and the bases of x and scale all whole vectors),
    else None."""
    if (E * itemsize % _VEC_BYTES or row_stride * itemsize % _VEC_BYTES
            or base_align % _VEC_BYTES):
        return None
    return E * itemsize // _VEC_BYTES


def plan_rmsnorm(n_rows, E, dtype, row_stride, base_align, num_sms):
    """The plan for RMSNorm over ``n_rows`` rows of ``E`` values of
    ``dtype`` (``torch.float32`` or ``torch.bfloat16``), rows
    ``row_stride`` elements apart, on a card with ``num_sms`` SMs.
    ``base_align``: the alignment in bytes of x's and scale's base
    addresses (16 or any multiple of it when both are 16-byte aligned).

    * ``simt`` for any layout the vector variants cannot read (a row, row
      stride or base that is not whole 16-byte vectors: odd E, offset
      views) and for rows wider than 128 KB, which no SM holds in
      registers;
    * ``warp`` for more rows than SMs, on rows up to 16 KB (bf16 E <=
      8192, f32 E <= 4096): the prefills and training steps;
    * ``block`` otherwise: at most one row per SM (decode), or rows of 16
      to 128 KB.

    The budgets: every vector variant holds at most ``_MAX_VEC`` vectors
    (32 registers) of a row per thread; warp holds two rows (64 registers
    of data at 256 threads a CTA, two CTAs an SM, so at most 128 a thread)
    and keeps scale in shared memory (at most 16 KB); block at 1024 threads
    holds one row (and scale up to 4 vectors; at 8 it reads scale at the
    store) within the 64 registers a thread has there."""
    itemsize = _ITEMSIZE[dtype]
    chunks = _vector_chunks(E, itemsize, row_stride if n_rows > 1 else E,
                            base_align)
    if chunks is None:
        return _simt_plan(n_rows)
    if n_rows > num_sms:
        plan = _warp_plan(n_rows, chunks, num_sms)
        if plan is not None:
            return plan
    return _block_plan(n_rows, chunks) or _simt_plan(n_rows)


def _rmsnorm_configure(lib):
    vp, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_float)
    head = [vp, vp, vp, ll, i, ll, ll, f, i]
    lib.mxt_rmsnorm_simt.argtypes = head + [vp]
    lib.mxt_rmsnorm_warp.argtypes = head + [i, i, i, i, vp]
    lib.mxt_rmsnorm_block.argtypes = head + [i, i, vp]
    for fn in (lib.mxt_rmsnorm_simt, lib.mxt_rmsnorm_warp,
               lib.mxt_rmsnorm_block):
        fn.restype = ctypes.c_int
    lib.mxt_rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.mxt_rmsnorm_error_string.restype = ctypes.c_char_p


def _rmsnorm_operands(x, scale):
    """Check the inputs of a launch; returns ``(x2 [N, E] with unit column
    stride, scale [E] contiguous in x's dtype, out [N, E] empty)``."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError("fused_rmsnorm: dtype %s not supported (float32, "
                        "bfloat16)" % x.dtype)
    E = x.shape[-1]
    if tuple(scale.shape) != (E,):
        raise ValueError("fused_rmsnorm: scale shape %s, expected (%d,)"
                         % (tuple(scale.shape), E))
    if scale.device != x.device:
        raise ValueError("fused_rmsnorm: scale on %s, x on %s"
                         % (scale.device, x.device))
    if E >= 2 ** 31:
        raise ValueError("fused_rmsnorm: %d features" % E)
    scale = scale.to(x.dtype).contiguous()
    x2 = x.reshape(-1, E)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    out = torch.empty((x2.shape[0], E), dtype=x.dtype, device=x.device)
    return x2, scale, out


def _layout(x2, scale):
    """``(row_stride, base_align)`` of :func:`plan_rmsnorm` for ``x2``."""
    n, E = x2.shape
    return (x2.stride(0) if n > 1 else E,
            math.gcd(x2.data_ptr(), scale.data_ptr(), _VEC_BYTES))


def _rmsnorm_launch(x2, scale, out, eps, plan):
    """Launch ``plan`` on operands checked by :func:`_rmsnorm_operands`;
    counts it as ``fused_rmsnorm`` and ``fused_rmsnorm.<variant>``."""
    n, E = x2.shape
    if n == 0:
        return out
    if plan.grid > _MAX_GRID:
        raise ValueError("fused_rmsnorm: %d rows need %d CTAs" % (n,
                                                                 plan.grid))
    lib = _build.load("rmsnorm", _rmsnorm_configure)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    args = (x2.data_ptr(), scale.data_ptr(), out.data_ptr(), n, E,
            x2.stride(0) if n > 1 else E, out.stride(0), float(eps),
            _DTYPE_CODE[x2.dtype])
    count_launch("fused_rmsnorm")
    count_launch("fused_rmsnorm." + plan.variant)
    if plan.variant == "warp":
        rc = lib.mxt_rmsnorm_warp(*args, plan.warps_per_row,
                                  plan.vec_per_thread, plan.rows_per_cta,
                                  plan.grid, stream)
    elif plan.variant == "block":
        rc = lib.mxt_rmsnorm_block(*args, plan.vec_per_thread, plan.threads,
                                   stream)
    else:
        rc = lib.mxt_rmsnorm_simt(*args, stream)
    _build.check(lib, "mxt_rmsnorm", rc)
    return out


def _forced(variant, x, scale, eps):
    """Launch ``variant`` whatever the planner would take; raises
    :class:`ValueError` on a layout or width it cannot take."""
    x2, scale, out = _rmsnorm_operands(x, scale)
    n, E = x2.shape
    if variant == "simt":
        plan = _simt_plan(n)
    else:
        chunks = _vector_chunks(E, x2.element_size(), *_layout(x2, scale))
        if chunks is None:
            raise ValueError(
                "fused_rmsnorm (%s variant): needs a row of whole 16-byte "
                "vectors, a row stride of whole vectors and 16-byte-aligned "
                "bases; got E %d, stride %d, offsets %d / %d (%s)"
                % (variant, E, x2.stride(0), x2.data_ptr() % 16,
                   scale.data_ptr() % 16, x2.dtype))
        plan = (_warp_plan(n, chunks, sm_count(x2.device)) if variant == "warp"
                else _block_plan(n, chunks))
        if plan is None:
            raise ValueError("fused_rmsnorm (%s variant): a row of %d "
                             "bytes is too wide" % (variant,
                                                    E * x2.element_size()))
    return _rmsnorm_launch(x2, scale, out, eps, plan).reshape(x.shape)


def _rmsnorm_warp_cuda(x, scale, eps=1e-6):
    """The ``warp`` variant of ``csrc/rmsnorm.cu`` (rows to warps,
    persistent) on CUDA tensor ``x`` [..., E]."""
    return _forced("warp", x, scale, eps)


def _rmsnorm_block_cuda(x, scale, eps=1e-6):
    """The ``block`` variant of ``csrc/rmsnorm.cu`` (one CTA a row)."""
    return _forced("block", x, scale, eps)


def _rmsnorm_simt_cuda(x, scale, eps=1e-6):
    """The ``simt`` variant of ``csrc/rmsnorm.cu`` (scalar loads; any
    layout)."""
    return _forced("simt", x, scale, eps)


def _rmsnorm_cuda(x, scale, eps=1e-6):
    """RMSNorm on CUDA tensor ``x`` [..., E]: the variant
    :func:`plan_rmsnorm` names for its shape and layout."""
    x2, scale, out = _rmsnorm_operands(x, scale)
    n, E = x2.shape
    plan = plan_rmsnorm(n, E, x2.dtype, *_layout(x2, scale),
                        sm_count(x2.device))
    return _rmsnorm_launch(x2, scale, out, eps, plan).reshape(x.shape)


class _RMSNorm(torch.autograd.Function):
    """The custom VJP ``_rmsnorm_op``: the kernel forward, the plain
    backward, saving ``(x, scale)``."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        fn, _ = select_impl("fused_rmsnorm", x)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return fn(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_reference(x, scale, g, ctx.eps)
        return dx, dscale, None


def fused_rmsnorm(x, scale, eps=1e-6):
    """RMSNorm over the last axis: ``x * rsqrt(mean(x^2) + eps) * scale``.

    x: [..., E]; scale: [E], cast to ``x.dtype`` in the forward.  The CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor.
    Differentiable in ``x`` and ``scale``."""
    return _RMSNorm.apply(x, scale, eps)


register_impl("fused_rmsnorm", cuda=_rmsnorm_cuda,
              reference=fused_rmsnorm_reference)


# ---------------------------------------------------------------------------
# softmax cross-entropy
# ---------------------------------------------------------------------------

def softmax_xent_reference(logits, labels, return_lse=False):
    """Plain per-row softmax cross-entropy with the TPU kernel's
    semantics: in f32, ``loss = logsumexp(s) − s[label]``, where a label
    outside ``[0, V)`` picks no gold logit (gold 0).  logits: [..., V];
    labels: [...] integer.  Returns ``loss`` (f32, ``labels.shape``), or
    ``(loss, lse)``."""
    lf = logits.float()
    V = lf.shape[-1]
    lab = labels.long()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, lab.clamp(0, V - 1)[..., None])[..., 0]
    gold = torch.where((lab >= 0) & (lab < V), gold, torch.zeros_like(gold))
    loss = lse - gold
    return (loss, lse) if return_lse else loss


def softmax_xent_bwd_reference(logits, labels, lse, g):
    """Plain gradient of the per-row loss: ``(exp(s − lse) − onehot(label))
    · g`` in f32, cast to the logits dtype.  ``g`` has ``labels.shape``."""
    lf = logits.float()
    V = lf.shape[-1]
    cols = torch.arange(V, device=lf.device)
    onehot = (cols == labels.long()[..., None]).float()
    p = torch.exp(lf - lse[..., None])
    return ((p - onehot) * g.float()[..., None]).to(logits.dtype)


def _xent_configure(lib):
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.mxt_xent_fwd.argtypes = [vp, vp, vp, vp, ll, i, ll, i, vp]
    lib.mxt_xent_fwd.restype = ctypes.c_int
    lib.mxt_xent_bwd.argtypes = [vp, vp, vp, vp, vp, ll, i, ll, ll, ll, i,
                                 vp]
    lib.mxt_xent_bwd.restype = ctypes.c_int
    lib.mxt_xent_error_string.argtypes = [ctypes.c_int]
    lib.mxt_xent_error_string.restype = ctypes.c_char_p


def _xent_rows(logits, labels):
    """Check the inputs and view them as rows: ``(l2 [N, V], lab [N]
    int64)``.  ``l2`` is a view whenever the class axis has unit stride (a
    copy otherwise); ``lab`` is copied only when not int64 or not
    contiguous."""
    if logits.dtype not in _DTYPE_CODE:
        raise TypeError("fused_softmax_xent: logits dtype %s not supported "
                        "(float32, bfloat16)" % logits.dtype)
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise TypeError("fused_softmax_xent: labels must be integers, got "
                        "%s" % labels.dtype)
    if tuple(labels.shape) != tuple(logits.shape[:-1]):
        raise ValueError("fused_softmax_xent: labels shape %s, expected %s"
                         % (tuple(labels.shape), tuple(logits.shape[:-1])))
    if labels.device != logits.device:
        raise ValueError("fused_softmax_xent: labels on %s, logits on %s"
                         % (labels.device, logits.device))
    V = logits.shape[-1]
    if V < 1 or V >= 2 ** 31:
        raise ValueError("fused_softmax_xent: %d classes" % V)
    l2 = logits.reshape(-1, V)
    if l2.stride(-1) != 1:
        l2 = l2.contiguous()
    lab = labels.reshape(-1).to(torch.int64).contiguous()
    return l2, lab


def _xent_fwd_cuda(logits, labels):
    """Launch ``xent_fwd_kernel``; returns ``(loss, lse)``, f32,
    ``labels.shape``."""
    l2, lab = _xent_rows(logits, labels)
    N, V = l2.shape
    loss = torch.empty(N, dtype=torch.float32, device=logits.device)
    lse = torch.empty(N, dtype=torch.float32, device=logits.device)
    if N:
        lib = _build.load("softmax_xent", _xent_configure)
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        count_launch("fused_softmax_xent")
        rc = lib.mxt_xent_fwd(l2.data_ptr(), lab.data_ptr(), loss.data_ptr(),
                              lse.data_ptr(), N, V, l2.stride(0),
                              _DTYPE_CODE[logits.dtype], stream)
        _build.check(lib, "mxt_xent", rc)
    return loss.reshape(labels.shape), lse.reshape(labels.shape)


def _xent_bwd_cuda(logits, labels, lse, g):
    """Launch ``xent_bwd_kernel``; returns ``dlogits`` in the logits dtype.
    ``g`` is read through its stride, so the expanded (stride 0) cotangent
    of a ``.mean()`` goes in without a copy."""
    l2, lab = _xent_rows(logits, labels)
    N, V = l2.shape
    lse1 = lse.reshape(-1).float().contiguous()
    g1 = g.reshape(-1).float()
    if lse1.numel() != N or g1.numel() != N:
        raise ValueError("fused_softmax_xent: lse/g hold %d/%d rows, "
                         "expected %d" % (lse1.numel(), g1.numel(), N))
    out = torch.empty((N, V), dtype=logits.dtype, device=logits.device)
    if N:
        lib = _build.load("softmax_xent", _xent_configure)
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        count_launch("fused_softmax_xent_bwd")
        rc = lib.mxt_xent_bwd(l2.data_ptr(), lab.data_ptr(), lse1.data_ptr(),
                              g1.data_ptr(), out.data_ptr(), N, V,
                              l2.stride(0), g1.stride(0), out.stride(0),
                              _DTYPE_CODE[logits.dtype], stream)
        _build.check(lib, "mxt_xent", rc)
    return out.reshape(logits.shape)


class _SoftmaxXent(torch.autograd.Function):
    """The custom VJP ``_xent_op``: saves ``(logits, labels, lse)``; the
    backward is the second kernel."""

    @staticmethod
    def forward(ctx, logits, labels):
        fn, _ = select_impl("fused_softmax_xent", logits)
        loss, lse = fn(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        fn, _ = select_impl("fused_softmax_xent_bwd", logits)
        return fn(logits, labels, lse, g), None


def fused_softmax_xent(logits, labels):
    """Per-example softmax cross-entropy: ``logsumexp(logits) −
    logits[label]``.

    logits: [..., V] f32 or bf16; labels: [...] integer.  Returns the loss
    with shape ``labels.shape`` (f32).  Differentiable in ``logits``: the
    backward writes ``(softmax − onehot)·g`` in the logits dtype in one
    pass."""
    return _SoftmaxXent.apply(logits, labels)


register_impl("fused_softmax_xent", cuda=_xent_fwd_cuda,
              reference=functools.partial(softmax_xent_reference,
                                          return_lse=True))
register_impl("fused_softmax_xent_bwd", cuda=_xent_bwd_cuda,
              reference=softmax_xent_bwd_reference)
