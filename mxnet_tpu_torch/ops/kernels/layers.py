"""Fused layer kernels: RMSNorm and softmax cross-entropy.

Counterpart of ``mxnet_tpu/ops/pallas/layers.py``.  Each public function is
differentiable (a :class:`torch.autograd.Function`, the counterpart of the
JAX custom VJP) and runs its hand-written CUDA kernel on a CUDA tensor and
its plain PyTorch version on a CPU tensor:

* :func:`fused_rmsnorm` — forward ``csrc/rmsnorm.cu``; the backward is the
  plain math of ``_rmsnorm_op_bwd``, which is lax math and no Pallas kernel
  in JAX either, so it is the same torch code on both devices;
* :func:`fused_softmax_xent` — forward ``csrc/softmax_xent.cu``
  (``xent_fwd_kernel``), backward the same file's ``xent_bwd_kernel``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .common import count_launch, register_impl, select_impl

__all__ = ["fused_rmsnorm", "fused_rmsnorm_reference",
           "rmsnorm_bwd_reference", "fused_softmax_xent",
           "softmax_xent_reference", "softmax_xent_bwd_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def _rmsnorm_configure(lib):
    lib.mxt_rmsnorm_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.mxt_rmsnorm_fwd.restype = ctypes.c_int
    lib.mxt_rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.mxt_rmsnorm_error_string.restype = ctypes.c_char_p


def _rmsnorm_cuda(x, scale, eps=1e-6):
    """Launch ``csrc/rmsnorm.cu`` on CUDA tensor ``x`` [..., E]."""
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
    scale = scale.to(x.dtype).contiguous()
    x2 = x.reshape(-1, E)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    n = x2.shape[0]
    out = torch.empty((n, E), dtype=x.dtype, device=x.device)
    if n:
        lib = _build.load("rmsnorm", _rmsnorm_configure)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        count_launch("fused_rmsnorm")
        rc = lib.mxt_rmsnorm_fwd(x2.data_ptr(), scale.data_ptr(),
                                 out.data_ptr(), n, E, x2.stride(0),
                                 out.stride(0), float(eps),
                                 _DTYPE_CODE[x.dtype], stream)
        _build.check(lib, "mxt_rmsnorm", rc)
    return out.reshape(x.shape)


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
