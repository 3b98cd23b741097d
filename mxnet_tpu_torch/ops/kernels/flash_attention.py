"""Flash attention, forward and backward.

Counterpart of ``mxnet_tpu/ops/pallas/flash_attention.py``.  The public
entry points take ``[B, T, H, D]`` tensors, as the JAX package's do:

* :func:`flash_attention` -> ``o`` in ``q``'s dtype;
* :func:`flash_attention_lse` -> ``(o, lse)``, ``lse`` f32 ``[B, H, Tq]``.

Both are differentiable: one :class:`torch.autograd.Function` stands for the
two custom VJPs ``_flash`` and ``_flash_lse``.  Its forward saves ``(q, k,
v, o, lse)``; its backward computes ``delta = rowsum(dO∘O) − dlse`` in f32
with torch ops, as ``_bwd`` does (the lse cotangent folds into ``delta``,
which is what lets a merge of partials over key sets train), then runs the
dQ and dK/dV kernels.

On a CUDA tensor they launch hand-written kernels, which read the inputs
through their strides (the q/k/v slices of a fused qkv projection and a
non-contiguous ``dO`` go in without a transpose copy).  The kernels take
head_dim 16, 32, 64 or 128, or above 128 any multiple of 64; any other
head_dim is zero-padded along D to the next of those widths (a layout copy:
zero columns add 0 to q·kᵀ and dO·Vᵀ), run at that width with ``scale``
fixed from the real head_dim, and sliced back (:func:`_padded_dim`).  Only
head_dim 0 raises.  The forward and the backward each have three variants,
chosen by dtype and padded head_dim alone (:func:`_fwd_variant`,
:func:`_bwd_variant`), never by whether a build or a launch worked:

* ``wgmma`` — tensor cores (wgmma, TMA rings, the f32 operands p and ds
  split into two bf16 terms): bf16 at head_dim 64 or 128 (the flagship's
  128, the long-context configuration's 64; 48 pads to 64, 80 and 96 to
  128).  Forward ``csrc/flash_attention_wgmma.cu``; backward
  ``csrc/flash_attention_bwd_wgmma.cu`` (dQ and dK/dV).  They need
  16-byte-aligned bases and (B, T, H) strides that are multiples of 8
  elements (:func:`_check_wgmma` raises otherwise; the backward copies the
  internal cotangent ``dO`` instead);
* ``simt`` — CUDA cores: f32 up to head_dim 128 (the tensor cores have no
  f32 operand that keeps q·kᵀ exact) and head_dim 16 or 32 (less than one
  128-byte row of the swizzled tiles the wgmma variant reads).  Forward
  ``csrc/flash_attention.cu``; backward ``csrc/flash_attention_bwd.cu``;
* ``wide`` — CUDA cores, f32 and bf16 above head_dim 128 (padded to a
  multiple of 64): the dot products over D walk it in chunks of 64 and
  each CTA owns at most 128 output columns, so any head_dim fits
  (``csrc/flash_attention_wide.cu``: forward, dQ and dK/dV).  A correctness
  path: no configuration in the repository has such a head_dim yet.

Every forward launch counts as ``kernels.launch.flash_attention`` and as
``kernels.launch.flash_attention.<variant>``; every backward launch as
``kernels.launch.flash_attention_dq`` / ``flash_attention_dkv`` and as
``kernels.launch.flash_attention_dq.<variant>`` /
``flash_attention_dkv.<variant>``.  On a CPU tensor they run
:func:`flash_attention_reference` and :func:`flash_attention_bwd_reference`,
the plain dense f32 versions of the same functions, at any head_dim.
The causal mask is ``q_pos >= k_pos`` with both positions counted from 0,
as in the TPU kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .common import _NEG, count_launch, register_impl, select_impl

__all__ = ["flash_attention", "flash_attention_lse",
           "flash_attention_reference", "flash_attention_bwd_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)      # the widths the kernels are built for
_WGMMA_HEAD_DIMS = (64, 128)
_WIDE_CHUNK = 64                    # above 128, widths are multiples of it
_BWD_ROWS = 64                      # lse/delta rows per tile of the wgmma dK/dV


def flash_attention_reference(q, k, v, causal=True, scale=None,
                              return_lse=False):
    """Plain dense attention with the flash kernel's semantics: f32 scores
    ``q·kᵀ·scale``, masked with the finite ``-1e30`` filler, softmax kept in
    f32 for the P·V product (``v`` upcast), ``o = acc / l`` with 0 where
    ``l == 0``, and ``lse = m + log(l)``.  q: [B, Tq, H, D]; k, v:
    [B, Tk, H, D]."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = torch.arange(Tq, device=q.device)[:, None]
        k_pos = torch.arange(Tk, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, _NEG)
    m = s.amax(-1, keepdim=True)                       # [B, H, Tq, 1]
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    safe = torch.where(l == 0, torch.ones_like(l), l)  # fully-masked rows
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = (acc / safe.permute(0, 2, 1, 3)).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(safe))[..., 0]
    return o


def _delta(o, do, dlse):
    """``rowsum(dO∘O) − dlse`` in f32, ``[B, H, Tq]`` contiguous: the
    ``delta`` operand of both backward kernels, computed outside them as
    ``_bwd`` does."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def flash_attention_bwd_reference(q, k, v, o, lse, do, dlse=None,
                                  causal=True, scale=None):
    """Plain dense f32 version of the dQ and dK/dV kernels: ``p = exp(s −
    lse)`` recomputed from the masked scaled scores, ``dp = dO·Vᵀ``, ``ds =
    p∘(dp − delta)·scale``; ``dQ = ds·K``, ``dK = dsᵀ·Q``, ``dV = pᵀ·dO``,
    each rounded to its input's dtype.  ``dlse`` (optional) is the
    cotangent of ``lse`` [B, H, Tq].  Returns ``(dq, dk, dv)``."""
    D = q.shape[-1]
    Tq, Tk = q.shape[1], k.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        q_pos = torch.arange(Tq, device=q.device)[:, None]
        k_pos = torch.arange(Tk, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, _NEG)
    p = torch.exp(s - lse.float()[..., None])                 # [B, H, Tq, Tk]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - _delta(o, do, dlse)[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _configure(lib):
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    lib.mxt_flash_fwd.argtypes = (
        [vp] * 5 + [i] * 5 + [ll] * 12
        + [ctypes.c_float, i, i, i, vp])
    lib.mxt_flash_fwd.restype = ctypes.c_int
    lib.mxt_flash_error_string.argtypes = [i]
    lib.mxt_flash_error_string.restype = ctypes.c_char_p


def _configure_wgmma(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.mxt_flash_wgmma_fwd.argtypes = (
        [vp] * 5 + [i] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, i, vp])
    lib.mxt_flash_wgmma_fwd.restype = ctypes.c_int
    lib.mxt_flash_wgmma_error_string.argtypes = [i]
    lib.mxt_flash_wgmma_error_string.restype = ctypes.c_char_p


def _configure_bwd(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    tail = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, i, vp]
    lib.mxt_flash_bwd_dq.argtypes = [vp] * 7 + [i] * 5 + tail
    lib.mxt_flash_bwd_dq.restype = ctypes.c_int
    lib.mxt_flash_bwd_dkv.argtypes = [vp] * 8 + [i] * 5 + tail
    lib.mxt_flash_bwd_dkv.restype = ctypes.c_int
    lib.mxt_flash_bwd_error_string.argtypes = [i]
    lib.mxt_flash_bwd_error_string.restype = ctypes.c_char_p


def _configure_bwd_wgmma(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    tail = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, vp]
    lib.mxt_flash_bwd_wgmma_dq.argtypes = [vp] * 7 + [i] * 6 + tail
    lib.mxt_flash_bwd_wgmma_dq.restype = ctypes.c_int
    lib.mxt_flash_bwd_wgmma_dkv.argtypes = [vp] * 8 + [i] * 6 + tail
    lib.mxt_flash_bwd_wgmma_dkv.restype = ctypes.c_int
    lib.mxt_flash_bwd_wgmma_error_string.argtypes = [i]
    lib.mxt_flash_bwd_wgmma_error_string.restype = ctypes.c_char_p


def _configure_wide(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    tail = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i]
    lib.mxt_flash_wide_fwd.argtypes = [vp] * 5 + [i] * 5 + tail + [i, i, vp]
    lib.mxt_flash_wide_fwd.restype = ctypes.c_int
    lib.mxt_flash_wide_dq.argtypes = [vp] * 7 + [i] * 5 + tail + [i, vp]
    lib.mxt_flash_wide_dq.restype = ctypes.c_int
    lib.mxt_flash_wide_dkv.argtypes = [vp] * 8 + [i] * 5 + tail + [i, vp]
    lib.mxt_flash_wide_dkv.restype = ctypes.c_int
    lib.mxt_flash_wide_error_string.argtypes = [i]
    lib.mxt_flash_wide_error_string.restype = ctypes.c_char_p


def _check_qkv(q, k, v):
    """Refuse what the kernels do not take; returns ``(B, Tq, Tk, H,
    D)``."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError("flash_attention: q/k/v must share one dtype of "
                        "float32 or bfloat16; got %s/%s/%s"
                        % (q.dtype, k.dtype, v.dtype))
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q/k/v on different devices")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: expected q [B,Tq,H,D] and k, v "
                         "[B,Tk,H,D]; got %s, %s, %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError("flash_attention: k/v batch, heads or head_dim "
                         "differ from q's")
    if D < 1:
        raise ValueError("flash_attention: got head_dim %d; the kernels take "
                         "head_dim 1 and up" % D)
    if Tk < 1:
        raise ValueError("flash_attention: no keys")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: head_dim must be the unit-stride "
                         "axis")
    return B, Tq, Tk, H, D


def _padded_dim(head_dim):
    """The kernel width a head_dim runs at: the least of 16, 32, 64 and 128
    that holds it, and above 128 the least multiple of 64 (the ``wide``
    variant's chunk)."""
    if head_dim > _HEAD_DIMS[-1]:
        return -(-head_dim // _WIDE_CHUNK) * _WIDE_CHUNK
    return next(w for w in _HEAD_DIMS if w >= head_dim)


def _pad_d(t, width):
    """``t`` zero-padded along its last axis to ``width`` (``t`` itself when
    it has that width)."""
    D = t.shape[-1]
    return t if D == width else torch.nn.functional.pad(t, (0, width - D))


def _fwd_variant(dtype, head_dim):
    """The forward kernel for ``dtype`` and ``head_dim`` (1 and up):
    ``"wide"`` above head_dim 128, ``"wgmma"`` for bf16 whose padded
    head_dim is 64 or 128, ``"simt"`` for every other input (f32 up to 128;
    bf16 at head_dim up to 32)."""
    if head_dim > _HEAD_DIMS[-1]:
        return "wide"
    if dtype == torch.bfloat16 and _padded_dim(head_dim) in _WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def _bwd_variant(dtype, head_dim):
    """The backward kernels (dQ and dK/dV) for ``dtype`` and ``head_dim``:
    the same rule as :func:`_fwd_variant` — ``"wide"``
    (``csrc/flash_attention_wide.cu``) above head_dim 128, ``"wgmma"``
    (``csrc/flash_attention_bwd_wgmma.cu``) for bf16 at a padded head_dim
    of 64 or 128, ``"simt"`` (``csrc/flash_attention_bwd.cu``) otherwise."""
    return _fwd_variant(dtype, head_dim)


def _tma_strides(t):
    """The (B, T, H) element strides of ``t`` as the wgmma variant's tensor
    maps take them.  A size-1 axis is never stepped along, so its stride is
    replaced by the one a contiguous layout would give it (PyTorch may give
    such an axis any stride)."""
    B, T, H, D = t.shape
    sb, st, sh = t.stride()[:3]
    if H == 1:
        sh = D
    if T == 1:
        st = H * sh
    if B == 1:
        sb = T * st
    return sb, st, sh


def _tma_fault(name, t):
    """Why the wgmma variants' TMA copies cannot read ``t`` (a message), or
    ``None``: they need its base address 16-byte aligned and each (B, T, H)
    stride a multiple of 8 elements (16 bytes)."""
    if t.data_ptr() % 16:
        return ("%s's base address is not 16-byte aligned (offset %d bytes); "
                "pass a tensor whose data starts on a 16-byte boundary"
                % (name, t.data_ptr() % 16))
    for axis, stride in zip("BTH", _tma_strides(t)):
        if stride % 8:
            return ("%s's %s stride %d is not a multiple of 8 elements (16 "
                    "bytes)" % (name, axis, stride))
    return None


def _check_wgmma(q, k, v, do=None):
    """Raise :class:`ValueError` on inputs the wgmma variants cannot read
    (:func:`_tma_fault`): q, k, v and, for the backward, ``do``.  Never a
    reason to take the other variant."""
    named = (("q", q), ("k", k), ("v", v)) + (
        (("dO", do),) if do is not None else ())
    for name, t in named:
        fault = _tma_fault(name, t)
        if fault:
            raise ValueError("flash_attention (wgmma variant): " + fault)


def _check_simt_width(D):
    if D not in _HEAD_DIMS:
        raise ValueError("flash_attention (simt variant): takes head_dim in "
                         "%s; got %d (_flash_cuda pads other head dims)"
                         % (_HEAD_DIMS, D))


def _flash_simt_cuda(q, k, v, causal=True, scale=None, kv_len=None):
    """Launch the CUDA-core variant ``csrc/flash_attention.cu`` on head_dim
    16, 32, 64 or 128; returns ``(o, lse)``.  ``kv_len`` (default ``Tk``):
    keys at and past it are masked, as ``_fwd``'s argument of that name."""
    B, Tq, Tk, H, D = _check_qkv(q, k, v)
    _check_simt_width(D)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kv_len = Tk if kv_len is None else int(kv_len)
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if B * H * Tq == 0:
        return o, lse
    lib = _build.load("flash_attention", _configure)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    count_launch("flash_attention")
    count_launch("flash_attention.simt")
    rc = lib.mxt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), lse.data_ptr(), B, H, Tq, Tk, D,
                           *strides, float(scale), int(bool(causal)), kv_len,
                           _DTYPE_CODE[q.dtype], stream)
    _build.check(lib, "mxt_flash", rc)
    return o, lse


def _flash_wgmma_cuda(q, k, v, causal=True, scale=None, kv_len=None):
    """Launch the tensor-core variant ``csrc/flash_attention_wgmma.cu`` on
    bf16 inputs with head_dim 64 or 128; returns ``(o, lse)``.  Raises on
    inputs it does not take (:func:`_check_wgmma`)."""
    B, Tq, Tk, H, D = _check_qkv(q, k, v)
    _check_bf16_width(q.dtype, D)
    _check_wgmma(q, k, v)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kv_len = Tk if kv_len is None else int(kv_len)
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if B * H * Tq == 0:
        return o, lse
    lib = _build.load("flash_attention_wgmma", _configure_wgmma)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    flat = [s for t in (q, k, v) for s in _tma_strides(t)] + list(
        o.stride()[:3])
    count_launch("flash_attention")
    count_launch("flash_attention.wgmma")
    rc = lib.mxt_flash_wgmma_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, H, Tq, Tk, D, (ctypes.c_longlong * 12)(*flat),
        float(scale), int(bool(causal)), kv_len, stream)
    _build.check(lib, "mxt_flash_wgmma", rc)
    return o, lse


def _check_wide_width(D):
    if D <= _HEAD_DIMS[-1] or D % _WIDE_CHUNK:
        raise ValueError("flash_attention (wide variant): takes head_dim "
                         "above %d in multiples of %d; got %d (_flash_cuda "
                         "pads other head dims)" % (_HEAD_DIMS[-1],
                                                    _WIDE_CHUNK, D))


def _flash_wide_cuda(q, k, v, causal=True, scale=None, kv_len=None):
    """Launch the forward of ``csrc/flash_attention_wide.cu`` (CUDA cores)
    on f32 or bf16 inputs with a head_dim above 128 that is a multiple of
    64; returns ``(o, lse)``."""
    B, Tq, Tk, H, D = _check_qkv(q, k, v)
    _check_wide_width(D)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kv_len = Tk if kv_len is None else int(kv_len)
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if B * H * Tq == 0:
        return o, lse
    lib = _build.load("flash_attention_wide", _configure_wide)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    count_launch("flash_attention")
    count_launch("flash_attention.wide")
    rc = lib.mxt_flash_wide_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, H, Tq, Tk, D, _strides(q, k, v, o), float(scale),
        int(bool(causal)), kv_len, _DTYPE_CODE[q.dtype], stream)
    _build.check(lib, "mxt_flash_wide", rc)
    return o, lse


def _check_bf16_width(dtype, D):
    if dtype != torch.bfloat16 or D not in _WGMMA_HEAD_DIMS:
        raise ValueError("flash_attention (wgmma variant): takes bf16 with "
                         "head_dim in %s; got %s, head_dim %d"
                         % (_WGMMA_HEAD_DIMS, dtype, D))


def _flash_cuda(q, k, v, causal=True, scale=None, kv_len=None):
    """The forward on CUDA tensors: q, k and v padded along D to
    :func:`_padded_dim`, the variant :func:`_fwd_variant` names for q's
    dtype and head_dim, ``o`` sliced back; returns ``(o, lse)``.
    ``scale=None`` is 1/√D of the real head_dim."""
    _, _, _, _, D = _check_qkv(q, k, v)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    width = _padded_dim(D)
    launch = {"wgmma": _flash_wgmma_cuda, "simt": _flash_simt_cuda,
              "wide": _flash_wide_cuda}[_fwd_variant(q.dtype, D)]
    if width == D:
        return launch(q, k, v, causal, scale, kv_len)
    o, lse = launch(_pad_d(q, width), _pad_d(k, width), _pad_d(v, width),
                    causal, scale, kv_len)
    return o[..., :D].contiguous(), lse


def _strides(*tensors):
    """The (B, T, H) strides of each tensor, as a C array of int64."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _flash_dq_simt_cuda(q, k, v, do, lse, delta, causal=True, scale=None):
    """Launch the dQ kernel of ``csrc/flash_attention_bwd.cu`` (CUDA cores)
    on checked inputs at a kernel width (``lse``, ``delta``: f32 [B, H, Tq]
    contiguous); returns ``dq``, contiguous, in ``q``'s dtype."""
    B, Tq, H, D = q.shape
    _check_simt_width(D)
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    if B * H * Tq == 0:
        return dq
    lib = _build.load("flash_attention_bwd", _configure_bwd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    count_launch("flash_attention_dq")
    count_launch("flash_attention_dq.simt")
    rc = lib.mxt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, Tq,
        k.shape[1], D, _strides(q, k, v, do, dq), float(scale),
        int(bool(causal)), _DTYPE_CODE[q.dtype], stream)
    _build.check(lib, "mxt_flash_bwd", rc)
    return dq


def _flash_dkv_simt_cuda(q, k, v, do, lse, delta, causal=True,
                         scale=None):
    """Launch the dK/dV kernel of ``csrc/flash_attention_bwd.cu`` (CUDA
    cores) on checked inputs; returns ``(dk, dv)``, contiguous, every row
    written (rows no query sees are 0)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    _check_simt_width(D)
    dk = torch.empty((B, Tk, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Tk, H, D), dtype=v.dtype, device=q.device)
    if B * H * Tq == 0:
        return dk.zero_(), dv.zero_()
    lib = _build.load("flash_attention_bwd", _configure_bwd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    count_launch("flash_attention_dkv")
    count_launch("flash_attention_dkv.simt")
    rc = lib.mxt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
        H, Tq, Tk, D, _strides(q, k, v, do, dk, dv), float(scale),
        int(bool(causal)), _DTYPE_CODE[q.dtype], stream)
    _build.check(lib, "mxt_flash_bwd", rc)
    return dk, dv


def _flash_dq_wide_cuda(q, k, v, do, lse, delta, causal=True, scale=None):
    """Launch the dQ kernel of ``csrc/flash_attention_wide.cu`` (CUDA
    cores) on checked inputs at a wide kernel width; returns ``dq``,
    contiguous, in ``q``'s dtype."""
    B, Tq, H, D = q.shape
    _check_wide_width(D)
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    if B * H * Tq == 0:
        return dq
    lib = _build.load("flash_attention_wide", _configure_wide)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    count_launch("flash_attention_dq")
    count_launch("flash_attention_dq.wide")
    rc = lib.mxt_flash_wide_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, Tq,
        k.shape[1], D, _strides(q, k, v, do, dq), float(scale),
        int(bool(causal)), _DTYPE_CODE[q.dtype], stream)
    _build.check(lib, "mxt_flash_wide", rc)
    return dq


def _flash_dkv_wide_cuda(q, k, v, do, lse, delta, causal=True,
                         scale=None):
    """Launch the dK/dV kernel of ``csrc/flash_attention_wide.cu`` on
    checked inputs at a wide kernel width; returns ``(dk, dv)``,
    contiguous, every row written (rows no query sees are 0)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    _check_wide_width(D)
    dk = torch.empty((B, Tk, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Tk, H, D), dtype=v.dtype, device=q.device)
    if B * H * Tq == 0:
        return dk.zero_(), dv.zero_()
    lib = _build.load("flash_attention_wide", _configure_wide)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    count_launch("flash_attention_dkv")
    count_launch("flash_attention_dkv.wide")
    rc = lib.mxt_flash_wide_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
        H, Tq, Tk, D, _strides(q, k, v, do, dk, dv), float(scale),
        int(bool(causal)), _DTYPE_CODE[q.dtype], stream)
    _build.check(lib, "mxt_flash_wide", rc)
    return dk, dv


def _rows_padded(x, Tq):
    """f32 [B, H, Tq] -> f32 [B, H, Tq rounded up to 64], zeros past Tq,
    contiguous: the wgmma dK/dV kernel copies lse and delta 64 rows at a
    time."""
    return torch.nn.functional.pad(x.float(),
                                   (0, -Tq % _BWD_ROWS)).contiguous()


def _bwd_wgmma_args(q, k, v, do, lse, delta):
    """Check the wgmma backward's inputs; returns ``(lse, delta, tq_pad)``
    with the row buffers padded (:func:`_rows_padded`)."""
    _check_bf16_width(q.dtype, q.shape[-1])
    _check_wgmma(q, k, v, do)
    Tq = q.shape[1]
    lse_p, delta_p = _rows_padded(lse, Tq), _rows_padded(delta, Tq)
    return lse_p, delta_p, lse_p.shape[-1]


def _flash_dq_wgmma_cuda(q, k, v, do, lse, delta, causal=True, scale=None):
    """Launch the dQ kernel of ``csrc/flash_attention_bwd_wgmma.cu``
    (tensor cores) on bf16 inputs with head_dim 64 or 128 (``lse``,
    ``delta``: f32 [B, H, Tq]); returns ``dq``, contiguous.  Raises on
    inputs it does not take (:func:`_check_wgmma`, with ``do``)."""
    B, Tq, H, D = q.shape
    lse_p, delta_p, tq_pad = _bwd_wgmma_args(q, k, v, do, lse, delta)
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    if B * H * Tq == 0:
        return dq
    lib = _build.load("flash_attention_bwd_wgmma", _configure_bwd_wgmma)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    flat = [s for t in (q, k, v, do) for s in _tma_strides(t)] + list(
        dq.stride()[:3])
    count_launch("flash_attention_dq")
    count_launch("flash_attention_dq.wgmma")
    rc = lib.mxt_flash_bwd_wgmma_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse_p.data_ptr(), delta_p.data_ptr(), dq.data_ptr(), B, H, Tq,
        k.shape[1], D, tq_pad, (ctypes.c_longlong * 15)(*flat), float(scale),
        int(bool(causal)), stream)
    _build.check(lib, "mxt_flash_bwd_wgmma", rc)
    return dq


def _flash_dkv_wgmma_cuda(q, k, v, do, lse, delta, causal=True,
                          scale=None):
    """Launch the dK/dV kernel of ``csrc/flash_attention_bwd_wgmma.cu`` on
    bf16 inputs with head_dim 64 or 128; returns ``(dk, dv)``, contiguous,
    every row written (rows no query sees are 0)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    lse_p, delta_p, tq_pad = _bwd_wgmma_args(q, k, v, do, lse, delta)
    dk = torch.empty((B, Tk, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Tk, H, D), dtype=v.dtype, device=q.device)
    if B * H * Tq == 0:
        return dk.zero_(), dv.zero_()
    lib = _build.load("flash_attention_bwd_wgmma", _configure_bwd_wgmma)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    flat = [s for t in (q, k, v, do) for s in _tma_strides(t)] + list(
        dk.stride()[:3]) + list(dv.stride()[:3])
    count_launch("flash_attention_dkv")
    count_launch("flash_attention_dkv.wgmma")
    rc = lib.mxt_flash_bwd_wgmma_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse_p.data_ptr(), delta_p.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, Tq, Tk, D, tq_pad, (ctypes.c_longlong * 18)(*flat),
        float(scale), int(bool(causal)), stream)
    _build.check(lib, "mxt_flash_bwd_wgmma", rc)
    return dk, dv


def _flash_bwd_cuda(q, k, v, o, lse, do, dlse=None, causal=True,
                    scale=None):
    """The backward on CUDA tensors: ``delta`` with torch ops on the
    unpadded o and dO, then q, k, v and dO padded along D to
    :func:`_padded_dim` and the dQ and the dK/dV kernel of the variant
    :func:`_bwd_variant` names; the gradients sliced back.  Returns ``(dq,
    dk, dv)``, contiguous, in the input dtype.  ``scale=None`` is 1/√D of
    the real head_dim.  ``dO`` is read through its strides (copied if its
    head_dim axis is not unit-stride, or, for the wgmma variant, if its
    layout fails :func:`_tma_fault`)."""
    B, Tq, Tk, H, D = _check_qkv(q, k, v)
    if tuple(do.shape) != (B, Tq, H, D) or tuple(o.shape) != (B, Tq, H, D):
        raise ValueError("flash_attention backward: o/dO shapes %s/%s, "
                         "expected %s" % (tuple(o.shape), tuple(do.shape),
                                          (B, Tq, H, D)))
    if tuple(lse.shape) != (B, H, Tq):
        raise ValueError("flash_attention backward: lse shape %s, expected "
                         "%s" % (tuple(lse.shape), (B, H, Tq)))
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    do = do.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    lse = lse.float().contiguous()
    delta = _delta(o, do, dlse)
    width = _padded_dim(D)
    q, k, v, do = (_pad_d(t, width) for t in (q, k, v, do))
    variant = _bwd_variant(q.dtype, D)
    if variant == "wgmma":
        if _tma_fault("dO", do):
            do = do.clone(memory_format=torch.contiguous_format)
        launch_dq, launch_dkv = _flash_dq_wgmma_cuda, _flash_dkv_wgmma_cuda
    elif variant == "wide":
        launch_dq, launch_dkv = _flash_dq_wide_cuda, _flash_dkv_wide_cuda
    else:
        launch_dq, launch_dkv = _flash_dq_simt_cuda, _flash_dkv_simt_cuda
    dq = launch_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = launch_dkv(q, k, v, do, lse, delta, causal, scale)
    if width != D:
        dq, dk, dv = (t[..., :D].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The custom VJPs ``_flash`` / ``_flash_lse`` in one: outputs ``(o,
    lse)``; saves ``(q, k, v, o, lse)``; the backward takes the cotangents
    of both outputs (``None`` for one that was not used)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        fn, _ = select_impl("flash_attention", q)
        o, lse = fn(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        fn, _ = select_impl("flash_attention_bwd", q)
        dq, dk, dv = fn(q, k, v, o, lse, do, dlse, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, scale=None):
    """Flash attention over [B, T, H, D] tensors; returns ``o``.
    Differentiable in ``q``, ``k`` and ``v``."""
    return flash_attention_lse(q, k, v, causal, scale)[0]


def flash_attention_lse(q, k, v, causal=True, scale=None):
    """Flash attention returning ``(o, lse)``: ``lse`` is the per-row
    logsumexp [B, H, Tq] (f32) of the scaled masked scores.
    Differentiable in both outputs."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))


register_impl("flash_attention", cuda=_flash_cuda,
              reference=functools.partial(flash_attention_reference,
                                          return_lse=True))
register_impl("flash_attention_bwd", cuda=_flash_bwd_cuda,
              reference=flash_attention_bwd_reference)
