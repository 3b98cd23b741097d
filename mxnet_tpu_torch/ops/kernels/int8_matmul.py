"""Int8 matmul, int32 out or with the per-channel dequant fused.

Counterpart of ``mxnet_tpu/ops/pallas/int8_matmul.py``.  ``a`` [M, K] int8
× ``b`` [N, K] int8, contracted over K on both (activations row-major, the
weight in FullyConnected's ``(num_hidden, input_dim)`` layout), accumulates
exactly in int32:

* without scales the int32 accumulator comes back (the TPU's
  ``_mm_i32_kernel``; launch counter ``int8_matmul``);
* with ``scale_a`` (scalar) and/or ``scale_b`` (scalar or per output
  channel [N]) the epilogue writes ``f32(acc) · s[n]`` with ``s = 1 ·
  scale_a · scale_b`` built in f32 as the TPU wrapper builds it, so the
  dequantized f32 result leaves the kernel once (``_mm_dequant_kernel``;
  launch counter ``int8_matmul_dequant``).

Both are bit-exact against the XLA lowering ``int8_matmul_lax``: the int32
sum is exact in any order (below 2^31; past it both wrap), and the epilogue
is one rounding of the int32 to f32 and one f32 product.

On a CUDA tensor :func:`int8_matmul` launches ``csrc/int8_matmul.cu``; on a
CPU tensor it runs :func:`int8_matmul_reference`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .common import count_launch, register_impl, select_impl

__all__ = ["int8_matmul", "int8_matmul_reference"]


def _dequant_scale(scale_a, scale_b, n, device):
    """``1 · scale_a · scale_b`` in f32, as an [n] vector, or None."""
    if scale_a is None and scale_b is None:
        return None
    s = torch.ones((), dtype=torch.float32, device=device)
    for v in (scale_a, scale_b):
        if v is not None:
            s = s * torch.as_tensor(v, dtype=torch.float32, device=device)
    if s.numel() not in (1, n):
        raise ValueError("int8_matmul: the scales hold %d values, expected "
                         "1 or N = %d" % (s.numel(), n))
    return s.reshape(-1).expand(n)


def int8_matmul_reference(a, b, scale_a=None, scale_b=None):
    """Plain version: an int32 matmul on the CPU; on the card, where integer
    ``mm`` is not supported, an f64 matmul cast to int32 (exact: |acc| <
    127²·K < 2^53)."""
    if a.device.type == "cuda":
        acc = torch.matmul(a.to(torch.float64),
                           b.to(torch.float64).t()).to(torch.int32)
    else:
        acc = torch.matmul(a.to(torch.int32), b.to(torch.int32).t())
    s = _dequant_scale(scale_a, scale_b, b.shape[0], a.device)
    return acc if s is None else acc.to(torch.float32) * s


def _configure(lib):
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mxt_int8_mm.argtypes = [vp, vp, vp, vp, i, i, i, ll, ll, ll, i, vp]
    lib.mxt_int8_mm.restype = ctypes.c_int
    lib.mxt_int8_mm_error_string.argtypes = [ctypes.c_int]
    lib.mxt_int8_mm_error_string.restype = ctypes.c_char_p


def _int8_matmul_cuda(a, b, scale_a=None, scale_b=None):
    """Launch ``csrc/int8_matmul.cu`` on CUDA int8 tensors ``a`` [M, K] and
    ``b`` [N, K]."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("int8_matmul: operands must be int8, got %s and %s"
                        % (a.dtype, b.dtype))
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError("int8_matmul: shapes %s x %s, expected [M, K] x "
                         "[N, K]" % (tuple(a.shape), tuple(b.shape)))
    if b.device != a.device:
        raise ValueError("int8_matmul: b on %s, a on %s" % (b.device,
                                                            a.device))
    M, K = a.shape
    N = b.shape[0]
    if max(M, N, K) >= 2 ** 31:
        raise ValueError("int8_matmul: dimensions %s too large" % ((M, N,
                                                                    K),))
    a = a if a.stride(1) == 1 else a.contiguous()
    b = b if b.stride(1) == 1 else b.contiguous()
    s = _dequant_scale(scale_a, scale_b, N, a.device)
    if s is None:
        out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    else:
        s = s.contiguous()
        out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = _build.load("int8_matmul", _configure)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    stream = torch.cuda.current_stream(a.device).cuda_stream
    count_launch("int8_matmul" if s is None else "int8_matmul_dequant")
    rc = lib.mxt_int8_mm(a.data_ptr(), b.data_ptr(),
                         None if s is None else s.data_ptr(), out.data_ptr(),
                         M, N, K, a.stride(0), b.stride(0), out.stride(0),
                         sms, stream)
    _build.check(lib, "mxt_int8_mm", rc)
    return out


def int8_matmul(a, b, scale_a=None, scale_b=None):
    """``a`` [M, K] int8 × ``b`` [N, K] int8 → [M, N]: the int32
    accumulator without scales, ``f32(acc) · scale_a · scale_b[n]`` with
    them.  The CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    fn, _ = select_impl("int8_matmul", a)
    return fn(a, b, scale_a, scale_b)


register_impl("int8_matmul", cuda=_int8_matmul_cuda,
              reference=int8_matmul_reference)
