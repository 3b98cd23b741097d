"""Shared plumbing: dtype conventions between numpy and torch.

Counterpart of ``mxnet_tpu/base.py``'s dtype helpers.  numpy has no
bfloat16 of its own: where ``ml_dtypes`` is installed its ``bfloat16`` is
the numpy twin of ``torch.bfloat16`` (the JAX package's convention), and
otherwise the string ``"bfloat16"`` stands for it; every helper here takes
either, and ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["np_dtype", "torch_dtype", "numpy_dtype", "dtype_name"]

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def _bfloat16_np():
    """``ml_dtypes``' bfloat16 numpy dtype, or ``"bfloat16"`` without it."""
    try:
        import ml_dtypes
    except ImportError:
        return "bfloat16"
    return np.dtype(ml_dtypes.bfloat16)


def _is_bfloat16(dtype):
    if dtype is torch.bfloat16:
        return True
    if isinstance(dtype, str):
        return dtype == "bfloat16"
    return getattr(dtype, "name", getattr(dtype, "__name__", None)) \
        == "bfloat16"


def dtype_name(dtype):
    """The numpy-style name of a dtype (``"float32"``, ``"bfloat16"``)."""
    if _is_bfloat16(dtype):
        return "bfloat16"
    return np_dtype(dtype).name


def np_dtype(dtype):
    """Normalize a string, a numpy dtype or a torch dtype to a numpy dtype;
    ``None`` means float32."""
    if dtype is None:
        return np.dtype(np.float32)
    if _is_bfloat16(dtype):
        return _bfloat16_np()
    if isinstance(dtype, torch.dtype):
        return numpy_dtype(dtype)
    return np.dtype(dtype)


def torch_dtype(dtype):
    """The torch dtype of anything :func:`np_dtype` accepts."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if _is_bfloat16(dtype):
        return torch.bfloat16
    dt = np_dtype(dtype)
    if dt not in _NP_TO_TORCH:
        raise TypeError("mxnet_tpu_torch: dtype %s is not supported" % dt)
    return _NP_TO_TORCH[dt]


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype."""
    if dtype is torch.bfloat16:
        return _bfloat16_np()
    if dtype not in _TORCH_TO_NP:
        raise TypeError("mxnet_tpu_torch: dtype %s has no numpy twin here"
                        % dtype)
    return _TORCH_TO_NP[dtype]
