"""Tensor operators the symbolic ResNet path emits: ``broadcast_add`` (what
``Symbol.__add__`` composes, with the aliases ``elemwise_add``, ``_plus``
and ``_add``), ``_plus_scalar`` and ``Flatten``.  Counterpart of those ops
in ``mxnet_tpu/ops/tensor.py``."""
from __future__ import annotations

import torch

from .registry import register


@register("broadcast_add", aliases=("elemwise_add", "_plus", "_add"))
def _broadcast_add(a, b):
    return torch.add(a, b)


@register("_plus_scalar")
def _plus_scalar(x, scalar=0.0):
    """``x + scalar``, the scalar cast to ``x``'s dtype first."""
    return x + torch.tensor(scalar, dtype=x.dtype, device=x.device)


@register("Flatten", aliases=("flatten",))
def _flatten(x):
    return x.reshape(x.shape[0], -1)
