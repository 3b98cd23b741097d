"""Sequence operators over the (seq_len, batch, ...) layout RNN models use.

Counterpart of ``mxnet_tpu/ops/sequence.py`` (reference
``src/operator/sequence_{mask,last,reverse}.cc``): ``SequenceMask``,
``SequenceLast`` and ``SequenceReverse``, each honouring
``sequence_length`` only under ``use_sequence_length``.
"""
from __future__ import annotations

import torch

from .registry import register


@register("SequenceMask", input_names=("data", "sequence_length"))
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    """Entries at or past each sequence's length become ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data
    axis = int(axis)                     # the time axis: 0 or 1
    pos = torch.arange(data.shape[axis], device=data.device)
    lens = sequence_length.to(torch.int32)
    if axis == 0:
        mask = pos[:, None] < lens[None, :]
    else:
        mask = pos[None, :] < lens[:, None]
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


@register("SequenceLast", input_names=("data", "sequence_length"))
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0):
    """Each sequence's last valid step."""
    axis = int(axis)
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    last = sequence_length.to(torch.int64) - 1
    moved = data.movedim(axis, 0)                      # (L, B, ...)
    return moved[last, torch.arange(moved.shape[1], device=data.device)]


@register("SequenceReverse", input_names=("data", "sequence_length"))
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0):
    """Each sequence's valid steps reversed in place, the padding kept
    (time is axis 0, as in the reference)."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))
    lens = sequence_length.to(torch.int64)                        # (B,)
    pos = torch.arange(data.shape[0], device=data.device)[:, None]
    src = torch.where(pos < lens[None, :], lens[None, :] - 1 - pos,
                      pos)                                        # (L, B)
    src = src.reshape(src.shape + (1,) * (data.dim() - 2)).expand(
        data.shape)
    return torch.gather(data, 0, src)
