"""Shared helpers for the kernel layer: the counterpart of
``mxnet_tpu/ops/pallas/common.py``.

Every kernel registers a ``cuda`` implementation (the hand-written kernel)
and a ``reference`` one (its plain PyTorch version) with
:func:`register_impl`; callers resolve them with :func:`select_impl`, which
picks by the device of the input tensor — ``cuda`` for a CUDA tensor,
``reference`` for a CPU one.  There is no fallback: a CUDA tensor launches
the kernel or raises.

Two sets of counters make the routing visible:

* ``kernels.select.<name>.<impl>`` — one per resolution
  (:func:`selection_counts`);
* ``kernels.launch.<name>`` — one per kernel launch, bumped by the CUDA
  wrapper right where it calls the kernel and nowhere else
  (:func:`launch_counts`).
"""
from __future__ import annotations

import collections
import threading

_NEG = -1e30  # masked-logit filler: finite (NaN-safe) but exp() == 0 in f32

_REGISTRY = {}
_COUNTS = collections.Counter()
_COUNTS_LOCK = threading.Lock()


def register_impl(name, *, cuda, reference):
    """Register kernel ``name``: ``cuda`` launches the hand-written kernel
    on CUDA tensors, ``reference`` is the plain PyTorch version."""
    _REGISTRY[name] = {"cuda": cuda, "reference": reference}


def _bump(key, n=1):
    with _COUNTS_LOCK:
        _COUNTS[key] += n


def select_impl(name, x):
    """Resolve kernel ``name`` for tensor ``x`` to ``(callable, impl)``.

    ``impl`` is ``'cuda'`` when ``x`` lies on a CUDA device and
    ``'reference'`` when it lies on the CPU.  Each resolution bumps the
    ``kernels.select.<name>.<impl>`` counter."""
    entry = _REGISTRY[name]         # the package imports every kernel module
    if x.device.type == "cuda":
        impl = "cuda"
    elif x.device.type == "cpu":
        impl = "reference"
    else:
        raise ValueError("kernel %r: no implementation for device %s"
                         % (name, x.device))
    _bump("kernels.select.%s.%s" % (name, impl))
    return entry[impl], impl


def sm_count(device):
    """The SM count of CUDA ``device``: what the planners size grids by."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def count_launch(name):
    """Called by a CUDA wrapper at its kernel launch, and nowhere else."""
    _bump("kernels.launch.%s" % name)


def selection_counts():
    """``{"kernels.select.<name>.<impl>": n}`` since the last reset."""
    with _COUNTS_LOCK:
        return {k: v for k, v in _COUNTS.items()
                if k.startswith("kernels.select.")}


def launch_counts():
    """``{"kernels.launch.<name>": n}`` since the last reset."""
    with _COUNTS_LOCK:
        return {k: v for k, v in _COUNTS.items()
                if k.startswith("kernels.launch.")}


def reset_counts():
    """Zero every selection and launch counter."""
    with _COUNTS_LOCK:
        _COUNTS.clear()
