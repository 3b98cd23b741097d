"""Shared helpers for the kernel layer: the counterpart of
``mxnet_tpu/ops/pallas/common.py``.

Every kernel registers a ``cuda`` implementation (the hand-written kernel)
and a ``reference`` one (its plain PyTorch version) with
:func:`register_impl`; its wrappers resolve them with
``select_impl(name, x)``, which picks by the device of the input tensor:
``cuda`` for a CUDA tensor, ``reference`` for a CPU one.  There is no
fallback: a CUDA tensor launches the kernel or raises.  The
``MXTPU_PALLAS`` mode (:func:`mxnet_tpu_torch.dispatch.pallas_mode`) is
read for a CUDA tensor only, and anything but ``auto`` raises there: the
port has no kernel interpreter (``interpret``), and it never hands the card
the plain version because of an environment variable (``off``, which the
JAX package's launch scripts set for its own side).  On the CPU every mode
runs the plain version.

The kernel library's front door has the JAX package's form too:
:func:`resolve_entry` (also reachable as ``select_impl(name)``) resolves
a kernel to the public entry the model paths call (:func:`register_entry`:
for ``flash_attention`` the autograd-aware
:func:`~.flash_attention.flash_attention`, whose backward launches the dQ
and dK/dV kernels), and :func:`kernel_unit` wraps such an entry in a
memoized callable labelled ``kernel.<name>`` that counts each new input
signature through a :class:`~mxnet_tpu_torch.dispatch.ShapeTracker` (the
counterpart of the JAX package's ``TrackedJit`` retrace record).  A unit
is not a CUDA graph.

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

from ...dispatch import pallas_mode

_NEG = -1e30  # masked-logit filler: finite (NaN-safe) but exp() == 0 in f32

_REGISTRY = {}
_ENTRIES = {}
_COUNTS = collections.Counter()
_COUNTS_LOCK = threading.Lock()
_UNITS = {}
_UNITS_LOCK = threading.Lock()


def register_impl(name, *, cuda, reference):
    """Register kernel ``name``: ``cuda`` launches the hand-written kernel
    on CUDA tensors, ``reference`` is the plain PyTorch version."""
    _REGISTRY[name] = {"cuda": cuda, "reference": reference}


def register_entry(name, entry):
    """Register ``entry`` as kernel ``name``'s public entry: what the
    JAX-form ``select_impl(name)`` hands out."""
    _ENTRIES[name] = entry


def _bump(key, n=1):
    with _COUNTS_LOCK:
        _COUNTS[key] += n


def select_impl(name, x=None):
    """Resolve kernel ``name`` for tensor ``x`` to ``(callable, impl)``:
    ``'cuda'`` (the kernel) for a CUDA tensor, ``'reference'`` (the plain
    version) for a CPU one.  On a CUDA tensor a mode other than ``auto``
    raises.  Each resolution bumps ``kernels.select.<name>.<impl>``.

    Without ``x`` it is the JAX package's form, :func:`resolve_entry`."""
    if x is None:
        return resolve_entry(name)
    entry = _REGISTRY[name]         # the package imports every kernel module
    kind = x.device.type
    if kind == "cuda":
        mode = pallas_mode()
        if mode != "auto":
            raise RuntimeError(
                "kernel %r: MXTPU_PALLAS=%s runs the plain version on the "
                "CPU only; a CUDA tensor launches the kernel "
                "(MXTPU_PALLAS=auto)" % (name, mode))
        impl = "cuda"
    elif kind == "cpu":
        impl = "reference"
    else:
        raise ValueError("kernel %r: no implementation for device %s"
                         % (name, x.device))
    _bump("kernels.select.%s.%s" % (name, impl))
    return entry[impl], impl


def resolve_entry(name):
    """The JAX package's ``select_impl(name)``: kernel ``name``'s public
    entry (:func:`register_entry`), which resolves per call by the
    device of its input, and the impl it runs on the card: ``'cuda'``
    under ``MXTPU_PALLAS=auto`` with a CUDA device present, else
    ``'reference'`` (what a CPU tensor runs; a CUDA tensor then raises).
    Bumps the ``kernels.resolve.<name>.<impl>`` telemetry counter, not
    the selection counters."""
    import torch
    from ... import telemetry as _telemetry

    fn = _ENTRIES[name]             # KeyError for an unknown kernel
    impl = "cuda" if pallas_mode() == "auto" and torch.cuda.is_available() \
        else "reference"
    _telemetry.registry().counter(
        "kernels.resolve.%s.%s" % (name, impl)).inc()
    return fn, impl


class _KernelUnit:
    """A labelled kernel entry: each call notes its arguments' signature
    with the unit's :class:`~mxnet_tpu_torch.dispatch.ShapeTracker` (a new
    one bumps ``recompile``), then calls the entry."""

    __slots__ = ("name", "fn", "tracker")

    def __init__(self, name, fn):
        from ...dispatch import ShapeTracker

        self.name = name
        self.fn = fn
        self.tracker = ShapeTracker("kernel." + name)

    @property
    def label(self):
        return self.tracker.label

    def __call__(self, *args, **kwargs):
        self.tracker.note(*args)
        return self.fn(*args, **kwargs)


def kernel_unit(name, fn=None):
    """Memoized unit for a kernel entry, labelled ``kernel.<name>`` (the
    JAX package's ``kernel_unit``).  The first call binds ``fn``; later
    calls with the same name return the same unit."""
    with _UNITS_LOCK:
        unit = _UNITS.get(name)
        if unit is None:
            if fn is None:
                raise KeyError("kernel_unit(%r): not yet bound" % name)
            unit = _UNITS[name] = _KernelUnit(name, fn)
        return unit


def kernel_units():
    """Snapshot of the live kernel units: ``{name: unit}``."""
    with _UNITS_LOCK:
        return dict(_UNITS)


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
