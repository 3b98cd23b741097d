"""Shape bucketing and the per-label shape tracker: the subset of
``mxnet_tpu/dispatch.py`` the serving path reads.

* :func:`pow2_chain` / :func:`bucket_size` — leading-dim shape buckets
  (``MXNET_SHAPE_BUCKETS``), as in the JAX package.
* :func:`pallas_mode` — the validated ``MXTPU_PALLAS`` kernel-selection
  mode (``auto`` / ``off`` / ``interpret``) that
  :func:`mxnet_tpu_torch.ops.kernels.common.select_impl` reads for a CUDA
  tensor.
* :class:`ShapeTracker` — the counterpart of ``TrackedJit`` as a counter.
  Under JAX a call with a new argument signature traces and compiles;
  eager PyTorch compiles nothing, so here the tracker is a tripwire: the
  first time a label sees an argument-shape signature it bumps the
  ``recompile`` and ``jit_cache_miss`` dispatch counters, and every later
  call with a seen signature bumps ``jit_cache_hit``, under the JAX
  package's names.  A warmed server that meets a bucket shape it did not
  warm shows it as a ``recompile`` after ``warm()``, as the JAX server
  does.  Each new signature is kept in a bounded ring
  (:func:`recompile_ring` / :func:`explain_recompiles`).  A CUDA-graph
  unit per bucket would make the counter count real captures; that is
  not ported yet.
"""
from __future__ import annotations

import collections
import functools
import os
import threading
import time

from .config import config

__all__ = ["bucket_size", "bucket_spec", "pow2_chain", "pallas_mode",
           "ShapeTracker", "recompile_ring", "explain_recompiles"]

# -- shape bucketing --------------------------------------------------------
_POW2 = "pow2"
_spec_cache = {}


def bucket_spec():
    """The parsed MXNET_SHAPE_BUCKETS spec: None (off), 'pow2', or a
    sorted tuple of bucket sizes."""
    raw = os.environ.get("MXNET_SHAPE_BUCKETS", "").strip().lower()
    return _parse_spec(raw)


def _parse_spec(raw):
    if not raw:
        return None
    got = _spec_cache.get(raw)
    if got is None:
        if raw == _POW2:
            got = _POW2
        else:
            got = tuple(sorted({int(t) for t in raw.split(",") if t.strip()}))
            if not got:
                got = None
        _spec_cache[raw] = got
    return got


def bucket_size(n, spec=None):
    """Padded leading-dim size for a batch of ``n`` rows under ``spec``
    (default: the MXNET_SHAPE_BUCKETS knob).  Returns ``n`` unchanged when
    bucketing is off or ``n`` exceeds the largest bucket."""
    if spec is None:
        spec = bucket_spec()
    elif isinstance(spec, str):
        spec = _parse_spec(spec.strip().lower())
    if spec is None or n <= 0:
        return n
    if spec == _POW2:
        return 1 << (int(n) - 1).bit_length()
    for b in spec:
        if b >= n:
            return b
    return n


def pow2_chain(cap):
    """Full power-of-two bucket chain up to ``cap``: (1, 2, 4, ..., cap),
    with ``cap`` itself always included even when it is not a power of
    two — the warmup enumeration of ``bucket_size(spec='pow2')``."""
    cap = int(cap)
    if cap <= 0:
        return ()
    out = []
    b = 1
    while b < cap:
        out.append(b)
        b <<= 1
    out.append(cap)
    return tuple(out)


# -- kernel-selection mode ---------------------------------------------------
_PALLAS = config.knob("MXTPU_PALLAS")


def pallas_mode():
    """'auto', 'off', or 'interpret' — the MXTPU_PALLAS knob, validated
    (the JAX package's name and parsing).

    Consumed by ``ops.kernels.common.select_impl``: on a CPU tensor every
    mode runs the plain PyTorch version; on a CUDA tensor 'auto' launches
    the hand-written kernel and 'off' or 'interpret' raise — the port has
    no kernel interpreter, and it never hands the card the plain version
    because of an environment variable."""
    return _parse_pallas(_PALLAS.value)


@functools.lru_cache(maxsize=None)
def _parse_pallas(raw):
    mode = (raw or "").strip().lower()
    if mode in ("", "1", "on", "true"):
        return "auto"
    if mode in ("0", "false", "no"):
        return "off"
    if mode not in ("auto", "off", "interpret"):
        raise ValueError(
            "MXTPU_PALLAS must be 'auto', 'off' or 'interpret'; got %r"
            % mode)
    return mode


# -- shape tracker ----------------------------------------------------------
_RING_CAP = 256
_ring = collections.deque(maxlen=_RING_CAP)
_ring_lock = threading.Lock()


def _descriptor(a):
    """One argument's signature: shape and dtype of an array or tensor,
    the type of a scalar."""
    shape = getattr(a, "shape", None)
    if shape is not None:
        return {"shape": [int(d) for d in shape], "dtype": str(a.dtype)}
    return {"scalar": type(a).__name__}


def _key(desc):
    return tuple((tuple(d["shape"]), d["dtype"]) if "shape" in d
                 else d["scalar"] for d in desc)


class ShapeTracker:
    """Counts a label's argument-shape signatures under the JAX package's
    dispatch counter names (see the module docstring)."""

    __slots__ = ("label", "_seen", "_lock", "_calls")

    def __init__(self, label):
        self.label = str(label)
        self._seen = set()
        self._lock = threading.Lock()
        self._calls = 0

    def note(self, *args):
        """Record one call with ``args``; returns True when its signature
        is new to this label (a ``recompile``)."""
        from . import profiler as _prof

        desc = [_descriptor(a) for a in args]
        key = _key(desc)
        with self._lock:
            self._calls += 1
            new = key not in self._seen
            if new:
                self._seen.add(key)
                n_sigs, call = len(self._seen), self._calls
        if not new:
            _prof.dispatch_count("jit_cache_hit")
            return False
        _prof.dispatch_count("recompile")
        _prof.dispatch_count("jit_cache_miss")
        kind = "initial" if n_sigs == 1 else "retrace"
        with _ring_lock:
            _ring.append({"ts_unix": round(time.time(), 3),
                          "fn": self.label, "trace": n_sigs, "call": call,
                          "kind": kind, "args": desc})
        from . import telemetry as _telemetry

        _telemetry.trace_instant("recompile::" + self.label, cat="dispatch",
                                 args={"kind": kind})
        return True

    @property
    def signatures(self):
        with self._lock:
            return len(self._seen)


def recompile_ring():
    """The newest new-signature entries, oldest first."""
    with _ring_lock:
        return list(_ring)


def explain_recompiles(n=20):
    """Human-readable lines for the newest ``n`` ring entries."""
    lines = []
    for e in recompile_ring()[-int(n):]:
        shapes = ", ".join("x".join(map(str, d["shape"])) + ":" + d["dtype"]
                           if "shape" in d else d["scalar"]
                           for d in e["args"])
        lines.append("%s %s #%d (call %d): (%s)" % (
            e["fn"], e["kind"], e["trace"], e["call"], shapes))
    return "\n".join(lines)
