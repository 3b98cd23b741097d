"""Postmortem debug bundles: the counterpart of ``mxnet_tpu/debug.py``.

When the runtime hits a failure it cannot diagnose from a counter alone,
it calls :func:`write_bundle`, which captures one JSON file in
``MXTPU_DEBUG_BUNDLE_DIR``:

* the full telemetry registry snapshot (counters/gauges/histograms),
* the dispatch counter table,
* the shape tracker's recompile ring,
* the newest N profiler chrome-trace events,
* the tagged device-memory view,
* the active chaos plan (spec, seed, faults not yet fired),
* every config knob's effective value + the MXTPU_/MXNET_ env,
* any subsystem sections registered via :func:`add_section` (the
  generation server registers its scheduler snapshot, leakcheck its
  ledger).

Bundle writing never raises into the failing caller and never runs with a
caller's lock held.  Per-reason cooldown and newest-N pruning keep a crash
loop from filling the disk.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

__all__ = ["bundle_dir", "write_bundle", "add_section", "remove_section",
           "StormDetector", "SCHEMA_VERSION"]

SCHEMA_VERSION = 1
_COOLDOWN_S = 30.0

_lock = threading.Lock()
_last_write = {}           # reason -> monotonic ts of last bundle
_sections = {}             # name -> zero-arg provider (weak for methods)
_seq = 0


class StormDetector:
    """Sliding-window threshold: ``hit()`` records one event and returns
    True when ``threshold`` events landed within ``window_s`` (the trigger
    of storm bundles, such as the serving front's breaker trips)."""

    __slots__ = ("threshold", "window_s", "_times", "_lock")

    def __init__(self, threshold, window_s=60.0):
        self.threshold = int(threshold)
        self.window_s = float(window_s)
        self._times = collections.deque(maxlen=max(4, self.threshold * 4))
        self._lock = threading.Lock()

    def hit(self, now=None):
        if self.threshold <= 0:
            return False
        now = time.monotonic() if now is None else now
        with self._lock:
            self._times.append(now)
            recent = sum(1 for t in self._times
                         if now - t <= self.window_s)
        return recent >= self.threshold


def bundle_dir():
    """The MXTPU_DEBUG_BUNDLE_DIR knob; '' means bundles are off."""
    from .config import config

    return (config.debug_bundle_dir or "").strip()


def add_section(name, provider):
    """Register a zero-arg provider whose JSON-ready return value lands
    in every future bundle under ``sections[name]``.  Bound methods are
    held weakly (a collected owner drops out silently)."""
    import weakref

    try:
        ref = weakref.WeakMethod(provider)
    except TypeError:
        ref = provider
    with _lock:
        _sections[name] = ref
    return name


def remove_section(name):
    with _lock:
        _sections.pop(name, None)


def _config_view():
    from .config import _Config

    out = {}
    for k in _Config._KNOBS:
        try:
            out[k.name] = k.value
        except Exception:
            out[k.name] = "<unreadable>"
    return out


def _env_view():
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith(("MXNET_", "MXTPU_", "BENCH_"))}


def _chaos_view():
    from . import chaos

    plan = chaos.active()
    if plan is None:
        return None
    return {"spec": plan.spec, "seed": plan.seed,
            "pending": [list(p) for p in plan.pending()]}


def _section_views():
    import weakref

    with _lock:
        items = list(_sections.items())
    out, dead = {}, []
    for name, ref in items:
        fn = ref() if isinstance(ref, weakref.WeakMethod) else ref
        if fn is None:
            dead.append(name)
            continue
        try:
            out[name] = fn()
        except Exception as e:
            out[name] = {"error": "%s: %s" % (type(e).__name__, e)}
    if dead:
        with _lock:
            for name in dead:
                _sections.pop(name, None)
    return out


def _collect(reason, extra, reg):
    from . import dispatch, memory, profiler, telemetry

    the_reg = reg or telemetry.registry()
    from .config import config

    return {
        "schema": SCHEMA_VERSION,
        "reason": reason,
        "ts_unix": round(time.time(), 3),
        "pid": os.getpid(),
        "extra": extra or {},
        "registry": the_reg.snapshot(),
        "dispatch": profiler.dispatch_stats(),
        "recompiles": dispatch.recompile_ring(),
        "events": profiler.recent_events(
            int(config.debug_bundle_events)),
        "memory": memory.update(publish=False),
        "chaos": _chaos_view(),
        "config": _config_view(),
        "env": _env_view(),
        "sections": _section_views(),
    }


def _prune(directory, keep):
    try:
        names = [n for n in os.listdir(directory)
                 if n.startswith("bundle-") and n.endswith(".json")]
    except OSError:
        return
    if len(names) <= keep:
        return
    full = []
    for n in names:
        p = os.path.join(directory, n)
        try:
            full.append((os.path.getmtime(p), p))
        except OSError:
            continue
    for _, p in sorted(full)[:-keep] if keep > 0 else sorted(full):
        try:
            os.remove(p)
        except OSError:
            pass


def write_bundle(reason, extra=None, reg=None, force=False):
    """Capture one postmortem bundle for ``reason``; returns the path,
    or None when bundles are off / the reason is inside its cooldown /
    anything at all failed.  Never raises — this runs on the runtime's
    worst day."""
    global _seq
    try:
        directory = bundle_dir()
        if not directory:
            return None
        now = time.monotonic()
        with _lock:
            last = _last_write.get(reason)
            if not force and last is not None \
                    and now - last < _COOLDOWN_S:
                return None
            _last_write[reason] = now
            _seq += 1
            seq = _seq
        payload = _collect(reason, extra, reg)
        os.makedirs(directory, exist_ok=True)
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        path = os.path.join(
            directory, "bundle-%s-%s-%d-%d.json"
            % (stamp, str(reason).replace(os.sep, "_"), os.getpid(), seq))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        os.replace(tmp, path)
        from .config import config
        from . import profiler

        profiler.dispatch_count("debug_bundles")
        _prune(directory, int(config.debug_bundle_keep))
        return path
    except Exception:
        return None
