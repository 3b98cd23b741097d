"""Tagged device-memory accounting: the counterpart of
``mxnet_tpu/memory.py`` on PyTorch's CUDA caching allocator.

Two layers:

* **Per-device live/peak gauges** — ``torch.cuda.memory_stats()``'s
  ``allocated_bytes.all.current`` / ``.peak`` for every visible CUDA
  device (``source: "backend"``).  Without a CUDA device (the CPU tests)
  the view has one ``cpu`` entry: the sum of the registered owners' tensor
  bytes, with a running-max peak kept across :func:`update` calls
  (``source: "fallback"``).
* **Per-subsystem tags** — any owner of device memory registers a
  zero-arg byte-count provider under a tag ("params", "kv_pages", ...).
  Bound-method providers are held through ``weakref.WeakMethod`` so a
  collected owner silently drops out — registration never extends a
  lifetime.

:func:`update` computes one JSON-ready snapshot, publishes it as
``mem.*`` gauges in the telemetry registry, and emits chrome-trace
counter events per device.  Related capacity gauges (``gen.kv_page_util``)
are rolled into the snapshot.  Everything here is diagnosis: no call may
raise into the caller.
"""
from __future__ import annotations

import itertools
import threading
import weakref

__all__ = ["register", "unregister", "tag_bytes", "device_view",
           "update", "accounting_enabled"]

_lock = threading.Lock()
_providers = {}            # handle id -> (tag, callable-or-WeakMethod)
_handle_seq = itertools.count(1)
_peak = {}                 # device str -> running-max fallback peak bytes


def accounting_enabled():
    """The MXTPU_MEM_ACCOUNTING knob (default on)."""
    from .config import config

    return bool(config.mem_accounting)


class _TagHandle:
    """Returned by :func:`register`; ``close()`` (or owner collection,
    for bound-method providers) removes the provider."""

    __slots__ = ("_id", "tag")

    def __init__(self, hid, tag):
        self._id = hid
        self.tag = tag

    def close(self):
        unregister(self)


def register(tag, provider):
    """Register a zero-arg callable returning this subsystem's current
    device-resident bytes under ``tag``.  Multiple providers may share a
    tag (their bytes sum).  A bound method is held weakly; a plain
    function is held strongly."""
    try:
        ref = weakref.WeakMethod(provider)
    except TypeError:
        ref = None
    hid = next(_handle_seq)
    with _lock:
        _providers[hid] = (str(tag), ref if ref is not None else provider)
    return _TagHandle(hid, str(tag))


def unregister(handle):
    with _lock:
        _providers.pop(handle._id, None)


def tag_bytes():
    """{tag: live_bytes} across the registered providers.  Dead owners
    are dropped; a provider that raises contributes nothing (diagnosis
    must never take down the job)."""
    with _lock:
        items = list(_providers.items())
    out = {}
    dead = []
    for hid, (tag, ref) in items:
        fn = ref() if isinstance(ref, weakref.WeakMethod) else ref
        if fn is None:
            dead.append(hid)
            continue
        try:
            n = int(fn())
        except Exception:
            continue
        out[tag] = out.get(tag, 0) + n
    if dead:
        with _lock:
            for hid in dead:
                _providers.pop(hid, None)
    return out


def _fallback_live_bytes():
    """Bytes held by the registered owners, for a host with no CUDA
    device: the sum of the tag providers (the owners' tensor bytes)."""
    return sum(tag_bytes().values())


def device_view():
    """{device: {live_bytes, peak_bytes, source}}: every visible CUDA
    device from the caching allocator ('backend'), or, without one, the
    ``cpu`` entry of :func:`_fallback_live_bytes` with a host-side running
    peak ('fallback')."""
    import torch

    out = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            try:
                stats = torch.cuda.memory_stats(i)
            except RuntimeError:
                continue
            live = int(stats.get("allocated_bytes.all.current", 0))
            peak = int(stats.get("allocated_bytes.all.peak", live))
            out["cuda:%d" % i] = {"live_bytes": live, "peak_bytes": peak,
                                  "source": "backend"}
        return out
    live = _fallback_live_bytes()
    with _lock:
        peak = max(_peak.get("cpu", 0), live)
        _peak["cpu"] = peak
    out["cpu"] = {"live_bytes": live, "peak_bytes": peak,
                  "source": "fallback"}
    return out


def _rollup(reg):
    """Related capacity gauges from the other subsystems, so one memory
    view answers page-pool and slice-placement questions too."""
    from . import telemetry

    out = {}
    for prefix in ("gen.kv_page_util", "gen.active_slots", "fleet."):
        for name, m in reg.find(prefix):
            if isinstance(m, telemetry.Gauge):
                out[name] = m.value
    return out


def update(publish=True, reg=None):
    """Compute the memory snapshot ``{devices, tags, rollup,
    accounting}`` and (by default) publish it: per-device
    ``mem.<device>.live_bytes`` / ``.peak_bytes`` gauges, per-tag
    ``mem.tag.<tag>.bytes`` gauges, and one chrome-trace counter event
    per device for the allocation timeline.  With
    ``MXTPU_MEM_ACCOUNTING=0`` returns a stub without touching the
    runtime."""
    if not accounting_enabled():
        return {"accounting": "off", "devices": {}, "tags": {},
                "rollup": {}}
    from . import telemetry

    the_reg = reg or telemetry.registry()
    devices = device_view()
    tags = tag_bytes()
    snap = {"accounting": "on", "devices": devices, "tags": tags,
            "rollup": _rollup(the_reg)}
    if not publish:
        return snap
    from . import profiler

    for dev, s in devices.items():
        the_reg.gauge("mem.%s.live_bytes" % dev).set(s["live_bytes"])
        the_reg.gauge("mem.%s.peak_bytes" % dev).set(s["peak_bytes"])
        profiler.record_event(
            {"name": "mem::%s" % dev, "cat": "counter", "ph": "C",
             "args": {"live_bytes": s["live_bytes"]}})
    for tag, n in tags.items():
        the_reg.gauge("mem.tag.%s.bytes" % tag).set(n)
    return snap
