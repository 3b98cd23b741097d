"""Profiler: the always-on dispatch counters and the chrome-trace event
ring, the part of ``mxnet_tpu/profiler.py`` the serving plane reads.

* **Dispatch counters** — :func:`dispatch_count` / :func:`dispatch_value`
  / :func:`dispatch_stats`: typed counters in the
  :mod:`~mxnet_tpu_torch.telemetry` registry under the ``dispatch.``
  prefix, with the JAX package's names (``gen_prefills``, ``gen_tokens``,
  ``recompile``, ``requests_admitted``, ...), so one benchmark reads both
  packages.  No profiler session is needed.
* **Event ring** — :func:`record_event` appends raw chrome-trace events
  (the request spans and instants :mod:`telemetry` emits) to a bounded
  ring while the profiler runs (:func:`start` / :func:`stop`);
  :func:`recent_events` reads it (postmortem bundles embed it).

The device side of a trace is ``torch.profiler``'s, not this module's:
the JAX package's ``jax.profiler`` bracket and its HLO breakdown have no
counterpart here yet.
"""
from __future__ import annotations

import collections
import os
import threading
import time

__all__ = ["set_state", "start", "stop", "state", "dispatch_count",
           "dispatch_stats", "dispatch_value", "record_event",
           "recent_events"]

_lock = threading.Lock()
_state = "stop"
# chrome trace events — bounded ring (oldest dropped) so a long serving
# run with the profiler on cannot grow host memory without bound
_events = collections.deque()
_max_events = int(os.environ.get("MXNET_PROFILER_MAX_EVENTS", "1000000"))
_t0 = time.perf_counter()


def _now_us():
    return (time.perf_counter() - _t0) * 1e6


def _count_dropped(n):
    _registry().counter("profiler.events_dropped").inc(n)


def _append(evt):
    """Sole writer into the event ring, evicting the oldest beyond the
    cap."""
    dropped = 0
    with _lock:
        while len(_events) >= _max_events:
            _events.popleft()
            dropped += 1
        _events.append(evt)
    if dropped:
        _count_dropped(dropped)


def recent_events(n=500):
    """Snapshot of the newest ``n`` chrome-trace events in the ring."""
    n = max(0, int(n))
    with _lock:
        if n >= len(_events):
            return list(_events)
        return list(_events)[-n:]


def record_event(evt):
    """Append one raw chrome-trace event (async 'b'/'e', instants,
    counters), filling in ``ts`` / ``pid`` / ``tid`` when absent.  A no-op
    unless the profiler is running."""
    if _state != "run":
        return
    e = dict(evt)
    e.setdefault("ts", _now_us())
    e.setdefault("pid", os.getpid())
    e.setdefault("tid", threading.get_ident() % 10000)
    _append(e)


# -- dispatch counters (always on) -------------------------------------------
# the JAX package's well-known keys, zero-filled by dispatch_stats(); the
# serving plane's counters are among them
_DISPATCH_KEYS = ("jit_cache_hit", "jit_cache_miss", "recompile",
                  "op_recompile", "donated_bytes", "bucket_padded_batches",
                  "host_sync", "trace_guard",
                  "nonfinite_steps", "rollbacks", "divergence_checks",
                  "faults_injected", "corrupt_records", "io_retries",
                  "requests_admitted", "requests_shed", "hedges_fired",
                  "breaker_trips", "batches_closed_by_deadline",
                  "requests_shed_brownout", "brownout_escalated",
                  "brownout_recovered",
                  "gen_prefills", "gen_decode_iters", "gen_tokens",
                  "gen_pages_shed", "gen_preempted", "gen_resumed",
                  "gen_brownout_shed",
                  "fleet_replicas_added", "fleet_replicas_removed",
                  "fleet_scale_ups", "fleet_scale_downs",
                  "fleet_heartbeats", "fleet_heartbeats_dropped",
                  "fleet_reaped",
                  "fleet_worker_restarts", "fleet_worker_crashes",
                  "fleet_worker_kills", "fleet_worker_beats",
                  "fleet_worker_beats_failed", "fleet_worker_requests",
                  "fleet_worker_idem_replays",
                  "gateway_requests", "gateway_retries",
                  "gateway_stream_lost", "gateway_stream_resumed",
                  "gateway_registry_errors",
                  "cost_analysis_failures", "debug_bundles")
_DISPATCH_PREFIX = "dispatch."


def _registry():
    from . import telemetry          # lazy: telemetry imports us back

    return telemetry.registry()


def dispatch_count(name, delta=1):
    """Bump a dispatch counter (unknown names are created on the fly).
    While the profiler runs, each update also lands as a chrome-trace
    counter event."""
    value = _registry().counter(_DISPATCH_PREFIX + name).inc(delta)
    if _state == "run":
        _append({"name": "dispatch::%s" % name, "cat": "counter",
                 "ph": "C", "ts": _now_us(), "pid": os.getpid(),
                 "args": {"value": value}})


def dispatch_value(name):
    """Current value of one dispatch counter."""
    return _registry().counter(_DISPATCH_PREFIX + name).value


def dispatch_stats(reset=False):
    """Snapshot of the dispatch counters as a plain dict (all the
    well-known keys, zero-filled, plus any ad-hoc ones); ``reset=True``
    zeroes each counter as it is read."""
    from . import telemetry

    out = {k: 0 for k in _DISPATCH_KEYS}
    for full, metric in _registry().find(_DISPATCH_PREFIX):
        if not isinstance(metric, telemetry.Counter):
            continue
        key = full[len(_DISPATCH_PREFIX):]
        out[key] = metric.reset() if reset else metric.value
    return out


# -- session ----------------------------------------------------------------
def set_state(state="stop"):
    """'run' or 'stop'."""
    global _state
    if state not in ("run", "stop"):
        raise ValueError("profiler state must be 'run' or 'stop', got %r"
                         % (state,))
    _state = state


def start():
    set_state("run")


def stop():
    set_state("stop")


def state():
    return _state
