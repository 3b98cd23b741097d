"""Runtime resource-leak sanitizer: the counterpart of
``mxnet_tpu/leakcheck.py``, with the same kinds and the same API.

It keeps a creation-site-attributed ledger of every live instance of the
leak-prone resources whose lifetimes cross threads or queue hand-offs:

=============  ========================================================
kind           one live entry per ...
=============  ========================================================
``kv_pages``   KV-cache page handed out by ``PageAllocator.alloc`` and
               not yet returned through ``free``
``probe_slots``  reserved half-open circuit-breaker probe slot
``mesh_slices``  mesh slice in a transitional scale-up window
``futures``    admitted :class:`~mxnet_tpu_torch.serving.ServingFuture` /
               ``StreamingFuture`` with no typed terminal outcome yet
``journal``    gateway stream journal alive for an in-flight stream
``migrations``  in-flight live-migration transfer buffer on a receiver
=============  ========================================================

The port instruments ``kv_pages`` and ``futures``; the other kinds are
kept so the two packages' ledgers have the same shape.

Armed by :func:`install` (the JAX package's ``MXTPU_LEAKCHECK`` modes):

* ``off`` (default) — every hook is a single ``if not _installed``
  check: zero ledger state, zero per-event cost.
* ``record`` — live entries are recorded with creation site + thread,
  exported as ``leakcheck.*`` telemetry gauges and a ``leakcheck``
  debug-bundle section; :func:`assert_quiescent` returns the leftovers.
* ``raise`` — additionally, :func:`assert_quiescent` raises
  :class:`LeakError` naming every live entry's kind and creation site:
  after a drain every page must be freed and every admitted future
  settled.

A handle is only leaked relative to a quiescence point, so ``raise`` mode
gates :func:`assert_quiescent` rather than the tracking hooks, which polls
with a short settle grace so background settlement (a scheduler thread
draining) is not misread as a leak.  Stdlib only.
"""
from __future__ import annotations

import os
import sys
import threading
import time

__all__ = ["LeakError", "KINDS", "install",
           "uninstall", "installed", "mode", "track", "untrack",
           "live_count", "assert_quiescent", "snapshot", "reset"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_THIS_FILE = os.path.abspath(__file__)

KINDS = ("kv_pages", "probe_slots", "mesh_slices", "futures", "journal",
         "migrations")

_MAX_FRAMES = 15        # creation-site walk depth
_MAX_REPORTED = 20      # entries listed per kind in LeakError / snapshot

_installed = False
_mode = "off"

# the ledger: kind -> {token: (site, thread_name)}; all mutation under
# one raw lock held only for dict operations, never across a call out
_ledger = {k: {} for k in KINDS}
_counters = {"tracked": 0, "untracked": 0, "untrack_misses": 0,
             "double_tracks": 0}
_state_lock = threading.Lock()

_tls = threading.local()


class LeakError(RuntimeError):
    """Quiescence violated: live resources remain past the point where
    the program claims everything was released/settled, reported with
    each survivor's creation site."""


def mode():
    return _mode


def installed():
    return _installed


def _site(skip):
    """Attribution frame: first frame at/above ``skip`` that is outside
    this file, as 'file.py:123 (func)' (framework files relative to the
    package root)."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return "?"
    for _ in range(_MAX_FRAMES):
        if f is None:
            return "?"
        fname = os.path.abspath(f.f_code.co_filename)
        if fname == _THIS_FILE:
            f = f.f_back
            continue
        if fname.startswith(_PKG_DIR + os.sep):
            fname = os.path.relpath(fname, _PKG_DIR).replace(os.sep, "/")
        else:
            fname = os.path.basename(fname)
        return "%s:%d (%s)" % (fname, f.f_lineno, f.f_code.co_name)
    return "?"


def track(kind, token, skip=0):
    """Record one live resource.  ``token`` is any hashable identity
    unique among live entries of the kind (instrumentation sites use
    ``id(obj)`` or ``(id(owner), small_int)``).  ``skip`` pushes the
    creation-site attribution up past wrapper frames (0 attributes the
    caller of the instrumented function).  No-op unless installed."""
    if not _installed or getattr(_tls, "bypass", False):
        return
    site = _site(3 + skip)
    thread = threading.current_thread().name
    with _state_lock:
        book = _ledger[kind]
        if token in book:
            _counters["double_tracks"] += 1
        else:
            _counters["tracked"] += 1
        book[token] = (site, thread)


def untrack(kind, token):
    """Drop one live resource.  A miss (token not live) is counted, not
    raised — arming mid-process legitimately sees releases of resources
    acquired before install.  No-op unless installed."""
    if not _installed or getattr(_tls, "bypass", False):
        return
    with _state_lock:
        if _ledger[kind].pop(token, None) is None:
            _counters["untrack_misses"] += 1
        else:
            _counters["untracked"] += 1


def live_count(kind=None):
    """Live entries of ``kind`` (all kinds summed when None)."""
    with _state_lock:
        if kind is not None:
            return len(_ledger[kind])
        return sum(len(b) for b in _ledger.values())


def _leftovers(kinds):
    out = {}
    with _state_lock:
        for k in kinds:
            if _ledger[k]:
                out[k] = [site for site, _ in _ledger[k].values()]
    return out


def assert_quiescent(kinds=None, grace_s=0.5):
    """Assert every tracked resource has been released/settled.

    Polls for up to ``grace_s`` so settlement still in flight on a
    background thread (a scheduler draining, a worker finishing its
    last release) is not misread as a leak.  Leftovers after the grace:
    ``raise`` mode raises :class:`LeakError` naming each survivor's
    kind and creation site; ``record`` mode returns them as
    ``{kind: [site, ...]}`` (empty dict == quiescent).  A no-op
    (returns {}) when the sanitizer is not installed."""
    if not _installed:
        return {}
    kinds = tuple(kinds) if kinds is not None else KINDS
    deadline = time.monotonic() + float(grace_s)
    while True:
        left = _leftovers(kinds)
        if not left:
            return {}
        if time.monotonic() >= deadline:
            break
        time.sleep(0.02)
    if _mode != "raise":
        return left
    lines = []
    for k in sorted(left):
        sites = left[k]
        shown = sites[:_MAX_REPORTED]
        more = len(sites) - len(shown)
        lines.append("  %s: %d live -- %s%s"
                     % (k, len(sites), ", ".join(shown),
                        " (+%d more)" % more if more else ""))
    raise LeakError(
        "leakcheck: %d resource(s) still live at quiescence point:\n%s"
        % (sum(len(v) for v in left.values()), "\n".join(lines)))


def install(sanitize_mode="record"):
    """Start the ledger.  Idempotent; ``sanitize_mode`` is 'record' or
    'raise'."""
    global _installed, _mode
    if sanitize_mode not in ("record", "raise"):
        raise ValueError("MXTPU_LEAKCHECK mode must be 'record' or "
                         "'raise', got %r" % (sanitize_mode,))
    _mode = sanitize_mode
    if _installed:
        return
    _installed = True
    from . import debug

    debug.add_section("leakcheck", snapshot)


def uninstall():
    """Stop tracking (tests).  Hooks already inlined at call sites keep
    hitting the ``_installed`` fast path and recording nothing."""
    global _installed, _mode
    if not _installed:
        return
    _installed = False
    _mode = "off"
    from . import debug

    debug.remove_section("leakcheck")


def reset():
    """Clear the ledger and counters (tests / measurement windows); the
    installed state is untouched."""
    with _state_lock:
        for book in _ledger.values():
            book.clear()
        for k in _counters:
            _counters[k] = 0


def _publish_gauges():
    """Export ``leakcheck.live.<kind>`` + counters as telemetry gauges;
    bypasses tracking so publishing cannot feed back into the ledger."""
    try:
        from . import telemetry
    except ImportError:       # partial interpreter teardown
        return
    _tls.bypass = True
    try:
        reg = telemetry.registry()
        with _state_lock:
            live = {k: len(b) for k, b in _ledger.items()}
            counters = dict(_counters)
        for k, n in live.items():
            reg.gauge("leakcheck.live.%s" % k).set(float(n))
        for name, value in counters.items():
            reg.gauge("leakcheck.%s" % name).set(float(value))
    finally:
        _tls.bypass = False


def snapshot():
    """JSON-ready view (the debug-bundle section): mode, counters, live
    counts, and a bounded sample of creation sites per kind.  Publishes
    the telemetry gauges."""
    with _state_lock:
        out = {
            "mode": _mode,
            "installed": _installed,
            "counters": dict(_counters),
            "live": {k: len(b) for k, b in _ledger.items()},
            "sites": {k: [{"site": site, "thread": thr}
                          for site, thr in list(b.values())[:_MAX_REPORTED]]
                      for k, b in _ledger.items() if b},
        }
    _publish_gauges()
    return out
