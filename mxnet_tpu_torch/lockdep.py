"""Runtime lock-order sanitizer: the counterpart of ``mxnet_tpu/lockdep.py``.

It wraps the ``threading.Lock`` / ``threading.RLock`` factories (before any
package module creates a lock) and keeps the package-wide acquisition-order
graph at runtime, keyed by lock *creation site*: the orderings a static
pass cannot see — locks taken through callbacks, ``getattr`` indirection
or third-party call paths.

Armed with ``MXTPU_LOCKDEP`` (read through :mod:`~mxnet_tpu_torch.config`
at ``import mxnet_tpu_torch``):

* ``off`` (default) — the factories are left untouched: zero overhead,
  no wrapper objects exist anywhere in the process.
* ``record`` — every lock created under ``mxnet_tpu_torch/`` is wrapped;
  acquisition edges, order inversions, and held-across-blocking events
  are recorded with thread + stack fingerprints, exported as
  ``lockdep.*`` telemetry gauges and a ``lockdep`` debug-bundle section.
* ``raise`` — additionally, an acquisition that closes a cycle in the
  order graph raises :class:`LockOrderError` *at the acquire that would
  deadlock* (before taking the inner lock), with both witness paths in
  the message.

Scope discipline: only locks whose creation site is inside this package's
directory (``_PKG_DIR`` plus a path separator, so ``mxnet_tpu/`` beside it
never matches) are wrapped — a lock created by torch, numpy, the stdlib
or the JAX package gets the real factory, so the sanitizer never taxes or
misattributes foreign locking.  Locks sharing a creation site (per-instance
locks of one class) are ordering-equivalent by construction, so same-site
edges are skipped rather than reported as sibling-instance inversions.

Held-across-blocking is *record-only* by design, never a raise: some
transports hold a lock across I/O on purpose (``async_kv``'s client
serializes its single-connection protocol that way), so it is evidence
for the postmortem bundle, not a gate.  Transports report their own waits
via :func:`note_blocking`; ``time.sleep`` is instrumented automatically
while installed.

Stdlib only: importable and installable before torch.
"""
from __future__ import annotations

import os
import sys
import threading
import time

__all__ = ["LockOrderError", "install", "install_from_env", "uninstall",
           "installed", "mode", "note_blocking", "snapshot", "reset"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_THIS_FILE = os.path.abspath(__file__)
_THREADING_FILE = os.path.abspath(threading.__file__)
# racecheck wraps the same factories; when both sanitizers are armed
# the creation-site walk must see through the sibling's frames too
_INTERNAL_FILES = (_THIS_FILE, _THREADING_FILE,
                   os.path.join(_PKG_DIR, "racecheck.py"))

_MAX_EDGES = 4096     # order-graph size cap (creation-site pairs)
_MAX_EVENTS = 128     # held-across-blocking ring cap
_MAX_FRAMES = 15      # creation-site walk depth

_real_Lock = threading.Lock
_real_RLock = threading.RLock
_real_sleep = time.sleep

_installed = False
_mode = "off"

# all mutable graph state lives under one RAW (never wrapped) lock; it
# is held only for dict/set mutation, never across a call out
_state_lock = _real_Lock()
_edges = {}           # (site_a, site_b) -> witness str (first wins)
_adj = {}             # site_a -> set(site_b), the same graph for BFS
_inversions = []      # {"a", "b", "path_ab", "path_ba"}
_inverted_pairs = set()
_blocking_events = []  # {"kind", "held", "at", "thread"}
_counters = {"locks_created": 0, "acquires": 0, "edges": 0,
             "inversions": 0, "held_across_blocking": 0}

_tls = threading.local()


class LockOrderError(RuntimeError):
    """An acquisition would close a cycle in the lock-order graph —
    the deadlock reported at the acquire, not at the hang."""


def mode():
    return _mode


def installed():
    return _installed


def _held_stack():
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _caller(skip=2):
    """First frame outside lockdep/threading: 'file.py:123 (func)'."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return "?"
    while f is not None and \
            os.path.abspath(f.f_code.co_filename) in _INTERNAL_FILES:
        f = f.f_back
    if f is None:
        return "?"
    return "%s:%d (%s)" % (os.path.basename(f.f_code.co_filename),
                           f.f_lineno, f.f_code.co_name)


def _creation_site():
    """Creation site if the first non-threading caller frame is inside
    this package (None otherwise -> use the real factory).  The stdlib
    creating a lock on its own behalf (queue.Queue's mutex) stays
    unwrapped even when package code instantiated the queue."""
    f = sys._getframe(2)
    for _ in range(_MAX_FRAMES):
        if f is None:
            return None
        fname = os.path.abspath(f.f_code.co_filename)
        if fname in _INTERNAL_FILES:
            f = f.f_back
            continue
        if not fname.startswith(_PKG_DIR + os.sep):
            return None
        return "%s:%d" % (os.path.relpath(fname, _PKG_DIR).replace(
            os.sep, "/"), f.f_lineno)
    return None


def _path_between(start, goal):
    """BFS start -> goal over the order graph (caller holds
    ``_state_lock``); returns the site list or None."""
    if start == goal:
        return [start]
    frontier = [start]
    came = {start: None}
    while frontier:
        nxt = []
        for n in frontier:
            for m in _adj.get(n, ()):
                if m in came:
                    continue
                came[m] = n
                if m == goal:
                    out = [m]
                    while came[out[-1]] is not None:
                        out.append(came[out[-1]])
                    return list(reversed(out))
                nxt.append(m)
        frontier = nxt
    return None


def _format_path(path):
    bits = []
    for a, b in zip(path, path[1:]):
        bits.append("%s -> %s [%s]" % (a, b, _edges.get((a, b), "?")))
    return "; ".join(bits)


def _record_edges(stack, site, where):
    """Record (held -> site) edges; detect a cycle BEFORE the caller
    takes the inner lock.  Returns a LockOrderError to raise (raise
    mode) or None."""
    thread = threading.current_thread().name
    err = None
    with _state_lock:
        for held_site, held_at in stack:
            if held_site == site:      # reentry / sibling instances
                continue
            key = (held_site, site)
            if key in _edges:
                continue
            back = _path_between(site, held_site)
            if back is not None:
                pair = frozenset((held_site, site))
                witness_ab = "%s: %s (acquired at %s) then %s (at %s)" \
                    % (thread, held_site, held_at, site, where)
                if pair not in _inverted_pairs:
                    _inverted_pairs.add(pair)
                    _counters["inversions"] += 1
                    _inversions.append({
                        "a": held_site, "b": site,
                        "path_ab": witness_ab,
                        "path_ba": _format_path(back),
                    })
                if _mode == "raise" and err is None:
                    err = LockOrderError(
                        "lock-order inversion: about to take %s while "
                        "holding %s, but the order graph already has "
                        "%s.\n  this path: %s\n  prior path: %s"
                        % (site, held_site, " -> ".join(back),
                           witness_ab, _format_path(back)))
                continue               # an inverted edge is not added
            if len(_edges) < _MAX_EDGES:
                _edges[key] = "%s: %s (acquired at %s) then %s (at %s)" \
                    % (thread, held_site, held_at, site, where)
                _adj.setdefault(held_site, set()).add(site)
                _counters["edges"] += 1
    return err


def note_blocking(kind):
    """Transport hook: record that the calling thread is about to block
    (``kind`` names the wait).  A no-op unless installed and the thread
    holds wrapped locks; record-only — never raises."""
    if not _installed:
        return
    stack = getattr(_tls, "held", None)
    if not stack or getattr(_tls, "bypass", False):
        return
    event = {"kind": kind, "held": [s for s, _ in stack],
             "at": _caller(), "thread": threading.current_thread().name}
    with _state_lock:
        _counters["held_across_blocking"] += 1
        if len(_blocking_events) < _MAX_EVENTS:
            _blocking_events.append(event)


def _lockdep_sleep(secs):
    note_blocking("time.sleep(%.4g)" % secs)
    _real_sleep(secs)


class _LockWrapper:
    """Order-tracking proxy over a real Lock/RLock.  Implements the
    ``Condition`` integration surface (``_is_owned`` /
    ``_release_save`` / ``_acquire_restore``) so wrapped locks drop
    into ``threading.Condition`` unchanged."""

    __slots__ = ("_inner", "_site", "_kind")

    def __init__(self, inner, site, kind):
        self._inner = inner
        self._site = site
        self._kind = kind

    def __repr__(self):
        return "<lockdep %s %s wrapping %r>" % (self._kind, self._site,
                                                self._inner)

    def _push(self, where):
        _held_stack().append((self._site, where))

    def _pop_one(self):
        stack = getattr(_tls, "held", None)
        if stack:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] == self._site:
                    del stack[i]
                    break

    def _pop_all(self):
        stack = getattr(_tls, "held", None)
        if stack:
            stack[:] = [e for e in stack if e[0] != self._site]

    def acquire(self, blocking=True, timeout=-1):
        if not _installed or getattr(_tls, "bypass", False):
            return self._inner.acquire(blocking, timeout)
        stack = _held_stack()
        where = _caller()
        err = None
        if stack:
            err = _record_edges(tuple(stack), self._site, where)
        with _state_lock:
            _counters["acquires"] += 1
        if err is not None:
            raise err
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._push(where)
        return got

    def release(self):
        self._inner.release()
        self._pop_one()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    # -- Condition integration (threading.Condition duck-typing) --------
    def _is_owned(self):
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _release_save(self):
        inner = self._inner
        if hasattr(inner, "_release_save"):
            state = inner._release_save()   # RLock: full release
        else:
            inner.release()
            state = None
        self._pop_all()
        return state

    def _acquire_restore(self, state):
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(state)
        else:
            inner.acquire()
        self._push(_caller())


def _make_factory(real, kind):
    def factory():
        if not _installed:
            return real()
        site = _creation_site()
        if site is None:
            return real()
        with _state_lock:
            _counters["locks_created"] += 1
        return _LockWrapper(real(), site, kind)

    factory.__name__ = "lockdep_%s" % kind
    return factory


def install(sanitize_mode="record"):
    """Wrap the threading factories and start recording.  Idempotent;
    ``sanitize_mode`` is 'record' or 'raise'."""
    global _installed, _mode
    if sanitize_mode not in ("record", "raise"):
        raise ValueError("MXTPU_LOCKDEP mode must be 'record' or "
                         "'raise', got %r" % (sanitize_mode,))
    _mode = sanitize_mode
    if _installed:
        return
    _installed = True
    threading.Lock = _make_factory(_real_Lock, "Lock")
    threading.RLock = _make_factory(_real_RLock, "RLock")
    time.sleep = _lockdep_sleep
    from . import debug

    debug.add_section("lockdep", snapshot)


def install_from_env():
    """Arm from ``MXTPU_LOCKDEP`` (called first thing at package
    import, before any package lock exists).  Unset/off: no-op."""
    from .config import config

    raw = (config.lockdep or "off").strip().lower()
    if raw in ("", "off", "0", "false", "no"):
        return
    install("raise" if raw == "raise" else "record")


def uninstall():
    """Restore the real factories (tests).  Wrappers already handed out
    keep delegating but stop recording (``_installed`` is checked per
    acquire)."""
    global _installed, _mode
    if not _installed:
        return
    _installed = False
    _mode = "off"
    threading.Lock = _real_Lock
    threading.RLock = _real_RLock
    time.sleep = _real_sleep
    from . import debug

    debug.remove_section("lockdep")


def reset():
    """Clear the recorded graph and counters (tests / measurement
    windows); the installed state is untouched."""
    with _state_lock:
        _edges.clear()
        _adj.clear()
        del _inversions[:]
        _inverted_pairs.clear()
        del _blocking_events[:]
        for k in _counters:
            _counters[k] = 0


def _publish_gauges():
    """Export the counters as ``lockdep.*`` telemetry gauges; bypasses
    recording so publishing cannot feed back into the graph."""
    try:
        from . import telemetry
    except ImportError:       # partial interpreter teardown
        return
    _tls.bypass = True
    try:
        reg = telemetry.registry()
        with _state_lock:
            counters = dict(_counters)
        for name, value in counters.items():
            reg.gauge("lockdep.%s" % name).set(float(value))
    finally:
        _tls.bypass = False


def snapshot():
    """JSON-ready view (the debug-bundle section): mode, counters,
    order-graph edges, inversions with both witness paths, and the
    held-across-blocking ring.  Publishes the telemetry gauges."""
    with _state_lock:
        out = {
            "mode": _mode,
            "installed": _installed,
            "counters": dict(_counters),
            "edges": [{"a": a, "b": b, "witness": w}
                      for (a, b), w in sorted(_edges.items())],
            "inversions": [dict(i) for i in _inversions],
            "held_across_blocking": [dict(e) for e in _blocking_events],
        }
    _publish_gauges()
    return out
