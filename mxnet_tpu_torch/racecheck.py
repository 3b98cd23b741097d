"""Runtime lockset race sanitizer: the counterpart of
``mxnet_tpu/racecheck.py``.

It runs the classic Eraser lockset algorithm over the fields a class
declares with :func:`track`: every instrumented field keeps a *candidate
lockset*, the set of locks held at every access so far; each access
intersects it with the locks the accessing thread currently holds, and
when the candidate set empties while the field is write-shared across
threads, that is a data race, reported with both access sites and thread
names.

Armed with ``MXTPU_RACECHECK`` (read through :mod:`~mxnet_tpu_torch.config`
at ``import mxnet_tpu_torch``, after lockdep):

* ``off`` (default) — :func:`track` only records which fields a class
  wants checked: zero overhead, no wrapped methods, no wrapped lock
  factories, no state anywhere in the process.
* ``record`` — instances of tracked classes get access hooks on the
  declared fields; races are recorded with both witness accesses,
  exported as ``racecheck.*`` telemetry gauges and a ``racecheck``
  debug-bundle section.
* ``raise`` — additionally, the access that empties a write-shared
  field's candidate lockset raises :class:`RaceError` *at that access*,
  naming both sides of the race.

Field states follow Eraser: ``virgin`` (never accessed) → ``exclusive``
(one thread so far; no refinement — single-writer init and monitor-loop
state stays silent) → ``shared`` (a second thread read it; refine but do
not report) → ``shared-modified`` (written by a second thread; refine and
report).  One deliberate deviation: only the *write* lockset gates a
report — a field must be written by ≥2 threads whose write-time locksets
share no lock.  An unguarded read of a lock-disciplined counter (the main
thread asserting on a counter after joining its writers) is ordered by
happens-before edges Eraser cannot see and is torn-read-benign on CPython
ints; the detector gates on write/write discipline, the kind that
corrupts invariants.  Locks are identified per *object* (so guarding
instance A's counter with instance B's lock does not pass) and displayed
by *creation site*, package-relative, like lockdep.

Scope discipline matches :mod:`~mxnet_tpu_torch.lockdep`: only locks
created under ``mxnet_tpu_torch/`` are tracked, the hooks never raise on
the hot path for their own bookkeeping failures (only a deliberate
:class:`RaceError` in raise mode escapes), and each field reports at most
once so a racy counter in a tight loop cannot storm the log.

Stdlib only: importable and installable before torch.
"""
from __future__ import annotations

import os
import sys
import threading
import weakref

__all__ = ["RaceError", "track", "install", "install_from_env",
           "uninstall", "installed", "mode", "snapshot", "reset"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_THIS_FILE = os.path.abspath(__file__)
_THREADING_FILE = os.path.abspath(threading.__file__)
# lockdep wraps the same factories; when both sanitizers are armed the
# creation-site walk must see through the sibling's frames too
_INTERNAL_FILES = (_THIS_FILE, _THREADING_FILE,
                   os.path.join(_PKG_DIR, "lockdep.py"))

_MAX_FIELDS = 8192    # per-(instance, field) state cap
_MAX_RACES = 128      # recorded-race ring cap
_MAX_FRAMES = 15      # creation-site walk depth

_real_Lock = threading.Lock
_real_RLock = threading.RLock

_installed = False
_mode = "off"

# every registered class, instrumented or not, so a late install() can
# instrument classes whose decorator ran while the sanitizer was off
_registry = []        # [(cls, frozenset(fields))]
_instrumented = {}    # id(cls) -> (cls, orig_getattribute, orig_setattr)

# all mutable detector state lives under one RAW (never wrapped) lock;
# it is held only for dict mutation, never across a call out
_state_lock = _real_Lock()
_field_states = {}    # (id(obj), field) -> _FieldState
_finalized = set()    # ids with a cleanup finalizer registered (id()
#                       reuse after GC must not inherit a dead
#                       instance's writer threads and locksets)
_forgotten = []       # (id, fields) of collected instances, queued by
#                       their finalizers (list.append needs no lock)
_races = []           # recorded race dicts (ring, first _MAX_RACES)
_counters = {"classes_instrumented": 0, "fields_tracked": 0,
             "locks_created": 0, "accesses": 0, "refinements": 0,
             "races": 0}

_tls = threading.local()

_VIRGIN, _EXCLUSIVE, _SHARED, _SHARED_MOD = range(4)
_STATE_NAMES = ("virgin", "exclusive", "shared", "shared-modified")


class RaceError(RuntimeError):
    """A write-shared field's candidate lockset emptied — two threads
    touch it and no single lock covers both accesses."""


def mode():
    return _mode


def installed():
    return _installed


def _held():
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _caller(skip=2):
    """First frame outside racecheck/lockdep/threading, as
    'file.py:123 (func)'."""
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
    """Package-relative creation site, or None for a lock created by
    foreign code (which then gets the real factory, untracked)."""
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


class _FieldState:
    __slots__ = ("state", "lockset", "write_lockset", "first_thread",
                 "last_writes", "reported")

    def __init__(self):
        self.state = _VIRGIN
        self.lockset = None        # None == "all locks" (top element)
        self.write_lockset = None  # intersection over writes only
        self.first_thread = None
        self.last_writes = {}      # thread ident -> (site, name, held)
        self.reported = False


def _describe(lockset):
    if not lockset:
        return "no locks"
    return "{%s}" % ", ".join(sorted(site for _, site in lockset))


def _tracked_of(cls):
    for c, fieldset in _registry:
        if c is cls:
            return fieldset
    return ()


def _forget(obj_id, fields):
    """Finalizer: queue a collected instance's field states for removal,
    so an allocation reusing its id starts virgin.  A finalizer runs on
    whatever thread triggers the collection — also one that holds
    ``_state_lock`` mid-snapshot — so it takes no lock: the queue is
    drained under the lock by the next access, snapshot or reset."""
    _forgotten.append((obj_id, fields))


def _drain_forgotten():
    """Drop the queued collected instances' states (caller holds
    ``_state_lock``)."""
    while _forgotten:
        obj_id, fields = _forgotten.pop()
        for f in fields:
            _field_states.pop((obj_id, f), None)
        _finalized.discard(obj_id)


def _on_access(obj, cls, field, is_write):
    """The Eraser step for one access.  Returns a RaceError to raise
    (raise mode) or None; never raises for its own failures."""
    thread = threading.current_thread()
    held = frozenset(_held())
    site = _caller(3)
    key = (id(obj), field)
    err = None
    with _state_lock:
        _drain_forgotten()
        _counters["accesses"] += 1
        fs = _field_states.get(key)
        if fs is None:
            if len(_field_states) >= _MAX_FIELDS:
                return None
            fs = _field_states[key] = _FieldState()
            _counters["fields_tracked"] += 1
            if id(obj) not in _finalized:
                _finalized.add(id(obj))
                try:
                    weakref.finalize(obj, _forget, id(obj),
                                     tuple(_tracked_of(cls)))
                except TypeError:   # not weakref-able: tolerate reuse
                    pass
        if fs.state == _VIRGIN:
            fs.state = _EXCLUSIVE
            fs.first_thread = thread.ident
        elif fs.state == _EXCLUSIVE and thread.ident != fs.first_thread:
            fs.state = _SHARED_MOD if is_write else _SHARED
            fs.lockset = held      # first intersection: what's held now
            _counters["refinements"] += 1
        elif fs.state in (_SHARED, _SHARED_MOD):
            if is_write:
                fs.state = _SHARED_MOD
            fs.lockset = held if fs.lockset is None \
                else (fs.lockset & held)
            _counters["refinements"] += 1
        racy = False
        # write bookkeeping starts when the field leaves EXCLUSIVE —
        # init-time writes by the owning thread (and clean ownership
        # handoffs) never pollute the write lockset
        if is_write and fs.state in (_SHARED, _SHARED_MOD):
            fs.write_lockset = held if fs.write_lockset is None \
                else (fs.write_lockset & held)
            racy = (len(fs.last_writes) >= 1
                    and any(t != thread.ident for t in fs.last_writes)
                    and not fs.write_lockset and not fs.reported)
        if racy:
            fs.reported = True
            _counters["races"] += 1
            prev_site, prev_thread, prev_locks = next(
                w for t, w in fs.last_writes.items()
                if t != thread.ident)
            msg = ("unsynchronized writes to %s.%s: write at %s "
                   "(thread %r, holding %s) races with prior write at "
                   "%s (thread %r, holding %s) — no lock covers both "
                   "sides.  Guard every post-init access with one "
                   "lock." % (cls.__name__, field, site, thread.name,
                              _describe(held), prev_site, prev_thread,
                              prev_locks))
            if len(_races) < _MAX_RACES:
                _races.append({
                    "cls": cls.__name__, "field": field,
                    "access": {"kind": "write", "at": site,
                               "thread": thread.name,
                               "held": _describe(held)},
                    "prior": {"kind": "write", "at": prev_site,
                              "thread": prev_thread, "held": prev_locks},
                })
            if _mode == "raise":
                err = RaceError(msg)
        if is_write and fs.state in (_SHARED, _SHARED_MOD):
            if len(fs.last_writes) < 8 or thread.ident in fs.last_writes:
                fs.last_writes[thread.ident] = (
                    site, thread.name, _describe(held))
    return err


def _instrument_class(cls, fields):
    """Swap in access-checking ``__getattribute__``/``__setattr__``.
    Only the declared field names pay the hook; everything else is one
    extra frozenset membership test."""
    if id(cls) in _instrumented:
        return
    orig_get = cls.__getattribute__
    orig_set = cls.__setattr__

    def __getattribute__(self, name):
        if name in fields and _installed \
                and not getattr(_tls, "bypass", False):
            _tls.bypass = True
            try:
                err = _on_access(self, cls, name, is_write=False)
            except Exception:
                err = None     # the sanitizer must never break the app
            finally:
                _tls.bypass = False
            if err is not None:
                raise err
        return orig_get(self, name)

    def __setattr__(self, name, value):
        if name in fields and _installed \
                and not getattr(_tls, "bypass", False):
            _tls.bypass = True
            try:
                err = _on_access(self, cls, name, is_write=True)
            except Exception:
                err = None
            finally:
                _tls.bypass = False
            if err is not None:
                raise err
        orig_set(self, name, value)

    cls.__getattribute__ = __getattribute__
    cls.__setattr__ = __setattr__
    _instrumented[id(cls)] = (cls, orig_get, orig_set)
    with _state_lock:
        _counters["classes_instrumented"] += 1


def track(*fields):
    """Class decorator declaring which fields the lockset detector
    should watch (the lock-disciplined ones — counters bumped from
    handler threads, tables shared with a monitor loop).  With the
    sanitizer off this only records the declaration and returns the
    class untouched."""
    fieldset = frozenset(fields)

    def deco(cls):
        _registry.append((cls, fieldset))
        if _installed:
            _instrument_class(cls, fieldset)
        return cls

    return deco


class _LockToken:
    """Identity-tracking proxy over a real Lock/RLock: pushes/pops
    (id, creation-site) on the per-thread held list.  Implements the
    ``Condition`` integration surface so wrapped locks drop into
    ``threading.Condition`` unchanged."""

    __slots__ = ("_inner", "_site", "_kind")

    def __init__(self, inner, site, kind):
        self._inner = inner
        self._site = site
        self._kind = kind

    def __repr__(self):
        return "<racecheck %s %s wrapping %r>" % (
            self._kind, self._site, self._inner)

    def _entry(self):
        return (id(self), self._site)

    def _push(self):
        _held().append(self._entry())

    def _pop_one(self):
        stack = getattr(_tls, "held", None)
        if stack:
            me = self._entry()
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == me:
                    del stack[i]
                    break

    def _pop_all(self):
        stack = getattr(_tls, "held", None)
        if stack:
            me = self._entry()
            stack[:] = [e for e in stack if e != me]

    def acquire(self, blocking=True, timeout=-1):
        got = self._inner.acquire(blocking, timeout)
        if got and _installed:
            self._push()
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
        if _installed:
            self._push()


def _make_factory(real, kind):
    # ``real`` is whatever factory is live at install time, so stacking
    # under lockdep composes: token wraps lockdep wraps the raw lock
    def factory():
        if not _installed:
            return real()
        site = _creation_site()
        if site is None:
            return real()
        with _state_lock:
            _counters["locks_created"] += 1
        return _LockToken(real(), site, kind)

    factory.__name__ = "racecheck_%s" % kind
    return factory


def install(sanitize_mode="record"):
    """Wrap the threading factories, instrument every registered class,
    and start detecting.  Idempotent; ``sanitize_mode`` is 'record' or
    'raise'."""
    global _installed, _mode, _prev_Lock, _prev_RLock
    if sanitize_mode not in ("record", "raise"):
        raise ValueError("MXTPU_RACECHECK mode must be 'record' or "
                         "'raise', got %r" % (sanitize_mode,))
    _mode = sanitize_mode
    if _installed:
        return
    _installed = True
    _prev_Lock = threading.Lock      # may already be lockdep's factory
    _prev_RLock = threading.RLock
    threading.Lock = _make_factory(_prev_Lock, "Lock")
    threading.RLock = _make_factory(_prev_RLock, "RLock")
    for cls, fieldset in _registry:
        _instrument_class(cls, fieldset)
    from . import debug

    debug.add_section("racecheck", snapshot)


def install_from_env():
    """Arm from ``MXTPU_RACECHECK`` (called at package import, after
    lockdep, before any tracked class is defined).  Unset/off: no-op."""
    from .config import config

    raw = (config.racecheck or "off").strip().lower()
    if raw in ("", "off", "0", "false", "no"):
        return
    install("raise" if raw == "raise" else "record")


def uninstall():
    """Restore the factories and de-instrument classes (tests).  Lock
    tokens already handed out keep delegating but stop recording."""
    global _installed, _mode
    if not _installed:
        return
    _installed = False
    _mode = "off"
    threading.Lock = _prev_Lock
    threading.RLock = _prev_RLock
    for cls, orig_get, orig_set in list(_instrumented.values()):
        cls.__getattribute__ = orig_get
        cls.__setattr__ = orig_set
    _instrumented.clear()
    from . import debug

    debug.remove_section("racecheck")


def reset():
    """Clear detector state and counters (tests / measurement windows);
    installed-ness and instrumentation are untouched."""
    with _state_lock:
        _drain_forgotten()
        _field_states.clear()
        del _races[:]
        for k in _counters:
            _counters[k] = 0


def _publish_gauges():
    """Export the counters as ``racecheck.*`` telemetry gauges;
    bypasses the hooks so publishing cannot feed back into detection."""
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
            reg.gauge("racecheck.%s" % name).set(float(value))
    finally:
        _tls.bypass = False


def snapshot():
    """JSON-ready view (the debug-bundle section): mode, counters, the
    per-field state census, and every recorded race with both witness
    accesses.  Publishes the telemetry gauges."""
    with _state_lock:
        _drain_forgotten()
        census = {}
        for fs in _field_states.values():
            name = _STATE_NAMES[fs.state]
            census[name] = census.get(name, 0) + 1
        out = {
            "mode": _mode,
            "installed": _installed,
            "counters": dict(_counters),
            "field_states": census,
            "races": [dict(r) for r in _races],
        }
    _publish_gauges()
    return out
