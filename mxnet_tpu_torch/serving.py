"""Serving types: lifecycle states, typed outcomes, the brownout ladder
and request futures.

The part of ``mxnet_tpu/serving.py`` that the generation server settles
requests with.  The outcome contract is the same: every admitted request
reaches **exactly one** typed terminal outcome — a result,
:class:`DeadlineExceeded`, :class:`Overloaded`, :class:`QuotaExceeded`,
:class:`Draining` (or, for a stream parked for live migration,
:class:`StreamMigrated`) — and none hang.  Each future carries a request
trace id: an async chrome-trace span opens at admission and closes at
settlement, and the ``serving.latency_ms`` /
``serving.rejected_latency_ms`` histograms record its latency.  Live
futures sit in the leakcheck ledger until they settle.

:class:`BrownoutController` is the overload-degradation ladder every
admission gate in the process consults (:func:`brownout`).
``ModelServer``, ``Replica`` and ``CircuitBreaker`` are not ported yet.
"""
from __future__ import annotations

import os
import sys
import threading

from . import clock as _clockmod
from . import leakcheck as _leakcheck
from . import telemetry as _telemetry

__all__ = ["ServingFuture", "StreamingFuture", "BrownoutController",
           "brownout", "ServingError", "Overloaded", "DeadlineExceeded",
           "Draining", "Unavailable", "ReplicaLost", "QuotaExceeded",
           "UnknownRoute", "StreamMigrated", "STARTING", "SERVING",
           "DEGRADED", "DRAINING", "STOPPED"]

# -- lifecycle states -------------------------------------------------------
STARTING = "STARTING"
SERVING = "SERVING"
DEGRADED = "DEGRADED"   # at least one breaker open, traffic still flowing
DRAINING = "DRAINING"   # admission closed, in-flight completing
STOPPED = "STOPPED"

# brownout ladder: consecutive breach /
# clear ticks to step one level up / down, the max_new_tokens cap applied
# at level >= 1, and the minimum priority rank admitted at level 3
_DEF_BROWNOUT_ENGAGE = int(os.environ.get("MXTPU_BROWNOUT_ENGAGE_TICKS",
                                          "3"))
_DEF_BROWNOUT_RECOVER = int(os.environ.get("MXTPU_BROWNOUT_RECOVER_TICKS",
                                           "5"))
_DEF_BROWNOUT_CAP = int(os.environ.get("MXTPU_BROWNOUT_CAP_TOKENS", "32"))
_DEF_BROWNOUT_MIN_RANK = int(os.environ.get("MXTPU_BROWNOUT_MIN_RANK", "1"))


def _log(msg):
    print("[serving] %s" % msg, file=sys.stderr, flush=True)


def _count(name, delta=1):
    from . import profiler as _prof

    _prof.dispatch_count(name, delta)


# ---------------------------------------------------------------------------
# typed outcomes
# ---------------------------------------------------------------------------
class ServingError(RuntimeError):
    """Base of every typed serving rejection/failure."""


class Overloaded(ServingError):
    """Admission queue at capacity — request shed, retry elsewhere/later."""


class DeadlineExceeded(ServingError):
    """The request's deadline expired before a result was produced."""


class Draining(ServingError):
    """The server is draining (or stopped) and admits no new requests."""


class Unavailable(ServingError):
    """Every replica was tried for this request and failed."""


class ReplicaLost(ServingError):
    """The worker process holding this request died mid-execution and
    the work could not be completed anywhere else.  Since the durable-
    stream contract, a generation stream that loses its worker mid-decode
    is *resumed* on a healthy sibling from the gateway's journal (prompt
    + seed + delivered tokens → re-prefill, exactly-once continuation);
    this error is the >= 2-failure fallback — the resumed incarnation
    died too, or no healthy sibling existed."""


class QuotaExceeded(ServingError):
    """The request's *tenant* is over its admission quota (empty token
    bucket) or weighted-fair queue share.  Deliberately distinct from
    :class:`Overloaded`: it is the flooding tenant's own typed outcome,
    the gateway never spills it to a sibling replica (every replica
    shares the same per-tenant verdict), and it does not feed the
    supervisor's shed-rate breach bit — one tenant's flood must not
    trigger fleet-wide brownout or autoscaling panic."""


class UnknownRoute(ServingError):
    """No worker in the fleet advertises the named model route
    (``POST /v1/<route>/...``).  A client-side 404, not a capacity
    signal: retrying elsewhere cannot help, so the gateway returns it
    without spilling."""


class StreamMigrated(ServingError):
    """The generation stream was parked for live KV migration (drain,
    rebalance).  NOT a
    client-visible outcome: the worker translates it into a ``migrate``
    NDJSON line carrying :attr:`handle`, and the gateway either completes
    the transfer (export -> import -> re-attach on the receiver, no
    re-prefill) or falls back to the resume-from-journal path — so the
    client still sees exactly one typed terminal outcome."""

    def __init__(self, msg="", handle=None):
        super().__init__(msg)
        self.handle = handle


# ---------------------------------------------------------------------------
# brownout ladder
# ---------------------------------------------------------------------------
class BrownoutController:
    """Typed overload-degradation ladder with tick-count hysteresis.

    Levels (each includes the measures of the ones below it):

    ====  ============  ====================================================
    0     normal        no degradation
    1     cap_tokens    generation ``max_new_tokens`` capped at
                        ``MXTPU_BROWNOUT_CAP_TOKENS``
    2     no_hedge      speculative hedging disabled (halves worst-case
                        duplicate work)
    3     qos_only      only priority ranks >= ``MXTPU_BROWNOUT_MIN_RANK``
                        admitted; the rest shed with typed ``Overloaded``
    ====  ============  ====================================================

    :meth:`observe` is fed one breach/clear signal per supervisor tick
    (the shed-rate / p99 breach bit that also drives autoscaling).
    ``engage_ticks`` consecutive breaches escalate one level;
    ``recover_ticks`` consecutive clears de-escalate one — so the ladder
    both engages and fully recovers automatically, without flapping.
    The current level is published on the ``serving.brownout_level``
    gauge and every transition is counted and trace-marked."""

    LEVELS = ("normal", "cap_tokens", "no_hedge", "qos_only")

    def __init__(self, engage_ticks=None, recover_ticks=None,
                 cap_tokens=None, min_rank=None):
        self.engage_ticks = max(1, _DEF_BROWNOUT_ENGAGE
                                if engage_ticks is None
                                else int(engage_ticks))
        self.recover_ticks = max(1, _DEF_BROWNOUT_RECOVER
                                 if recover_ticks is None
                                 else int(recover_ticks))
        self.cap_tokens = (_DEF_BROWNOUT_CAP if cap_tokens is None
                           else int(cap_tokens))
        self.min_rank = (_DEF_BROWNOUT_MIN_RANK if min_rank is None
                         else int(min_rank))
        self._lock = threading.Lock()
        self._level = 0
        self._breach_streak = 0
        self._clear_streak = 0
        self._publish(0)

    def _publish(self, level):
        _telemetry.registry().gauge("serving.brownout_level").set(level)

    @property
    def level(self):
        return self._level

    @property
    def mode(self):
        return self.LEVELS[self._level]

    def observe(self, breach):
        """Feed one supervisor-tick overload signal; returns the (possibly
        new) level.  Hysteresis: a level only changes after
        ``engage_ticks`` consecutive breaches / ``recover_ticks``
        consecutive clears, and streaks reset on every transition."""
        with self._lock:
            old = self._level
            if breach:
                self._clear_streak = 0
                self._breach_streak += 1
                if (self._breach_streak >= self.engage_ticks
                        and self._level < len(self.LEVELS) - 1):
                    self._level += 1
                    self._breach_streak = 0
            else:
                self._breach_streak = 0
                self._clear_streak += 1
                if (self._clear_streak >= self.recover_ticks
                        and self._level > 0):
                    self._level -= 1
                    self._clear_streak = 0
            level = self._level
        if level != old:
            self._publish(level)
            _count("brownout_escalated" if level > old
                   else "brownout_recovered")
            _telemetry.trace_instant(
                "serving.brownout", args={"level": level,
                                          "mode": self.LEVELS[level]})
            _log("brownout level %d (%s) -> %d (%s)"
                 % (old, self.LEVELS[old], level, self.LEVELS[level]))
        return level

    # -- degradation measures (queried at the enforcement sites) -------
    def cap_max_new(self, max_new):
        """Level >= 1: cap a generation request's ``max_new_tokens``."""
        if self._level >= 1 and self.cap_tokens > 0:
            return min(int(max_new), self.cap_tokens)
        return int(max_new)

    def hedging_disabled(self):
        """Level >= 2: the hedging sweep becomes a no-op."""
        return self._level >= 2

    def admits(self, rank):
        """Level 3: only priority ranks >= ``min_rank`` are admitted."""
        return self._level < 3 or int(rank) >= self.min_rank

    def reset(self):
        with self._lock:
            self._level = 0
            self._breach_streak = 0
            self._clear_streak = 0
        self._publish(0)


_BROWNOUT = None
_BROWNOUT_LOCK = threading.Lock()


def brownout():
    """The process-global :class:`BrownoutController` — shared by the
    fleet supervisor (which feeds it) and every admission/hedging
    enforcement site (which query it).  Tests ``reset()`` it."""
    global _BROWNOUT
    with _BROWNOUT_LOCK:
        if _BROWNOUT is None:
            _BROWNOUT = BrownoutController()
        return _BROWNOUT



# ---------------------------------------------------------------------------
# request / future
# ---------------------------------------------------------------------------
class ServingFuture:
    """One admitted request.  Resolved exactly once (first writer wins —
    the deadline/drain races all funnel through :meth:`_resolve` /
    :meth:`_reject` under the server lock)."""

    __slots__ = ("inputs", "rows", "deadline", "t_admit", "_outputs",
                 "_error", "_event", "t_done", "trace_id", "clock")

    def __init__(self, inputs, rows, deadline, t_admit, clock=None):
        self.inputs = inputs          # {name: np.ndarray}, leading dim=rows
        self.rows = rows
        self.deadline = deadline      # absolute clock.now() time
        self.t_admit = t_admit
        self.clock = _clockmod.resolve(clock)
        # settle writes happen-before every reader: _settle() stores them,
        # then _event.set() publishes, and readers gate on the event
        self._outputs = None
        self._error = None
        self._event = threading.Event()
        self.t_done = None
        # end-to-end request trace: one async chrome-trace span per
        # admitted request, keyed by this id from admission to outcome
        self.trace_id = _telemetry.new_trace_id()
        # leakcheck ledger: live until the one typed terminal outcome lands
        _leakcheck.track("futures", id(self))

    @property
    def done(self):
        return self._event.is_set()

    def _settle(self):
        """Mark terminal (caller holds the server lock)."""
        self.t_done = self.clock.now()
        self._event.set()
        _leakcheck.untrack("futures", id(self))

    def _resolve(self, outputs):
        if self._event.is_set():
            return False
        self._outputs = outputs
        self._settle()
        lat_ms = (self.t_done - self.t_admit) * 1e3
        _telemetry.registry().histogram("serving.latency_ms").observe(lat_ms)
        _telemetry.trace_end("request", self.trace_id,
                             args={"outcome": "ok",
                                   "latency_ms": round(lat_ms, 3)})
        return True

    def _reject(self, error):
        if self._event.is_set():
            return False
        self._error = error
        self._settle()
        lat_ms = (self.t_done - self.t_admit) * 1e3
        _telemetry.registry().histogram(
            "serving.rejected_latency_ms").observe(lat_ms)
        _telemetry.trace_end("request", self.trace_id,
                             args={"outcome": type(error).__name__,
                                   "latency_ms": round(lat_ms, 3)})
        return True

    def result(self, timeout=None):
        """Block for the terminal outcome: the output list, or the typed
        :class:`ServingError` raised."""
        if not self._event.wait(timeout):
            raise TimeoutError("serving request not terminal after %ss"
                               % timeout)
        if self._error is not None:
            raise self._error
        return self._outputs

    def latency_s(self):
        return None if self.t_done is None else self.t_done - self.t_admit


class StreamingFuture(ServingFuture):
    """A :class:`ServingFuture` whose result accretes incrementally — the
    generative-serving request handle.

    The terminal contract is unchanged: exactly one typed terminal outcome
    per admitted request (``result()`` returns the full token list or
    raises the typed :class:`ServingError`).  On top of that the producer
    streams tokens as they are generated; consumers pick one of
    - ``on_token(token_id)`` callback, invoked from the scheduler thread
      with no locks held — keep it fast, it gates decode iterations;
    - the :meth:`tokens` iterator, yielding each token as it lands and
      finishing (or raising the terminal error) at settlement;
    - plain ``result()``, ignoring the stream entirely.
    A token emitted concurrently with a terminal race (deadline, drain)
    is dropped rather than delivered after the outcome — the stream is
    always a prefix of the settled result.
    """

    __slots__ = ("_stream", "_stream_cv", "_on_token", "t_first_token")

    def __init__(self, inputs, rows, deadline, t_admit, on_token=None,
                 clock=None):
        super().__init__(inputs, rows, deadline, t_admit, clock=clock)
        self._stream = []
        self._stream_cv = threading.Condition()
        self._on_token = on_token
        self.t_first_token = None

    def _emit(self, token):
        """Producer side: append one token (no server lock held).  Returns
        False (and drops the token) when the future is already terminal."""
        with self._stream_cv:
            if self._event.is_set():
                return False
            if self.t_first_token is None:
                self.t_first_token = self.clock.now()
            self._stream.append(token)
            self._stream_cv.notify_all()
        if self._on_token is not None:
            self._on_token(token)
        return True

    def _settle(self):
        # take the stream lock across the terminal flip so an _emit racing
        # with settlement either lands fully before it or is dropped —
        # never delivered after the typed outcome
        with self._stream_cv:
            super()._settle()
            self._stream_cv.notify_all()

    @property
    def stream_tokens(self):
        """Snapshot of the tokens streamed so far."""
        with self._stream_cv:
            return list(self._stream)

    def tokens(self, timeout=None):
        """Iterate over generated tokens as they arrive.

        Ends at a successful terminal outcome; raises the typed
        :class:`ServingError` if the request settled with one.  ``timeout``
        bounds the wait for EACH next token, not the whole stream."""
        i = 0
        while True:
            with self._stream_cv:
                while i >= len(self._stream) and not self._event.is_set():
                    if not self._stream_cv.wait(timeout):
                        raise TimeoutError(
                            "no token after %ss" % timeout)
                if i >= len(self._stream):
                    break
                tok = self._stream[i]
                i += 1
            yield tok
        if self._error is not None:
            raise self._error
