"""Serving: lifecycle states, typed outcomes, the brownout ladder, request
futures, and the model-serving front (:class:`ModelServer` over
``predict.Predictor`` replicas).

Counterpart of ``mxnet_tpu/serving.py``.  The outcome contract is the
same: every admitted request reaches **exactly one** typed terminal
outcome — a result, :class:`DeadlineExceeded`, :class:`Overloaded`,
:class:`QuotaExceeded`, :class:`Draining`, :class:`Unavailable` (every
replica tried failed) or, for a stream parked for live migration,
:class:`StreamMigrated` — and none hang.  Each future carries a request
trace id: an async chrome-trace span opens at admission and closes at
settlement, and the ``serving.latency_ms`` /
``serving.rejected_latency_ms`` histograms record its latency.  Live
futures sit in the leakcheck ledger until they settle.

:class:`BrownoutController` is the overload-degradation ladder every
admission gate in the process consults (:func:`brownout`).

:class:`ModelServer` is the robustness front of the JAX package, on one
device: bounded admission with load shedding, deadline-aware dynamic
batching padded to shape buckets, replica hedging, a per-replica
:class:`CircuitBreaker` with half-open health probes, the lifecycle
STARTING -> SERVING -> DEGRADED -> DRAINING -> STOPPED with the SIGTERM
drain, the atomic hot-swap ``reload``, and ``add_replica`` /
``remove_replica`` over ``Predictor.clone``.  One scheduler thread owns
every timing decision under the server's condition variable; a pool of
workers runs the model forwards outside the lock.
"""
from __future__ import annotations

import collections
import os
import queue
import random as _pyrandom
import sys
import threading
import time

import numpy as np

from . import chaos as _chaos
from . import clock as _clockmod
from . import leakcheck as _leakcheck
from . import telemetry as _telemetry

__all__ = ["ModelServer", "Replica", "CircuitBreaker", "backoff_delay",
           "ServingFuture", "StreamingFuture", "BrownoutController",
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

# env-tunable defaults of the model-serving front
_DEF_MAX_QUEUE = int(os.environ.get("MXTPU_SERVE_MAX_QUEUE", "64"))
_DEF_MAX_BATCH = int(os.environ.get("MXTPU_SERVE_MAX_BATCH", "8"))
_DEF_MAX_WAIT_MS = float(os.environ.get("MXTPU_SERVE_MAX_WAIT_MS", "5"))
_DEF_DEADLINE_MS = float(os.environ.get("MXTPU_SERVE_DEADLINE_MS", "1000"))
_DEF_HEDGE_MS = float(os.environ.get("MXTPU_SERVE_HEDGE_MS", "0"))
_DEF_BREAKER_THRESHOLD = int(os.environ.get(
    "MXTPU_SERVE_BREAKER_THRESHOLD", "3"))
_DEF_BREAKER_BACKOFF = float(os.environ.get(
    "MXTPU_SERVE_BREAKER_BACKOFF", "0.2"))
_DEF_BREAKER_BACKOFF_CAP = float(os.environ.get(
    "MXTPU_SERVE_BREAKER_BACKOFF_CAP", "30"))
# brownout ladder: consecutive breach /
# clear ticks to step one level up / down, the max_new_tokens cap applied
# at level >= 1, and the minimum priority rank admitted at level 3
_DEF_BROWNOUT_ENGAGE = int(os.environ.get("MXTPU_BROWNOUT_ENGAGE_TICKS",
                                          "3"))
_DEF_BROWNOUT_RECOVER = int(os.environ.get("MXTPU_BROWNOUT_RECOVER_TICKS",
                                           "5"))
_DEF_BROWNOUT_CAP = int(os.environ.get("MXTPU_BROWNOUT_CAP_TOKENS", "32"))
_DEF_BROWNOUT_MIN_RANK = int(os.environ.get("MXTPU_BROWNOUT_MIN_RANK", "1"))

# close a batch this many seconds before the oldest deadline would be
# missed, on top of the EWMA latency estimate (slack safety margin)
_CLOSE_MARGIN_S = 0.02
_EWMA_ALPHA = 0.3
# scheduler idle poll: bounds how late a signal-set drain flag is noticed
_IDLE_POLL_S = 0.1


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

    __slots__ = ("inputs", "rows", "deadline", "t_admit", "job",
                 "_outputs", "_error", "_event", "t_done", "trace_id",
                 "clock")

    def __init__(self, inputs, rows, deadline, t_admit, clock=None):
        self.inputs = inputs          # {name: np.ndarray}, leading dim=rows
        self.rows = rows
        self.deadline = deadline      # absolute clock.now() time
        self.t_admit = t_admit
        self.clock = _clockmod.resolve(clock)
        self.job = None               # set when batched (ModelServer)
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
        if self.job is not None:
            self.job.unresolved -= 1
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


# ---------------------------------------------------------------------------
# the model-serving front: batch jobs, circuit breaker, replicas, server
# ---------------------------------------------------------------------------
def backoff_delay(attempt, base, cap, jitter=True):
    """Bounded exponential backoff for retry ``attempt`` (0-based):
    ``min(cap, base * 2**attempt)``, scaled by uniform [0.5, 1.0) jitter
    (the JAX package's ``async_kv.backoff_delay``; the circuit breaker's
    reopen delay)."""
    d = min(float(cap), float(base) * (2.0 ** attempt))
    if jitter:
        d *= 0.5 + 0.5 * _pyrandom.random()
    return d


class _BatchJob:
    """One closed batch: the padded feed plus per-request row offsets."""

    __slots__ = ("requests", "offsets", "feed", "rows", "padded_rows",
                 "close_reason", "tried", "inflight_execs", "hedged",
                 "hedge_at", "failures", "unresolved", "dispatched")

    def __init__(self, requests, offsets, feed, rows, padded_rows, reason):
        self.requests = requests
        self.offsets = offsets
        self.feed = feed
        self.rows = rows
        self.padded_rows = padded_rows
        self.close_reason = reason
        self.tried = set()            # replica ids this job ran (or runs) on
        self.inflight_execs = 0
        self.hedged = False
        self.hedge_at = None
        self.failures = 0
        self.unresolved = len(requests)
        self.dispatched = False


class CircuitBreaker:
    """Consecutive-failure circuit breaker with half-open probing.

    CLOSED --(threshold consecutive failures)--> OPEN
    OPEN   --(backoff elapsed)--> HALF_OPEN (admits ONE probe)
    HALF_OPEN --probe ok--> CLOSED;  --probe fails--> OPEN (backoff doubles)

    The server runs the probe as a zeros health check (``Replica.probe``
    -> ``Predictor.health_check``) before the replica sees live traffic
    again.  A probe dispatch cancelled before it ran must call
    :meth:`release_probe`.  The reopen delay is :func:`backoff_delay`.
    Every method runs under the owning server's lock.
    """

    CLOSED, OPEN, HALF_OPEN = "CLOSED", "OPEN", "HALF_OPEN"

    def __init__(self, threshold=_DEF_BREAKER_THRESHOLD,
                 backoff=_DEF_BREAKER_BACKOFF,
                 backoff_cap=_DEF_BREAKER_BACKOFF_CAP):
        self.threshold = max(1, int(threshold))
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self.state = self.CLOSED
        self.failures = 0         # consecutive
        self.trips = 0
        self.reopen_at = None
        self.probe_inflight = False

    def would_allow(self, now):
        """Non-mutating availability check (scheduler peek)."""
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN:
            return now >= self.reopen_at
        return not self.probe_inflight

    def allow(self, now):
        """Mutating admission check: an OPEN breaker whose backoff has
        elapsed goes HALF_OPEN and reserves the probe slot."""
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN:
            if now < self.reopen_at:
                return False
            self.state = self.HALF_OPEN
            self.acquire_probe()
            return True
        if self.probe_inflight:
            return False
        self.acquire_probe()
        return True

    def acquire_probe(self):
        """Reserve the single half-open probe slot; exactly one of
        :meth:`record_success` / :meth:`record_failure` /
        :meth:`release_probe` follows on every path (the leakcheck ledger's
        ``probe_slots``)."""
        self.probe_inflight = True
        _leakcheck.track("probe_slots", id(self))

    def record_success(self):
        if self.state != self.CLOSED:
            _log("breaker: probe succeeded, closing (after %d trip%s)"
                 % (self.trips, "" if self.trips == 1 else "s"))
        self.state = self.CLOSED
        self.failures = 0
        self.trips = 0
        self.reopen_at = None
        if self.probe_inflight:
            _leakcheck.untrack("probe_slots", id(self))
        self.probe_inflight = False

    def release_probe(self):
        """Release a reserved half-open probe slot WITHOUT recording an
        outcome (the probe execution was cancelled before it ran)."""
        if self.probe_inflight:
            _leakcheck.untrack("probe_slots", id(self))
        self.probe_inflight = False

    def record_failure(self, now):
        """Returns True when this failure tripped (or re-tripped) the
        breaker."""
        if self.probe_inflight:
            _leakcheck.untrack("probe_slots", id(self))
        self.probe_inflight = False
        self.failures += 1
        if self.state == self.HALF_OPEN:
            return self._trip(now)        # failed probe: straight back OPEN
        if self.state == self.CLOSED and self.failures >= self.threshold:
            return self._trip(now)
        return False

    def _trip(self, now):
        self.trips += 1
        self.state = self.OPEN
        delay = backoff_delay(self.trips - 1, self.backoff, self.backoff_cap)
        self.reopen_at = now + delay
        _count("breaker_trips")
        _log("breaker tripped (trip %d, %d consecutive failures): "
             "half-open probe in %.3fs" % (self.trips, self.failures, delay))
        return True


_BREAKER_STORM = None


def _note_breaker_trip(replica_id):
    """Breaker-trip storm detector feeding the debug bundles; called after
    the server lock is released (bundle writing is file I/O)."""
    global _BREAKER_STORM
    from . import debug as _debug

    if _BREAKER_STORM is None:
        _BREAKER_STORM = _debug.StormDetector(3, window_s=30.0)
    if _BREAKER_STORM.hit():
        _debug.write_bundle(
            "breaker_trip_storm",
            extra={"replica": replica_id,
                   "trips_threshold": _BREAKER_STORM.threshold,
                   "window_s": _BREAKER_STORM.window_s})


class Replica:
    """One Predictor behind its own serialization lock and breaker.  The
    Predictor's executor stages inputs statefully, so executions on one
    replica serialize; concurrency comes from several replicas."""

    def __init__(self, rid, predictor,
                 breaker_threshold=_DEF_BREAKER_THRESHOLD,
                 breaker_backoff=_DEF_BREAKER_BACKOFF,
                 breaker_backoff_cap=_DEF_BREAKER_BACKOFF_CAP):
        self.id = rid
        self.predictor = predictor
        self.breaker = CircuitBreaker(breaker_threshold, breaker_backoff,
                                      breaker_backoff_cap)
        self.inflight = 0             # guarded by the server lock
        self.retired = False
        self._lock = threading.Lock()

    def execute(self, feed):
        """Run one padded batch on the predictor's device; numpy in, list
        of numpy outputs out."""
        from . import ndarray as nd

        with self._lock:
            ctx = self.predictor._ctx
            outs = self.predictor.forward(
                **{k: nd.array(v, ctx=ctx) for k, v in feed.items()})
            return [o.asnumpy() for o in outs]

    def probe(self):
        """Half-open health probe (``Predictor.health_check``) under the
        same serialization lock as live executions."""
        with self._lock:
            return self.predictor.health_check()


class ModelServer:
    """Robustness front over one or more ``Predictor`` replicas on one
    device (counterpart of ``mxnet_tpu.serving.ModelServer``).

    Build it from an exported model (``symbol`` + ``params`` +
    ``input_shapes`` on ``ctx``, replicated ``num_replicas`` times through
    ``Predictor.clone()``, which shares the parameter arrays) or hand it
    ``predictors=[...]``.  ``submit()`` / ``submit_async()`` take
    ``{input_name: np.ndarray}`` with a leading batch dim and return the
    model's output list (the request's rows) or raise a typed
    :class:`ServingError`: bounded admission (:class:`Overloaded`),
    deadline-aware bucketed batching, hedging, failover, per-replica
    circuit breakers with half-open health probes, ``drain`` /
    ``install_preemption_drain``, the atomic ``reload`` and
    ``add_replica`` / ``remove_replica``.  Every timer reads ``clock``
    (default the monotonic clock); the chaos stall of ``slow_replica`` and
    the execute-time EWMA are real time, as in the JAX package.  Sharded
    replicas (``mesh_axes=``, ``rules=``, ``devices=``) are not ported and
    raise.
    """

    def __init__(self, symbol=None, params=None, input_shapes=None,
                 ctx=None, predictors=None, num_replicas=1,
                 max_queue=None, max_batch=None, max_wait_ms=None,
                 deadline_ms=None, hedge_ms=None, buckets=None,
                 breaker_threshold=None, breaker_backoff=None,
                 breaker_backoff_cap=None, warm=True,
                 mesh_axes=None, rules=None, devices=None, clock=None):
        if mesh_axes or rules is not None or devices is not None:
            raise NotImplementedError(
                "mxnet_tpu_torch: sharded serving replicas (mesh_axes= / "
                "rules= / devices=) are not ported (ROADMAP Queue 1 item 9)")
        self.clock = _clockmod.resolve(clock)
        self.max_queue = _DEF_MAX_QUEUE if max_queue is None \
            else int(max_queue)
        self.max_batch = _DEF_MAX_BATCH if max_batch is None \
            else int(max_batch)
        self.max_wait = (_DEF_MAX_WAIT_MS if max_wait_ms is None
                         else float(max_wait_ms)) / 1e3
        self.default_deadline = (_DEF_DEADLINE_MS if deadline_ms is None
                                 else float(deadline_ms)) / 1e3
        self.hedge_ms = _DEF_HEDGE_MS if hedge_ms is None \
            else float(hedge_ms)
        self._breaker_cfg = (
            _DEF_BREAKER_THRESHOLD if breaker_threshold is None
            else int(breaker_threshold),
            _DEF_BREAKER_BACKOFF if breaker_backoff is None
            else float(breaker_backoff),
            _DEF_BREAKER_BACKOFF_CAP if breaker_backoff_cap is None
            else float(breaker_backoff_cap))
        self._buckets = self._resolve_buckets(buckets)

        self._state = STARTING
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending = collections.deque()   # admitted, not yet batched
        self._jobs = []                       # closed batches, not finished
        self._dispatch_q = queue.Queue()      # (job, replica, exec_idx)
        self._drain_flag = threading.Event()
        self._stop = False
        self._exec_seq = 0
        self._rr = 0
        self._retired = []
        self._replica_seq = 0
        self._scaleup_seq = 0
        self._ewma_latency = 0.01
        self._preemption = None
        self.stats = {
            "queue_depth_peak": 0, "admitted": 0, "shed": 0,
            "shed_brownout": 0, "shed_quota": 0,
            "rejected_draining": 0, "ok": 0, "deadline_exceeded": 0,
            "unavailable": 0, "batches_full": 0, "batches_timer": 0,
            "batches_deadline": 0, "hedges_fired": 0, "hedge_wins": 0,
            "wasted_executions": 0, "failovers": 0, "reloads": 0,
            "replicas_added": 0, "replicas_removed": 0,
        }
        # build + warm the replicas (still STARTING: nothing admitted)
        self._model_spec = (symbol, params, dict(input_shapes or {}), ctx)
        self._replicas = self._build_replicas(predictors, symbol, params,
                                              input_shapes, ctx,
                                              num_replicas, warm)
        if not self._replicas:
            raise ValueError("ModelServer needs at least one replica")
        self._input_names = list(
            self._replicas[0].predictor._input_names)

        n_workers = max(2, 2 * len(self._replicas))
        self._threads = [threading.Thread(target=self._scheduler_loop,
                                          name="serve-sched", daemon=True)]
        self._threads += [
            threading.Thread(target=self._worker_loop,
                             name="serve-exec-%d" % i, daemon=True)
            for i in range(n_workers)]
        for t in self._threads:
            t.start()
        with self._cv:
            self._state = SERVING
        from . import memory as _memory

        self._mem_handle = _memory.register("replica_slices",
                                            self._mem_replica_bytes)
        _log("serving: %d replica(s), max_queue=%d max_batch=%d "
             "buckets=%s hedge_ms=%g"
             % (len(self._replicas), self.max_queue, self.max_batch,
                list(self._buckets), self.hedge_ms))

    def _mem_replica_bytes(self):
        """The distinct parameter tensors' bytes over every replica (clones
        share theirs)."""
        seen, total = set(), 0
        for repl in tuple(self._replicas):
            ex = repl.predictor._executor
            for d in (ex.arg_dict, ex.aux_dict):
                for arr in d.values():
                    t = arr.data
                    if id(t) not in seen:
                        seen.add(id(t))
                        total += t.numel() * t.element_size()
        return total

    # -- construction helpers ----------------------------------------------
    def _resolve_buckets(self, buckets):
        from . import dispatch as _dispatch

        if buckets is None:
            spec = _dispatch.bucket_spec()
            if isinstance(spec, tuple):
                buckets = [b for b in spec if b <= self.max_batch]
            else:                      # None or 'pow2': pow2 chain
                buckets = list(_dispatch.pow2_chain(self.max_batch))
        buckets = sorted(set(int(b) for b in buckets) | {self.max_batch})
        return tuple(b for b in buckets if b <= self.max_batch)

    def _build_replicas(self, predictors, symbol, params, input_shapes,
                        ctx, num_replicas, warm):
        from .predict import Predictor

        preds = list(predictors or [])
        if not preds:
            if symbol is None or params is None:
                raise ValueError("pass symbol+params (+input_shapes) or "
                                 "predictors=[...]")
            first = Predictor(symbol, params, ctx=ctx,
                              input_shapes=input_shapes)
            preds = [first] + [first.clone()
                               for _ in range(int(num_replicas) - 1)]
        out = []
        for p in preds:
            if warm:
                p.warm(self._buckets)     # every bucket shape runs once
            rid = self._replica_seq
            self._replica_seq += 1
            out.append(Replica(rid, p, *self._breaker_cfg))
        return out

    # -- public surface ----------------------------------------------------
    @property
    def state(self):
        with self._cv:
            return self._state

    def queue_depth(self):
        with self._cv:
            return self._queue_depth_locked()

    def submit_async(self, inputs, deadline_ms=None, priority=None,
                     tenant=None):
        """Admit one request; returns a :class:`ServingFuture`.  Raises
        :class:`Overloaded` / :class:`Draining` / :class:`QuotaExceeded`
        at admission.  ``priority`` is a QoS rank (an int or the
        ``"name=rank"`` wire form) for the brownout gate; ``tenant`` spends
        one token of that tenant's bucket."""
        feed = {}
        rows = None
        for name, arr in dict(inputs).items():
            a = np.asarray(arr)
            if a.ndim == 0:
                raise ValueError("input %r must have a leading batch dim"
                                 % name)
            if rows is None:
                rows = a.shape[0]
            elif a.shape[0] != rows:
                raise ValueError(
                    "ragged request: input %r has %d rows, expected %d"
                    % (name, a.shape[0], rows))
            feed[name] = a
        if not feed:
            raise ValueError("empty request")
        unknown = set(feed) - set(self._input_names)
        if unknown:
            raise ValueError("unknown input(s) %s (model inputs: %s)"
                             % (sorted(unknown), self._input_names))
        missing = set(self._input_names) - set(feed)
        if missing:
            raise ValueError("missing input(s) %s" % sorted(missing))
        if rows > self.max_batch:
            raise ValueError("request rows %d > max_batch %d"
                             % (rows, self.max_batch))
        rank = 0
        if priority is not None:
            tail = str(priority).partition("=")[2] or str(priority)
            try:
                rank = int(tail.strip())
            except ValueError:
                rank = 0
        from . import tenancy as _tenancy

        tenant = _tenancy.parse_tenant(tenant)
        gov = _tenancy.governor()
        exempt = gov.exempt(tenant)
        bo = brownout()
        now = self.clock.now()
        deadline = now + (self.default_deadline if deadline_ms is None
                          else float(deadline_ms) / 1e3)
        with self._cv:
            if self._drain_flag.is_set() or self._state in (DRAINING,
                                                            STOPPED):
                self.stats["rejected_draining"] += 1
                raise Draining("server is %s: not admitting requests"
                               % (DRAINING if self._state != STOPPED
                                  else STOPPED))
            try:
                gov.check(tenant, now)
            except QuotaExceeded:
                self.stats["shed_quota"] += 1
                _count("requests_shed_quota")
                _count("requests_shed_by_tenant.%s" % tenant)
                raise
            if not exempt and not bo.admits(rank):
                # metered apart from "shed": deliberate degradation must
                # not feed the shed-rate breach bit
                self.stats["shed_brownout"] += 1
                _count("requests_shed_brownout")
                raise Overloaded(
                    "brownout level %d (%s) admits only priority rank >= "
                    "%d" % (bo.level, bo.mode, bo.min_rank))
            depth = self._queue_depth_locked()
            if depth >= self.max_queue:
                self.stats["shed"] += 1
                _count("requests_shed")
                raise Overloaded(
                    "admission queue at capacity (%d/%d): request shed"
                    % (depth, self.max_queue))
            req = ServingFuture(feed, rows, deadline, now,
                                clock=self.clock)
            self._pending.append(req)
            self.stats["admitted"] += 1
            _count("requests_admitted")
            if tenant != "anon":
                _count("requests_admitted_by_tenant.%s" % tenant)
            _telemetry.trace_begin("request", req.trace_id,
                                   args={"rows": rows,
                                         "deadline_ms": round(
                                             (deadline - now) * 1e3, 1)})
            self.stats["queue_depth_peak"] = max(
                self.stats["queue_depth_peak"],
                self._queue_depth_locked())
            self._cv.notify_all()
        return req

    def submit(self, inputs, deadline_ms=None, timeout=None,
               priority=None, tenant=None):
        """Synchronous :meth:`submit_async`: the output list, or the
        typed :class:`ServingError` raised."""
        fut = self.submit_async(inputs, deadline_ms=deadline_ms,
                                priority=priority, tenant=tenant)
        if timeout is None:
            timeout = (fut.deadline - self.clock.now()) + 30.0
        return fut.result(timeout=timeout)

    def install_preemption_drain(self, handler=None):
        """Wire graceful drain into SIGTERM/SIGINT
        (:func:`~mxnet_tpu_torch.elastic.install_preemption_drain`): the
        first signal stops admission at once; the caller then finishes
        with :meth:`drain`.  Returns the handler."""
        from .elastic import install_preemption_drain

        handler = install_preemption_drain(self._drain_flag.set,
                                           handler=handler)
        self._preemption = handler
        return handler

    def drain(self, timeout=None):
        """Graceful drain: stop admitting (typed :class:`Draining`), let
        every admitted request reach its terminal outcome, then stop the
        threads.  True when everything in flight completed (False on
        timeout, with the survivors rejected as :class:`Draining`)."""
        self._drain_flag.set()
        deadline = None if timeout is None else self.clock.now() + timeout
        with self._cv:
            if self._state == STOPPED:
                return True
            if self._state != DRAINING:
                self._state = DRAINING
                _log("state -> DRAINING (%d queued, %d batches in flight)"
                     % (len(self._pending), len(self._jobs)))
            self._cv.notify_all()
            while self._pending or self._jobs:
                if deadline is not None and self.clock.now() >= deadline:
                    break
                self._cv.wait(0.05)
            drained = not self._pending and not self._jobs
            if not drained:
                # the outcome contract survives the timeout: once the
                # scheduler stops, nothing else would settle these
                aborted = 0
                while self._pending:
                    req = self._pending.popleft()
                    self._reject_locked(req, Draining(
                        "drain timed out after %.1fs with the request "
                        "still queued" % timeout))
                    aborted += 1
                for job in self._jobs:
                    for req in job.requests:
                        if not req.done:
                            self._reject_locked(req, Draining(
                                "drain timed out after %.1fs with the "
                                "request still in flight" % timeout))
                            aborted += 1
                self._prune_jobs_locked()
                _log("drain timeout: aborted %d unresolved request(s) "
                     "with typed Draining" % aborted)
            self._stop = True
            self._cv.notify_all()
        for _ in self._threads:
            self._dispatch_q.put(None)     # one sentinel per worker
        for t in self._threads:
            t.join(timeout=5.0)
        with self._cv:
            self._state = STOPPED
        _log("state -> STOPPED (drained=%s)" % drained)
        return drained

    close = drain

    def reload(self, symbol=None, params=None, predictors=None,
               num_replicas=None, warm=True):
        """Atomic hot-swap reload: build and warm the new replicas FIRST,
        then flip the replica list under the lock.  In-flight batches
        finish on the old replicas, retired once idle.  Admission never
        pauses."""
        old_symbol, old_params, shapes, ctx = self._model_spec
        symbol = old_symbol if symbol is None else symbol
        if params is None and predictors is None:
            raise ValueError("reload needs params or predictors")
        n = num_replicas if num_replicas is not None \
            else len(self._replicas)
        new = self._build_replicas(predictors, symbol, params, shapes,
                                   ctx, n, warm)
        with self._cv:
            old = self._replicas
            for r in old:
                r.retired = True
            self._replicas = new
            self._retired.extend(old)
            # admission validates against the NEW model's input names
            self._input_names = list(new[0].predictor._input_names)
            self._model_spec = (symbol,
                                params if params is not None
                                else old_params, shapes, ctx)
            self.stats["reloads"] += 1
            self._prune_retired_locked()
            self._cv.notify_all()
        _log("reload: swapped in %d replica(s); %d old retiring"
             % (len(new), len(old)))

    def num_active_replicas(self):
        with self._cv:
            return len(self._active_replicas())

    def add_replica(self, predictor=None, warm=True):
        """Scale up by one replica (a clone of the newest active one, which
        shares its parameters, unless ``predictor`` is given); the build
        and warm-up run outside the lock.  Returns the new replica id."""
        t0 = self.clock.now()
        with self._cv:
            if self._drain_flag.is_set() or self._state in (DRAINING,
                                                            STOPPED):
                raise Draining("server is draining: not adding replicas")
            seq = self._scaleup_seq
            self._scaleup_seq += 1
            template = None
            if predictor is None:
                act = self._active_replicas()
                if not act:
                    raise RuntimeError("no active replica to clone")
                template = act[-1].predictor
        # chaos replica_slow_start: a cold replica whose build stalls
        # (the sleep is outside every lock)
        delay = _chaos.replica_slow_start(seq)
        if delay:
            time.sleep(delay)
        if predictor is None:
            predictor = template.clone()
        if warm:
            predictor.warm(self._buckets)
        with self._cv:
            if self._drain_flag.is_set() or self._state in (DRAINING,
                                                            STOPPED):
                raise Draining("server drained while the replica built")
            rid = self._replica_seq
            self._replica_seq += 1
            self._replicas.append(Replica(rid, predictor,
                                          *self._breaker_cfg))
            self.stats["replicas_added"] += 1
            self._cv.notify_all()
        _count("fleet_replicas_added")
        _log("replica %d added in %.0fms"
             % (rid, (self.clock.now() - t0) * 1e3))
        return rid

    def remove_replica(self, rid=None):
        """Scale down: retire one replica (the newest, or ``rid``); its
        in-flight executions finish under the reload's retirement.
        Refuses to drop the last active replica.  Returns its id."""
        with self._cv:
            act = self._active_replicas()
            if len(act) <= 1:
                raise ValueError("cannot remove the last active replica")
            if rid is None:
                r = act[-1]
            else:
                r = next((x for x in act if x.id == rid), None)
                if r is None:
                    raise KeyError("no active replica %r" % (rid,))
            r.retired = True
            self._replicas.remove(r)
            self._retired.append(r)
            self.stats["replicas_removed"] += 1
            self._prune_retired_locked()
            self._cv.notify_all()
        _count("fleet_replicas_removed")
        _log("replica %d retired (scale-down)" % r.id)
        return r.id

    def snapshot(self):
        """Point-in-time stats + lifecycle view (for tests/metrics)."""
        with self._cv:
            return {
                "state": self._state,
                "queue_depth": self._queue_depth_locked(),
                "replicas": [
                    {"id": r.id, "breaker": r.breaker.state,
                     "inflight": r.inflight, "trips": r.breaker.trips,
                     "devices": 1}
                    for r in self._replicas],
                "retired_pending": len(self._retired),
                "mesh_slices": 0,
                "free_slices": 0,
                "ewma_latency_s": self._ewma_latency,
                **dict(self.stats),
            }

    # -- internals (all *_locked helpers run under self._cv) ---------------
    def _queue_depth_locked(self):
        depth = len(self._pending)
        for j in self._jobs:
            if not j.dispatched:
                depth += len(j.requests)
        return depth

    def _est_latency(self):
        return self._ewma_latency

    def _bucket_for(self, rows):
        for b in self._buckets:
            if b >= rows:
                return b
        return rows

    def _active_replicas(self):
        return [r for r in self._replicas if not r.retired]

    def _pick_locked(self, tried, now, peek=False):
        """Least-loaded active replica that the breaker admits, has a free
        execution slot and is not in ``tried``; None if none is free."""
        best = None
        cands = self._active_replicas()
        n = len(cands)
        for i in range(n):
            r = cands[(self._rr + i) % n]
            if r.id in tried or r.inflight >= 1:
                continue
            if not r.breaker.would_allow(now):
                continue
            if best is None or r.inflight < best.inflight:
                best = r
        if best is not None and not peek:
            if not best.breaker.allow(now):     # reserves half-open probe
                return None
            self._rr += 1
        return best

    def _expire_locked(self, now):
        """Every admitted request past its deadline gets its typed outcome
        HERE (queued, batched or in flight), so none hangs on a wedged
        replica."""
        for req in [r for r in self._pending if r.deadline <= now]:
            self._pending.remove(req)
            self._reject_locked(req, DeadlineExceeded(
                "deadline expired after %.0fms in queue"
                % ((now - req.t_admit) * 1e3)))
        for job in self._jobs:
            for req in job.requests:
                if not req.done and req.deadline <= now:
                    self._reject_locked(req, DeadlineExceeded(
                        "deadline expired after %.0fms (batch %s)"
                        % ((now - req.t_admit) * 1e3,
                           "in flight" if job.inflight_execs else "queued")))

    def _reject_locked(self, req, err):
        if req._reject(err):
            key = ("deadline_exceeded" if isinstance(err, DeadlineExceeded)
                   else "unavailable" if isinstance(err, Unavailable)
                   else "rejected_other")
            self.stats[key] = self.stats.get(key, 0) + 1
            if isinstance(err, DeadlineExceeded):
                _count("requests_deadline_exceeded")

    def _form_batches_locked(self, now):
        while self._pending:
            if self._pick_locked(frozenset(), now, peek=True) is None:
                return            # nobody can run it: leave queued (bounded)
            oldest = self._pending[0]
            rows_avail = sum(r.rows for r in self._pending)
            full = rows_avail >= self.max_batch
            timer = (now - oldest.t_admit) >= self.max_wait
            dl = (oldest.deadline - now) <= (self._est_latency()
                                             + _CLOSE_MARGIN_S)
            if not (full or timer or dl):
                return
            reason = "full" if full else ("deadline" if dl else "timer")
            take, offsets, rows = [], [], 0
            while self._pending and \
                    rows + self._pending[0].rows <= self.max_batch:
                r = self._pending.popleft()
                take.append(r)
                offsets.append(rows)
                rows += r.rows
            padded = self._bucket_for(rows)
            feed = {}
            for name in self._input_names:
                cat = np.concatenate([r.inputs[name] for r in take], axis=0)
                if padded != rows:
                    # wrap-around padding (NDArrayIter 'pad' semantics)
                    cat = cat[np.arange(padded) % rows]
                feed[name] = cat
            job = _BatchJob(take, offsets, feed, rows, padded, reason)
            for r in take:
                r.job = job
            self._jobs.append(job)
            self.stats["batches_%s" % reason] += 1
            if reason == "deadline":
                _count("batches_closed_by_deadline")
            if padded != rows:
                _count("bucket_padded_batches")
            _telemetry.trace_instant(
                "batch_close",
                args={"reason": reason, "rows": rows, "padded": padded,
                      "trace_ids": [r.trace_id for r in take]})

    def _dispatch_locked(self, job, repl, now, hedge=False):
        # probe_inflight is True here iff THIS dispatch's allow() just
        # reserved the half-open slot
        probe = repl.breaker.probe_inflight
        repl.inflight += 1
        job.inflight_execs += 1
        job.tried.add(repl.id)
        job.dispatched = True
        if not hedge and self.hedge_ms > 0:
            job.hedge_at = now + self.hedge_ms / 1e3
        idx = self._exec_seq
        self._exec_seq += 1
        _telemetry.trace_instant(
            "hedge_dispatch" if hedge else "dispatch",
            args={"replica": repl.id, "exec": idx, "probe": probe,
                  "trace_ids": [r.trace_id for r in job.requests]})
        self._dispatch_q.put((job, repl, idx, hedge, probe))

    def _assign_locked(self, now):
        for job in self._jobs:
            if job.unresolved == 0 or job.inflight_execs > 0:
                continue
            active_ids = {r.id for r in self._active_replicas()}
            if job.failures > 0 and active_ids and \
                    active_ids <= job.tried:
                for req in job.requests:
                    self._reject_locked(req, Unavailable(
                        "all %d replica(s) failed this batch"
                        % len(job.tried)))
                continue
            repl = self._pick_locked(job.tried, now)
            if repl is None:
                continue              # parked until a breaker reopens
            if job.failures > 0:
                self.stats["failovers"] += 1
            self._dispatch_locked(job, repl, now)

    def _hedge_locked(self, now):
        if self.hedge_ms <= 0 or brownout().hedging_disabled():
            return
        for job in self._jobs:
            if (job.unresolved and job.inflight_execs >= 1
                    and not job.hedged and job.hedge_at is not None
                    and now >= job.hedge_at):
                repl = self._pick_locked(job.tried, now)
                if repl is None:
                    continue
                job.hedged = True
                self.stats["hedges_fired"] += 1
                _count("hedges_fired")
                self._dispatch_locked(job, repl, now, hedge=True)

    def _prune_jobs_locked(self):
        self._jobs = [j for j in self._jobs
                      if j.unresolved > 0 or j.inflight_execs > 0]

    def _prune_retired_locked(self):
        self._retired = [r for r in self._retired if r.inflight > 0]

    def _recompute_state_locked(self):
        if self._state not in (SERVING, DEGRADED):
            return
        degraded = any(r.breaker.state != CircuitBreaker.CLOSED
                       for r in self._active_replicas())
        want = DEGRADED if degraded else SERVING
        if want != self._state:
            _log("state %s -> %s" % (self._state, want))
            self._state = want

    def _next_wake_locked(self, now):
        cand = [now + _IDLE_POLL_S]
        if self._pending:
            oldest = self._pending[0]
            cand.append(oldest.t_admit + self.max_wait)
            cand.append(oldest.deadline - self._est_latency()
                        - _CLOSE_MARGIN_S)
            cand.append(min(r.deadline for r in self._pending))
        for job in self._jobs:
            if job.unresolved:
                cand.append(min(r.deadline for r in job.requests
                                if not r.done))
                if (job.hedge_at is not None and not job.hedged
                        and job.inflight_execs >= 1):
                    cand.append(job.hedge_at)
        if self._pending or any(j.unresolved and j.inflight_execs == 0
                                for j in self._jobs):
            for r in self._active_replicas():
                if r.breaker.state == CircuitBreaker.OPEN:
                    cand.append(r.breaker.reopen_at)
        return max(5e-4, min(cand) - now)

    # -- threads -----------------------------------------------------------
    def _scheduler_loop(self):
        with self._cv:
            while not self._stop:
                now = self.clock.now()
                if self._drain_flag.is_set() and \
                        self._state in (SERVING, DEGRADED):
                    self._state = DRAINING
                    _log("state -> DRAINING (signal)")
                self._expire_locked(now)
                self._prune_jobs_locked()
                self._form_batches_locked(now)
                self._assign_locked(now)
                self._hedge_locked(now)
                self._prune_retired_locked()
                self._recompute_state_locked()
                self._cv.wait(self._next_wake_locked(now))

    def _worker_loop(self):
        while True:
            item = self._dispatch_q.get()
            if item is None:
                return
            job, repl, idx, is_hedge, is_probe = item
            with self._cv:
                if job.unresolved == 0:
                    # first-wins cancellation: the batch settled (hedge
                    # winner or deadline) before this execution started
                    repl.inflight -= 1
                    job.inflight_execs -= 1
                    if is_probe:
                        repl.breaker.release_probe()
                    self.stats["wasted_executions"] += 1
                    self._cv.notify_all()
                    continue
            if is_probe:
                # half-open readmission: the replica proves itself on a
                # zeros health check BEFORE live traffic (outside the lock)
                healthy = repl.probe()
                tripped = False
                with self._cv:
                    if healthy:
                        repl.breaker.record_success()
                    else:
                        repl.inflight -= 1
                        job.inflight_execs -= 1
                        tripped = repl.breaker.record_failure(
                            self.clock.now())
                        # the batch never ran here: it may retry this
                        # replica after the next backoff
                        job.tried.discard(repl.id)
                        _log("replica %d failed half-open health probe"
                             % repl.id)
                        self._recompute_state_locked()
                        self._cv.notify_all()
                if not healthy:
                    if tripped:
                        _note_breaker_trip(repl.id)
                    continue
            # chaos + compute happen OUTSIDE every lock
            delay = _chaos.slow_replica(idx)
            if delay:
                time.sleep(delay)
            t0 = time.perf_counter()
            outs, err = None, None
            try:
                _chaos.replica_crash(idx)
                outs = repl.execute(job.feed)
            except Exception as e:   # noqa: BLE001 — typed outcome below
                err = e
            dt = time.perf_counter() - t0
            from . import profiler as _prof

            _prof.record_span(
                "serving::execute", "serving",
                _prof.now_us() - dt * 1e6, dt * 1e6,
                args={"replica": repl.id, "hedge": is_hedge,
                      "error": type(err).__name__ if err else None,
                      "trace_ids": [r.trace_id for r in job.requests]})
            _telemetry.registry().histogram(
                "serving.execute_ms").observe(dt * 1e3)
            tripped = False
            with self._cv:
                repl.inflight -= 1
                job.inflight_execs -= 1
                now = self.clock.now()
                if err is None:
                    repl.breaker.record_success()
                    self._ewma_latency = (
                        (1 - _EWMA_ALPHA) * self._ewma_latency
                        + _EWMA_ALPHA * dt)
                    self._settle_job_locked(job, outs, is_hedge)
                else:
                    job.failures += 1
                    tripped = repl.breaker.record_failure(now)
                    _log("replica %d failed batch (%s: %s)"
                         % (repl.id, type(err).__name__, err))
                self._recompute_state_locked()
                self._cv.notify_all()
            if tripped:
                _note_breaker_trip(repl.id)

    def _settle_job_locked(self, job, outs, from_hedge=False):
        resolved = 0
        for req, off in zip(job.requests, job.offsets):
            if req.done:
                continue
            if req._resolve([o[off:off + req.rows] for o in outs]):
                resolved += 1
        if resolved:
            self.stats["ok"] += resolved
            # a hedge "win" is only when the HEDGE execution settled it
            if from_hedge:
                self.stats["hedge_wins"] += 1
        else:
            self.stats["wasted_executions"] += 1
