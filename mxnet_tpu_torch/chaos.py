"""Deterministic seeded fault injection: the serving half of
``mxnet_tpu/chaos.py``.

A plan is a comma list of ``fault@step`` items plus an optional seed::

    MXNET_CHAOS="seed=7,page_pressure@3"            # env-driven
    with chaos.inject("page_pressure@3", seed=7): ...  # scoped

:data:`FAULT_KINDS` is the JAX package's set, so every spec it parses
parses here.  The hooks ported so far are the ones the generation server
and loadgen read (each firing bumps the ``faults_injected`` dispatch
counter):

==============================  ==============================================
``page_pressure@N``             the generation scheduler's Nth loop turn
                                impounds most of the KV free list for a
                                bounded window: page exhaustion that must
                                preempt the lowest-priority stream, never
                                shed a higher one
``tenant_flood@N``              loadgen's Nth trace slot: that request's
                                tenant offers ``factor`` x its traffic
``request_burst@N``             the Nth load-generator wave is multiplied
``migrate_interrupt@N``         the Nth KV-migration chunk push dies
                                mid-transfer
``drain_migrate@N``             the Nth drain opportunity with a live
                                stream drains the worker
``worker_kill_mid_decode@N``    the Nth kill opportunity with a streamed
                                token kills the worker
``adapter_swap_mid_burst@N``    the Nth opportunity with a resident
                                adapter hot-swaps it mid-traffic
==============================  ==============================================

Every fault fires at most once per process; ``step`` counts are 0-based
and fault-local (the Nth opportunity of that kind).  The plan is inert —
a hook costs one attribute load — unless ``MXNET_CHAOS`` is set or
``inject()`` is active.  The training and kvstore hooks (``nan_grad``,
``bitflip_param``, ``kv_*``, ``ckpt_*``, ``loader_raise``) parse but have
no consumer in the port yet.
"""
from __future__ import annotations

import os
import threading

import numpy as np

__all__ = ["ChaosPlan", "inject", "active", "FAULT_KINDS",
           "page_pressure", "tenant_flood", "request_burst",
           "migrate_interrupt", "drain_migrate", "worker_kill_mid_decode",
           "adapter_swap_mid_burst"]

FAULT_KINDS = frozenset({
    "nan_grad", "bitflip_param", "kv_drop", "kv_delay", "kv_dup",
    "ckpt_truncate", "ckpt_bitflip", "loader_raise",
    "slow_replica", "replica_crash", "request_burst",
    "registry_stale", "replica_slow_start",
    "gateway_partition", "worker_kill",
    "worker_kill_mid_decode", "page_pressure",
    "migrate_interrupt", "drain_migrate",
    "tenant_flood", "adapter_swap_mid_burst",
})


def _count_fault():
    from . import profiler as _prof

    _prof.dispatch_count("faults_injected")


class ChaosPlan:
    """Parsed, seeded fault plan.  ``fire(kind, step)`` is True exactly
    once for each ``kind@step`` item in the spec (and then consumed), so
    injected faults stay deterministic under restarts and retries."""

    def __init__(self, spec, seed=0):
        self.spec = spec
        self.seed = int(seed)
        self._faults = {}      # (kind, step) -> not-yet-fired
        self._lock = threading.Lock()
        for item in str(spec or "").split(","):
            item = item.strip()
            if not item:
                continue
            if item.startswith("seed="):
                self.seed = int(item[len("seed="):])
                continue
            if "@" not in item:
                raise ValueError("MXNET_CHAOS item %r: expected "
                                 "'fault@step' or 'seed=N'" % item)
            kind, step = item.split("@", 1)
            kind = kind.strip()
            if kind not in FAULT_KINDS:
                raise ValueError("MXNET_CHAOS: unknown fault %r (one of "
                                 "%s)" % (kind, sorted(FAULT_KINDS)))
            self._faults[(kind, int(step))] = True
        self.kinds = frozenset(k for k, _ in self._faults)

    def rng(self, kind, step):
        """Per-fault deterministic RNG: which bit/element gets hit
        depends only on (seed, kind, step), never on call order."""
        return np.random.RandomState(
            (self.seed * 1000003 + hash((kind, step))) & 0x7FFFFFFF)

    def fire(self, kind, step):
        """True exactly once when the plan schedules ``kind`` at this
        fault-local ``step``; bumps ``faults_injected``."""
        if kind not in self.kinds:
            return False
        with self._lock:
            if not self._faults.get((kind, int(step))):
                return False
            self._faults[(kind, int(step))] = False
        _count_fault()
        return True

    def pending(self):
        """Faults not yet fired (chaos tests assert this drains empty)."""
        return sorted(k for k, live in self._faults.items() if live)


_scoped = None
_env_plan = None
_env_spec_seen = None


def active():
    """The active :class:`ChaosPlan`, or None.  A scoped ``inject()``
    shadows the ``MXNET_CHAOS`` env plan."""
    global _env_plan, _env_spec_seen
    if _scoped is not None:
        return _scoped
    spec = os.environ.get("MXNET_CHAOS", "")
    if not spec:
        return None
    if spec != _env_spec_seen:  # re-parse only when the env changes
        _env_plan = ChaosPlan(spec)
        _env_spec_seen = spec
    return _env_plan


class inject:
    """Context manager arming a scoped chaos plan::

        with chaos.inject("nan_grad@2", seed=7) as plan:
            train()
        assert plan.pending() == []
    """

    def __init__(self, spec, seed=0):
        self.plan = ChaosPlan(spec, seed=seed)

    def __enter__(self):
        global _scoped
        if _scoped is not None:
            raise RuntimeError("chaos.inject() does not nest")
        _scoped = self.plan
        return self.plan

    def __exit__(self, *exc):
        global _scoped
        _scoped = None
        return False


# ---------------------------------------------------------------------------
# serving fault hooks (the generation scheduler / load generators)
# ---------------------------------------------------------------------------
def page_pressure(n, frac=0.9):
    """``page_pressure@N``: fraction of the KV free list the generation
    scheduler should impound on its Nth opportunity (0.0 otherwise).  The
    resulting page exhaustion must be absorbed by QoS preemption — the
    lowest-priority stream is journaled and re-admitted, never a
    higher-priority one shed."""
    plan = active()
    if plan is not None and plan.fire("page_pressure", n):
        return float(frac)
    return 0.0


def tenant_flood(n, factor=8):
    """``tenant_flood@N``: multiplier for the Nth load-generator wave's
    *single noisiest tenant* (1 otherwise) — one tenant suddenly offers
    ``factor``x its traffic while everyone else stays steady.  The
    noisy-neighbor isolation contract: the flooder sheds typed
    ``QuotaExceeded`` at its token-bucket/fair-share limits and every
    other tenant's TTFT p99 stays put."""
    plan = active()
    if plan is not None and plan.fire("tenant_flood", n):
        return int(factor)
    return 1


def request_burst(n, factor=8):
    """``request_burst@N``: multiplier for the Nth load-generator wave
    (1 otherwise) — the traffic spike the bounded admission queue must
    shed, not absorb."""
    plan = active()
    if plan is not None and plan.fire("request_burst", n):
        return int(factor)
    return 1


def migrate_interrupt(n):
    """``migrate_interrupt@N``: True when the Nth KV-migration chunk
    push should die mid-transfer (the gateway raises a connection error
    between chunks).  The transfer-abort path must free the receiver's
    partial buffer/pages (leakcheck-audited) and the stream must degrade
    to the resume-from-journal path — migration is never worse than
    failover, even when the transfer itself is the casualty."""
    plan = active()
    return plan is not None and plan.fire("migrate_interrupt", n)


def drain_migrate(n, streams):
    """``drain_migrate@N``: True when the Nth opportunity should SIGTERM
    a live worker that holds ``streams >= 1`` active generation streams
    — a *planned* drain (rc-76), not a crash.  The zero-loss drain
    contract: the worker parks + exports every active stream and the
    gateway re-attaches each on a sibling, so the chaos suite asserts
    zero ``ReplicaLost`` and zero re-prefills alongside the usual
    exactly-one-typed-outcome invariant."""
    plan = active()
    if plan is None or streams < 1:
        return False
    return plan.fire("drain_migrate", n)


def worker_kill_mid_decode(n, streamed):
    """``worker_kill_mid_decode@N``: True when the Nth opportunity should
    SIGKILL a live worker AND at least one generation stream has already
    streamed a token (``streamed >= 1``).  Unlike ``worker_kill`` this
    targets the mid-decode window specifically: the gateway must resume
    the interrupted stream on a sibling from its journal so the client
    sees an exactly-once continuation, not ``ReplicaLost``."""
    plan = active()
    if plan is None or streamed < 1:
        return False
    return plan.fire("worker_kill_mid_decode", n)


def adapter_swap_mid_burst(n, adapters):
    """``adapter_swap_mid_burst@N``: True when the worker's Nth
    heartbeat should hot-swap a route's resident adapter while traffic
    is in flight — an operator rollout at the worst moment.  Gated on
    ``adapters >= 1`` resident adapters BEFORE consuming the plan item,
    so the fault waits for a swappable worker.  The atomic hot-swap
    contract absorbs it: in-flight streams keep their typed outcomes
    and the recompile counter does not move."""
    plan = active()
    if plan is None or adapters < 1:
        return False
    return plan.fire("adapter_swap_mid_burst", n)
