"""Deterministic seeded fault injection: the serving and training hooks of
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
``registry_stale@N``            fleet: the Nth heartbeat publish is dropped,
                                so the registry entry's TTL lapses and the
                                reaper fires
``gateway_partition@N``         gateway: the Nth registry refresh fails as
                                if the registry were unreachable (the
                                last-known-good view keeps routing)
``worker_kill@N``               fleet: the Nth worker-kill opportunity
                                SIGKILLs a live worker process
``kv_drop@N`` / ``kv_delay@N``  the async-KV client's Nth call loses its
/ ``kv_dup@N``                  reply after send / is delayed before send /
                                is sent twice (:func:`arm_kv_client`)
``slow_replica@N``              ModelServer: the Nth model execution stalls
                                0.25 s (outside every lock)
``replica_crash@N``             ModelServer: the Nth model execution raises
                                :class:`InjectedReplicaCrash`
``replica_slow_start@N``        ModelServer: the Nth ``add_replica`` build
                                stalls 0.3 s
``nan_grad@N``                  training step N: the loss scale is NaN
                                (FusedTrainStep), or one seeded gradient
                                element is NaN (the eager Trainer)
``bitflip_param@N``             training step N: one seeded bit of one
                                parameter element flips
==============================  ==============================================

Every fault fires at most once per process; ``step`` counts are 0-based
and fault-local (the Nth opportunity of that kind).  The plan is inert —
a hook costs one attribute load — unless ``MXNET_CHAOS`` is set or
``inject()`` is active.  The seeded hooks pick what they hit from
``ChaosPlan.rng`` exactly as the JAX package's do, so in one process both
packages poison the same element and flip the same bit.  A bfloat16
parameter is left alone by both (its numpy twin is not a float kind in
the JAX package).  The checkpoint and data hooks (``ckpt_*``,
``loader_raise``) parse but have no consumer in the port yet.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

__all__ = ["ChaosPlan", "inject", "active", "FAULT_KINDS",
           "page_pressure", "tenant_flood", "request_burst",
           "migrate_interrupt", "drain_migrate", "worker_kill_mid_decode",
           "adapter_swap_mid_burst", "registry_stale", "gateway_partition",
           "worker_kill", "arm_kv_client", "note_kv_fault",
           "slow_replica", "replica_crash",
           "replica_slow_start", "InjectedReplicaCrash",
           "corrupt_loss_scale", "poison_grad", "flip_param_bit"]

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

# ---------------------------------------------------------------------------
# fleet fault hooks (the registry heartbeat, the gateway, the supervisors)
# ---------------------------------------------------------------------------
def registry_stale(n):
    """``registry_stale@N``: True when the Nth fleet heartbeat publish
    should be dropped — the replica's TTL'd registry entry lapses and
    the reaper must purge it (then the next beat re-registers; the
    fleet view self-heals)."""
    plan = active()
    return plan is not None and plan.fire("registry_stale", n)


def gateway_partition(n):
    """``gateway_partition@N``: True when the gateway's Nth registry
    refresh should fail as if the KV registry were unreachable.  The
    gateway keeps serving from its last-known-good :class:`FleetView`
    (marked stale) and re-syncs on the next successful refresh — the
    same self-healing contract :func:`registry_stale` proves for the
    worker side."""
    plan = active()
    return plan is not None and plan.fire("gateway_partition", n)


def worker_kill(n):
    """``worker_kill@N``: True when the Nth worker-kill opportunity
    should SIGKILL a live worker process (a hard crash, no drain).  The
    WorkerSupervisor must restart it within the backoff budget and the
    gateway must fail over — retrying idempotent work, resolving
    non-resumable streams with typed ``ReplicaLost``."""
    plan = active()
    return plan is not None and plan.fire("worker_kill", n)


# ---------------------------------------------------------------------------
# async-KV transport fault hooks (mxnet_tpu_torch.async_kv)
# ---------------------------------------------------------------------------
def arm_kv_client(client):
    """Arm the async-KV transport faults (``kv_drop``/``kv_delay``/
    ``kv_dup``) on an :class:`~mxnet_tpu_torch.async_kv.AsyncKVClient`.  The
    step number in the spec is the 1-based sequence number of the call to
    hit (the client numbers requests from 1)."""
    plan = active()
    if plan is None:
        return client
    for (kind, seq), live in list(plan._faults.items()):
        if not live:
            continue
        if kind == "kv_drop":
            client._fi_drop_after_send.add(seq)
        elif kind == "kv_delay":
            client._fi_delay_before_send[seq] = 0.05
        elif kind == "kv_dup":
            client._fi_duplicate_send.add(seq)
    return client


def note_kv_fault(kind, seq):
    """Called by the async_kv client when an armed transport fault
    actually fires — routes the event through the plan so counters and
    ``pending()`` stay truthful."""
    plan = active()
    if plan is not None:
        plan.fire(kind, seq)
    else:
        _count_fault()  # hand-armed via the test hooks


# ---------------------------------------------------------------------------
# serving-front fault hooks (mxnet_tpu_torch.serving.ModelServer)
# ---------------------------------------------------------------------------
class InjectedReplicaCrash(RuntimeError):
    """The failure :func:`replica_crash` raises inside a serving replica
    execution — caught by the serving layer's failover path like any
    real replica fault."""


def slow_replica(n, delay=0.25):
    """``slow_replica@N``: seconds the Nth model execution should stall
    before running (0.0 otherwise).  The serving worker sleeps OUTSIDE
    every lock, then executes normally — a straggler, not a failure."""
    plan = active()
    if plan is not None and plan.fire("slow_replica", n):
        return float(delay)
    return 0.0


def replica_crash(n):
    """``replica_crash@N``: raise :class:`InjectedReplicaCrash` in place
    of the Nth model execution — feeds the serving failover and circuit
    breaker exactly like a real replica fault."""
    plan = active()
    if plan is not None and plan.fire("replica_crash", n):
        raise InjectedReplicaCrash("chaos: injected crash on serving "
                                   "execution %d" % n)


def replica_slow_start(n, delay=0.3):
    """``replica_slow_start@N``: seconds the Nth ``add_replica`` build
    should stall before starting (0.0 otherwise) — a slow cold start."""
    plan = active()
    if plan is not None and plan.fire("replica_slow_start", n):
        return float(delay)
    return 0.0


# ---------------------------------------------------------------------------
# training fault hooks (FusedTrainStep / Trainer under a numeric guard)
# ---------------------------------------------------------------------------
def corrupt_loss_scale(step, scale):
    """``nan_grad``: NaN in place of the step's loss scale.  The scale
    multiplies the loss inside the step, so every gradient goes
    non-finite through the real backward computation."""
    plan = active()
    if plan is not None and plan.fire("nan_grad", step):
        return float("nan")
    return scale


def _flippable(t, kinds):
    """Whether a tensor's numpy kind is in ``kinds`` (bfloat16's numpy
    twin is a 2-byte void, kind ``'V'``, as in the JAX package)."""
    if t.dtype == torch.bfloat16:
        return False
    if t.dtype.is_floating_point:
        return "f" in kinds
    if t.dtype == torch.bool:
        return False
    return ("u" if t.dtype == torch.uint8 else "i") in kinds


def poison_grad(step, params):
    """``nan_grad`` on the eager Trainer path (which has no loss-scale
    slot): NaN into one seeded element of one parameter's gradient before
    the update (the element the JAX package's hook picks).  Returns the
    poisoned parameter's name or None."""
    plan = active()
    if plan is None or not params or "nan_grad" not in plan.kinds:
        return None
    if not plan.fire("nan_grad", step):
        return None
    rng = plan.rng("nan_grad", step)
    p = params[rng.randint(len(params))]
    for g in p.list_grad():
        flat = g.data.detach().reshape(-1)
        if flat.numel() == 0 or not _flippable(flat, "f"):
            return None
        i = rng.randint(flat.numel())
        with torch.no_grad():
            g.data.view(-1)[i] = float("nan")
    return getattr(p, "name", None)


def flip_param_bit(step, params):
    """``bitflip_param``: flip one seeded bit of one element of one
    parameter, in place (the bit the JAX package's hook flips).  Returns
    the poisoned parameter's name, or None when nothing fired."""
    plan = active()
    if plan is None or not params or "bitflip_param" not in plan.kinds:
        return None
    if not plan.fire("bitflip_param", step):
        return None
    rng = plan.rng("bitflip_param", step)
    p = params[rng.randint(len(params))]
    arr = p.list_data()[0] if hasattr(p, "list_data") else p
    t = arr.data
    if t.numel() == 0 or not _flippable(t, "fiu"):
        return None
    idx = rng.randint(t.numel())
    item = t.element_size()
    elem = t.detach().reshape(-1)[idx:idx + 1].cpu().numpy().copy()
    bits = elem.view("u%d" % item)
    bits ^= np.asarray(1, bits.dtype) << rng.randint(8 * item)
    with torch.no_grad():
        t.view(-1)[idx:idx + 1] = torch.from_numpy(elem).to(t.device)
    return getattr(p, "name", None)
