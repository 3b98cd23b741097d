"""Simulated-clock fleet: the counterpart of ``mxnet_tpu/simfleet.py``.

The point of this module is what it does NOT mock.  A :class:`SimFleet`
runs the **real** control plane — the production
:class:`~mxnet_tpu_torch.fleet.ServiceRegistry` (TTL'd KV over sockets),
the real :class:`~mxnet_tpu_torch.fleet.FleetSupervisor` autoscaling tick
(hysteresis, cooldowns, shed-rate windows, predictive scale-up), the real
:class:`~mxnet_tpu_torch.gateway.Gateway` routing policy (least-loaded,
breaker-aware, suspect windows, sticky sessions, last-known-good partition
fallback), the real brownout ladder and tenant governor, and the real
:mod:`~mxnet_tpu_torch.chaos` hooks — and replaces only two things:

* **time** — a :class:`~mxnet_tpu_torch.clock.SimClock` threaded through
  the fleet/gateway seams, advanced tick by tick, so a simulated hour of
  hundreds of replicas runs in seconds of wall time;
* **the data plane** — a :class:`SimServer` whose replicas cost what the
  live telemetry says they cost: service latency, scale-up delay, and
  TTFT are sampled from a :class:`CostModel` calibrated with one call to
  :func:`mxnet_tpu_torch.fleet.cost_model` (quantile interpolation over
  the real histograms, built-in defaults when a histogram is empty).

Determinism: all sampling flows through one seeded numpy generator, the
clock only moves when the stepping loop advances it, and every container
iterates in insertion order — the same seeded trace replayed twice
produces identical outcome curves, and the JAX package's SimFleet on the
same trace and seed produces the same ones.  It runs on the host only:
no tensor is made.

Every simulated incident (worker kill, registry partition) drops a real
debug bundle (:func:`mxnet_tpu_torch.debug.write_bundle`, ``force=True``
— simulated incidents are seconds apart in wall time).
"""
from __future__ import annotations

import collections
import sys
import time

import numpy as np

from . import chaos as _chaos
from . import clock as _clockmod
from . import debug as _debug
from . import loadgen as _loadgen
from . import serving as _serving
from . import tenancy as _tenancy
from .config import config as _config
from .fleet import FleetSupervisor, ServiceRegistry, cost_model
from .gateway import Gateway

__all__ = ["CostModel", "SimServer", "SimFleet", "partition_window"]

# env-tunable defaults (MXTPU_SIM_*, read through config at import)
_DEF_TICK_S = _config.sim_tick_s
_DEF_SLOTS = _config.sim_slots
_DEF_QUEUE = _config.sim_queue
_DEF_MAX_WALL_S = _config.sim_max_wall_s

# built-in cost quantiles for histograms with no live observations:
# a plausible small-model CPU serving profile (ms except decode rate)
_DEFAULT_COSTS = {
    "serving.latency_ms": {"min": 50.0, "p50": 300.0, "p95": 600.0,
                           "p99": 900.0, "max": 1200.0},
    "fleet.scaleup_ms": {"min": 500.0, "p50": 2000.0, "p95": 5000.0,
                         "p99": 8000.0, "max": 10000.0},
    "gen.ttft_ms": {"min": 20.0, "p50": 80.0, "p95": 250.0,
                    "p99": 400.0, "max": 600.0},
}


def _log(msg):
    print("[simfleet] %s" % msg, file=sys.stderr, flush=True)


class CostModel:
    """Replica cost distributions, sampled by quantile interpolation.

    ``tables`` maps histogram names to ``{min, p50, p95, p99, max}``
    quantile dicts — exactly what :func:`mxnet_tpu_torch.fleet.cost_model`
    returns for live telemetry.  Sampling draws a uniform and
    piecewise-linearly interpolates across the quantile knots, so the
    simulated latency distribution has the same median AND the same
    tail as the measured one (a mean-only model would never reproduce
    a p99 knee)."""

    _KNOTS = ((0.0, "min"), (0.5, "p50"), (0.95, "p95"), (0.99, "p99"),
              (1.0, "max"))

    def __init__(self, tables=None):
        self.tables = {}
        for name, dflt in _DEFAULT_COSTS.items():
            self.tables[name] = dict(dflt)
        for name, tab in dict(tables or {}).items():
            if tab and tab.get("count"):
                self.tables[name] = {k: float(tab[k]) for _, k in
                                     self._KNOTS if tab.get(k)
                                     is not None}

    @classmethod
    def from_telemetry(cls, reg=None):
        """Calibrate from the live registry (one call): measured
        histograms override the defaults, empty ones keep them."""
        return cls(cost_model(reg))

    def sample(self, name, rng):
        tab = self.tables.get(name) or _DEFAULT_COSTS.get(name)
        if not tab:
            raise KeyError("no cost table for %r" % name)
        u = float(rng.random())
        knots = [(q, tab[k]) for q, k in self._KNOTS if k in tab]
        for (q0, v0), (q1, v1) in zip(knots, knots[1:]):
            if u <= q1:
                frac = 0.0 if q1 == q0 else (u - q0) / (q1 - q0)
                return v0 + frac * (v1 - v0)
        return knots[-1][1]

    def latency_s(self, rng):
        return self.sample("serving.latency_ms", rng) / 1e3

    def scaleup_s(self, rng):
        return self.sample("fleet.scaleup_ms", rng) / 1e3

    def ttft_s(self, rng):
        return self.sample("gen.ttft_ms", rng) / 1e3

    def mean_latency_s(self):
        tab = self.tables["serving.latency_ms"]
        return tab.get("p50", 300.0) / 1e3


def partition_window(start, count):
    """Chaos spec fragment failing ``count`` consecutive gateway
    refreshes starting at refresh ``start`` (a registry partition that
    heals after the window)."""
    return ",".join("gateway_partition@%d" % n
                    for n in range(int(start), int(start) + int(count)))


class _SimReplica:
    __slots__ = ("rid", "ready_at", "slots", "queue", "inflight",
                 "state", "retiring")

    def __init__(self, rid, ready_at, slots):
        self.rid = rid
        self.ready_at = ready_at
        self.slots = slots
        self.queue = collections.deque()     # admitted, waiting for a slot
        self.inflight = []                   # [done_at, deadline_abs, req]
        self.state = "SERVING"
        self.retiring = False

    def ready(self, now):
        return self.state == "SERVING" and now >= self.ready_at

    def load(self):
        return len(self.queue) + len(self.inflight)


class SimServer:
    """Duck-types the :class:`~mxnet_tpu_torch.serving.ModelServer`
    surface the :class:`~mxnet_tpu_torch.fleet.FleetSupervisor` scales —
    snapshot(), num_active_replicas(), add_replica(), remove_replica() —
    over cost-model replicas instead of predictors.  The supervisor
    cannot tell the difference, which is the point: its hysteresis,
    cooldown, and shed-window logic runs unmodified."""

    def __init__(self, clock, costs, rng, initial_replicas=1,
                 max_replicas=None, slots=None, queue_cap=None,
                 instant_start=True):
        self.clock = clock
        self.costs = costs
        self.rng = rng
        self.slots = _DEF_SLOTS if slots is None else int(slots)
        self.queue_cap = _DEF_QUEUE if queue_cap is None \
            else int(queue_cap)
        self.max_replicas = (int(initial_replicas) if max_replicas is None
                             else int(max_replicas))
        self.replicas = {}           # rid -> _SimReplica (insertion order)
        self._seq = 0
        self.stats = {"admitted": 0, "shed": 0, "shed_brownout": 0,
                      "shed_quota": 0, "ok": 0, "deadline_exceeded": 0,
                      "replica_lost": 0, "unavailable": 0, "migrated": 0}
        for _ in range(int(initial_replicas)):
            self.add_replica(instant=instant_start)

    # -- the supervisor-facing surface ---------------------------------
    def num_active_replicas(self):
        return sum(1 for r in self.replicas.values()
                   if r.state == "SERVING" and not r.retiring)

    def add_replica(self, instant=False):
        """One cold replica; it starts SERVING after a scale-up delay
        sampled from the calibrated cost model (``instant`` seeds the
        initial fleet with warm replicas)."""
        now = self.clock.now()
        delay = 0.0 if instant else self.costs.scaleup_s(self.rng)
        rid = self._seq
        self._seq += 1
        self.replicas[rid] = _SimReplica(rid, now + delay, self.slots)
        return rid

    def remove_replica(self):
        """Retire the newest active replica: it leaves rotation now and
        drains its in-flight work (the rc-76 discipline, simulated)."""
        for rid in sorted(self.replicas, reverse=True):
            r = self.replicas[rid]
            if r.state == "SERVING" and not r.retiring:
                if self.num_active_replicas() <= 1:
                    raise ValueError("refusing to retire the last "
                                     "active replica")
                r.retiring = True
                return rid
        raise ValueError("no active replica to retire")

    def snapshot(self):
        live = [r for r in self.replicas.values()
                if r.state == "SERVING" and not r.retiring]
        return {
            "state": "SERVING",
            "queue_depth": sum(len(r.queue) for r in live),
            "replicas": [{"id": r.rid, "breaker": "CLOSED",
                          "inflight": len(r.inflight), "trips": 0,
                          "devices": 1} for r in live],
            "free_slices": self.max_replicas - len(self.replicas),
            **self.stats,
        }

    # -- sim-side helpers ----------------------------------------------
    def ready_replicas(self, now):
        return [r for r in self.replicas.values() if r.ready(now)]


class SimFleet:
    """Step a trace through the real control plane in simulated time.

    ``run()`` returns a dict with the
    :class:`~mxnet_tpu_torch.loadgen.ReplayReport` (``report``), the
    goodput-vs-offered curve (``curve``), the incident list
    (``incidents``), and the supervisor/server end states.  Chaos
    storms arm the real plan: ``chaos_spec`` uses the production kinds
    — ``gateway_partition@N`` fails the gateway's Nth registry refresh
    (see :func:`partition_window`), ``worker_kill@N`` hard-kills a
    replica on the Nth sim tick, exactly like the WorkerSupervisor's
    kill hook, ``drain_migrate@N`` rc-76-drains the busiest replica
    with the :attr:`migrate_on_drain` policy deciding whether its
    streams live-migrate or die (the drain-storm A/B), and
    ``tenant_flood@N`` bursts the Nth arrival's tenant factor-fold
    through the real per-tenant quota gate (the noisy-neighbor A/B).

    ``predict=True`` turns on the supervisor's predictive scale-up
    (EWMA queue-depth slope); ``supervisor["scaleup_lags_ms"]`` in the
    result is the reactive-vs-predictive figure of merit on the same
    seeded trace."""

    def __init__(self, trace, initial_replicas=4, max_replicas=None,
                 slots=None, queue_cap=None, costs=None, seed=0,
                 tick_s=None, heartbeat_s=0.5, interval_s=0.5,
                 refresh_s=0.5, suspect_s=1.0, retries=2,
                 autoscale=True, shed_up=0.05, cooldown_s=2.0,
                 breach_ticks=2, idle_down_s=30.0, service="sim",
                 migrate_on_drain=True, migrate_cost_s=0.05,
                 predict=None, predict_alpha=None,
                 predict_horizon_s=None, predict_depth_up=None):
        self.trace = sorted(trace, key=lambda r: (r["t"], r["i"]))
        self.clock = _clockmod.SimClock()
        self.rng = np.random.default_rng(int(seed))
        self.costs = costs if costs is not None else CostModel()
        self.tick_s = _DEF_TICK_S if tick_s is None else float(tick_s)
        self.heartbeat_s = float(heartbeat_s)
        self.interval_s = float(interval_s)
        self.refresh_s = float(refresh_s)
        self.autoscale = bool(autoscale)
        # huge TTL: registry TTLs are wall-clock server-side; sim
        # liveness is driven by withdraw (kill/retire), not TTL lapse
        self.registry = ServiceRegistry(service=service, ttl_s=3600.0)
        self.server = SimServer(
            self.clock, self.costs, self.rng,
            initial_replicas=initial_replicas,
            max_replicas=max_replicas, slots=slots, queue_cap=queue_cap)
        self.sup = FleetSupervisor(
            self.server, registry=self.registry,
            min_replicas=max(1, int(initial_replicas)),
            max_replicas=self.server.max_replicas,
            shed_up=shed_up, p99_up_ms=0.0, idle_down_s=idle_down_s,
            cooldown_s=cooldown_s, breach_ticks=breach_ticks,
            heartbeat_s=heartbeat_s, interval_s=interval_s,
            predict=predict, predict_alpha=predict_alpha,
            predict_horizon_s=predict_horizon_s,
            predict_depth_up=predict_depth_up,
            start=False, clock=self.clock)
        # offline gateway: no threads, no listener traffic — only the
        # production routing policy (_pick), suspect windows, and the
        # refresh/partition state machine (refresh_once)
        self.gateway = Gateway(registry=self.registry,
                               refresh_s=refresh_s, retries=retries,
                               suspect_s=suspect_s, start=False,
                               clock=self.clock)
        self.records = [None] * len(self.trace)
        # the live request list: trace order, plus any chaos ghosts
        # (tenant_flood duplicates) appended mid-run — records[req["i"]]
        # is each request's one settlement slot
        self.reqs = list(self.trace)
        self.incidents = []
        # drain policy sweep: with migrate_on_drain
        # a drained replica's in-flight streams transfer to siblings
        # keeping their remaining service time (+ a small migrate cost);
        # without it the drain degrades to the kill-and-resume path so
        # the same drain-storm trace A/Bs the two policies
        self.migrate_on_drain = bool(migrate_on_drain)
        self.migrate_cost_s = float(migrate_cost_s)
        self._settled = 0
        self._kill_seq = 0
        self._drain_seq = 0
        self._beat_seq = 0
        self._next_beat = 0.0
        self._next_sup = 0.0
        self._next_refresh = 0.0
        self._was_stale = False
        _debug.add_section("simfleet", self.snapshot)

    # -- outcome bookkeeping -------------------------------------------
    def _settle(self, req, outcome, now, ttft_ms=None):
        i = int(req["i"])
        if self.records[i] is not None:
            return
        lat_ms = (now - float(req["t"])) * 1e3
        self.records[i] = _loadgen._outcome_record(
            req, outcome, latency_ms=lat_ms, ttft_ms=ttft_ms)
        self._settled += 1
        key = {"ok": "ok", "DeadlineExceeded": "deadline_exceeded",
               "ReplicaLost": "replica_lost",
               "Unavailable": "unavailable"}.get(outcome)
        if key:
            self.server.stats[key] += 1

    def snapshot(self):
        return {"sim_now_s": round(self.clock.now(), 3),
                "settled": self._settled, "total": len(self.records),
                "replicas": self.server.num_active_replicas(),
                "stats": dict(self.server.stats),
                "gateway_stale": self.gateway.stale,
                "incidents": list(self.incidents)}

    # -- routing (the real gateway policy + retry discipline) ----------
    @staticmethod
    def _prio_rank(req):
        """QoS rank from the trace's ``"name=rank"`` priority (or bare
        class name -> rank 0) — the wire form loadgen stamps."""
        p = req.get("priority") or req.get("class")
        if p is None:
            return 0
        tail = str(p).partition("=")[2] or str(p)
        try:
            return int(tail.strip())
        except ValueError:
            return 0

    def _route(self, req, now):
        # the real per-tenant admission gate: token-bucket quota through
        # the process governor (queue_cap=0 -> fair-share skipped, the
        # ModelServer treatment).  A flooding tenant sheds typed
        # QuotaExceeded here and never reaches a replica queue.
        tenant = req.get("tenant") or "anon"
        gov = _tenancy.governor()
        try:
            gov.check(tenant, now)
        except _serving.QuotaExceeded:
            self.server.stats["shed_quota"] += 1
            self._settle(req, "QuotaExceeded", now)
            return
        # brownout level 3 (qos_only): the real admission gate — fed by
        # the real FleetSupervisor._tick breach bit — sheds low-rank
        # classes with one typed Overloaded before they reach a replica
        bo = _serving.brownout()
        if not gov.exempt(tenant) and not bo.admits(self._prio_rank(req)):
            # metered apart from "shed": a deliberate qos_only rejection
            # must not feed the shed-rate breach bit, or the ladder would
            # hold its own level up and never recover
            self.server.stats["shed_brownout"] += 1
            self._settle(req, "Overloaded", now)
            return
        excluded = []
        attempt = 0
        while True:
            picked = self.gateway._pick(session=req.get("session"),
                                        exclude=excluded)
            if picked is None:
                self._settle(req, "Unavailable", now)
                return
            rid = int(picked[0])
            repl = self.server.replicas.get(rid)
            if repl is None or not repl.ready(now) or repl.retiring:
                # the (possibly stale) view listed a corpse: the real
                # gateway marks it suspect and retries elsewhere
                self.gateway._note_suspect(picked[0])
                excluded.append(picked[0])
                attempt += 1
                if attempt > self.gateway.retries:
                    self._settle(req, "Unavailable", now)
                    return
                continue
            if repl.load() >= repl.slots + self.server.queue_cap:
                # worker-side shed (Overloaded): spill to a sibling
                # while retries remain, exactly like the 429 path
                self.server.stats["shed"] += 1
                excluded.append(picked[0])
                attempt += 1
                if attempt <= self.gateway.retries:
                    continue
                self._settle(req, "Overloaded", now)
                return
            self.server.stats["admitted"] += 1
            self.gateway._track(picked[0], 1)
            deadline_abs = float(req["t"]) + req["deadline_ms"] / 1e3
            repl.queue.append((req, deadline_abs, picked[0]))
            return

    def _kill_replica(self, now):
        """Hard-kill the busiest ready replica (chaos worker_kill):
        in-flight work dies with typed ReplicaLost, queued idempotent
        work is re-routed, the registry entry is withdrawn, and the
        incident drops a debug bundle."""
        ready = self.server.ready_replicas(now)
        if not ready:
            return
        victim = max(ready, key=lambda r: (r.load(), r.rid))
        victim.state = "DEAD"
        lost, requeue = len(victim.inflight), len(victim.queue)
        for _, _, req in victim.inflight:
            self.gateway._track(str(victim.rid), -1)
            self._settle(req, "ReplicaLost", now)
        victim.inflight = []
        gw_rid = str(victim.rid)
        self.gateway._note_suspect(gw_rid)
        try:
            self.registry.withdraw(victim.rid)
        except Exception:
            pass
        queued = list(victim.queue)
        victim.queue.clear()
        for req, _, _ in queued:
            self.gateway._track(gw_rid, -1)
            self.server.stats["admitted"] -= 1   # re-admission below
            self._route(req, now)
        self.incidents.append({"kind": "worker_kill", "rid": victim.rid,
                               "sim_t": round(now, 3),
                               "inflight_lost": lost,
                               "requeued": requeue})
        _debug.write_bundle("sim_worker_kill",
                            extra=self.incidents[-1], force=True)
        _log("t=%.2fs killed replica %d (%d in-flight lost, %d "
             "requeued)" % (now, victim.rid, lost, requeue))

    def _drain_replica(self, now):
        """rc-76 drain of the busiest ready replica (chaos
        ``drain_migrate``).  With ``migrate_on_drain`` every in-flight
        stream live-migrates to a ready sibling: its KV state moves, so
        it keeps its remaining service time and only pays the small
        transfer cost — no ReplicaLost, no re-prefill.  Without it (or
        with no sibling) the drain degrades to the kill path, so one
        trace sweeps both policies."""
        if not self.migrate_on_drain:
            self._kill_replica(now)
            return
        ready = self.server.ready_replicas(now)
        if not ready:
            return
        victim = max(ready, key=lambda r: (r.load(), r.rid))
        siblings = [r for r in ready if r.rid != victim.rid]
        if not siblings:
            # nowhere to migrate to: same outcome as a kill
            self._kill_replica(now)
            return
        victim.state = "DEAD"
        gw_rid = str(victim.rid)
        self.gateway._note_suspect(gw_rid)
        try:
            self.registry.withdraw(victim.rid)
        except Exception:
            pass
        moved = 0
        for done_at, deadline_abs, req in victim.inflight:
            # live migration: remaining decode continues on the least-
            # loaded sibling — the transferred stream keeps its decode
            # slot (brief oversubscription, like the real receiver
            # attaching an imported stream ahead of the admission gate)
            target = min(siblings, key=lambda r: (r.load(), r.rid))
            self.gateway._track(gw_rid, -1)
            self.gateway._track(str(target.rid), 1)
            target.inflight.append(
                (done_at + self.migrate_cost_s, deadline_abs, req))
            self.server.stats["migrated"] += 1
            moved += 1
        victim.inflight = []
        queued = list(victim.queue)
        victim.queue.clear()
        for req, _, _ in queued:
            # not started yet: plain idempotent re-admission
            self.gateway._track(gw_rid, -1)
            self.server.stats["admitted"] -= 1
            self._route(req, now)
        self.incidents.append({"kind": "drain_migrate",
                               "rid": victim.rid,
                               "sim_t": round(now, 3),
                               "migrated": moved,
                               "requeued": len(queued)})
        _debug.write_bundle("sim_drain_migrate",
                            extra=self.incidents[-1], force=True)
        _log("t=%.2fs drained replica %d (%d stream(s) migrated, %d "
             "requeued)" % (now, victim.rid, moved, len(queued)))

    # -- the stepping loop ---------------------------------------------
    def _heartbeat(self, now):
        beat = self._beat_seq
        self._beat_seq += 1
        if _chaos.registry_stale(beat):
            self.sup.heartbeats_dropped += 1
            return
        for r in self.server.ready_replicas(now):
            if r.retiring:
                continue
            self.registry.publish(r.rid, {
                "state": "SERVING", "breaker": "CLOSED",
                "inflight": r.load(), "devices": 1,
                "addr": "sim:%d" % r.rid, "beat": beat})
            self.sup.heartbeats += 1

    def _step_replicas(self, now):
        for r in list(self.server.replicas.values()):
            if r.state != "SERVING":
                continue
            # completions settle at their true finish time, not the
            # tick edge (keeps latency curves on the cost model)
            still = []
            for done_at, deadline_abs, req in r.inflight:
                if done_at > now:
                    still.append((done_at, deadline_abs, req))
                    continue
                self.gateway._track(str(r.rid), -1)
                if done_at > deadline_abs:
                    self._settle(req, "DeadlineExceeded", done_at)
                else:
                    ttft = self.costs.ttft_s(self.rng) * 1e3
                    self._settle(req, "ok", done_at, ttft_ms=ttft)
            r.inflight = still
            # queued deadline expiry (deadline classes mix, so the
            # queue is NOT deadline-ordered: scan it all), then pull
            # survivors into free slots
            keep = collections.deque()
            for req, deadline_abs, gw_rid in r.queue:
                if now >= deadline_abs:
                    self.gateway._track(gw_rid, -1)
                    self._settle(req, "DeadlineExceeded", now)
                else:
                    keep.append((req, deadline_abs, gw_rid))
            r.queue = keep
            while r.queue and len(r.inflight) < r.slots:
                req, deadline_abs, _ = r.queue.popleft()
                done_at = now + self.costs.latency_s(self.rng)
                r.inflight.append((done_at, deadline_abs, req))
            if r.retiring and not r.inflight and not r.queue:
                r.state = "RETIRED"

    def run(self, chaos_spec=None, chaos_seed=0, max_sim_s=None,
            max_wall_s=None, bucket_s=1.0):
        """Step the whole trace to settlement; returns the result dict.
        Deterministic for a fixed (trace, seed, chaos_spec)."""
        max_wall = _DEF_MAX_WALL_S if max_wall_s is None \
            else float(max_wall_s)
        horizon = (self.trace[-1]["t"] if self.trace else 0.0) + 60.0 \
            if max_sim_s is None else float(max_sim_s)
        wall0 = time.monotonic()
        ctx = _chaos.inject(chaos_spec, seed=chaos_seed) \
            if chaos_spec else None
        try:
            if ctx is not None:
                ctx.__enter__()
            self._run_steps(horizon, wall0, max_wall)
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)
        now = self.clock.now()
        # drain sweep: anything unsettled at the horizon gets its one
        # typed outcome (the contract survives even a truncated sim);
        # reqs covers chaos ghosts appended after the trace's own slots
        for req in self.reqs:
            if self.records[int(req["i"])] is None:
                self._settle(req, "Draining", now)
        report = _loadgen.ReplayReport(self.records, wall_s=now,
                                       speed=float("inf"),
                                       name="simfleet")
        report.wall_s = time.monotonic() - wall0
        return {"report": report, "curve": report.curve(bucket_s),
                "outcomes": report.outcome_counts(),
                "incidents": list(self.incidents),
                "supervisor": self.sup.snapshot(),
                "server": self.server.snapshot(),
                "sim_s": round(now, 3),
                "wall_s": round(report.wall_s, 3)}

    def _run_steps(self, horizon, wall0, max_wall):
        next_arrival = 0
        n = len(self.trace)
        while self._settled < len(self.records):
            now = self.clock.now()
            if now > horizon:
                _log("sim horizon %.1fs reached with %d/%d settled"
                     % (horizon, self._settled, len(self.records)))
                break
            if time.monotonic() - wall0 > max_wall:
                _log("wall budget %.0fs exhausted with %d/%d settled"
                     % (max_wall, self._settled, len(self.records)))
                break
            if _chaos.worker_kill(self._kill_seq):
                self._kill_replica(now)
            self._kill_seq += 1
            streams = sum(len(r.inflight)
                          for r in self.server.replicas.values()
                          if r.state == "SERVING")
            if _chaos.drain_migrate(self._drain_seq, streams):
                self._drain_replica(now)
            self._drain_seq += 1
            if now >= self._next_beat:
                self._heartbeat(now)
                self._next_beat = now + self.heartbeat_s
            if now >= self._next_refresh:
                self.gateway.refresh_once()
                stale = self.gateway.stale
                if stale and not self._was_stale:
                    self.incidents.append(
                        {"kind": "registry_partition",
                         "sim_t": round(now, 3)})
                    _debug.write_bundle("sim_registry_partition",
                                        extra=self.incidents[-1],
                                        force=True)
                elif self._was_stale and not stale:
                    self.incidents.append(
                        {"kind": "registry_healed",
                         "sim_t": round(now, 3)})
                self._was_stale = stale
                self._next_refresh = now + self.refresh_s
            while next_arrival < n \
                    and self.trace[next_arrival]["t"] <= now:
                req = self.trace[next_arrival]
                # noisy-neighbor injection: the triggering arrival's
                # tenant bursts factor-fold at this instant — ghost
                # duplicates get fresh record slots so every one still
                # settles with exactly one typed outcome
                factor = _chaos.tenant_flood(next_arrival)
                self._route(req, now)
                if factor > 1:
                    for _ in range(factor - 1):
                        ghost = dict(req)
                        ghost["i"] = len(self.records)
                        ghost["session"] = None
                        ghost["ghost"] = 1
                        self.records.append(None)
                        self.reqs.append(ghost)
                        self._route(ghost, now)
                next_arrival += 1
            self._step_replicas(now)
            if self.autoscale and now >= self._next_sup:
                self.sup._tick(now)
                self._next_sup = now + self.interval_s
            self.clock.advance(self.tick_s)

    def close(self):
        try:
            self.gateway.httpd.server_close()
        except Exception:
            pass
        try:
            self.registry.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
