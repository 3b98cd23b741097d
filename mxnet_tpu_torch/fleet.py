"""Fleet layer: service registry, shed-rate-driven replica autoscaling and
worker supervision — the counterpart of ``mxnet_tpu/fleet.py``.

The same signals the serving layer already exports (shed rate, queue
depth, the ``serving.latency_ms`` p99) drive a supervisor that adds and
drains **logical replicas** of a :class:`~mxnet_tpu_torch.serving.
ModelServer` — shared-weight clones (``add_replica`` / ``remove_replica``)
— against explicit bounds, hysteresis, and cooldowns.  Sharded replicas
(mesh slices) are not ported: ``ModelServer(mesh_axes=)`` raises (ROADMAP
Queue 1 item 9).

Five cooperating parts:

* :class:`ServiceRegistry` — TTL'd heartbeat/load-report store over the
  ``async_kv`` transport (one ``rset`` per replica per beat under
  ``fleet/<service>/<rid>``).  An entry whose TTL lapses is *stale*; the
  reaper purges it and the next beat re-registers — the fleet view
  self-heals through heartbeat loss (chaos kind ``registry_stale``).
  Without an address it starts an in-process server, so a single-host
  fleet needs zero configuration.
* :class:`FleetView` — one point-in-time snapshot of the registry:
  live replicas, their load reports, what the reaper just purged.
* :class:`FleetSupervisor` — the control loop.  Scale **up** when the
  windowed shed rate or the latency p99 breaches its threshold for
  ``breach_ticks`` consecutive ticks (hysteresis) and the cooldown has
  elapsed, or — with ``predict`` — when the EWMA'd queue-depth slope
  projects a breach; scale **down** after ``idle_down_s`` of continuous
  idle, through the server's own drain contract (``remove_replica``: in-
  flight work finishes), so it is free.  Every timer reads an injected
  ``clock`` (a :class:`~mxnet_tpu_torch.clock.SimClock` in simulation).
* :class:`WorkerSupervisor` — the cross-process lifecycle manager for
  ``python -m mxnet_tpu_torch.fleet_worker`` processes behind the gateway:
  spawns each worker with its argv (``subprocess``: fork and exec, so no
  CUDA context is inherited), restarts crashes with exponential backoff +
  jitter on a bounded failure budget (rc-76 graceful drains restart free),
  times death -> replacement into the ``fleet.failover_ms`` histogram, and
  writes a postmortem debug bundle when crashes storm.
* :class:`FleetRebalancer` — sticky-session load rebalancing by live KV
  migration across generation workers.

Every decision is observable: ``fleet.replicas`` / ``fleet.shed_rate`` /
``fleet.p99_ms`` / ``fleet.free_slices`` gauges, the ``fleet.scaleup_ms``
histogram (burst -> first new-replica admission), and the ``fleet_*``
dispatch counters.

Threading model: daemon loop threads, plain single-writer attributes, the
server only touched through its own locked public surface, and every
blocking call (registry RPC, replica build/warm) run with no lock held.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading

from . import chaos as _chaos
from . import clock as _clock
from . import serving as _serving
from . import telemetry as _telemetry
from .async_kv import AsyncKVClient, start_local_server
from .config import config as _config
from .elastic import PREEMPTED_EXIT_CODE, _backoff_delay

__all__ = ["ServiceRegistry", "FleetView", "FleetSupervisor",
           "WorkerSupervisor", "FleetRebalancer", "cost_model"]

# env-tunable defaults (MXTPU_FLEET_* / MXTPU_MIGRATE_REBALANCE_*, read
# through config at import, as the JAX package reads them)
_DEF_HEARTBEAT_S = _config.fleet_heartbeat_s
_DEF_TTL_S = _config.fleet_ttl_s
_DEF_INTERVAL_S = _config.fleet_interval_s
_DEF_MIN_REPLICAS = _config.fleet_min_replicas
_DEF_MAX_REPLICAS = _config.fleet_max_replicas
_DEF_SHED_UP = _config.fleet_shed_up
_DEF_P99_UP_MS = _config.fleet_p99_up_ms
_DEF_IDLE_DOWN_S = _config.fleet_idle_down_s
_DEF_COOLDOWN_S = _config.fleet_cooldown_s
_DEF_BREACH_TICKS = _config.fleet_breach_ticks
# predictive autoscaling: scale on the EWMA'd queue-depth slope so
# capacity arrives BEFORE the shed-rate breach — off by default
_DEF_PREDICT = _config.fleet_predict
_DEF_PREDICT_ALPHA = _config.fleet_predict_alpha
_DEF_PREDICT_HORIZON_S = _config.fleet_predict_horizon_s
_DEF_PREDICT_DEPTH_UP = _config.fleet_predict_depth_up
# sticky-session rebalancer: a worker whose inflight exceeds the fleet
# median by more than BAND gets up to MAX streams parked for migration,
# then COOLDOWN_S of peace
_DEF_REBALANCE_S = _config.migrate_rebalance_s
_DEF_REBALANCE_BAND = _config.migrate_rebalance_band
_DEF_REBALANCE_COOLDOWN_S = _config.migrate_rebalance_cooldown_s
_DEF_REBALANCE_MAX = _config.migrate_rebalance_max

def _log(msg):
    print("[fleet] %s" % msg, file=sys.stderr, flush=True)


def _count(name, delta=1):
    from . import profiler as _prof

    _prof.dispatch_count(name, delta)


# histograms the simulator calibrates its replica cost model from
_COST_MODEL_METRICS = (
    "fleet.scaleup_ms",
    "fleet.failover_ms",
    "serving.latency_ms",
    "serving.execute_ms",
    "gen.ttft_ms",
    "gen.decode_tokens_per_sec",
    "gateway.route_ms",
)
_COST_MODEL_KEYS = ("count", "avg", "min", "max", "p50", "p95", "p99")


def cost_model(reg=None):
    """One-call calibration snapshot for :mod:`mxnet_tpu_torch.simfleet`.

    Returns ``{metric: {count, avg, min, max, p50, p95, p99}}`` for each
    histogram in :data:`_COST_MODEL_METRICS`, pulled from the live
    telemetry registry (or ``reg``).  A histogram that has never been
    observed comes back as ``{"count": 0}`` so the simulator knows to
    fall back to its built-in defaults.  Registered as the
    ``cost_model`` debug-bundle section, so every postmortem carries the
    fleet's measured cost profile.
    """
    reg = _telemetry.registry() if reg is None else reg
    hists = reg.snapshot().get("histograms", {})
    out = {}
    for name in _COST_MODEL_METRICS:
        h = hists.get(name)
        if not h or not h.get("count"):
            out[name] = {"count": 0}
        else:
            out[name] = {k: h.get(k) for k in _COST_MODEL_KEYS}
    return out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
class ServiceRegistry:
    """TTL'd service registry over the async-KV transport.

    ``addr='host:port'`` joins an existing KV server (the multi-host
    deployment: every host's supervisor publishes into one store);
    without it an in-process server is started and owned.  Keys live
    under ``fleet/<service>/<replica_id>``; a value is whatever picklable
    load report the publisher sends.  TTL semantics are server-side
    monotonic time, so publishers never need synchronized clocks.
    """

    def __init__(self, addr=None, client=None, service="default",
                 ttl_s=None):
        self.service = str(service)
        if ttl_s is None:
            ttl_s = float(_DEF_TTL_S) if _DEF_TTL_S \
                else 3.0 * _DEF_HEARTBEAT_S
        self.ttl_s = float(ttl_s)
        self._server = None
        if client is None:
            if addr is None:
                self._server, addr = start_local_server()
            client = AsyncKVClient(addr=addr)
        self._client = client
        self.addr = addr

    @property
    def prefix(self):
        return "fleet/%s/" % self.service

    def _key(self, rid):
        return self.prefix + str(rid)

    def publish(self, rid, report, ttl_s=None):
        """One heartbeat: (re)register ``rid`` with its load report for
        one TTL window."""
        self._client.registry_set(self._key(rid), dict(report),
                                  self.ttl_s if ttl_s is None else ttl_s)

    def withdraw(self, rid):
        """Clean deregistration (drain/scale-down) — no TTL wait."""
        self._client.registry_delete(self._key(rid))

    def reap(self):
        """Purge expired entries for this service; returns reaped ids."""
        pfx = self.prefix
        return [k[len(pfx):] for k in self._client.registry_reap(pfx)]

    def view(self, reap=True):
        """Point-in-time :class:`FleetView` (reaping stale entries first
        unless ``reap=False``)."""
        reaped = self.reap() if reap else []
        pfx = self.prefix
        entries = {}
        for key, (value, ttl_left) in self._client.registry_list(pfx) \
                .items():
            entries[key[len(pfx):]] = (value, ttl_left)
        return FleetView(self.service, entries, reaped)

    def close(self):
        """Shut down the owned in-process server (no-op when joined)."""
        if self._server is not None:
            self._server.shutdown()
            self._server = None


class FleetView:
    """One registry snapshot: live replicas + load reports + reap log."""

    def __init__(self, service, entries, reaped=()):
        self.service = service
        self.replicas = {rid: report for rid, (report, _) in
                         entries.items()}
        self.ttl_remaining = {rid: ttl for rid, (_, ttl) in
                              entries.items()}
        self.reaped = list(reaped)

    @property
    def alive(self):
        return sorted(self.replicas)

    def __len__(self):
        return len(self.replicas)

    def total(self, field, default=0):
        return sum(r.get(field, default) for r in self.replicas.values())

    def max(self, field, default=0):
        vals = [r.get(field, default) for r in self.replicas.values()]
        return max(vals) if vals else default

    def as_dict(self):
        return {"service": self.service, "alive": self.alive,
                "reaped": self.reaped, "replicas": dict(self.replicas)}

    def __repr__(self):
        return "FleetView(%s: %d alive%s)" % (
            self.service, len(self),
            ", %d reaped" % len(self.reaped) if self.reaped else "")


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------
class FleetSupervisor:
    """Autoscaling control loop over a :class:`~mxnet_tpu_torch.serving.
    ModelServer` (or anything with its ``snapshot`` /
    ``num_active_replicas`` / ``add_replica`` / ``remove_replica``
    surface, such as :class:`~mxnet_tpu_torch.simfleet.SimServer`).

    The heartbeat thread publishes one TTL'd load report per active
    replica per beat; the control thread reaps stale entries, recomputes
    the windowed shed rate and latency p99, and moves the replica count:

    * **up** — when ``shed_rate >= shed_up`` (or ``p99 >= p99_up_ms``
      when enabled) for ``breach_ticks`` consecutive ticks, replicas are
      below ``max_replicas``, and the cooldown has elapsed.  The whole
      build (+warm) is timed into the ``fleet.scaleup_ms`` histogram.
    * **down** — after ``idle_down_s`` of continuous idle (no offered
      traffic, empty queue, nothing in flight) above ``min_replicas``,
      again behind the cooldown.  Retirement is the serving layer's
      existing drain contract, so no request is lost.

    ``stop()`` joins both threads and withdraws the replicas' registry
    entries.  The supervisor never holds a lock across anything blocking.
    """

    def __init__(self, server, registry=None, service="default",
                 heartbeat_s=None, interval_s=None,
                 min_replicas=None, max_replicas=None,
                 shed_up=None, p99_up_ms=None, idle_down_s=None,
                 cooldown_s=None, breach_ticks=None, start=True,
                 clock=None, predict=None, predict_alpha=None,
                 predict_horizon_s=None, predict_depth_up=None):
        self.server = server
        self.clock = _clock.resolve(clock)
        self.registry = registry if registry is not None \
            else ServiceRegistry(service=service)
        self.heartbeat_s = _DEF_HEARTBEAT_S if heartbeat_s is None \
            else float(heartbeat_s)
        self.interval_s = _DEF_INTERVAL_S if interval_s is None \
            else float(interval_s)
        self.min_replicas = _DEF_MIN_REPLICAS if min_replicas is None \
            else int(min_replicas)
        self.max_replicas = _DEF_MAX_REPLICAS if max_replicas is None \
            else int(max_replicas)
        self.shed_up = _DEF_SHED_UP if shed_up is None else float(shed_up)
        self.p99_up_ms = _DEF_P99_UP_MS if p99_up_ms is None \
            else float(p99_up_ms)
        self.idle_down_s = _DEF_IDLE_DOWN_S if idle_down_s is None \
            else float(idle_down_s)
        self.cooldown_s = _DEF_COOLDOWN_S if cooldown_s is None \
            else float(cooldown_s)
        self.breach_ticks = max(1, _DEF_BREACH_TICKS if breach_ticks
                                is None else int(breach_ticks))
        self.predict = _DEF_PREDICT if predict is None else bool(predict)
        self.predict_alpha = _DEF_PREDICT_ALPHA if predict_alpha is None \
            else float(predict_alpha)
        self.predict_horizon_s = (_DEF_PREDICT_HORIZON_S
                                  if predict_horizon_s is None
                                  else float(predict_horizon_s))
        self.predict_depth_up = (_DEF_PREDICT_DEPTH_UP
                                 if predict_depth_up is None
                                 else float(predict_depth_up))
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas "
                             "(got %d..%d)" % (self.min_replicas,
                                               self.max_replicas))

        # control state: single-writer attributes (each written by
        # exactly one loop thread, read by snapshot()) stay plain
        self.shed_rate = 0.0
        self.p99_ms = 0.0
        self.scale_ups = 0
        self.scale_downs = 0
        self.reaped_total = 0
        self.heartbeats = 0
        self.heartbeats_dropped = 0
        self._last_shed = None
        self._last_admitted = None
        self._last_hist_count = None
        self._breach_streak = 0
        self._idle_since = None
        self._cooldown_until = 0.0
        self._beat_seq = 0
        # predictive-scaling state (control-thread-only): EWMA'd queue-
        # depth slope, the clock reading of the first tick of the
        # current raw-breach episode (the scaleup-lag anchor), and the
        # per-decision lags — the reactive-vs-predictive evidence
        self._last_depth = None
        self._last_tick_t = None
        self._depth_slope = 0.0
        self._raw_breach_since = None
        self.predictive_ups = 0
        self.scaleup_lags_ms = []
        # the one cross-thread set: the heartbeat thread adds ids, the
        # control thread discards on scale-down, and stop() (any
        # thread) iterates it for withdrawal — so it gets its own lock
        # (never held across anything blocking)
        self._pub_lock = threading.Lock()
        self._published = set()

        # postmortem bundles embed the live fleet view (weakly held:
        # a collected supervisor drops out of future bundles)
        from . import debug as _debug

        _debug.add_section("fleet", self.snapshot)

        self._stop_evt = threading.Event()
        self._threads = [
            threading.Thread(target=self._heartbeat_loop,
                             name="fleet-heartbeat", daemon=True),
            threading.Thread(target=self._control_loop,
                             name="fleet-control", daemon=True),
        ]
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        for t in self._threads:
            if not t.is_alive():
                t.start()
        return self

    def stop(self, withdraw=True):
        """Stop both loops; withdraw this fleet's registry entries so
        peers see a clean deregistration instead of a TTL lapse."""
        self._stop_evt.set()
        for t in self._threads:
            t.join(timeout=5.0)
        if withdraw:
            with self._pub_lock:
                published = sorted(self._published)
            for rid in published:
                try:
                    self.registry.withdraw(rid)
                except Exception:
                    pass      # registry may already be gone at teardown
        _log("supervisor stopped (%d up / %d down, %d beats)"
             % (self.scale_ups, self.scale_downs, self.heartbeats))

    def snapshot(self):
        """Point-in-time control-loop view (tests/metrics)."""
        return {
            "replicas": self.server.num_active_replicas(),
            "shed_rate": self.shed_rate,
            "p99_ms": self.p99_ms,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "reaped_total": self.reaped_total,
            "heartbeats": self.heartbeats,
            "heartbeats_dropped": self.heartbeats_dropped,
            "breach_streak": self._breach_streak,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "predict": self.predict,
            "predictive_ups": self.predictive_ups,
            "depth_slope": round(self._depth_slope, 4),
            "scaleup_lags_ms": self.scaleup_lags(),
        }

    def scaleup_lags(self):
        """Per-scale-up lag (ms from the first raw breach tick of the
        episode; 0 for a pre-breach predictive fire) — the
        reactive-vs-predictive figure of merit, read per-supervisor so
        bench A/Bs never mix runs through the process histogram."""
        with self._pub_lock:
            return [round(v, 1) for v in self.scaleup_lags_ms]

    # -- heartbeat thread --------------------------------------------------
    def _heartbeat_loop(self):
        reg = _telemetry.registry()
        while not self._stop_evt.is_set():
            beat = self._beat_seq
            self._beat_seq += 1
            if _chaos.registry_stale(beat):
                # injected heartbeat loss: the TTL lapses and the reaper
                # fires; the NEXT beat re-registers (self-healing)
                self.heartbeats_dropped += 1
                _count("fleet_heartbeats_dropped")
            else:
                try:
                    snap = self.server.snapshot()
                    for r in snap["replicas"]:
                        self.registry.publish(r["id"], {
                            "state": snap["state"],
                            "breaker": r["breaker"],
                            "inflight": r["inflight"],
                            "devices": r.get("devices", 1),
                            "queue_depth": snap["queue_depth"],
                            "shed_rate": self.shed_rate,
                            "p99_ms": self.p99_ms,
                            "beat": beat,
                        })
                        with self._pub_lock:
                            self._published.add(r["id"])
                        self.heartbeats += 1
                        _count("fleet_heartbeats")
                except Exception as e:
                    # a dead registry must not kill the publisher: report
                    # and retry next beat (the transport already retries)
                    _log("heartbeat failed: %s: %s"
                         % (type(e).__name__, e))
            reg.gauge("fleet.replicas").set(
                self.server.num_active_replicas())
            self._stop_evt.wait(self.heartbeat_s)

    # -- control thread ----------------------------------------------------
    def _signals(self):
        """Windowed load signals from the server stats + latency
        histogram: (shed_rate, p99_ms, offered, queue_depth, inflight)."""
        snap = self.server.snapshot()
        shed, admitted = snap["shed"], snap["admitted"]
        d_shed = shed - (self._last_shed if self._last_shed is not None
                         else shed)
        d_adm = admitted - (self._last_admitted if self._last_admitted
                            is not None else admitted)
        self._last_shed, self._last_admitted = shed, admitted
        offered = d_shed + d_adm
        shed_rate = d_shed / offered if offered else 0.0

        hist = _telemetry.registry().histogram("serving.latency_ms")
        hist_count = hist.count
        if self._last_hist_count is not None and \
                hist_count > self._last_hist_count:
            p99 = hist.percentile(99) or 0.0
        else:
            p99 = 0.0     # no completions this window: p99 carries no news
        self._last_hist_count = hist_count

        inflight = sum(r["inflight"] for r in snap["replicas"])
        return shed_rate, p99, offered, snap["queue_depth"], inflight, snap

    def _tick(self, now):
        reaped = self.registry.reap()
        if reaped:
            self.reaped_total += len(reaped)
            _count("fleet_reaped", len(reaped))
            _log("reaped %d stale registry entr%s: %s"
                 % (len(reaped), "y" if len(reaped) == 1 else "ies",
                    reaped))

        shed_rate, p99, offered, depth, inflight, snap = self._signals()
        self.shed_rate, self.p99_ms = shed_rate, p99
        reg = _telemetry.registry()
        reg.gauge("fleet.shed_rate").set(shed_rate)
        reg.gauge("fleet.p99_ms").set(p99)
        reg.gauge("fleet.free_slices").set(snap.get("free_slices", 0))

        n = self.server.num_active_replicas()
        breach = shed_rate >= self.shed_up or \
            (self.p99_up_ms > 0 and p99 >= self.p99_up_ms)
        idle = offered == 0 and depth == 0 and inflight == 0
        # the same breach bit that drives autoscaling feeds the brownout
        # ladder: scaling adds capacity over seconds, brownout sheds load
        # NOW and steps back down as the clear streak accumulates.
        # Predictive forecasts do NOT feed it — brownout degrades live
        # traffic, and a forecast is not yet pain.
        _serving.brownout().observe(breach)

        # EWMA'd queue-depth slope: a rising queue forecasts the breach
        # the shed-rate signal only reports after the fact
        if self._last_depth is not None and self._last_tick_t is not None \
                and now > self._last_tick_t:
            raw_slope = (depth - self._last_depth) \
                / (now - self._last_tick_t)
            a = self.predict_alpha
            self._depth_slope = a * raw_slope + (1 - a) * self._depth_slope
        self._last_depth, self._last_tick_t = depth, now
        pred_breach = bool(
            self.predict and self._depth_slope > 0
            and depth + self._depth_slope * self.predict_horizon_s
            >= self.predict_depth_up)
        reg.gauge("fleet.depth_slope").set(round(self._depth_slope, 4))

        if breach:
            if self._raw_breach_since is None:
                self._raw_breach_since = now    # scaleup-lag anchor
            self._breach_streak += 1
            self._idle_since = None
        else:
            self._raw_breach_since = None
            self._breach_streak = 0
            if idle and not pred_breach:
                if self._idle_since is None:
                    self._idle_since = now
            else:
                self._idle_since = None

        reactive_fire = breach and self._breach_streak >= self.breach_ticks
        if (reactive_fire or pred_breach) \
                and n < self.max_replicas and now >= self._cooldown_until:
            self._scale_up(n, now=now,
                           predicted=pred_breach and not reactive_fire)
        elif (not breach) and self._idle_since is not None \
                and now - self._idle_since >= self.idle_down_s \
                and n > self.min_replicas and now >= self._cooldown_until:
            self._scale_down(n)

    def _scale_up(self, n, now=None, predicted=False):
        t0 = self.clock.now()
        try:
            rid = self.server.add_replica()
        except Exception as e:
            # pool exhausted / drain race: back off a full cooldown
            _log("scale-up blocked: %s: %s" % (type(e).__name__, e))
            self._cooldown_until = self.clock.now() + self.cooldown_s
            from . import debug as _debug

            _debug.write_bundle(
                "fleet_scale_up_blocked",
                extra={"replicas": n, "shed_rate": self.shed_rate,
                       "p99_ms": self.p99_ms,
                       "error": "%s: %s" % (type(e).__name__, e)})
            return
        dt_ms = (self.clock.now() - t0) * 1e3
        self.scale_ups += 1
        self._breach_streak = 0
        self._cooldown_until = self.clock.now() + self.cooldown_s
        _count("fleet_scale_ups")
        _telemetry.registry().histogram("fleet.scaleup_ms").observe(dt_ms)
        # scaleup lag: how long the fleet had been in raw breach before
        # this capacity decision fired.  A predictive fire lands at 0 —
        # capacity arrived BEFORE the breach — which is exactly the
        # reactive-vs-predictive figure of merit SimFleet sweeps.
        lag_ms = 0.0
        if self._raw_breach_since is not None and now is not None:
            lag_ms = max(0.0, (now - self._raw_breach_since) * 1e3)
        if predicted:
            self.predictive_ups += 1
            _count("fleet_predictive_ups")
        with self._pub_lock:
            self.scaleup_lags_ms.append(lag_ms)
        _telemetry.registry().histogram("fleet.scaleup_lag_ms").observe(
            lag_ms)
        _log("scale UP %d -> %d (replica %d, %.0fms%s, lag %.0fms; "
             "shed_rate=%.3f p99=%.1fms)"
             % (n, n + 1, rid, dt_ms,
                ", predictive" if predicted else "", lag_ms,
                self.shed_rate, self.p99_ms))

    def _scale_down(self, n):
        try:
            rid = self.server.remove_replica()
        except (ValueError, KeyError) as e:
            _log("scale-down blocked: %s" % e)
            self._cooldown_until = self.clock.now() + self.cooldown_s
            return
        self.scale_downs += 1
        self._idle_since = self.clock.now()  # re-arm: one window per step
        self._cooldown_until = self.clock.now() + self.cooldown_s
        _count("fleet_scale_downs")
        try:
            self.registry.withdraw(rid)      # clean deregistration
        except Exception:
            pass
        with self._pub_lock:
            self._published.discard(rid)
        _log("scale DOWN %d -> %d (retired replica %d after %.1fs idle)"
             % (n, n - 1, rid, self.idle_down_s))

    def _control_loop(self):
        while not self._stop_evt.is_set():
            try:
                self._tick(self.clock.now())
            except Exception as e:
                # one bad tick (registry blip, server drain race) must
                # not end autoscaling for the process's lifetime
                _log("control tick failed: %s: %s"
                     % (type(e).__name__, e))
            self._stop_evt.wait(self.interval_s)


# ---------------------------------------------------------------------------
# cross-process worker supervision
# ---------------------------------------------------------------------------
class WorkerSupervisor:
    """Spawn, monitor, and restart ``fleet_worker`` processes.

    ``specs`` maps each worker id to the argv that (re)starts it, e.g.
    ``{"w0": [sys.executable, "-m", "mxnet_tpu_torch.fleet_worker",
    "--registry", addr, "--rid", "w0"]}``.  Workers start through
    ``subprocess`` (fork and exec), so a child inherits no CUDA context
    from this process.  The monitor thread polls the children and applies
    the JAX package's ``elastic.supervise`` restart semantics in-process:

    * **crash** (any rc except 0 / rc-76) — charged against the
      per-worker ``max_restarts`` budget and respawned after
      exponential backoff with jitter; a worker over budget (or exiting
      a ``nonretryable`` code) is given up on and withdrawn.
    * **rc-76 graceful drain** — respawned immediately, budget
      untouched (a preempted worker did nothing wrong).
    * **clean exit (rc 0)** — left down (it chose to stop).

    Each respawn observes death -> replacement into the
    ``fleet.failover_ms`` histogram and bumps ``fleet_worker_restarts``;
    crashes that storm (3 within 30s across the fleet) write one
    ``fleet_worker_crash_storm`` debug bundle.  The chaos kind
    ``worker_kill@N`` SIGKILLs a live worker on the Nth monitor tick;
    tests can also call :meth:`kill_worker` directly.

    The monitor thread owns the restart bookkeeping (plain single-writer
    attributes), while the process table ``_procs`` — mutated by the
    monitor, iterated by ``stop()``/``alive()``/``kill_worker()`` from
    other threads — is guarded by ``_procs_lock``; the lock is never held across
    ``Popen``/``wait`` (snapshot-copy, then block outside it).
    """

    def __init__(self, specs, registry=None, service="default",
                 max_restarts=3, backoff=0.05, backoff_cap=8.0,
                 poll_s=0.05, env=None, nonretryable=None, start=True,
                 clock=None, streamed_probe=None):
        if not isinstance(specs, dict):
            specs = {"w%d" % i: argv for i, argv in enumerate(specs)}
        self.clock = _clock.resolve(clock)
        self.specs = {str(rid): list(argv) for rid, argv in specs.items()}
        self.registry = registry
        self.service = service
        self.max_restarts = int(max_restarts)
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self.poll_s = float(poll_s)
        self._env = dict(env if env is not None else os.environ)
        if nonretryable is None:
            raw = self._env.get("MXTPU_NONRETRYABLE_EXIT_CODES", "")
            nonretryable = {int(x) for x in raw.split(",") if x.strip()}
        self.nonretryable = frozenset(nonretryable)

        # monitor-thread state (plain attributes; snapshot() only reads)
        self._procs_lock = threading.Lock()
        self._procs = {}           # rid -> live Popen (guarded by _procs_lock)
        self._incarnation = {rid: 0 for rid in self.specs}
        self._failures = {rid: 0 for rid in self.specs}
        self._died_at = {}         # rid -> monotonic death time
        self._restart_at = {}      # rid -> earliest respawn time
        self._given_up = set()
        self._done = set()         # clean rc-0 exits
        self._kill_seq = 0
        # worker_kill_mid_decode@N: optional zero-arg callable returning
        # how many generation tokens have been streamed fleet-wide (e.g.
        # a gateway counter) — the kill only fires once it reads >= 1
        self._streamed_probe = streamed_probe
        self._mid_kill_seq = 0
        self._drain_seq = 0
        self.restarts = 0
        self.preemption_restarts = 0
        self.kills = 0

        from . import debug as _debug

        self._storm = _debug.StormDetector(3, window_s=30.0)
        _debug.add_section("worker_supervisor", self.snapshot)

        self._stop_evt = threading.Event()
        self._thread = threading.Thread(target=self._monitor_loop,
                                        name="fleet-worker-supervisor",
                                        daemon=True)
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        with self._procs_lock:
            have = set(self._procs)
        for rid in self.specs:
            if rid not in have:
                self._spawn(rid)
        if not self._thread.is_alive():
            self._thread.start()
        return self

    def stop(self, timeout=15.0):
        """Graceful shutdown: stop monitoring (no more restarts), then
        SIGTERM every live worker (the rc-76 drain path) and SIGKILL
        whatever outlives ``timeout``."""
        self._stop_evt.set()
        if self._thread.is_alive() and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)
        with self._procs_lock:
            procs = dict(self._procs)
        for proc in procs.values():
            if proc.poll() is None:
                try:
                    proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = self.clock.now() + float(timeout)
        for rid, proc in procs.items():
            left = max(0.1, deadline - self.clock.now())
            try:
                proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                _log("worker %s ignored SIGTERM for %.1fs — SIGKILL"
                     % (rid, timeout))
                proc.kill()
                proc.wait(timeout=5.0)
        _log("worker supervisor stopped (%d restarts, %d free, "
             "%d kills)" % (self.restarts, self.preemption_restarts,
                            self.kills))

    def snapshot(self):
        return {
            "workers": sorted(self.specs),
            "alive": sorted(self.alive()),
            "incarnation": dict(self._incarnation),
            "failures": dict(self._failures),
            "given_up": sorted(self._given_up),
            "done": sorted(self._done),
            "restarts": self.restarts,
            "preemption_restarts": self.preemption_restarts,
            "kills": self.kills,
            "max_restarts": self.max_restarts,
        }

    def alive(self):
        """Worker ids whose process is currently running."""
        with self._procs_lock:
            procs = list(self._procs.items())
        return [rid for rid, p in procs if p.poll() is None]

    def pid(self, rid):
        with self._procs_lock:
            proc = self._procs.get(str(rid))
        return None if proc is None else proc.pid

    def kill_worker(self, rid=None, sig=signal.SIGKILL):
        """SIGKILL a live worker (chaos ``worker_kill`` / tests).
        Returns the killed rid, or None when nothing is running."""
        live = sorted(self.alive())
        if rid is None:
            if not live:
                return None
            rid = live[0]
        rid = str(rid)
        with self._procs_lock:
            proc = self._procs.get(rid)
        if proc is None or proc.poll() is not None:
            return None
        try:
            proc.send_signal(sig)
        except OSError:
            return None
        self.kills += 1
        _count("fleet_worker_kills")
        _log("killed worker %s (pid %d, sig %d)"
             % (rid, proc.pid, int(sig)))
        return rid

    def wait_registered(self, n, timeout=30.0):
        """Block until ``n`` workers are live in the registry view (the
        spawn -> register rendezvous).  Needs a ``registry``."""
        if self.registry is None:
            raise ValueError("wait_registered needs a registry")
        deadline = self.clock.now() + float(timeout)
        while self.clock.now() < deadline:
            try:
                view = self.registry.view(reap=True)
                if len(view) >= n:
                    return view
            except Exception:
                pass              # registry still coming up
            self.clock.sleep(0.05)
        raise TimeoutError("only %d/%d workers registered after %.1fs"
                           % (len(self.registry.view(reap=False)), n,
                              timeout))

    # -- monitor -----------------------------------------------------------
    def _spawn(self, rid):
        inc = self._incarnation[rid]
        env = {**self._env, "MXTPU_RESTART_COUNT": str(inc)}
        proc = subprocess.Popen(self.specs[rid], env=env)
        with self._procs_lock:
            self._procs[rid] = proc
        self._incarnation[rid] = inc + 1
        self._restart_at.pop(rid, None)
        died = self._died_at.pop(rid, None)
        if died is not None:
            dt_ms = (self.clock.now() - died) * 1e3
            _telemetry.registry().histogram(
                "fleet.failover_ms").observe(dt_ms)
            self.restarts += 1
            _count("fleet_worker_restarts")
            _log("worker %s respawned (incarnation %d, pid %d, "
                 "%.0fms after death)" % (rid, inc, proc.pid, dt_ms))

    def _on_exit(self, rid, rc, now):
        self._died_at[rid] = now
        if rc == 0:
            self._done.add(rid)
            self._died_at.pop(rid, None)
            _log("worker %s exited cleanly — not restarting" % rid)
            return
        if rc in self.nonretryable:
            self._given_up.add(rid)
            self._died_at.pop(rid, None)
            _log("worker %s exited non-retryable rc=%d — giving up"
                 % (rid, rc))
            return
        if rc == PREEMPTED_EXIT_CODE:
            self.preemption_restarts += 1
            self._restart_at[rid] = now     # free, immediate
            _log("worker %s drained gracefully (rc=%d): restarting, "
                 "budget untouched" % (rid, rc))
            return
        self._failures[rid] += 1
        fails = self._failures[rid]
        if fails > self.max_restarts:
            self._given_up.add(rid)
            self._died_at.pop(rid, None)
            _log("worker %s failed %d times — budget exhausted"
                 % (rid, fails))
            from . import debug as _debug

            _debug.write_bundle(
                "fleet_worker_budget_exhausted",
                extra={"rid": rid, "rc": rc, "failures": fails})
            return
        delay = _backoff_delay(fails, self.backoff, self.backoff_cap)
        self._restart_at[rid] = now + delay
        _count("fleet_worker_crashes")
        _log("worker %s crashed rc=%d; restart %d/%d in %.2fs"
             % (rid, rc, fails, self.max_restarts, delay))
        if self._storm.hit():
            from . import debug as _debug

            _debug.write_bundle(
                "fleet_worker_crash_storm",
                extra={"rid": rid, "rc": rc,
                       "snapshot": self.snapshot()})

    def _busiest_alive(self):
        """The live worker reporting the highest inflight (registry
        view), falling back to the first live id — the drain_migrate
        chaos victim with the most streams to migrate."""
        live = set(self.alive())
        if not live:
            return None
        if self.registry is not None:
            try:
                view = self.registry.view(reap=False)
                loaded = sorted(
                    ((rep.get("inflight", 0), rid)
                     for rid, rep in view.replicas.items()
                     if rid in live), reverse=True)
                if loaded:
                    return loaded[0][1]
            except Exception:
                pass
        return sorted(live)[0]

    def _tick(self, now):
        if _chaos.worker_kill(self._kill_seq):
            self.kill_worker()
        self._kill_seq += 1
        if self._streamed_probe is not None:
            try:
                streamed = int(self._streamed_probe())
            except Exception:
                streamed = 0
            if _chaos.worker_kill_mid_decode(self._mid_kill_seq, streamed):
                self.kill_worker()
            self._mid_kill_seq += 1
            # drain_migrate@N: SIGTERM (not SIGKILL) the busiest worker
            # while streams are in flight — its rc-76 drain parks them
            # for live migration instead of losing the KV state, the
            # zero-loss half of the worker_kill_mid_decode drill
            if _chaos.drain_migrate(self._drain_seq, streamed):
                self.kill_worker(self._busiest_alive(),
                                 sig=signal.SIGTERM)
            self._drain_seq += 1
        with self._procs_lock:
            procs = list(self._procs.items())
        for rid, proc in procs:
            if rid in self._died_at or rid in self._given_up \
                    or rid in self._done:
                continue
            rc = proc.poll()
            if rc is not None:
                self._on_exit(rid, rc, now)
        for rid, t in list(self._restart_at.items()):
            if now >= t and rid not in self._given_up:
                self._spawn(rid)

    def _monitor_loop(self):
        while not self._stop_evt.is_set():
            try:
                self._tick(self.clock.now())
            except Exception as e:
                # one bad tick must not end supervision
                _log("worker-supervisor tick failed: %s: %s"
                     % (type(e).__name__, e))
            self._stop_evt.wait(self.poll_s)


class FleetRebalancer:
    """Sticky-session load rebalancer (live migration).

    Session affinity keeps a stream's KV pages on one worker, so a
    fleet's load can skew permanently: sessions pile onto whichever
    worker held them when the burst landed, and least-loaded routing
    cannot move work that is already admitted.  This control loop closes
    that gap with live migration: every ``MXTPU_MIGRATE_REBALANCE_S`` it
    reads the registry view, computes the fleet-median inflight across
    serving generate workers, and any worker whose inflight exceeds the
    median by more than the ``MXTPU_MIGRATE_REBALANCE_BAND`` hysteresis
    band gets up to ``MXTPU_MIGRATE_REBALANCE_MAX`` streams parked
    (``POST /v1/migrate_out {"park": k}``) — the gateway carries each
    parked stream's KV blob to the least-loaded sibling with no
    re-prefill and no client-visible gap.  A rebalanced worker then
    rests for ``MXTPU_MIGRATE_REBALANCE_COOLDOWN_S`` so reports can
    catch up (no park storms, no oscillation).

    Same threading shape as the other supervisors: one daemon thread,
    plain-attribute state, nothing blocking under a lock."""

    def __init__(self, registry=None, registry_addr=None,
                 service="default", interval_s=None, band=None,
                 cooldown_s=None, max_moves=None, start=True,
                 clock=None):
        self.clock = _clock.resolve(clock)
        self.registry = registry if registry is not None else \
            ServiceRegistry(addr=registry_addr, service=service)
        self.interval_s = _DEF_REBALANCE_S if interval_s is None \
            else float(interval_s)
        self.band = _DEF_REBALANCE_BAND if band is None else float(band)
        self.cooldown_s = _DEF_REBALANCE_COOLDOWN_S if cooldown_s is None \
            else float(cooldown_s)
        self.max_moves = _DEF_REBALANCE_MAX if max_moves is None \
            else int(max_moves)
        self.ticks = 0
        self.rebalances = 0        # park actions issued
        self.streams_parked = 0    # streams those actions parked
        self.errors = 0
        self._cooldown = {}        # rid -> earliest next action
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-rebalancer",
                                        daemon=True)
        if start:
            self.start()

    def start(self):
        if not self._thread.is_alive():
            self._thread.start()
        return self

    def stop(self):
        self._stop_evt.set()
        if self._thread.is_alive() and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)

    def snapshot(self):
        return {"ticks": self.ticks, "rebalances": self.rebalances,
                "streams_parked": self.streams_parked,
                "errors": self.errors, "band": self.band,
                "cooldown_s": self.cooldown_s,
                "max_moves": self.max_moves}

    @staticmethod
    def _post_json(addr, path, obj, timeout=5.0):
        import http.client
        import json as _json

        host, _, port = addr.rpartition(":")
        conn = http.client.HTTPConnection(host, int(port),
                                          timeout=timeout)
        try:
            conn.request("POST", path, body=_json.dumps(obj).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, _json.loads(resp.read() or b"{}")
        finally:
            conn.close()

    def tick(self):
        """One rebalance pass (the loop body; tests drive it directly).
        Returns how many streams were parked this pass."""
        self.ticks += 1
        now = self.clock.now()
        try:
            view = self.registry.view(reap=True)
        except Exception:
            self.errors += 1
            return 0
        loads = []
        for rid, rep in view.replicas.items():
            if not rep.get("addr") or rep.get("kind") != "generate":
                continue
            if rep.get("state") not in (None, "SERVING"):
                continue
            loads.append((int(rep.get("inflight", 0)), rid,
                          rep["addr"]))
        if len(loads) < 2:
            return 0                # nowhere to migrate to
        ranked = sorted(x[0] for x in loads)
        median = ranked[len(ranked) // 2]
        _telemetry.registry().gauge("fleet.rebalance_median").set(median)
        parked = 0
        for load, rid, addr in sorted(loads, reverse=True):
            if load <= median + self.band:
                break               # sorted: nobody further is over
            if now < self._cooldown.get(rid, 0.0):
                continue
            k = min(self.max_moves, int(load - median))
            try:
                status, resp = self._post_json(addr, "/v1/migrate_out",
                                               {"park": k})
            except OSError:
                self.errors += 1
                continue
            handles = resp.get("handles") or []
            self._cooldown[rid] = now + self.cooldown_s
            if status == 200 and handles:
                self.rebalances += 1
                self.streams_parked += len(handles)
                parked += len(handles)
                _count("fleet_rebalancer_parked", len(handles))
                _log("rebalance: parked %d stream(s) on %s "
                     "(inflight %d > median %d + band %g)"
                     % (len(handles), rid, load, median, self.band))
        return parked

    def _loop(self):
        while not self._stop_evt.is_set():
            try:
                self.tick()
            except Exception as e:
                self.errors += 1
                _log("rebalancer tick failed: %s: %s"
                     % (type(e).__name__, e))
            self._stop_evt.wait(self.interval_s)


# every debug bundle carries the measured cost profile (module-level
# function: add_section keeps a strong ref, which is what we want here)
from . import debug as _debug  # noqa: E402  (needs cost_model defined)

_debug.add_section("cost_model", cost_model)
