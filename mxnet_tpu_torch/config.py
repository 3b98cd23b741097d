"""Environment-variable configuration tier: the knobs of
``mxnet_tpu/config.py`` that the port reads through ``config``
(telemetry's peak rates and step costs, debug bundles, memory accounting,
the numerical-health guard and its rollback ring, the kernel-selection
mode, the two runtime sanitizers, and the fleet plane's defaults: the
async-KV transport, the registry and autoscaler, the rebalancer, the
gateway, the fleet worker and the simulated fleet).

Each knob is declared once with a type, default and doc.  Names are the
JAX package's, so one launch script sets both packages.  The peak rates
the telemetry gauges divide by default to one NVIDIA H100 SXM's published
dense figures (989 TFLOP/s bf16, 3.35 TB/s HBM3), not to a TPU's.
"""
from __future__ import annotations

import os

__all__ = ["config", "Knob"]


class Knob:
    def __init__(self, name, typ, default, doc):
        self.name = name
        self.typ = typ
        self.default = default
        self.doc = doc

    @property
    def value(self):
        raw = os.environ.get(self.name)
        if raw is None:
            return self.default
        if self.typ is bool:
            return raw.strip().lower() not in ("0", "false", "no", "off",
                                               "f", "")
        return self.typ(raw)


class _Config:
    """Typed view over the MXNET_* / MXTPU_* env tier."""

    _KNOBS = [
        Knob("MXNET_NUMERIC_GUARD", str, "",
             "Numerical-health sentinel over the training hot path: a "
             "finiteness reduction over loss+gradients on the device "
             "rides FusedTrainStep / Trainer.step. 'warn' counts+warns "
             "but still applies the update; 'skip' keeps params, "
             "BatchNorm statistics and optimizer state bitwise unchanged "
             "across a non-finite step (selected on the device, no host "
             "round-trip); 'escalate' runs the ladder skip -> rescale -> "
             "rollback-k -> exit(77, retryable). '' disables."),
        Knob("MXNET_ROLLBACK_STEPS", int, 0,
             "Depth k of the bad-step rollback ring (host-RAM snapshots "
             "of params + optimizer state kept by the sentinel; a restore "
             "writes into the same tensors). 0 disables snapshotting; the "
             "escalation ladder then skips the rollback rung."),
        Knob("MXNET_TELEMETRY_COST", bool, True,
             "Count each training step's FLOPs and bytes from the shapes "
             "its first call sees (convolutions and products forward and "
             "backward; parameters, optimizer state and activations), so "
             "the live train.fused.mfu / hbm_gbs / hbm_util gauges are "
             "published with zero device syncs; set 0 to skip."),
        Knob("MXNET_TELEMETRY_PEAK_FLOPS", float, 989e12,
             "Accelerator peak FLOP/s the MFU gauges divide by. Default: "
             "one NVIDIA H100 SXM, dense bf16 (989 TFLOP/s, published "
             "figure at the 700 W limit)."),
        Knob("MXNET_TELEMETRY_PEAK_HBM_GBS", float, 3350.0,
             "Accelerator peak HBM bandwidth (GB/s) the hbm_util gauge "
             "divides by. Default: one NVIDIA H100 SXM, HBM3 "
             "(3.35 TB/s)."),
        Knob("MXTPU_DEBUG_BUNDLE_DIR", str, "",
             "Directory for postmortem debug bundles (registry snapshot, "
             "recent profiler events, recompile ring, dispatch stats, "
             "memory view, chaos plan). '' disables."),
        Knob("MXTPU_DEBUG_BUNDLE_KEEP", int, 20,
             "Newest-N bundles kept in MXTPU_DEBUG_BUNDLE_DIR."),
        Knob("MXTPU_DEBUG_BUNDLE_EVENTS", int, 500,
             "How many of the newest profiler ring events each bundle "
             "embeds."),
        Knob("MXTPU_MEM_ACCOUNTING", bool, True,
             "Tagged device-memory accounting (mxnet_tpu_torch.memory): "
             "per-device live/peak gauges from the CUDA caching "
             "allocator, per-subsystem tag providers. Set 0 to make "
             "update() a no-op."),
        Knob("MXTPU_PALLAS", str, "auto",
             "Kernel-selection mode (ops.kernels.common.select_impl; "
             "dispatch.pallas_mode): every mode runs the plain PyTorch "
             "version on a CPU tensor; on a CUDA tensor 'auto' launches "
             "the hand-written CUDA kernel, and 'off' and 'interpret' "
             "raise (the port has no kernel interpreter, and never hands "
             "the card the plain version because of this knob)."),
        Knob("MXTPU_LOCKDEP", str, "off",
             "Runtime lock-order sanitizer (mxnet_tpu_torch.lockdep): "
             "wraps every threading.Lock/RLock created by mxnet_tpu_torch "
             "code and keeps the acquisition-order graph by creation "
             "site. 'record' keeps edges, inversions and held-across-"
             "blocking events (lockdep.* gauges, a 'lockdep' debug-bundle "
             "section); 'raise' also raises LockOrderError at the acquire "
             "that would deadlock. 'off' (default): zero overhead. Read "
             "once, at import mxnet_tpu_torch, before any package lock."),
        Knob("MXTPU_RACECHECK", str, "off",
             "Runtime lockset race sanitizer (mxnet_tpu_torch.racecheck): "
             "Eraser locksets over the fields @racecheck.track declares. "
             "'record' keeps races (racecheck.* gauges, a 'racecheck' "
             "debug-bundle section); 'raise' also raises RaceError at the "
             "racing write. 'off' (default): zero overhead. Read once, at "
             "import mxnet_tpu_torch, after MXTPU_LOCKDEP."),
        # -- the async-KV transport (the fleet registry's backing store) --
        Knob("MXTPU_KV_TIMEOUT", float, 60.0,
             "Async-KV client socket timeout in s."),
        Knob("MXTPU_KV_RETRIES", int, 5,
             "Async-KV client retries of a failed call on a fresh "
             "connection."),
        Knob("MXTPU_KV_BACKOFF", float, 0.05,
             "Async-KV client retry backoff base in s."),
        Knob("MXTPU_KV_BACKOFF_CAP", float, 2.0,
             "Async-KV client retry backoff cap in s."),
        Knob("MXTPU_KV_REAP_S", float, 600.0,
             "Async-KV server: a connection idle this long is closed."),
        # -- the fleet: registry, autoscaler, rebalancer --------------------
        Knob("MXTPU_FLEET_HEARTBEAT_S", float, 0.25,
             "Fleet registry heartbeat period in s."),
        Knob("MXTPU_FLEET_TTL_S", str, "",
             "Registry-entry TTL in s ('' = 3 x the heartbeat period)."),
        Knob("MXTPU_FLEET_INTERVAL_S", float, 0.25,
             "FleetSupervisor control-tick period in s."),
        Knob("MXTPU_FLEET_MIN_REPLICAS", int, 1,
             "Autoscaler lower replica bound."),
        Knob("MXTPU_FLEET_MAX_REPLICAS", int, 4,
             "Autoscaler upper replica bound."),
        Knob("MXTPU_FLEET_SHED_UP", float, 0.05,
             "Scale-up trigger: windowed shed-rate threshold."),
        Knob("MXTPU_FLEET_P99_UP_MS", float, 0.0,
             "Scale-up trigger: latency p99 threshold in ms (0 = off)."),
        Knob("MXTPU_FLEET_IDLE_DOWN_S", float, 2.0,
             "Scale-down after this many s of continuous idle."),
        Knob("MXTPU_FLEET_COOLDOWN_S", float, 1.0,
             "Cooldown after each scaling decision in s."),
        Knob("MXTPU_FLEET_BREACH_TICKS", int, 2,
             "Consecutive breach ticks before a scale-up (hysteresis)."),
        Knob("MXTPU_FLEET_PREDICT", bool, False,
             "Predictive scale-up on the EWMA'd queue-depth slope."),
        Knob("MXTPU_FLEET_PREDICT_ALPHA", float, 0.4,
             "EWMA smoothing factor of the queue-depth slope."),
        Knob("MXTPU_FLEET_PREDICT_HORIZON_S", float, 3.0,
             "Predictive look-ahead horizon in s."),
        Knob("MXTPU_FLEET_PREDICT_DEPTH_UP", float, 8.0,
             "Projected queue depth that fires a predictive scale-up."),
        Knob("MXTPU_MIGRATE_REBALANCE_S", float, 0.5,
             "FleetRebalancer tick period in s."),
        Knob("MXTPU_MIGRATE_REBALANCE_BAND", float, 2.0,
             "Streams above the fleet median before a worker is shaved."),
        Knob("MXTPU_MIGRATE_REBALANCE_COOLDOWN_S", float, 2.0,
             "Per-worker cooldown between shaves in s."),
        Knob("MXTPU_MIGRATE_REBALANCE_MAX", int, 1,
             "Most streams parked per worker per rebalance tick."),
        # -- the gateway ------------------------------------------------------
        Knob("MXTPU_GATE_REFRESH_S", float, 0.25,
             "Gateway fleet-view refresh period in s."),
        Knob("MXTPU_GATE_RETRIES", int, 2,
             "Gateway retry budget for idempotent failover."),
        Knob("MXTPU_GATE_TIMEOUT_S", float, 60.0,
             "Gateway per-hop worker connection timeout in s."),
        Knob("MXTPU_GATE_SUSPECT_S", float, 2.0,
             "Seconds a worker stays routed around after a connection "
             "failure."),
        Knob("MXTPU_GATE_SESSION_CAP", int, 4096,
             "Session-affinity entries the gateway keeps (LRU)."),
        Knob("MXTPU_GATE_JOURNAL_CAP", int, 4096,
             "Delivered tokens journaled per stream for mid-decode "
             "resume; past it a worker death ends in ReplicaLost."),
        Knob("MXTPU_MIGRATE_CHUNK_KB", int, 256,
             "Live-migration transfer chunk size in KiB."),
        # -- the fleet worker ---------------------------------------------
        Knob("MXTPU_FLEET_WORKER_HEARTBEAT_S", float, 0.25,
             "Fleet worker registry heartbeat period in s."),
        Knob("MXTPU_FLEET_WORKER_IDEM_CACHE", int, 1024,
             "Idempotency-cache entries a fleet worker keeps."),
        Knob("MXTPU_FLEET_WORKER_DEADLINE_MS", float, 30000.0,
             "Fleet worker default request deadline in ms."),
        Knob("MXTPU_MIGRATE_PARK_TIMEOUT_S", float, 30.0,
             "Seconds a migration transfer buffer on a receiver survives "
             "unfinished."),
        Knob("MXTPU_MIGRATE_DRAIN_WAIT_S", float, 5.0,
             "Seconds a draining worker waits for its parked streams to "
             "be fetched before it exits rc 76."),
        # -- the simulated fleet ------------------------------------------
        Knob("MXTPU_SIM_TICK_S", float, 0.05,
             "SimFleet stepping tick in simulated s."),
        Knob("MXTPU_SIM_SLOTS", int, 4,
             "SimFleet per-replica concurrency slots."),
        Knob("MXTPU_SIM_QUEUE", int, 16,
             "SimFleet per-replica queue depth."),
        Knob("MXTPU_SIM_MAX_WALL_S", float, 300.0,
             "SimFleet real-wall-clock safety fuse in s."),
    ]

    def __init__(self):
        self._by_name = {k.name: k for k in self._KNOBS}

    def __getattr__(self, item):
        for prefix in ("MXNET_", "MXTPU_"):
            key = prefix + item.upper()
            if key in self._by_name:
                return self._by_name[key].value
        raise AttributeError(item)

    def knob(self, name):
        return self._by_name[name]


config = _Config()
