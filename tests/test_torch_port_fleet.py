"""The port's fleet control plane against the JAX package's:
``mxnet_tpu_torch.async_kv``, ``fleet.ServiceRegistry`` / ``FleetView``,
``fleet.FleetSupervisor``, ``fleet.WorkerSupervisor`` and
``fleet.cost_model`` beside ``mxnet_tpu``'s.

* The async-KV transport: the same ops give the same replies in both
  packages (an optimizer payload is each package's own SGD), a lost reply
  is applied exactly once, and the wire protocol is the same (a port
  client talks to a JAX server).
* The registry: TTL publish, reap and view alike.
* The autoscaler: the same scripted load signals, ticked on a
  ``SimClock``, give the same scale-ups, scale-downs and scale-up lags,
  reactive and predictive; bounds are validated alike; the heartbeat
  publishes the same load-report fields over a real ``ModelServer``.
* The worker supervisor: crash budget with backoff and clean exit, and
  the free rc-76 restart, alike (cheap non-framework children).
* ``cost_model`` from the same histograms gives the same quantile dicts.
"""
import pickle
import sys
import types

import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401
from mxnet_tpu import async_kv as jkv
from mxnet_tpu import chaos as jchaos
from mxnet_tpu import clock as jclock
from mxnet_tpu import fleet as jfleet
from mxnet_tpu import optimizer as jopt
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu_torch import async_kv as tkv
from mxnet_tpu_torch import chaos as tchaos
from mxnet_tpu_torch import clock as tclock
from mxnet_tpu_torch import elastic as telastic
from mxnet_tpu_torch import fleet as tfleet
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch import telemetry as ttelemetry
from torch_port_fleet_util import cpu_model, wait

torch.set_num_threads(1)

JAX = types.SimpleNamespace(kv=jkv, chaos=jchaos, clock=jclock, fleet=jfleet,
                            opt=jopt, serving=jserving, telemetry=jtelemetry)
PORT = types.SimpleNamespace(kv=tkv, chaos=tchaos, clock=tclock,
                             fleet=tfleet, opt=topt, serving=tserving,
                             telemetry=ttelemetry)


def both(scenario):
    return scenario(JAX), scenario(PORT)


# ---------------------------------------------------------------------------
# async_kv
# ---------------------------------------------------------------------------
def _kv_round_trips(P):
    server, addr = P.kv.start_local_server()
    try:
        c = P.kv.AsyncKVClient(addr=addr, backoff=0.001)
        out = {}
        c.init("w", np.arange(4, dtype=np.float32))
        c.init("w", np.zeros(4, np.float32))          # first init wins
        out["pull0"] = c.pull("w").tolist()
        with pytest.raises(RuntimeError, match="set_optimizer"):
            c.push("w", np.ones(4, np.float32))
        c.set_optimizer(pickle.dumps(P.opt.create(
            "sgd", learning_rate=0.5, rescale_grad=1.0)))
        c.push("w", np.ones(4, np.float32))
        c.push("w", np.full(4, 2.0, np.float32))
        out["pull1"] = c.pull("w").tolist()
        with pytest.raises(KeyError):
            c.pull("nope")
        c.init_rows("emb", (10, 3), "float32", None)
        c.push_rows("emb", np.array([2, 7]), np.ones((2, 3), np.float32))
        out["rows"] = c.pull_rows("emb", np.array([7, 2, 0])).tolist()
        out["rows_empty"] = list(c.pull_rows("emb", np.array([],
                                                            np.int64)).shape)
        c.registry_set("fleet/s/a", {"x": 1}, 30.0)
        out["rget"] = c.registry_get("fleet/s/a")
        out["rlist"] = sorted(c.registry_list("fleet/"))
        c.registry_delete("fleet/s/a")
        out["rlist_after"] = c.registry_list("fleet/")
        return out
    finally:
        server.shutdown()
        server.server_close()


def test_async_kv_round_trips_alike():
    ref, got = both(_kv_round_trips)
    assert got == ref
    assert got["pull1"] == [-1.5, -0.5, 0.5, 1.5]
    assert got["rows"][0] == got["rows"][1] == [-0.5, -0.5, -0.5]


def _kv_lost_reply(P):
    """``kv_drop@3``: the reply of the client's third call (the push) is
    lost after send; the retransmit is answered from the server's dedup
    cache, so the push lands once."""
    server, addr = P.kv.start_local_server()
    try:
        with P.chaos.inject("kv_drop@3"):
            c = P.chaos.arm_kv_client(P.kv.AsyncKVClient(
                addr=addr, backoff=0.001))
            c.set_optimizer(pickle.dumps(P.opt.create(
                "sgd", learning_rate=1.0, rescale_grad=1.0)))   # seq 1
            c.init("w", np.zeros(2, np.float32))                # seq 2
            c.push("w", np.ones(2, np.float32))                 # seq 3
            return c.pull("w").tolist()
    finally:
        server.shutdown()
        server.server_close()


def test_lost_reply_applied_exactly_once_alike():
    ref, got = both(_kv_lost_reply)
    assert got == ref == [-1.0, -1.0]


def test_port_client_speaks_the_jax_wire_protocol():
    server, addr = jkv.start_local_server()
    try:
        c = tkv.AsyncKVClient(addr=addr)
        c.registry_set("fleet/x/w0", {"inflight": 3}, 30.0)
        assert c.registry_get("fleet/x/w0") == {"inflight": 3}
        assert list(c.registry_list("fleet/x/")) == ["fleet/x/w0"]
    finally:
        server.shutdown()
        server.server_close()


def test_client_without_an_address_raises():
    with pytest.raises(NotImplementedError, match="item 9"):
        tkv.AsyncKVClient()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def _registry_ttl(P):
    import time

    reg = P.fleet.ServiceRegistry(service="ttl", ttl_s=0.2)
    try:
        reg.publish("w0", {"inflight": 1})
        reg.publish("w1", {"inflight": 2}, ttl_s=30.0)
        v0 = reg.view()
        time.sleep(0.3)
        stale = reg.view(reap=False)      # lapsed: invisible, not reaped
        v1 = reg.view()
        reg.publish("w0", {"inflight": 0})   # the next beat re-registers
        reg.withdraw("w1")
        v2 = reg.view()
        return [(v.alive, v.reaped, v.total("inflight"), v.max("inflight"))
                for v in (v0, stale, v1, v2)] + [repr(v1)]
    finally:
        reg.close()


def test_registry_ttl_publish_reap_view_alike():
    ref, got = both(_registry_ttl)
    assert got == ref
    assert got[2][:2] == (["w1"], ["w0"])
    assert got[3][0] == ["w0"]


# ---------------------------------------------------------------------------
# FleetSupervisor: scripted load through each package's control loop
# ---------------------------------------------------------------------------
class _ScriptedServer:
    """The ModelServer surface FleetSupervisor reads, driven by a script
    of per-tick (newly shed, newly admitted, queue depth, inflight)."""

    def __init__(self, script):
        self.script = list(script)
        self.i = 0
        self.n = 1
        self.shed = self.admitted = 0
        self.added, self.removed = [], []

    def advance(self):
        d_shed, d_adm, self.depth, self.inflight = self.script[self.i]
        self.shed += d_shed
        self.admitted += d_adm
        self.i += 1

    def num_active_replicas(self):
        return self.n

    def add_replica(self):
        self.n += 1
        self.added.append(self.i)
        return self.n - 1

    def remove_replica(self):
        self.n -= 1
        self.removed.append(self.i)
        return self.n

    def snapshot(self):
        return {"state": "SERVING", "queue_depth": self.depth,
                "shed": self.shed, "admitted": self.admitted,
                "free_slices": 0,
                "replicas": [{"id": r, "breaker": "CLOSED",
                              "inflight": self.inflight if r == 0 else 0,
                              "devices": 1} for r in range(self.n)]}


SCRIPT = ([(0, 0, 0, 0)] * 3                      # idle
          + [(0, 10, 2, 2), (0, 10, 5, 4), (3, 10, 9, 4), (5, 10, 14, 4),
             (8, 10, 16, 4), (6, 10, 12, 4), (0, 10, 6, 4), (0, 10, 2, 2)]
          + [(0, 0, 0, 0)] * 14)                  # idle: scale back down


def _scripted(P, predict):
    P.serving.brownout().reset()
    clk = P.clock.SimClock()
    srv = _ScriptedServer(SCRIPT)
    reg = P.fleet.ServiceRegistry(service="scripted", ttl_s=30.0)
    sup = P.fleet.FleetSupervisor(
        srv, registry=reg, min_replicas=1, max_replicas=3, shed_up=0.1,
        p99_up_ms=0.0, idle_down_s=2.0, cooldown_s=1.0, breach_ticks=2,
        interval_s=0.5, predict=predict, predict_alpha=0.5,
        predict_horizon_s=2.0, predict_depth_up=12, start=False,
        clock=clk)
    try:
        trail = []
        for _ in SCRIPT:
            srv.advance()
            sup._tick(clk.now())
            trail.append(srv.n)
            clk.advance(0.5)
        snap = sup.snapshot()
        return {"trail": trail, "added": srv.added, "removed": srv.removed,
                "lags": snap["scaleup_lags_ms"],
                "predictive_ups": snap["predictive_ups"],
                "scale_ups": snap["scale_ups"],
                "scale_downs": snap["scale_downs"],
                "depth_slope": snap["depth_slope"]}
    finally:
        reg.close()                   # never started: no loop to stop
        P.serving.brownout().reset()


@pytest.mark.parametrize("predict", [False, True])
def test_supervisor_scales_alike_on_scripted_load(predict):
    ref, got = both(lambda P: _scripted(P, predict))
    assert got == ref
    assert got["scale_ups"] >= 1 and got["scale_downs"] >= 1
    assert max(got["trail"]) <= 3 and min(got["trail"]) >= 1


def test_predictive_scales_up_before_the_reactive_one():
    reactive, predictive = _scripted(PORT, False), _scripted(PORT, True)
    assert predictive["predictive_ups"] >= 1
    assert predictive["added"][0] < reactive["added"][0]


def test_supervisor_bounds_validated_alike():
    def bad(P):
        with pytest.raises(ValueError, match="min_replicas") as e1:
            P.fleet.FleetSupervisor(_ScriptedServer([]), registry=object(),
                                    min_replicas=3, max_replicas=2,
                                    start=False)
        with pytest.raises(ValueError, match="min_replicas") as e2:
            P.fleet.FleetSupervisor(_ScriptedServer([]), registry=object(),
                                    min_replicas=0, start=False)
        return str(e1.value), str(e2.value)

    ref, got = both(bad)
    assert got == ref


def test_heartbeats_publish_the_load_report_over_a_model_server():
    """A real port ModelServer (the demo model on the CPU) under the
    supervisor's heartbeat thread: one TTL'd report per replica with the
    JAX package's fields; stop() withdraws them."""
    srv = cpu_model()
    reg = tfleet.ServiceRegistry(service="beats", ttl_s=30.0)
    sup = tfleet.FleetSupervisor(srv, registry=reg, heartbeat_s=0.02,
                                 interval_s=0.05, idle_down_s=60.0,
                                 cooldown_s=60.0)
    try:
        wait(lambda: sup.heartbeats >= 3, msg="heartbeats")
        view = reg.view(reap=False)
        assert view.alive == ["0"]
        assert set(view.replicas["0"]) == {
            "state", "breaker", "inflight", "devices", "queue_depth",
            "shed_rate", "p99_ms", "beat"}
    finally:
        sup.stop()
        assert srv.drain(timeout=30)
    assert len(reg.view(reap=False)) == 0
    reg.close()


def test_supervisor_scales_a_model_server_with_shared_weights():
    """Scale-up on a real ModelServer is ``add_replica`` (a clone that
    shares the parameters); scale-down retires it through the server's
    drain contract."""
    srv = cpu_model()
    reg = tfleet.ServiceRegistry(service="clone", ttl_s=30.0)
    sup = tfleet.FleetSupervisor(srv, registry=reg, min_replicas=1,
                                 max_replicas=2, cooldown_s=0.0,
                                 start=False, clock=tclock.SimClock())
    try:
        sup._scale_up(1, now=0.0)
        assert srv.num_active_replicas() == 2
        out = srv.submit({"data": np.ones((1, 4), np.float32)})
        assert out[0].shape == (1, 5)
        sup._scale_down(2)
        assert srv.num_active_replicas() == 1
        assert (sup.scale_ups, sup.scale_downs) == (1, 1)
    finally:
        assert srv.drain(timeout=30)
        reg.close()


# ---------------------------------------------------------------------------
# WorkerSupervisor: cheap children, no framework import
# ---------------------------------------------------------------------------
def _crash_budget(P):
    crasher = [sys.executable, "-c", "import sys; sys.exit(5)"]
    cleaner = [sys.executable, "-c", "import sys; sys.exit(0)"]
    sup = P.fleet.WorkerSupervisor({"bad": crasher, "ok": cleaner},
                                   max_restarts=2, backoff=0.01,
                                   backoff_cap=0.02, poll_s=0.01)
    try:
        wait(lambda: "bad" in sup._given_up and "ok" in sup._done,
             timeout=30, msg="crash budget to exhaust")
        snap = sup.snapshot()
        snap["alive"] = []
        return snap, dict(sup._incarnation)
    finally:
        sup.stop(timeout=5.0)


def test_worker_crash_budget_and_clean_exit_alike():
    ref, got = both(_crash_budget)
    assert got == ref
    snap, inc = got
    assert snap["failures"]["bad"] == 3 and snap["restarts"] == 2
    assert snap["done"] == ["ok"] and snap["given_up"] == ["bad"]
    assert inc == {"bad": 3, "ok": 1}


def _rc76(P):
    code = ("import os, sys, time\n"
            "if os.environ.get('MXTPU_RESTART_COUNT') == '0':\n"
            "    sys.exit(76)\n"
            "time.sleep(60)\n")
    sup = P.fleet.WorkerSupervisor({"w0": [sys.executable, "-c", code]},
                                   max_restarts=1, backoff=0.01,
                                   poll_s=0.01)
    try:
        wait(lambda: sup.preemption_restarts == 1
             and sup.alive() == ["w0"], timeout=30,
             msg="free restart after rc-76")
        return (sup._failures["w0"], sup._incarnation["w0"],
                sup.preemption_restarts, sup.restarts)
    finally:
        sup.stop(timeout=5.0)


def test_rc76_drain_restarts_for_free_alike():
    ref, got = both(_rc76)
    assert got == ref == (0, 2, 1, 1)      # a respawn, budget untouched
    assert telastic.PREEMPTED_EXIT_CODE == 76


def test_backoff_delay_bounds():
    for fails in (1, 2, 5, 12):
        d = telastic._backoff_delay(fails, 0.05, 2.0)
        cap = min(2.0, 0.05 * 2 ** (fails - 1))
        assert 0.5 * cap <= d <= cap
    assert telastic._backoff_delay(3, 0.0) == 0.0


def test_wait_registered_needs_a_registry():
    sup = tfleet.WorkerSupervisor({}, start=False)
    with pytest.raises(ValueError, match="registry"):
        sup.wait_registered(1)


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------
def _cost_model(P):
    reg = P.telemetry.MetricsRegistry()
    rng = np.random.RandomState(0)
    for name, scale in (("serving.latency_ms", 30.0),
                        ("fleet.scaleup_ms", 900.0), ("gen.ttft_ms", 12.0),
                        ("gateway.route_ms", 0.4)):
        h = reg.histogram(name)
        for v in rng.gamma(2.0, scale, size=257):
            h.observe(float(v))
    return P.fleet.cost_model(reg)


def test_cost_model_gives_the_same_quantiles():
    ref, got = both(_cost_model)
    assert got == ref
    assert got["fleet.failover_ms"] == {"count": 0}
    assert got["serving.latency_ms"]["count"] == 257
