"""The port's SimFleet against the JAX package's: the same seeded traces,
settings and chaos plans through ``mxnet_tpu.simfleet`` and
``mxnet_tpu_torch.simfleet`` give exactly the same goodput-vs-offered
curves, outcome counts, simulated end time and scale-up lags.

The simulator runs each package's real control plane (registry over a
socket, ``FleetSupervisor`` ticks, the gateway's ``_pick``, the brownout
ladder, the tenant governor, chaos) on the default ``CostModel()`` in
simulated time, so the comparison is exact.  The brownout ladder and the
tenant governor are process-global in each package and are reset before
every run.
"""
import pytest

from mxnet_tpu import loadgen as jloadgen
from mxnet_tpu import serving as jserving
from mxnet_tpu import simfleet as jsimfleet
from mxnet_tpu import tenancy as jtenancy
from mxnet_tpu_torch import clock as tclock
from mxnet_tpu_torch import loadgen as tloadgen
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch import simfleet as tsimfleet
from mxnet_tpu_torch import tenancy as ttenancy

PKGS = {"jax": (jsimfleet, jserving, jtenancy, jloadgen),
        "torch": (tsimfleet, tserving, ttenancy, tloadgen)}


def _trace(loadgen, seed=7, ramp=((4.0, 20.0), (4.0, 60.0))):
    """tests/test_simfleet.py's seeded ramp traces."""
    return loadgen.generate_trace(loadgen.TraceSpec(
        seed=seed,
        segments=[{"duration_s": d, "rate_rps": r} for d, r in ramp],
        deadline_classes=[{"name": "std", "deadline_ms": 3000.0,
                           "weight": 1.0}]))


def _bench_burst(loadgen):
    """bench.py's tenant-leg scale-up trace: 3 s at 2 rps, 6 s at 60."""
    return loadgen.generate_trace(loadgen.TraceSpec(
        seed=33, segments=[{"duration_s": 3.0, "rate_rps": 2.0},
                           {"duration_s": 6.0, "rate_rps": 60.0}]))


# (trace builder, SimFleet kwargs, run kwargs): bench.py's A/B and the
# seeded scenarios of tests/test_simfleet.py
CASES = {
    "bench_reactive": (_bench_burst, dict(
        initial_replicas=2, max_replicas=12, seed=5, predict=False,
        predict_horizon_s=4.0, predict_depth_up=6), {}),
    "bench_predictive": (_bench_burst, dict(
        initial_replicas=2, max_replicas=12, seed=5, predict=True,
        predict_horizon_s=4.0, predict_depth_up=6), {}),
    "seeded_replay": (_trace, dict(
        initial_replicas=2, max_replicas=8, slots=2, queue_cap=8,
        seed=1), {}),
    "overload_autoscale": (
        lambda lg: _trace(lg, ramp=((2.0, 10.0), (6.0, 80.0))), dict(
            initial_replicas=2, max_replicas=12, slots=2, queue_cap=8,
            seed=3), {}),
    "worker_kill": (
        lambda lg: _trace(lg, ramp=((6.0, 40.0),)), dict(
            initial_replicas=3, max_replicas=3, slots=2, queue_cap=8,
            seed=2, autoscale=False),
        dict(chaos_spec="worker_kill@40")),
    "gateway_partition": (
        lambda lg: _trace(lg, ramp=((8.0, 10.0),)), dict(
            initial_replicas=2, max_replicas=2, slots=2, queue_cap=16,
            seed=4, autoscale=False),
        dict(chaos_spec=jsimfleet.partition_window(4, 4))),
}


def run_case(pkg, build, kw, run_kw):
    """One SimFleet run of ``build(loadgen)`` through package ``pkg``."""
    simfleet, serving, tenancy, loadgen = PKGS[pkg]
    tenancy.reset_governor(tenancy.TenantGovernor(quotas={}))
    serving.brownout().reset()
    try:
        with simfleet.SimFleet(build(loadgen), **kw) as fleet:
            res = fleet.run(**run_kw)
    finally:
        tenancy.reset_governor()
        serving.brownout().reset()
    return res


def assert_runs_equal(ref, got):
    assert got["curve"] == ref["curve"]
    assert got["outcomes"] == ref["outcomes"]
    assert got["sim_s"] == ref["sim_s"]
    assert got["supervisor"]["scaleup_lags_ms"] == \
        ref["supervisor"]["scaleup_lags_ms"]
    assert got["supervisor"]["scale_ups"] == ref["supervisor"]["scale_ups"]
    assert [i["kind"] for i in got["incidents"]] == \
        [i["kind"] for i in ref["incidents"]]
    # every request exactly one typed outcome
    assert sum(got["outcomes"].values()) == len(got["report"].records)
    assert set(got["outcomes"]) <= set(tloadgen.TYPED_OUTCOMES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_simfleet_matches_the_jax_package_exactly(case):
    assert_runs_equal(run_case("jax", *CASES[case]),
                      run_case("torch", *CASES[case]))


def _run(pkg, case):
    return run_case(pkg, *CASES[case])


def test_bench_ab_predictive_scales_before_the_breach():
    """bench.py's figures on the port: the predictive run fires its first
    scale-up before the raw breach (lag 0) and its mean lag is below the
    reactive run's; a second run of each gives the same lag list."""
    r1, p1 = _run("torch", "bench_reactive"), _run("torch",
                                                   "bench_predictive")
    r2, p2 = _run("torch", "bench_reactive"), _run("torch",
                                                   "bench_predictive")
    rl, pl = (r1["supervisor"]["scaleup_lags_ms"],
              p1["supervisor"]["scaleup_lags_ms"])
    assert rl == r2["supervisor"]["scaleup_lags_ms"]
    assert pl == p2["supervisor"]["scaleup_lags_ms"]
    assert rl and pl and pl[0] == 0.0
    assert sum(pl) / len(pl) < sum(rl) / len(rl)


def test_simfleet_runs_on_the_port_clock():
    with tsimfleet.SimFleet(_trace(tloadgen, ramp=((1.0, 5.0),)),
                            initial_replicas=1, seed=0) as fleet:
        assert isinstance(fleet.clock, tclock.SimClock)
        assert fleet.sup.clock is fleet.clock
        assert fleet.gateway.clock is fleet.clock
        res = fleet.run()
    assert res["outcomes"].get("ok", 0) > 0
