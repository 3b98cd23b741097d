"""tests/test_simfleet.py's acceptance scenario through both packages'
SimFleet: 200 replicas under the real supervisor and gateway policy, a
ramped trace past twice the capacity (~35 000 requests), a registry
partition and two worker kills; the port's curve, outcomes, simulated end
time and scale-up lags equal the JAX package's exactly.  Its own file:
each package takes ~8 s on it.
"""
from mxnet_tpu import simfleet as jsimfleet
from test_torch_port_simfleet import assert_runs_equal, run_case


def _storm_trace(loadgen):
    return loadgen.generate_trace(loadgen.TraceSpec(seed=3, segments=[
        {"duration_s": 8.0, "rate_rps": 400.0},
        {"duration_s": 8.0, "rate_rps": 1300.0},
        {"duration_s": 8.0, "rate_rps": 2600.0}],
        deadline_classes=[{"name": "std", "deadline_ms": 3000.0,
                           "weight": 1.0}]))


def test_200_replica_storm_matches_the_jax_package_exactly():
    case = (_storm_trace,
            dict(initial_replicas=200, max_replicas=240, slots=2,
                 queue_cap=8, seed=5),
            dict(chaos_spec=jsimfleet.partition_window(8, 6)
                 + ",worker_kill@100,worker_kill@140", chaos_seed=0))
    ref, got = run_case("jax", *case), run_case("torch", *case)
    assert_runs_equal(ref, got)
    kinds = [i["kind"] for i in got["incidents"]]
    assert kinds.count("worker_kill") == 2
    assert "registry_partition" in kinds and "registry_healed" in kinds
    assert len(got["report"].records) > 20000
