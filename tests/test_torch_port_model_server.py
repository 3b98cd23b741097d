"""The port's model-serving front (``serving.ModelServer``, ``Replica``,
``CircuitBreaker``) against the JAX package's, on the CPU.

The cases of ``tests/test_serving.py`` run through both packages'
ModelServer over the same model (a 4 -> 5 FullyConnected, and bench.py's
64 -> 256 -> 8 serving MLP) with the same numpy requests, and must give
equal outcomes, equal ``snapshot()`` stats and equal dispatch-counter
deltas; outputs are held to each other and to numpy within ``ATOL``.

Both servers batch on scheduler threads.  Each gets its own
``clock.SimClock``, so a batch closes on its timer, a deadline expires or
a hedge fires only when the test advances that clock; and a scenario that
fills the queue does so while the single replica is held in a stalled
execution (``slow_replica``), so that no batch can form meanwhile.  Both
packages therefore form the same batches from the same requests.  The
drain-timeout case runs on the real clock (a drain waits on it).
"""
import collections
import signal
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu import chaos as jchaos
from mxnet_tpu import clock as jclock
from mxnet_tpu import elastic as jelastic
from mxnet_tpu import predict as jpredict
from mxnet_tpu import profiler as jprof
from mxnet_tpu import serving as jserving
from mxnet_tpu_torch import chaos as tchaos
from mxnet_tpu_torch import clock as tclock
from mxnet_tpu_torch import elastic as telastic
from mxnet_tpu_torch import predict as tpredict
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch import serving as tserving

CPU = mt.cpu()
ATOL = 1e-6
Pkg = collections.namedtuple("Pkg", "name mx serving chaos clock prof "
                                    "predict elastic ctx")
PKGS = [Pkg("jax", jmx, jserving, jchaos, jclock, jprof, jpredict, jelastic,
            {}),
        Pkg("torch", mt, tserving, tchaos, tclock, tprof, tpredict, telastic,
            {"ctx": CPU})]
STATS = ("admitted", "shed", "rejected_draining", "ok", "deadline_exceeded",
         "unavailable", "batches_full", "batches_timer", "batches_deadline",
         "hedges_fired", "hedge_wins", "failovers", "reloads",
         "queue_depth_peak", "replicas_added", "replicas_removed")
COUNTERS = ("requests_admitted", "requests_shed", "hedges_fired",
            "breaker_trips", "batches_closed_by_deadline",
            "bucket_padded_batches", "faults_injected", "recompile",
            "requests_deadline_exceeded")


def _fc_model(pkg, seed=3, name="fc", data="data"):
    mx = pkg.mx
    out = mx.sym.FullyConnected(mx.sym.var(data),
                                mx.sym.var(name + "_weight"),
                                mx.sym.var(name + "_bias"), num_hidden=5,
                                name=name)
    wn = np.random.RandomState(seed).rand(5, 4).astype(np.float32)
    params = {"arg:%s_weight" % name: mx.nd.array(wn, **pkg.ctx),
              "arg:%s_bias" % name: mx.nd.zeros((5,), **pkg.ctx)}
    return out, params, wn


def _server(pkg, n_replicas=1, sim=True, model=None, **kw):
    sym, params, wn = model or _fc_model(pkg)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 2)
    kw.setdefault("deadline_ms", 20_000)
    clock = pkg.clock.SimClock(start=100.0) if sim else None
    srv = pkg.serving.ModelServer(sym, params, input_shapes={"data": (1, 4)},
                                  num_replicas=n_replicas, clock=clock,
                                  **dict(kw, **pkg.ctx))
    return srv, wn


def _req(rng, rows=1):
    return {"data": rng.rand(rows, 4).astype(np.float32)}


def _outcomes(futs, timeout=30):
    out = []
    for f in futs:
        try:
            f.result(timeout=timeout)
            out.append("ok")
        except Exception as e:         # typed outcomes, compared by name
            out.append(type(e).__name__)
    return out


def _wait(cond, timeout=20.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("timed out waiting for " + what)
        time.sleep(0.002)


def _inflight(srv):
    return sum(r["inflight"] for r in srv.snapshot()["replicas"])


def _run(scenario, **kw):
    """``scenario(pkg, **kw)`` in each package: the results, the stats and
    the counter deltas, which must be equal."""
    res = {}
    for pkg in PKGS:
        before = pkg.prof.dispatch_stats()
        out, snap = scenario(pkg, **kw)
        after = pkg.prof.dispatch_stats()
        res[pkg.name] = (out, {k: snap[k] for k in STATS},
                         {k: after.get(k, 0) - before.get(k, 0)
                          for k in COUNTERS})
    for i, what in enumerate(("results", "stats", "counter deltas")):
        assert res["torch"][i] == res["jax"][i], (what, res)
    return res["torch"]


# ---------------------------------------------------------------------------
# correctness + batching
# ---------------------------------------------------------------------------
def test_serving_matches_bare_predictor():
    outs = {}

    def scenario(pkg):
        srv, wn = _server(pkg)
        try:
            x = np.random.RandomState(0).rand(1, 4).astype(np.float32)
            fut = srv.submit_async({"data": x})
            srv.clock.advance(1.0)                 # the batch timer
            got = fut.result(timeout=30)
            np.testing.assert_allclose(got[0], x @ wn.T, rtol=1e-5,
                                       atol=ATOL)
            outs[pkg.name] = got[0]
            return [srv.state], srv.snapshot()
        finally:
            srv.drain(timeout=30)

    out, _, _ = _run(scenario)
    assert out == ["SERVING"]
    np.testing.assert_allclose(outs["torch"], outs["jax"], atol=ATOL, rtol=0)


def test_batching_slices_rows_back():
    """Concurrent requests ride one padded batch; each gets exactly its
    own rows back."""
    def scenario(pkg):
        srv, wn = _server(pkg, max_wait_ms=20, max_batch=8)
        try:
            rng = np.random.RandomState(1)
            xs = [rng.rand(r, 4).astype(np.float32) for r in (1, 2, 3)]
            futs = [srv.submit_async({"data": x}) for x in xs]
            srv.clock.advance(1.0)
            shapes = []
            for x, f in zip(xs, futs):
                out = f.result(timeout=30)
                np.testing.assert_allclose(out[0], x @ wn.T, rtol=1e-5,
                                           atol=ATOL)
                shapes.append(out[0].shape)
                assert f.job.padded_rows == 8 and f.job.rows == 6
            return shapes, srv.snapshot()
        finally:
            srv.drain(timeout=30)

    out, stats, counters = _run(scenario)
    assert out == [(1, 5), (2, 5), (3, 5)]
    assert stats["ok"] == 3 and stats["batches_timer"] == 1
    assert counters["bucket_padded_batches"] == 1


def test_bucket_padding_no_recompile_after_warm():
    """Warmed buckets absorb every batch shape: the padded 3-row batch
    bumps bucket_padded_batches but triggers no new signature."""
    def scenario(pkg):
        srv, _ = _server(pkg, max_wait_ms=30, max_batch=8)
        try:
            warmed = pkg.prof.dispatch_stats()["recompile"]
            rng = np.random.RandomState(2)
            futs = [srv.submit_async(_req(rng)) for _ in range(3)]
            srv.clock.advance(1.0)
            out = _outcomes(futs)
            return [out, pkg.prof.dispatch_stats()["recompile"] - warmed], \
                srv.snapshot()
        finally:
            srv.drain(timeout=30)

    (out, after_warm), _, counters = _run(scenario)
    assert out == ["ok"] * 3 and after_warm == 0
    assert counters["recompile"] == 4           # the warm-up: 1, 2, 4, 8
    assert counters["bucket_padded_batches"] == 1


def test_request_validation():
    def scenario(pkg):
        srv, _ = _server(pkg)
        errs = []
        try:
            rng = np.random.RandomState(3)
            for bad in ({}, {"bogus": rng.rand(1, 4)}, _req(rng, rows=64),
                        {"data": np.float32(1.0)}):
                try:
                    srv.submit_async(bad)
                    errs.append(None)
                except ValueError as e:
                    errs.append(str(e))
            return errs, srv.snapshot()
        finally:
            srv.drain(timeout=30)

    errs, _, _ = _run(scenario)
    assert None not in errs


# ---------------------------------------------------------------------------
# overload / deadlines
# ---------------------------------------------------------------------------
def test_overload_sheds_typed_and_queue_stays_bounded():
    """While the replica is held in a stalled execution, admissions past
    the cap get a typed Overloaded at once and the queue never grows past
    max_queue."""
    def scenario(pkg):
        srv, _ = _server(pkg, max_queue=8)
        try:
            rng = np.random.RandomState(4)
            with pkg.chaos.inject("slow_replica@0") as plan:
                futs = [srv.submit_async(_req(rng))]
                srv.clock.advance(1.0)
                _wait(lambda: plan.pending() == [], what="the stall")
                shed = 0
                for _ in range(40):
                    try:
                        futs.append(srv.submit_async(_req(rng)))
                    except pkg.serving.Overloaded:
                        shed += 1
                srv.clock.advance(1.0)
                outcomes = _outcomes(futs)
            return [shed, outcomes], srv.snapshot()
        finally:
            srv.drain(timeout=30)

    (shed, outcomes), stats, counters = _run(scenario)
    assert shed == 32 and outcomes == ["ok"] * 9
    assert stats["queue_depth_peak"] == 8 and stats["shed"] == 32
    assert counters["requests_shed"] == 32


def test_deadline_exceeded_is_typed():
    """Requests whose deadline expires while the replica is stalled get
    DeadlineExceeded — not a hang, not a silent drop."""
    def scenario(pkg):
        srv, _ = _server(pkg, max_queue=32)
        try:
            rng = np.random.RandomState(5)
            with pkg.chaos.inject("slow_replica@0") as plan:
                soak = srv.submit_async(_req(rng))
                srv.clock.advance(1.0)
                _wait(lambda: plan.pending() == [], what="the stall")
                doomed = [srv.submit_async(_req(rng), deadline_ms=40)
                          for _ in range(4)]
                srv.clock.advance(1.0)             # past their deadlines
                out = _outcomes(doomed) + _outcomes([soak])
            return out, srv.snapshot()
        finally:
            srv.drain(timeout=30)

    out, stats, counters = _run(scenario)
    assert out == ["DeadlineExceeded"] * 4 + ["ok"]
    assert stats["deadline_exceeded"] == 4
    assert counters["requests_deadline_exceeded"] == 4


def test_batch_closes_early_for_tight_deadline():
    """A lone request with little slack does not wait out the max-wait
    timer: the batcher closes by deadline slack."""
    def scenario(pkg):
        srv, _ = _server(pkg, max_wait_ms=5_000, max_batch=8)
        try:
            rng = np.random.RandomState(6)
            fut = srv.submit_async(_req(rng), deadline_ms=200)
            srv.clock.advance(0.19)       # inside the slack, 4.8 s early
            return _outcomes([fut]), srv.snapshot()
        finally:
            srv.drain(timeout=30)

    out, stats, counters = _run(scenario)
    assert out == ["ok"] and stats["batches_deadline"] == 1
    assert counters["batches_closed_by_deadline"] == 1


# ---------------------------------------------------------------------------
# hedging / failover / circuit breaker
# ---------------------------------------------------------------------------
def test_hedge_beats_straggler():
    """The first execution stalls; past hedge_ms the second replica
    answers while the straggler still sleeps."""
    def scenario(pkg):
        srv, wn = _server(pkg, n_replicas=2, hedge_ms=60)
        try:
            rng = np.random.RandomState(7)
            x = rng.rand(1, 4).astype(np.float32)
            with pkg.chaos.inject("slow_replica@0") as plan:
                fut = srv.submit_async({"data": x})
                srv.clock.advance(0.003)           # the batch timer only
                _wait(lambda: plan.pending() == [], what="the stall")
                srv.clock.advance(0.1)             # past hedge_ms
                got = fut.result(timeout=30)
            np.testing.assert_allclose(got[0], x @ wn.T, rtol=1e-5,
                                       atol=ATOL)
            _wait(lambda: _inflight(srv) == 0, what="the straggler")
            return ["ok"], srv.snapshot()
        finally:
            srv.drain(timeout=30)

    _, stats, counters = _run(scenario)
    assert stats["hedges_fired"] == 1 and stats["hedge_wins"] == 1
    assert counters["hedges_fired"] == 1


def test_failover_to_second_replica():
    def scenario(pkg):
        srv, wn = _server(pkg, n_replicas=2, breaker_threshold=3)
        try:
            x = np.random.RandomState(8).rand(1, 4).astype(np.float32)
            with pkg.chaos.inject("replica_crash@0"):
                fut = srv.submit_async({"data": x})
                srv.clock.advance(1.0)
                got = fut.result(timeout=30)
            np.testing.assert_allclose(got[0], x @ wn.T, rtol=1e-5,
                                       atol=ATOL)
            return ["ok"], srv.snapshot()
        finally:
            srv.drain(timeout=30)

    _, stats, _ = _run(scenario)
    assert stats["failovers"] == 1


def test_single_replica_total_failure_is_unavailable():
    def scenario(pkg):
        srv, _ = _server(pkg, breaker_threshold=5)
        try:
            with pkg.chaos.inject("replica_crash@0"):
                fut = srv.submit_async(_req(np.random.RandomState(9)))
                srv.clock.advance(1.0)
                return _outcomes([fut]), srv.snapshot()
        finally:
            srv.drain(timeout=30)

    out, stats, _ = _run(scenario)
    assert out == ["Unavailable"] and stats["unavailable"] == 1


def test_breaker_trips_and_recovers_half_open():
    """threshold consecutive failures trip the breaker (DEGRADED); after
    the backoff a half-open probe succeeds and the breaker closes."""
    def scenario(pkg):
        srv, _ = _server(pkg, breaker_threshold=2, breaker_backoff=0.05,
                         breaker_backoff_cap=0.1)
        try:
            rng = np.random.RandomState(10)
            seen = []
            with pkg.chaos.inject("replica_crash@0,replica_crash@1") as plan:
                for _ in range(2):
                    fut = srv.submit_async(_req(rng))
                    srv.clock.advance(0.003)
                    seen += _outcomes([fut])
                assert plan.pending() == []
                snap = srv.snapshot()
                seen += [snap["replicas"][0]["breaker"], snap["state"]]
                fut = srv.submit_async(_req(rng))  # parked until reopen
                srv.clock.advance(1.0)
                seen += _outcomes([fut])
            _wait(lambda: srv.snapshot()["state"] == "SERVING",
                  what="SERVING")
            snap = srv.snapshot()
            seen += [snap["replicas"][0]["breaker"], snap["state"]]
            return seen, snap
        finally:
            srv.drain(timeout=30)

    out, _, counters = _run(scenario)
    assert out == ["Unavailable", "Unavailable", "OPEN", "DEGRADED", "ok",
                   "CLOSED", "SERVING"]
    assert counters["breaker_trips"] == 1


def _breaker_sequence(cls, now=1000.0):
    """tests/test_serving.py's two breaker unit cases as one trace."""
    seq = []
    br = cls(threshold=2, backoff=10.0, backoff_cap=100.0)
    seq += [br.allow(now), br.state, br.record_failure(now),
            br.record_failure(now), br.state, br.trips, br.allow(now)]
    later = br.reopen_at + 0.001
    seq += [br.would_allow(later), br.allow(later), br.state,
            br.allow(later), br.record_failure(later), br.state, br.trips]
    again = br.reopen_at + 0.001
    seq += [br.allow(again)]
    br.record_success()
    seq += [br.state, br.failures, br.trips, br.allow(again)]
    # a cancelled probe dispatch releases the half-open slot
    br = cls(threshold=1, backoff=10.0, backoff_cap=10.0)
    seq += [br.record_failure(now)]
    later = br.reopen_at + 0.001
    seq += [br.allow(later), br.probe_inflight, br.would_allow(later)]
    br.release_probe()
    seq += [br.state, br.would_allow(later), br.allow(later)]
    br.record_success()
    seq += [br.state]
    return seq


def test_circuit_breaker_unit_and_release_probe():
    assert _breaker_sequence(tserving.CircuitBreaker) == \
        _breaker_sequence(jserving.CircuitBreaker)
    assert _breaker_sequence(tserving.CircuitBreaker)[:7] == \
        [True, "CLOSED", False, True, "OPEN", 1, False]


def test_backoff_delay_bounds_match():
    from mxnet_tpu.async_kv import backoff_delay as jdelay

    for attempt in range(8):
        assert tserving.backoff_delay(attempt, 0.2, 30, jitter=False) == \
            jdelay(attempt, 0.2, 30, jitter=False)
        d = tserving.backoff_delay(attempt, 0.2, 1.0)
        full = min(1.0, 0.2 * 2 ** attempt)
        assert 0.5 * full <= d < full


def test_half_open_probe_is_health_check():
    """Half-open readmission probes with Predictor.health_check before
    live traffic: an unhealthy replica never closes its breaker, a healthy
    one recovers."""
    def scenario(pkg):
        srv, wn = _server(pkg, breaker_threshold=1, breaker_backoff=0.05,
                          breaker_backoff_cap=0.1)
        try:
            rng = np.random.RandomState(21)
            seen = []
            with pkg.chaos.inject("replica_crash@0"):
                fut = srv.submit_async(_req(rng))
                srv.clock.advance(0.003)
                seen += _outcomes([fut])
            seen.append(srv.snapshot()["replicas"][0]["breaker"])
            repl = srv._replicas[0]
            orig, calls = repl.predictor.health_check, []
            repl.predictor.health_check = \
                lambda: (calls.append(1), False)[1]
            try:
                fut = srv.submit_async(_req(rng), deadline_ms=600)
                srv.clock.advance(0.2)             # past the reopen
                _wait(lambda: calls, what="a probe")
                srv.clock.advance(1.0)             # past the deadline
                seen += _outcomes([fut])
                seen.append(srv.snapshot()["replicas"][0]["breaker"]
                            != "CLOSED")
            finally:
                repl.predictor.health_check = orig
            x = rng.rand(1, 4).astype(np.float32)
            fut = srv.submit_async({"data": x})
            srv.clock.advance(1.0)
            got = fut.result(timeout=30)
            np.testing.assert_allclose(got[0], x @ wn.T, rtol=1e-5,
                                       atol=ATOL)
            seen.append(srv.snapshot()["replicas"][0]["breaker"])
            return seen, srv.snapshot()
        finally:
            srv.drain(timeout=30)

    out, _, _ = _run(scenario)
    assert out == ["Unavailable", "OPEN", "DeadlineExceeded", True,
                   "CLOSED"]


def test_hedge_wins_only_counts_hedge_settling():
    """Both replicas stall; the hedge fires, the primary still finishes
    first: hedges_fired bumps, hedge_wins stays 0."""
    def scenario(pkg):
        srv, _ = _server(pkg, n_replicas=2, hedge_ms=60)
        try:
            rng = np.random.RandomState(22)
            with pkg.chaos.inject("slow_replica@0,slow_replica@1") as plan:
                fut = srv.submit_async(_req(rng))
                srv.clock.advance(0.003)
                _wait(lambda: ("slow_replica", 0) not in plan.pending(),
                      what="the first stall")
                srv.clock.advance(0.1)
                out = _outcomes([fut])
            _wait(lambda: _inflight(srv) == 0, what="the hedge")
            return out, srv.snapshot()
        finally:
            srv.drain(timeout=30)

    out, stats, _ = _run(scenario)
    assert out == ["ok"]
    assert stats["hedges_fired"] == 1 and stats["hedge_wins"] == 0


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_chaos_burst_and_crash_every_request_typed(pkg):
    """tests/test_serving.py's acceptance scenario in each package, on the
    real clock: every admitted request reaches exactly one typed outcome,
    the queue stays bounded, every fault fires, and the breakers close
    again."""
    srv, wn = _server(pkg, n_replicas=2, sim=False, max_queue=8,
                      max_wait_ms=1, deadline_ms=5_000, breaker_threshold=2,
                      breaker_backoff=0.05, breaker_backoff_cap=0.1)
    try:
        rng = np.random.RandomState(11)
        futs, shed = [], 0
        spec = ("replica_crash@1,replica_crash@2,replica_crash@3,"
                "request_burst@1,slow_replica@5")
        with pkg.chaos.inject(spec, seed=11) as plan:
            for wave in range(6):
                for _ in range(2 * pkg.chaos.request_burst(wave)):
                    try:
                        futs.append(srv.submit_async(_req(rng)))
                    except pkg.serving.Overloaded:
                        shed += 1
                time.sleep(0.01)
            outcomes = _outcomes(futs, timeout=60)
            assert plan.pending() == [], plan.pending()
        assert set(outcomes) <= {"ok", "DeadlineExceeded", "Unavailable"}
        assert outcomes.count("ok") >= 1
        snap = srv.snapshot()
        assert snap["admitted"] == len(futs)
        assert snap["ok"] + snap["deadline_exceeded"] \
            + snap["unavailable"] == len(futs)
        assert snap["shed"] == shed and snap["queue_depth_peak"] <= 8
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            snap = srv.snapshot()
            if all(r["breaker"] == "CLOSED" for r in snap["replicas"]):
                break
            try:
                srv.submit({"data": rng.rand(1, 4).astype(np.float32)},
                           timeout=10)
            except pkg.serving.ServingError:
                pass
            time.sleep(0.05)
        assert all(r["breaker"] == "CLOSED" for r in snap["replicas"]), snap
        x = rng.rand(1, 4).astype(np.float32)
        np.testing.assert_allclose(srv.submit({"data": x}, timeout=30)[0],
                                   x @ wn.T, rtol=1e-5, atol=ATOL)
        assert srv.snapshot()["state"] == "SERVING"
    finally:
        srv.drain(timeout=30)


# ---------------------------------------------------------------------------
# lifecycle: drain, reload, replicas, SIGTERM
# ---------------------------------------------------------------------------
def test_drain_completes_admitted_rejects_new():
    def scenario(pkg):
        srv, _ = _server(pkg, max_queue=64, max_wait_ms=20)
        rng = np.random.RandomState(12)
        with pkg.chaos.inject("slow_replica@0") as plan:
            # the 10 queue behind a stalled request
            futs = [srv.submit_async(_req(rng))]
            srv.clock.advance(1.0)
            _wait(lambda: plan.pending() == [], what="the stall")
            futs += [srv.submit_async(_req(rng)) for _ in range(10)]
            # the drain waits on the last, timer batch: move the clock
            threading.Timer(0.3, srv.clock.advance, (1.0,)).start()
            drained = srv.drain(timeout=60)
        out = [drained] + _outcomes(futs, timeout=5)
        try:
            srv.submit_async(_req(rng))
            out.append("admitted")
        except pkg.serving.Draining:
            out.append("Draining")
        out.append(srv.state)
        return out, srv.snapshot()

    out, stats, _ = _run(scenario)
    assert out == [True] + ["ok"] * 11 + ["Draining", "STOPPED"]
    assert stats["rejected_draining"] == 1 and stats["queue_depth_peak"] == 10


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_drain_timeout_rejects_unresolved_typed(pkg):
    """drain(timeout) expiring with work in flight leaves no future
    unresolved: the survivors get a typed Draining (real clock)."""
    srv, _ = _server(pkg, sim=False, max_wait_ms=1)
    with pkg.chaos.inject("slow_replica@0"):
        fut = srv.submit_async(_req(np.random.RandomState(23)))
        time.sleep(0.05)                 # dispatched and stalled ~250ms
        assert srv.drain(timeout=0.1) is False
        with pytest.raises(pkg.serving.Draining):
            fut.result(timeout=5)
    assert srv.state == "STOPPED"


def test_reload_refreshes_input_names_and_hot_swaps():
    """reload() to a model with other input names validates admissions
    against the new names; reload(params=) swaps the weights atomically
    and retires the old replicas."""
    def scenario(pkg):
        srv, w1 = _server(pkg)
        rng = np.random.RandomState(24)
        x = rng.rand(1, 4).astype(np.float32)
        got = []
        try:
            def ask(feed):
                fut = srv.submit_async(feed)
                srv.clock.advance(1.0)
                return fut.result(timeout=30)[0]

            got.append(ask({"data": x}))
            _, params2, w2 = _fc_model(pkg, seed=4)
            srv.reload(params=params2)
            got.append(ask({"data": x}))
            np.testing.assert_allclose(got[-1], x @ w2.T, rtol=1e-5,
                                       atol=ATOL)
            sym3, params3, w3 = _fc_model(pkg, seed=5, name="fc2",
                                          data="tokens")
            p3 = pkg.predict.Predictor(sym3, params3,
                                       input_shapes={"tokens": (1, 4)},
                                       **pkg.ctx)
            srv.reload(symbol=sym3, predictors=[p3])
            got.append(ask({"tokens": x}))
            np.testing.assert_allclose(got[-1], x @ w3.T, rtol=1e-5,
                                       atol=ATOL)
            try:
                srv.submit_async({"data": x})
                got.append("admitted")
            except ValueError:
                got.append("ValueError")
            snap = srv.snapshot()
            return ([got[-1], snap["retired_pending"]],
                    snap)
        finally:
            srv.drain(timeout=30)

    out, stats, _ = _run(scenario)
    assert out == ["ValueError", 0] and stats["reloads"] == 2


def test_add_and_remove_replica():
    def scenario(pkg):
        srv, wn = _server(pkg)
        try:
            seen = [srv.num_active_replicas()]
            seen.append(srv.add_replica())
            seen.append(srv.num_active_replicas())
            # the clone shares the parameter arrays
            a, b = (r.predictor._shared_params() for r in srv._replicas)
            seen.append(all(a[k] is b[k] for k in a))
            seen.append(srv.remove_replica())
            try:
                srv.remove_replica()
            except ValueError:
                seen.append("last")
            fut = srv.submit_async(_req(np.random.RandomState(25)))
            srv.clock.advance(1.0)
            seen += _outcomes([fut])
            return seen, srv.snapshot()
        finally:
            srv.drain(timeout=30)

    out, stats, _ = _run(scenario)
    assert out == [1, 1, 2, True, 1, "last", "ok"]
    assert stats["replicas_added"] == stats["replicas_removed"] == 1


def test_sigterm_closes_admission_and_drain_completes():
    """install_preemption_drain: the first SIGTERM closes admission at
    once (typed Draining), the admitted requests complete on drain.  The
    handler's signal entry point is called directly (a test worker may
    not own the main thread that a real signal needs)."""
    def scenario(pkg):
        srv, _ = _server(pkg, max_wait_ms=20)
        rng = np.random.RandomState(26)
        handler = srv.install_preemption_drain(pkg.elastic.PreemptionHandler())
        try:
            futs = [srv.submit_async(_req(rng)) for _ in range(3)]
            handler._on_signal(signal.SIGTERM, None)
            out = [handler.requested]
            try:
                srv.submit_async(_req(rng))
                out.append("admitted")
            except pkg.serving.Draining:
                out.append("Draining")
            threading.Timer(0.05, srv.clock.advance, (1.0,)).start()
            out.append(srv.drain(timeout=30))
            out += _outcomes(futs)
            return out, srv.snapshot()
        finally:
            srv.drain(timeout=30)

    out, _, _ = _run(scenario)
    assert out == [True, "Draining", True, "ok", "ok", "ok"]


def test_every_request_carries_a_trace_id():
    """Every admitted request has a unique trace id, a begin/end pair in
    the profiler's event ring, its outcome on the end event, and the
    batch_close / execute events name it."""
    def scenario(pkg):
        pkg.prof.start()
        srv, _ = _server(pkg, max_wait_ms=10, max_batch=4)
        try:
            rng = np.random.RandomState(21)
            with pkg.chaos.inject("slow_replica@0") as plan:
                # the 8 queue behind a stalled request: two full batches
                futs = [srv.submit_async(_req(rng))]
                srv.clock.advance(1.0)
                _wait(lambda: plan.pending() == [], what="the stall")
                futs += [srv.submit_async(_req(rng)) for _ in range(8)]
                outcomes = _outcomes(futs)
        finally:
            srv.drain(timeout=30)
            pkg.prof.stop()
        ids = [f.trace_id for f in futs]
        evts = pkg.prof.recent_events(100000)
        by_id = {}
        for e in evts:
            if e.get("cat") == "serving" and e.get("ph") in ("b", "e") \
                    and e.get("id") in ids:
                by_id.setdefault(e["id"], []).append(e["ph"])
        ends = [e["args"]["outcome"] for e in evts
                if e.get("ph") == "e" and e.get("id") in ids]
        covered = set()
        for e in evts:
            if e.get("name") in ("batch_close", "serving::execute"):
                covered.update(e.get("args", {}).get("trace_ids", []))
        return [outcomes, len(set(ids)),
                all(sorted(by_id.get(t, [])) == ["b", "e"] for t in ids),
                ends, set(ids) <= covered], srv.snapshot()

    out, stats, _ = _run(scenario)
    assert out == [["ok"] * 9, 9, True, ["ok"] * 9, True]
    assert stats["batches_full"] == 2 and stats["queue_depth_peak"] == 8


def test_bench_mlp_served_bitwise_as_bare_and_burst_sheds():
    """bench.py's serving leg at a small count: the 64 -> 256 -> 8 MLP;
    sequential requests through the server equal the bare Predictor's
    outputs bit for bit and the JAX package's within ATOL; a burst of
    4 x max_queue against a stalled replica sheds exactly the overflow."""
    def model(pkg):
        mx, rng = pkg.mx, np.random.RandomState(0)
        h = mx.sym.Activation(mx.sym.FullyConnected(
            mx.sym.var("data"), mx.sym.var("fc1_weight"),
            mx.sym.var("fc1_bias"), num_hidden=256, name="fc1"),
            act_type="relu")
        sym = mx.sym.FullyConnected(h, mx.sym.var("fc2_weight"),
                                    mx.sym.var("fc2_bias"), num_hidden=8,
                                    name="fc2")
        params = {
            "arg:fc1_weight": mx.nd.array((rng.rand(256, 64) * 0.1)
                                          .astype(np.float32), **pkg.ctx),
            "arg:fc1_bias": mx.nd.zeros((256,), **pkg.ctx),
            "arg:fc2_weight": mx.nd.array((rng.rand(8, 256) * 0.1)
                                          .astype(np.float32), **pkg.ctx),
            "arg:fc2_bias": mx.nd.zeros((8,), **pkg.ctx)}
        xs = [rng.rand(1, 64).astype(np.float32) for _ in range(16)]
        return sym, params, xs

    outs = {}

    def scenario(pkg):
        sym, params, xs = model(pkg)
        bare = pkg.predict.Predictor(sym, dict(params),
                                     input_shapes={"data": (1, 64)},
                                     **pkg.ctx)
        want = [bare.forward(data=pkg.mx.nd.array(x, **pkg.ctx))[0]
                .asnumpy() for x in xs]
        srv = pkg.serving.ModelServer(
            sym, dict(params), input_shapes={"data": (1, 64)},
            max_queue=32, max_batch=8, max_wait_ms=0, deadline_ms=30_000,
            clock=pkg.clock.SimClock(start=100.0), **pkg.ctx)
        try:
            got = [srv.submit({"data": xs[i % 16]})[0] for i in range(32)]
            same = all(np.array_equal(g, want[i % 16])
                       for i, g in enumerate(got))
            outs[pkg.name] = np.stack(got)
            with pkg.chaos.inject("slow_replica@32") as plan:
                futs = [srv.submit_async({"data": xs[0]})]
                _wait(lambda: plan.pending() == [], what="the stall")
                shed = 0
                for i in range(4 * 32):
                    try:
                        futs.append(srv.submit_async({"data": xs[i % 16]}))
                    except pkg.serving.Overloaded:
                        shed += 1
                outcomes = _outcomes(futs)
            return [same, shed, outcomes.count("ok")], srv.snapshot()
        finally:
            srv.drain(timeout=30)

    (same, shed, ok), stats, _ = _run(scenario)
    assert same and shed == 96 and ok == 33
    assert stats["queue_depth_peak"] == 32
    np.testing.assert_allclose(outs["torch"], outs["jax"], atol=ATOL,
                               rtol=1e-6)


def test_chaos_serving_fault_kinds():
    for chaos in (jchaos, tchaos):
        for kind in ("slow_replica", "replica_crash", "request_burst"):
            assert kind in chaos.FAULT_KINDS
        assert chaos.slow_replica(0) == 0.0
        chaos.replica_crash(0)
        assert chaos.request_burst(0) == 1
        with chaos.inject("slow_replica@1,request_burst@0") as plan:
            assert chaos.slow_replica(0) == 0.0
            assert chaos.slow_replica(1) == 0.25
            assert chaos.slow_replica(1) == 0.0
            assert chaos.request_burst(0, factor=5) == 5
            assert plan.pending() == []
        with chaos.inject("replica_crash@0"):
            with pytest.raises(chaos.InjectedReplicaCrash):
                chaos.replica_crash(0)


def test_unported_options_raise():
    sym, params, _ = _fc_model(PKGS[1])
    for kw in ({"mesh_axes": {"tp": 2}}, {"rules": []}, {"devices": [CPU]}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            tserving.ModelServer(sym, params, input_shapes={"data": (1, 4)},
                                 ctx=CPU, **kw)
    with pytest.raises(ValueError, match="symbol\\+params"):
        tserving.ModelServer(input_shapes={"data": (1, 4)}, ctx=CPU)
