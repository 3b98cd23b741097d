"""The port's serving plane against the JAX package's: telemetry, the
profiler's dispatch counters, loadgen, the brownout ladder, chaos plans,
tenancy, memory and debug bundles, the shape tracker, and the SIGTERM
drain.

Each host-only module takes the same inputs in both packages and must give
the same outputs: histogram snapshots, traces, ladders, parsed plans and
verdicts.  A ``generation_target`` replay of a loadgen trace against a port
server gives only typed outcomes, and a child process drains a server on
SIGTERM.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import subprocess_env

from mxnet_tpu import chaos as jchaos
from mxnet_tpu import loadgen as jload
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtel
from mxnet_tpu import tenancy as jten
from mxnet_tpu_torch import GenerationServer
from mxnet_tpu_torch import chaos as pchaos
from mxnet_tpu_torch import debug as pdebug
from mxnet_tpu_torch import dispatch as pdispatch
from mxnet_tpu_torch import loadgen as pload
from mxnet_tpu_torch import memory as pmem
from mxnet_tpu_torch import profiler as pprof
from mxnet_tpu_torch import serving as pserving
from mxnet_tpu_torch import telemetry as ptel
from mxnet_tpu_torch import tenancy as pten

from torch_port_serving_util import gcfg, port_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
def _observations(kind):
    rng = np.random.default_rng(11)
    return {
        "lognormal": rng.lognormal(2.0, 1.0, 500),
        "decades": 10.0 ** rng.uniform(-4, 5, 300),
        "bounds": 1e-3 * 1.25 ** np.arange(0, 60, 3.0),
        "edge": np.array([0.0, -1.0, 1e-4, np.nan, 1e12, 7.5]),
        "constant": np.full(20, 3.0),
        "empty": np.array([]),
    }[kind]


@pytest.mark.parametrize("kind", ["lognormal", "decades", "bounds", "edge",
                                  "constant", "empty"])
def test_histogram_snapshot_matches_jax(kind):
    jh, ph = jtel.Histogram("h"), ptel.Histogram("h")
    for v in _observations(kind):
        jh.observe(v)
        ph.observe(v)
    assert ph.snapshot() == jh.snapshot()
    for q in (0, 1, 25, 50, 90, 99, 100):
        assert ph.percentile(q) == jh.percentile(q)


def test_registry_snapshot_and_prometheus_match_jax():
    regs = (jtel.MetricsRegistry(), ptel.MetricsRegistry())
    for reg in regs:
        reg.counter("dispatch.gen_tokens").inc(7)
        reg.counter("dispatch.recompile").inc()
        reg.gauge("gen.kv_page_util").set(0.25)
        reg.gauge("serving.brownout_level").add(2)
        h = reg.histogram("gen.ttft_ms")
        for v in (1.5, 3.0, 250.0, 12.0):
            h.observe(v)
    js, ps = (r.snapshot() for r in regs)
    js.pop("ts_unix")
    ps.pop("ts_unix")
    assert ps == js
    assert regs[1].dump_prometheus() == regs[0].dump_prometheus()
    with pytest.raises(TypeError):
        regs[1].gauge("dispatch.gen_tokens")


def test_dispatch_counters_and_trace_events():
    base = pprof.dispatch_value("gen_tokens")
    pprof.dispatch_count("gen_tokens", 3)
    assert pprof.dispatch_value("gen_tokens") == base + 3
    stats = pprof.dispatch_stats()
    assert set(stats) >= {"recompile", "gen_prefills", "gen_preempted"}
    pprof.start()
    try:
        tid = ptel.new_trace_id()
        ptel.trace_begin("request", tid, cat="gen", args={"x": 1})
        ptel.trace_instant("gen.park", cat="gen")
        ptel.trace_end("request", tid, cat="gen")
    finally:
        pprof.stop()
    evts = [e for e in pprof.recent_events(50) if e.get("cat") == "gen"]
    assert [e["ph"] for e in evts[-3:]] == ["b", "i", "e"]
    assert evts[-1]["id"] == tid


def test_step_accountant_uses_h100_peaks():
    reg = ptel.MetricsRegistry()
    acc = ptel.StepAccountant("t", reg=reg).set_cost(
        {"flops": 989e12, "bytes_accessed": 3.35e12})
    acc.on_step(8)
    acc._last_t -= 1.0                  # one step in one second
    acc.on_step(8)
    g = {n: m.value for n, m in reg.find("t.")}
    assert g["t.mfu"] == pytest.approx(1.0, rel=1e-3)
    assert g["t.hbm_util"] == pytest.approx(1.0, rel=1e-3)


def test_serving_future_trace_and_latency_histograms():
    reg = ptel.registry()
    n_ok = reg.histogram("serving.latency_ms").count
    n_rej = reg.histogram("serving.rejected_latency_ms").count
    f1 = pserving.ServingFuture({}, 1, deadline=1e9, t_admit=0.0)
    f2 = pserving.StreamingFuture({}, 1, deadline=1e9, t_admit=0.0)
    assert f1.trace_id != f2.trace_id
    assert f1._resolve([1]) and not f1._reject(pserving.Overloaded("x"))
    assert f2._reject(pserving.QuotaExceeded("q"))
    assert reg.histogram("serving.latency_ms").count == n_ok + 1
    assert reg.histogram("serving.rejected_latency_ms").count == n_rej + 1
    err = pserving.StreamMigrated("parked", handle="kvm-1")
    assert err.handle == "kvm-1" and isinstance(err, pserving.ServingError)


# ---------------------------------------------------------------------------
# loadgen
# ---------------------------------------------------------------------------
SPECS = {
    "poisson": dict(seed=3),
    "mmpp": dict(seed=4, arrival="mmpp", burst_factor=3.0,
                 burst_dwell_s=0.5,
                 segments=[{"duration_s": 4.0, "rate_rps": 20.0},
                           {"duration_s": 3.0, "rate_rps": 5.0}]),
    "tenants": dict(seed=5, tenants=[{"name": "gold", "weight": 4},
                                     {"name": "free", "weight": 2},
                                     {"name": "bulk", "weight": 1}],
                    deadline_classes=[
                        {"name": "tight", "deadline_ms": 200, "weight": 1},
                        {"name": "loose", "deadline_ms": 8000,
                         "weight": 3}]),
    "prefix": dict(seed=6, prefix_groups=3, prefix_hit_rate=0.5,
                   session_count=4, prompt_len_mean=128,
                   prompt_len_max=1024, output_len_mean=32,
                   output_len_max=64),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_generate_trace_matches_jax(name):
    want = jload.generate_trace(jload.TraceSpec(**SPECS[name]))
    got = pload.generate_trace(pload.TraceSpec(**SPECS[name]))
    assert got == want and len(got) > 5
    for req in got[:10]:
        assert np.array_equal(pload.prompt_tokens(req, vocab=97, seed=2),
                              jload.prompt_tokens(req, vocab=97, seed=2))


def test_trace_jsonl_crosses_packages(tmp_path):
    spec = jload.TraceSpec(**SPECS["tenants"])
    trace = jload.generate_trace(spec)
    path = str(tmp_path / "t.jsonl")
    jload.save_trace(path, trace, spec)
    got, pspec = pload.load_trace(path)
    assert got == trace and pspec.as_dict() == spec.as_dict()


def test_report_summary_and_knee_match_jax():
    trace = jload.generate_trace(jload.TraceSpec(**SPECS["tenants"]))
    outcomes = ["ok", "Overloaded", "ok", "QuotaExceeded", "ok",
                "DeadlineExceeded"]
    recs = [jload._outcome_record(r, outcomes[i % len(outcomes)],
                                  latency_ms=10.0 + i, ttft_ms=1.0 + i,
                                  tokens=i % 7)
            for i, r in enumerate(trace)]
    jr = jload.ReplayReport(recs, wall_s=3.0)
    pr = pload.ReplayReport(recs, wall_s=3.0)
    assert pr.summary() == jr.summary()
    assert pr.curve() == jr.curve()
    assert pload.shed_knee(pr.curve()) == jload.shed_knee(jr.curve())


def test_generation_target_replay_gives_typed_outcomes():
    """A trace at several times what a tiny server with a short queue
    takes: every record is one typed outcome, some ok and some shed."""
    srv = GenerationServer(port_model(), gcfg(max_new_tokens=8),
                           device="cpu", max_queue=2)
    try:
        spec = pload.TraceSpec(seed=9, segments=[{"duration_s": 1.0,
                                                   "rate_rps": 60.0}],
                               prompt_len_mean=6, prompt_len_max=20,
                               output_len_mean=4, output_len_max=8,
                               deadline_classes=[{"name": "d",
                                                  "deadline_ms": 5000,
                                                  "weight": 1}])
        trace = pload.generate_trace(spec)
        rep = pload.replay(trace, pload.generation_target(srv, seed=1),
                           speed=4.0)
        counts = rep.outcome_counts()
        assert sum(counts.values()) == len(trace)
        assert set(counts) <= set(pload.TYPED_OUTCOMES), counts
        assert counts.get("ok", 0) >= 1 and counts.get("Overloaded", 0) >= 1
        ok = [r for r in rep.records if r["outcome"] == "ok"]
        assert all(r["tokens"] == trace[r["i"]]["max_new_tokens"]
                   for r in ok)
        assert rep.summary()["loadreplay_goodput_per_sec"] > 0
    finally:
        srv.drain(timeout=30)
    assert srv.engine.allocator.used == 0


def test_tenant_flood_replay_adds_ghosts():
    calls = []

    def target(req):
        calls.append(req)
        return pload._outcome_record(req, "ok")

    trace = pload.generate_trace(pload.TraceSpec(**SPECS["tenants"]))
    with pchaos.inject("tenant_flood@2") as plan:
        rep = pload.replay(trace[:6], target, speed=float("inf"))
    assert plan.pending() == []
    assert len(rep.records) == 6 + 7
    assert sum(1 for r in calls if r.get("ghost")) == 7


# ---------------------------------------------------------------------------
# brownout ladder, chaos plans, tenancy
# ---------------------------------------------------------------------------
def test_brownout_ladder_matches_jax():
    signals = [True] * 11 + [False, True] + [False] * 12 + [True] * 2
    levels = []
    for mod in (jserving, pserving):
        bo = mod.BrownoutController(engage_ticks=2, recover_ticks=2,
                                    cap_tokens=8, min_rank=1)
        seq = []
        for s in signals:
            lvl = bo.observe(s)
            seq.append((lvl, bo.mode, bo.cap_max_new(64),
                        bo.hedging_disabled(), bo.admits(0), bo.admits(1)))
        levels.append(seq)
        bo.reset()
    assert levels[1] == levels[0]
    assert max(lv for lv, *_ in levels[1]) == 3
    assert ptel.registry().gauge("serving.brownout_level").value == 0


PLANS = ["", "seed=7,page_pressure@3", "tenant_flood@0, request_burst@2",
         "nan_grad@3,kv_drop@5,ckpt_bitflip@1,loader_raise@0",
         "drain_migrate@1,migrate_interrupt@4,worker_kill_mid_decode@2,"
         "adapter_swap_mid_burst@0,seed=3",
         "bogus@1", "page_pressure", "page_pressure@x"]


@pytest.mark.parametrize("spec", PLANS)
def test_chaos_plan_parsing_matches_jax(spec):
    try:
        want = jchaos.ChaosPlan(spec)
    except ValueError:
        with pytest.raises(ValueError):
            pchaos.ChaosPlan(spec)
        return
    got = pchaos.ChaosPlan(spec)
    assert (got.seed, got.kinds, got.pending()) == \
        (want.seed, want.kinds, want.pending())
    for kind, step in want.pending():
        assert got.fire(kind, step) and want.fire(kind, step)
        assert not got.fire(kind, step)
    assert got.pending() == want.pending() == []


def test_chaos_fault_kinds_and_hooks():
    assert pchaos.FAULT_KINDS == jchaos.FAULT_KINDS
    assert pchaos.page_pressure(0) == 0.0              # inert without a plan
    with pchaos.inject("page_pressure@2,tenant_flood@1,request_burst@0,"
                       "worker_kill_mid_decode@0,adapter_swap_mid_burst@0"):
        assert pchaos.page_pressure(1) == 0.0
        assert pchaos.page_pressure(2) == pytest.approx(0.9)
        assert pchaos.page_pressure(2) == 0.0
        assert pchaos.tenant_flood(1) == 8 and pchaos.request_burst(0) == 8
        assert pchaos.worker_kill_mid_decode(0, 0) is False
        assert pchaos.worker_kill_mid_decode(0, 1) is True
        assert pchaos.adapter_swap_mid_burst(0, 0) is False
        assert pchaos.adapter_swap_mid_burst(0, 1) is True
        with pytest.raises(RuntimeError):
            pchaos.inject("page_pressure@9").__enter__()


TENANTS = ["", None, "gold", "a.b-c_9", " padded ", "x" * 64, "x" * 65,
           "bad tenant", "caf\xe9", "<script>", "a/b", "\x00"]


@pytest.mark.parametrize("value", TENANTS,
                         ids=[repr(v)[:16] for v in TENANTS])
def test_parse_tenant_matches_jax(value):
    try:
        want = jten.parse_tenant(value)
    except ValueError:
        with pytest.raises(ValueError):
            pten.parse_tenant(value)
        return
    assert pten.parse_tenant(value) == want


def test_governor_verdicts_match_jax():
    quotas = "gold:rate=50,burst=100,weight=4,exempt;bulk:rate=1,burst=2"
    govs = (jten.TenantGovernor(quotas=quotas),
            pten.TenantGovernor(quotas=quotas))
    calls = [("bulk", 0.0, 0, 8, 0, ()), ("bulk", 0.1, 0, 8, 0, ()),
             ("bulk", 0.2, 0, 8, 0, ()), ("bulk", 1.5, 0, 8, 0, ()),
             ("anon", 1.5, 6, 8, 5, ("anon", "gold")),
             ("gold", 1.6, 6, 8, 1, ("anon", "gold")),
             ("anon", 1.6, 2, 8, 2, ("anon",))]
    verdicts = []
    for gov in govs:
        out = []
        for t, now, qlen, qcap, tp, qt in calls:
            try:
                out.append(gov.check(t, now, queue_len=qlen, queue_cap=qcap,
                                     tenant_pending=tp,
                                     queue_tenants=qt).as_dict())
            except Exception as e:
                out.append(type(e).__name__)
        out.append(gov.snapshot())
        out.append((gov.exempt("gold"), gov.exempt("bulk")))
        verdicts.append(out)
    assert verdicts[1] == verdicts[0]
    assert "QuotaExceeded" in verdicts[1]


# ---------------------------------------------------------------------------
# memory, debug bundles, the shape tracker
# ---------------------------------------------------------------------------
def test_memory_tags_and_debug_bundle(tmp_path, monkeypatch):
    srv = GenerationServer(port_model(), gcfg(), device="cpu")
    try:
        snap = pmem.update()
        eng = srv.engine
        kv = 2 * eng.k_pages.numel() * eng.k_pages.element_size()
        assert snap["tags"]["kv_pages"] >= kv
        assert snap["tags"]["params"] > 0
        assert snap["devices"]["cpu"]["source"] == "fallback"
        assert ptel.registry().gauge("mem.tag.kv_pages.bytes").value >= kv
        monkeypatch.setenv("MXTPU_DEBUG_BUNDLE_DIR", str(tmp_path))
        path = pdebug.write_bundle("test", extra={"why": "test"}, force=True)
        assert path is not None
        with open(path) as f:
            bundle = json.load(f)
        assert bundle["sections"]["generation"]["state"] == "SERVING"
        assert bundle["dispatch"]["recompile"] >= 1
        assert bundle["recompiles"] and bundle["extra"] == {"why": "test"}
    finally:
        srv.drain(timeout=10)


def test_shape_tracker_counts_like_tracked_jit():
    t = pdispatch.ShapeTracker("probe")
    r0, h0 = (pprof.dispatch_value(k) for k in ("recompile", "jit_cache_hit"))
    a, b = np.zeros((1, 8), np.int64), np.zeros((1, 16), np.int64)
    assert t.note(a, 3) is True
    assert t.note(np.ones((1, 8), np.int64), 5) is False
    assert t.note(b, 3) is True
    assert t.note(a.astype(np.int32), 3) is True
    assert pprof.dispatch_value("recompile") == r0 + 3
    assert pprof.dispatch_value("jit_cache_hit") == h0 + 1
    ring = [e for e in pdispatch.recompile_ring() if e["fn"] == "probe"]
    assert [e["kind"] for e in ring] == ["initial", "retrace", "retrace"]
    assert "probe retrace #3" in pdispatch.explain_recompiles()
    assert pdispatch.pow2_chain(6) == (1, 2, 4, 6)
    assert pdispatch.bucket_size(5, "pow2") == 8
    assert pdispatch.bucket_size(5, "4,16") == 16


# ---------------------------------------------------------------------------
# the SIGTERM drain
# ---------------------------------------------------------------------------
_DRAIN_CHILD = r"""
import json, os, signal, sys, time
import numpy as np
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.serving import Draining
cfg = mt.TransformerConfig(vocab_size=97, d_model=64, n_heads=4, n_layers=2,
                           d_ff=128, max_len=64, dtype="float32")
srv = mt.GenerationServer(mt.TransformerLM(cfg, device="cpu"),
                          mt.GenerationConfig(page_size=8, max_pages=32,
                                              max_slots=4,
                                              prefill_buckets="8,16,32"),
                          device="cpu")
prev = signal.getsignal(signal.SIGTERM)
handler = srv.install_preemption_drain()
futs = [srv.submit_async(np.arange(1, 6 + i), max_new_tokens=12,
                         on_token=lambda t: time.sleep(0.005))
        for i in range(3)]
os.kill(os.getpid(), signal.SIGTERM)
deadline = time.monotonic() + 10
while not handler.requested and time.monotonic() < deadline:
    time.sleep(0.01)
try:
    srv.submit_async(np.arange(1, 5))
    rejected = False
except Draining:
    rejected = True
lens = [len(f.result(timeout=60)) for f in futs]
drained = srv.drain(timeout=30)
handler.uninstall()
print(json.dumps({"requested": handler.requested, "rejected": rejected,
                  "lens": lens, "drained": drained,
                  "restored": signal.getsignal(signal.SIGTERM) == prev,
                  "state": srv.state,
                  "pages": srv.engine.allocator.used}))
"""


def test_sigterm_drain_in_subprocess():
    proc = subprocess.run([sys.executable, "-c", _DRAIN_CHILD],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO, env=subprocess_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"requested": True, "rejected": True, "lens": [12] * 3,
                   "drained": True, "restored": True, "state": "STOPPED",
                   "pages": 0}
