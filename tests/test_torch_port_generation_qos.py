"""QoS, tenancy, chaos and the weight swap of the port's GenerationServer
against the JAX package's.

The same f32 weights and the same numpy prompts go through both servers.
Each scenario queues every request while the schedulers are held
(``gated``), so both packages run the same scheduler turns in the same
order: the streams, the ``preempted`` / ``shed_*`` stats and the deltas of
the dispatch counters (each package's own registry) must be equal.  At f32
the two packages' logits agree within 1e-5, far inside the gaps between
the top logits of these prompts, and sampling is host-side f64 numpy in
both, so greedy and seeded streams are the same tokens.
"""
import numpy as np
import pytest

from mxnet_tpu import chaos as jchaos
from mxnet_tpu import clock as jclock
from mxnet_tpu import generation as jgen
from mxnet_tpu import profiler as jprof
from mxnet_tpu import serving as jserving
from mxnet_tpu import tenancy as jten
from mxnet_tpu_torch import GenerationServer
from mxnet_tpu_torch import chaos as pchaos
from mxnet_tpu_torch import clock as pclock
from mxnet_tpu_torch import generation as pgen
from mxnet_tpu_torch import profiler as pprof
from mxnet_tpu_torch import serving as pserving
from mxnet_tpu_torch import tenancy as pten

from torch_port_serving_util import (gated, gcfg, jax_model, np_params,
                                     outcome, port_model, prompts, wait)

COUNTERS = ("gen_prefills", "gen_decode_iters", "gen_tokens",
            "gen_preempted", "gen_resumed", "gen_pages_shed",
            "requests_admitted", "requests_shed", "gen_quota_shed",
            "gen_brownout_shed", "faults_injected", "recompile",
            "jit_cache_miss")
STATS = ("admitted", "ok", "preempted", "resumed", "shed_pages",
         "shed_queue", "shed_quota", "shed_brownout", "deadline_exceeded")


@pytest.fixture(autouse=True)
def _fresh_globals():
    """The brownout ladder and the tenant governor are process-global in
    each package: start and leave every test at level 0, default quotas."""
    for mod in (jserving, pserving):
        mod.brownout().reset()
    jten.reset_governor()
    pten.reset_governor()
    yield
    for mod in (jserving, pserving):
        mod.brownout().reset()
    jten.reset_governor()
    pten.reset_governor()


def _servers(clock=False, max_queue=None, **kw):
    jm, params = jax_model()
    jkw = {"clock": jclock.SimClock()} if clock else {}
    pkw = {"clock": pclock.SimClock()} if clock else {}
    jsrv = jgen.GenerationServer(jm, params, gcfg(jax_side=True, **kw),
                                 max_queue=max_queue, **jkw)
    psrv = GenerationServer(port_model(), gcfg(**kw), device="cpu",
                            max_queue=max_queue, **pkw)
    return jsrv, psrv


def _counters(prof):
    return {k: prof.dispatch_value(k) for k in COUNTERS}


def _delta(before, after):
    return {k: after[k] - before[k] for k in before}


def _stats(srv):
    s = srv.snapshot()["stats"]
    return {k: s[k] for k in STATS}


def _run_both(jsrv, psrv, submit):
    """``submit(srv)`` -> list of futures (or typed admission errors),
    queued with the scheduler held; returns per package (outcomes, stats,
    counter deltas)."""
    out = []
    for srv, prof in ((jsrv, jprof), (psrv, pprof)):
        before = _counters(prof)
        with gated(srv):
            futs = submit(srv)
        outs = [f if isinstance(f, tuple) else outcome(f) for f in futs]
        out.append((outs, _stats(srv), _delta(before, _counters(prof))))
    return out


# ---------------------------------------------------------------------------
# parse_priority: the JAX package's table of shapes, and hostile values
# ---------------------------------------------------------------------------
PRIORITY_VALUES = [
    None, 0, 2, -3, np.int64(5), "interactive=2", "3", "batch", "batch=junk",
    "gold=3", "7", "x" * 300, "gold=abc", "gold=" + "9" * 20, "gold=1e9",
    "<script>=1", "a b=2", "x" * 33 + "=3", "=", "==", "=1=2", "\x00",
    "caf\xe9=1", " ", "-" * 256, "a=" + "\xff" * 10, "9" * 256, "--3",
    b"\xff\xfe".decode("latin-1"), "+4", "gold=+2", "gold=-2", "p.x-1_=8",
]


@pytest.mark.parametrize("value", PRIORITY_VALUES,
                         ids=[repr(v)[:24] for v in PRIORITY_VALUES])
def test_parse_priority_matches_jax(value):
    got = pgen.parse_priority(value)
    assert got == jgen.parse_priority(value)
    assert isinstance(got[0], str) and isinstance(got[1], int)


# ---------------------------------------------------------------------------
# QoS preemption: same streams, stats and counters as JAX
# ---------------------------------------------------------------------------
def test_preemption_matches_jax():
    """5 usable pages, three 9-token prompts of 2 pages: the high-priority
    admission preempts a rank-0 stream, which is journaled, re-prefilled
    and completes; nothing is shed."""
    jsrv, psrv = _servers(max_pages=6, max_new_tokens=6)
    try:
        p = prompts([9, 9, 9], seed=5)
        skw = dict(temperature=1.1, top_k=8, seed=77)

        def submit(srv):
            return [srv.submit_async(p[0], max_new_tokens=6,
                                     temperature=0.0, priority="batch=0"),
                    srv.submit_async(p[1], max_new_tokens=6, priority=0,
                                     **skw),
                    srv.submit_async(p[2], max_new_tokens=6,
                                     temperature=0.0,
                                     priority="interactive=2")]

        (jo, js, jc), (po, ps, pc) = _run_both(jsrv, psrv, submit)
        assert po == jo
        assert all(k == "ok" and len(t) == 6 for k, t in po)
        assert ps == js and pc == jc
        assert ps["preempted"] >= 1 and ps["shed_pages"] == 0
        assert pc["gen_preempted"] == ps["preempted"]
        assert pc["gen_pages_shed"] == 0 and pc["recompile"] == 0
        assert psrv.engine.allocator.used == 0
        # preemption perturbed nothing: each stream equals an uncontended run
        assert po[0][1] == psrv.submit(p[0], max_new_tokens=6,
                                       temperature=0.0, timeout=60)
        assert po[1][1] == psrv.submit(p[1], max_new_tokens=6, timeout=60,
                                       **skw)
    finally:
        jsrv.drain(timeout=10)
        psrv.drain(timeout=10)


def test_same_or_higher_priority_sheds_like_jax():
    """The low-rank admission finds no lower-rank victim: it is shed with
    a typed Overloaded in both packages, and nothing is preempted."""
    jsrv, psrv = _servers(max_pages=6, max_new_tokens=6)
    try:
        p = prompts([9, 9, 9], seed=5)

        def submit(srv):
            return [srv.submit_async(x, max_new_tokens=6, temperature=0.0,
                                     priority="interactive=2")
                    for x in p[:2]] + [
                srv.submit_async(p[2], max_new_tokens=6, temperature=0.0,
                                 priority="batch=0")]

        (jo, js, jc), (po, ps, pc) = _run_both(jsrv, psrv, submit)
        assert po == jo and ps == js and pc == jc
        assert ps["preempted"] == 0
        assert [k for k, _ in po] == ["ok", "ok", "Overloaded"]
        assert pc["gen_pages_shed"] == 1
    finally:
        jsrv.drain(timeout=10)
        psrv.drain(timeout=10)


def test_page_pressure_chaos_matches_jax():
    """``page_pressure`` impounds most of the free list on a chosen turn:
    the high-priority admission preempts the low stream, which waits out
    the window and completes; nothing is shed.  Turns are counted, so both
    packages fire on the same one."""
    jsrv, psrv = _servers(max_pages=8, max_new_tokens=10)
    try:
        res = []
        for srv, prof, chaos in ((jsrv, jprof, jchaos),
                                 (psrv, pprof, pchaos)):
            before = _counters(prof)
            with gated(srv):
                spec = "page_pressure@%d" % (srv._loop_turn + 2)
                low = srv.submit_async(prompts([9])[0], max_new_tokens=10,
                                       temperature=0.0, priority="batch=0")
                high = srv.submit_async(prompts([9], seed=9)[0],
                                        max_new_tokens=4, temperature=0.0,
                                        priority="interactive=2")
                ctx = chaos.inject(spec)
                plan = ctx.__enter__()
            try:
                outs = [outcome(high), outcome(low, timeout=120)]
            finally:
                ctx.__exit__(None, None, None)
            assert plan.pending() == []
            res.append((outs, _stats(srv),
                        _delta(before, _counters(prof))))
        assert res[1] == res[0]
        outs, stats, counters = res[1]
        assert [k for k, _ in outs] == ["ok", "ok"]
        assert [len(t) for _, t in outs] == [4, 10]
        assert stats["preempted"] >= 1 and stats["shed_pages"] == 0
        assert counters["faults_injected"] == 1
        for srv in (jsrv, psrv):              # the window ends, pages return
            wait(lambda srv=srv: srv.engine.allocator.held == 0,
                 msg="pressure window to release")
    finally:
        jsrv.drain(timeout=10)
        psrv.drain(timeout=10)


def test_allocator_impound_matches_jax():
    for frac in (-0.5, 0.0, 0.3, 0.5, 0.9, 1.0, 1.7):
        ja, pa = jgen.PageAllocator(11), pgen.PageAllocator(11)
        for a in (ja, pa):
            a.alloc(3)
        assert pa.impound(frac) == ja.impound(frac)
        assert (pa.held, pa.used, pa.min_free()) == \
            (ja.held, ja.used, ja.min_free())
        assert pa.impound(0.5) == ja.impound(0.5)
        assert pa.release() == ja.release()
        assert pa.release() == ja.release() == 0
        assert (pa.used, pa.peak_util) == (ja.used, ja.peak_util)


# ---------------------------------------------------------------------------
# tenancy and brownout at admission
# ---------------------------------------------------------------------------
QUOTAS = "gold:weight=4,exempt;free:weight=2;bulk:rate=2,burst=2,weight=1"


def test_tenant_admission_and_quota_sheds_match_jax():
    """A frozen clock (no bucket refill) and a held scheduler: bulk's
    bucket empties after two admissions, and once the queue is contended
    each tenant holds its weighted-fair share.  Every request's typed
    outcome, the stats and the counters match."""
    jten.reset_governor(jten.TenantGovernor(quotas=QUOTAS))
    pten.reset_governor(pten.TenantGovernor(quotas=QUOTAS))
    jsrv, psrv = _servers(clock=True, max_queue=8, max_new_tokens=3)
    try:
        order = ["bulk", "free", "bulk", "gold", "bulk", "free", "free",
                 "free", "gold", "free", "bulk", "gold", "gold", "anon"]
        p = prompts([5] * len(order), seed=3)

        def submit(srv):
            out = []
            for x, t in zip(p, order):
                try:
                    out.append(srv.submit_async(x, max_new_tokens=3,
                                                tenant=t))
                except Exception as e:          # typed admission errors
                    out.append((type(e).__name__, []))
            return out

        (jo, js, jc), (po, ps, pc) = _run_both(jsrv, psrv, submit)
        assert po == jo and ps == js and pc == jc
        kinds = [k for k, _ in po]
        assert "QuotaExceeded" in kinds and "ok" in kinds
        assert ps["shed_quota"] == kinds.count("QuotaExceeded")
        assert jten.governor().snapshot() == pten.governor().snapshot()
        for t in ("bulk", "free", "gold"):
            name = "gen.shed_by_tenant." + t
            assert pprof.dispatch_value(name) == jprof.dispatch_value(name)
    finally:
        jsrv.drain(timeout=10)
        psrv.drain(timeout=10)


def test_brownout_caps_and_gates_like_jax():
    """Level 3 sheds rank 0 with a typed Overloaded, caps max_new_tokens,
    and exempts an exempt tenant from both."""
    jten.reset_governor(jten.TenantGovernor(quotas=QUOTAS))
    pten.reset_governor(pten.TenantGovernor(quotas=QUOTAS))
    jsrv, psrv = _servers(max_new_tokens=40, max_pages=64)
    try:
        for mod in (jserving, pserving):
            bo = mod.brownout()
            for _ in range(3 * bo.engage_ticks):
                bo.observe(True)
            assert bo.level == 3
        p = prompts([5, 4, 6], seed=11)

        def submit(srv):
            out = []
            for x, kw in ((p[0], {}), (p[1], {"priority": "interactive=1"}),
                          (p[2], {"tenant": "gold"})):
                try:
                    out.append(srv.submit_async(x, max_new_tokens=40,
                                                temperature=0.0, **kw))
                except Exception as e:
                    out.append((type(e).__name__, []))
            return out

        (jo, js, jc), (po, ps, pc) = _run_both(jsrv, psrv, submit)
        assert po == jo and ps == js and pc == jc
        assert po[0][0] == "Overloaded"
        assert len(po[1][1]) == pserving.brownout().cap_tokens
        assert len(po[2][1]) == 40             # exempt: not capped
        assert ps["shed_brownout"] == 1
    finally:
        jsrv.drain(timeout=10)
        psrv.drain(timeout=10)


# ---------------------------------------------------------------------------
# swap_params and the recompile counter
# ---------------------------------------------------------------------------
def _perturbed(seed=3):
    rng = np.random.RandomState(seed)
    return {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(v.dtype)
            for k, v in np_params().items()}


def test_swap_params_stream_equality():
    """After a swap mid-life, a stream equals a fresh server's on the new
    weights, and the JAX server's after the same swap; the recompile
    counter does not move."""
    import jax.numpy as jnp

    new = _perturbed()
    jsrv, psrv = _servers()
    fresh = GenerationServer(port_model(params=new), gcfg(), device="cpu")
    try:
        p = prompts([7], seed=19)[0]
        before = psrv.submit(p, max_new_tokens=8, timeout=60)
        assert before == jsrv.submit(p, max_new_tokens=8, timeout=60)
        r0 = pprof.dispatch_value("recompile")
        s0 = pprof.dispatch_value("gen_adapter_swaps")
        assert psrv.swap_params(new) is True
        jsrv.swap_params({k: jnp.asarray(v) for k, v in new.items()})
        after = psrv.submit(p, max_new_tokens=8, timeout=60)
        assert after == fresh.submit(p, max_new_tokens=8, timeout=60)
        assert after == jsrv.submit(p, max_new_tokens=8, timeout=60)
        assert after != before
        assert pprof.dispatch_value("recompile") == r0
        assert pprof.dispatch_value("gen_adapter_swaps") == s0 + 1
        # the module's own weights are untouched
        assert np.array_equal(
            psrv.engine.model.embed.detach().numpy(), np_params()["embed"])
    finally:
        for s in (jsrv, psrv, fresh):
            s.drain(timeout=10)


def test_swap_params_rejects_mismatch():
    psrv = GenerationServer(port_model(), gcfg(), device="cpu")
    try:
        new = np_params()
        bad_shape = dict(new, embed=new["embed"][:-1])
        bad_dtype = dict(new, embed=new["embed"].astype(np.float64))
        missing = {k: v for k, v in new.items() if k != "embed"}
        for bad in (bad_shape, bad_dtype, missing):
            with pytest.raises(ValueError):
                psrv.swap_params(bad)
    finally:
        psrv.drain(timeout=10)


def test_recompile_delta_after_warm_is_zero_like_jax():
    """Join/leave churn on a warmed server meets only warmed bucket
    shapes: neither package's recompile counter moves."""
    jsrv, psrv = _servers()
    try:
        p = prompts([4, 11, 6, 2, 9, 13, 5, 8], seed=3)
        for srv, prof in ((jsrv, jprof), (psrv, pprof)):
            base = prof.dispatch_value("recompile")
            futs = [srv.submit_async(x, max_new_tokens=3 + (i % 5))
                    for i, x in enumerate(p)]
            for f in futs:
                f.result(timeout=60)
            assert prof.dispatch_value("recompile") == base
        # warmup itself counted one signature per bucket, as JAX traces
        n = len(psrv.engine.prefill_chain) + len(psrv.engine.slot_chain)
        assert psrv.engine._prefill_track.signatures \
            + psrv.engine._decode_track.signatures == n
    finally:
        jsrv.drain(timeout=10)
        psrv.drain(timeout=10)


def test_unwarmed_bucket_counts_a_recompile():
    psrv = GenerationServer(port_model(), gcfg(), device="cpu", warm=False)
    try:
        base = pprof.dispatch_value("recompile")
        psrv.submit(prompts([5])[0], max_new_tokens=3, timeout=60)
        # one prefill bucket (8) and one decode bucket (1), once each
        assert pprof.dispatch_value("recompile") == base + 2
        psrv.submit(prompts([6])[0], max_new_tokens=3, timeout=60)
        assert pprof.dispatch_value("recompile") == base + 2
    finally:
        psrv.drain(timeout=10)
