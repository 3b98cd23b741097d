"""The port's numerical-health sentinel against the JAX package's, on the
CPU: ``sentinel``, ``optimizer.DynamicLossScaler``, ``monitor``, the chaos
training hooks, and the guard of ``FusedTrainStep`` and ``Trainer``.

The cases of ``tests/test_chaos.py`` that concern the sentinel run through
both packages.  Both build the same small net (conv 8, BatchNorm, relu,
global pool, dense 10) under one explicit prefix; the JAX net is
initialized from a seed and its parameters go into the port's net as
numpy.  The same chaos plan then runs through both packages' fused step
or Trainer: the sentinel's events and actions, the chaos hooks' choices
(the element ``poison_grad`` poisons, the bit ``flip_param_bit`` flips)
and the counters must be equal, the losses within ``LOSS_TOL`` and the
parameters within ``PARAM_TOL`` relative and ``PARAM_ATOL`` absolute
(f32 on both sides, a few steps; the absolute term covers the conv bias
ahead of BatchNorm, whose gradient cancels to ~1e-7 in both packages);
containment is bitwise inside each package.  The port's guarded
finite step is held bitwise to its unguarded step, and the step
accountants' gauges are checked.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu import chaos as jchaos
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import monitor as jmonitor
from mxnet_tpu import profiler as jprof
from mxnet_tpu import sentinel as jsent
from mxnet_tpu.gluon.contrib import FusedTrainStep as JFused
from mxnet_tpu.optimizer import DynamicLossScaler as JScaler
from mxnet_tpu_torch import chaos as tchaos
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import monitor as tmonitor
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch import sentinel as tsent
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.gluon.contrib import FusedTrainStep as TFused
from mxnet_tpu_torch.optimizer import DynamicLossScaler as TScaler

CPU = mt.cpu()
LOSS_TOL = 1e-5
PARAM_TOL = 1e-5
PARAM_ATOL = 1e-6
J = dict(name="jax", mx=jmx, gluon=jgluon, chaos=jchaos, prof=jprof,
         sent=jsent, fused=JFused, scaler=JScaler, monitor=jmonitor)
T = dict(name="torch", mx=mt, gluon=tgluon, chaos=tchaos, prof=tprof,
         sent=tsent, fused=TFused, scaler=TScaler, monitor=tmonitor)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's ops here are small: on one thread they do not contend
    with the other test processes that share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(pkg, prefix):
    g = pkg["gluon"]
    net = g.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(g.nn.Conv2D(8, 3, padding=1))
        net.add(g.nn.BatchNorm())
        net.add(g.nn.Activation("relu"))
        net.add(g.nn.GlobalAvgPool2D())
        net.add(g.nn.Dense(10))
    return net


def _data():
    rng = np.random.RandomState(0)
    return (rng.rand(4, 3, 8, 8).astype(np.float32),
            rng.randint(0, 10, (4,)).astype(np.float32))


def _nets(seed, prefix="s_"):
    """The JAX net initialized from ``seed`` and the port's net carrying
    its parameters; with each package's (x, y)."""
    xn, yn = _data()
    np.random.seed(seed)
    jmx.random.seed(seed)
    jn = _build(J, prefix)
    jn.initialize(jmx.init.Xavier())
    jx, jy = jmx.nd.array(xn), jmx.nd.array(yn)
    jn(jx)
    weights = {k: v.data().asnumpy() for k, v in
               jn.collect_params().items()}
    tn = _build(T, prefix)
    tn.initialize(mt.init.Xavier(), ctx=CPU)
    tx, ty = mt.nd.array(xn, ctx=CPU), mt.nd.array(yn, ctx=CPU)
    with mt.autograd.pause():
        tn(tx)
    tn.load_dict(weights, ctx=CPU)
    return {"jax": (jn, jx, jy), "torch": (tn, tx, ty)}


def _host(net):
    return {n: p.list_data()[0].asnumpy().copy()
            for n, p in net.collect_params().items()}


def _delta(prof, key, before):
    return prof.dispatch_stats()[key] - before[key]


def _assert_params_close(a, b):
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=PARAM_TOL,
                                   atol=PARAM_ATOL, err_msg=k)


def _fused_run(pkg, net, x, y, spec, n_steps, seed=7, opt=None,
               sentinel_kw=None, **step_kw):
    g = pkg["gluon"]
    tr = g.Trainer(net.collect_params(), "sgd",
                   opt or {"learning_rate": 0.5, "momentum": 0.9})
    if sentinel_kw is not None:
        kw = dict(sentinel_kw)
        if "scaler" in kw:
            kw["scaler"] = pkg["scaler"](**kw["scaler"])
        if "policy" in kw:
            kw["policy"] = pkg["sent"].EscalationPolicy(**kw["policy"])
        step_kw["sentinel"] = pkg["sent"].HealthSentinel(trainer=tr, **kw)
    step = pkg["fused"](net, g.loss.SoftmaxCrossEntropyLoss(), tr,
                        **step_kw)
    losses, snaps = [], []
    with pkg["chaos"].inject(spec, seed=seed) as plan:
        for _ in range(n_steps):
            losses.append(float(step(x, y).asnumpy().mean()))
            snaps.append(_host(net))
        step.check_health()
        pending = plan.pending()
    return {"losses": losses, "snaps": snaps, "pending": pending,
            "step": step, "trainer": tr}


def _both_fused(init_seed, spec, n_steps, **kw):
    nets = _nets(init_seed)
    out = {}
    for pkg in (J, T):
        before = pkg["prof"].dispatch_stats()
        net, x, y = nets[pkg["name"]]
        out[pkg["name"]] = r = _fused_run(pkg, net, x, y, spec, n_steps,
                                          **kw)
        r["delta"] = {k: _delta(pkg["prof"], k, before)
                      for k in ("faults_injected", "nonfinite_steps",
                                "rollbacks")}
        s = r["step"]._sentinel
        r["events"] = list(s.events) if s is not None else []
    j, t = out["jax"], out["torch"]
    assert t["events"] == j["events"]
    assert t["delta"] == j["delta"] and t["pending"] == j["pending"] == []
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    _assert_params_close(t["snaps"][-1], j["snaps"][-1])
    return j, t


# ---------------------------------------------------------------------------
# plan parsing
# ---------------------------------------------------------------------------
def test_plan_parse_fire_once_and_rng_match():
    for chaos in (jchaos, tchaos):
        plan = chaos.ChaosPlan("seed=7, nan_grad@3, kv_drop@5")
        assert plan.seed == 7
        assert plan.pending() == [("kv_drop", 5), ("nan_grad", 3)]
        assert plan.fire("nan_grad", 3) and not plan.fire("nan_grad", 3)
        assert not plan.fire("nan_grad", 4) and not plan.fire("kv_dup", 5)
        with pytest.raises(ValueError, match="unknown fault"):
            chaos.ChaosPlan("frobnicate@1")
    # the which-element RNG depends only on (seed, kind, step), and the
    # two packages draw the same numbers
    for kind, step in (("nan_grad", 3), ("bitflip_param", 0)):
        a = jchaos.ChaosPlan("", seed=7).rng(kind, step).randint(10 ** 6)
        b = tchaos.ChaosPlan("", seed=7).rng(kind, step).randint(10 ** 6)
        assert a == b


# ---------------------------------------------------------------------------
# the acceptance scenario: NaN gradient at step N, skip and recover
# ---------------------------------------------------------------------------
def test_nan_gradient_step_is_skipped_and_training_recovers():
    bad = 3
    j, t = _both_fused(1234, "nan_grad@%d" % bad, 7,
                       numeric_guard="skip")
    assert [(s, a) for s, a, _ in t["events"]] == [(bad, "skip")]
    assert t["delta"] == {"faults_injected": 1, "nonfinite_steps": 1,
                          "rollbacks": 0}
    for r in (j, t):
        assert np.isfinite(r["losses"]).all()
        # containment: the bad step left every parameter (BatchNorm's
        # running statistics included) bitwise unchanged
        for name in r["snaps"][bad]:
            np.testing.assert_array_equal(r["snaps"][bad][name],
                                          r["snaps"][bad - 1][name])
        assert r["losses"][bad + 1] == r["losses"][bad]
        assert r["losses"][bad + 2] != r["losses"][bad + 1]
        assert r["losses"][-1] < r["losses"][0]


def test_post_recovery_params_are_bitwise_deterministic():
    a = _fused_run(T, *_nets(1234, "a_")["torch"], "nan_grad@3", 7,
                   numeric_guard="skip")
    b = _fused_run(T, *_nets(1234, "b_")["torch"], "nan_grad@3", 7,
                   numeric_guard="skip")
    for (na, va), (nb, vb) in zip(sorted(a["snaps"][-1].items()),
                                  sorted(b["snaps"][-1].items())):
        assert na[2:] == nb[2:]
        np.testing.assert_array_equal(va, vb, err_msg=na)


def test_warn_mode_reports_but_applies_the_update():
    nets = _nets(7)
    for pkg in (J, T):
        net, x, y = nets[pkg["name"]]
        g = pkg["gluon"]
        tr = g.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
        step = pkg["fused"](net, g.loss.SoftmaxCrossEntropyLoss(), tr,
                            numeric_guard="warn")
        with pkg["chaos"].inject("nan_grad@1", seed=2):
            step(x, y).asnumpy()
            step(x, y).asnumpy()       # the poisoned step (verdict pending)
            with pytest.warns(RuntimeWarning, match="update APPLIED"):
                step.check_health()
        host = _host(net)
        assert any(not np.isfinite(v).all() for v in host.values())


# ---------------------------------------------------------------------------
# escalation ladder
# ---------------------------------------------------------------------------
def test_escalate_rolls_back_to_ring_snapshot():
    j, t = _both_fused(
        99, "nan_grad@3,nan_grad@4", 7, seed=11,
        sentinel_kw=dict(mode="escalate", rollback_steps=4,
                         snapshot_interval=1,
                         policy=dict(skip_steps=1, rescale_steps=0,
                                     rollbacks=1,
                                     restore_checkpoint=False)))
    assert [(s, a) for s, a, _ in t["events"]] == [(3, "skip"),
                                                   (4, "rollback")]
    assert t["delta"]["rollbacks"] == 1
    for r in (j, t):
        for name in r["snaps"][4]:
            np.testing.assert_array_equal(r["snaps"][4][name],
                                          r["snaps"][2][name])
        s = r["step"]._sentinel
        assert s.bad_streak == 0 and s.last_action == "ok"


def test_escalate_rescale_rung_backs_the_loss_scale_off():
    j, t = _both_fused(
        5, "nan_grad@2,nan_grad@3", 5, seed=4, opt={"learning_rate": 0.1},
        sentinel_kw=dict(mode="escalate", rollback_steps=0,
                         scaler=dict(init_scale=2.0 ** 8,
                                     growth_interval=10 ** 9),
                         policy=dict(skip_steps=1, rescale_steps=2,
                                     rollbacks=0,
                                     restore_checkpoint=False)))
    assert [a for _, a, _ in t["events"]] == ["skip", "rescale"]
    for r in (j, t):
        assert r["step"]._sentinel.scaler.loss_scale == 2.0 ** 7
        assert all(np.isfinite(v).all() for v in r["snaps"][-1].values())
    # the loss scale is in the host scalars the update ops receive
    assert t["step"].last_scalars[1] == 2.0 ** 7


def test_exit_rung_when_no_mechanisms_available():
    from mxnet_tpu.elastic import NUMERIC_EXIT_CODE as J_EXIT
    from mxnet_tpu_torch.elastic import NUMERIC_EXIT_CODE as T_EXIT

    assert T_EXIT == J_EXIT == 77
    for sent in (jsent, tsent):
        s = sent.HealthSentinel(
            mode="escalate", rollback_steps=0,
            policy=sent.EscalationPolicy(skip_steps=0, rescale_steps=0,
                                         rollbacks=0,
                                         restore_checkpoint=False))
        with pytest.raises(SystemExit) as exc:
            s.observe(0, 1, [], [])
        assert exc.value.code == T_EXIT


def test_unported_rungs_raise_and_name_their_item():
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        tsent.HealthSentinel(mode="escalate", checkpoint_manager=object())


@pytest.mark.parametrize("arg,item", [
    ("devices", "9.3"), ("bucket", "8"), ("watchdog", "8"),
    ("preemption", "8")])
def test_fused_step_unported_arguments_name_their_item(arg, item):
    """``FusedTrainStep``'s arguments that are not ported raise naming the
    ROADMAP Queue 1 item that ports them."""
    net, x, y = _nets(3)["torch"]
    tr = tgluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    with pytest.raises(NotImplementedError,
                       match=r"FusedTrainStep\(%s=\.\.\.\) is not ported "
                             r"\(ROADMAP Queue 1 item %s " % (arg, item)):
        TFused(net, tgluon.loss.SoftmaxCrossEntropyLoss(), tr,
               **{arg: object()})


def test_kv_divergence_transport_first_writer_wins_as_jax():
    """``KVDivergenceTransport`` over each package's own local async-KV
    server: two clients publish different digests under one key and both
    get the first one back (``init`` is store-if-absent), a new key starts
    afresh, and a ``DivergenceDetector`` over it agrees for the replica
    whose parameters match the first and reports the other, in both
    packages alike."""
    from mxnet_tpu import async_kv as jkv
    from mxnet_tpu_torch import async_kv as tkv

    params = [np.arange(6, dtype=np.float32), np.ones(3, np.float32)]
    other = [params[0] + 1, params[1]]
    got = {}
    for name, sent, kv, arr in (("jax", jsent, jkv, jmx.nd.array),
                                ("port", tsent, tkv, mt.nd.array)):
        server, addr = kv.start_local_server()
        try:
            a, b = (sent.KVDivergenceTransport(kv.AsyncKVClient(addr=addr))
                    for _ in range(2))
            seen = [a.publish("mxtpu:div:5", 0x1111), b.publish(
                "mxtpu:div:5", 0x2222), b.publish("mxtpu:div:6", 0x3333),
                a.publish("mxtpu:div:6", 0x4444)]
            ctx = {} if name == "jax" else {"ctx": mt.cpu()}
            mine, theirs = ([arr(x, **ctx) for x in ps]
                            for ps in (params, other))
            det_a, det_b = (sent.DivergenceDetector(interval=1, transport=t)
                            for t in (a, b))
            with pytest.warns(RuntimeWarning, match="replica divergence"):
                verdicts = [det_a.check(7, mine), det_b.check(7, theirs)]
            got[name] = (seen, verdicts, sent.params_digest(mine))
        finally:
            server.shutdown()
    assert got["port"][0] == [0x1111, 0x1111, 0x3333, 0x3333]
    assert got["port"][1] == [True, False]
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# the eager Trainer path
# ---------------------------------------------------------------------------
def test_trainer_eager_path_skips_poisoned_step():
    nets = _nets(17)
    res = {}
    for pkg in (J, T):
        mx, g = pkg["mx"], pkg["gluon"]
        net, x, y = nets[pkg["name"]]
        loss_fn = g.loss.SoftmaxCrossEntropyLoss()
        tr = g.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.5, "momentum": 0.9},
                       numeric_guard="skip")
        before = pkg["prof"].dispatch_stats()
        snaps = []
        with pkg["chaos"].inject("nan_grad@1", seed=13) as plan:
            for _ in range(3):
                with mx.autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                tr.step(x.shape[0])
                snaps.append(_host(net))
        assert plan.pending() == []
        assert _delta(pkg["prof"], "nonfinite_steps", before) == 1
        trained = [p.name for p in tr._params if p.grad_req != "null"]
        for name in trained:
            np.testing.assert_array_equal(snaps[1][name], snaps[0][name])
        assert any(not np.array_equal(snaps[2][n], snaps[1][n])
                   for n in trained)
        assert all(np.isfinite(v).all() for v in snaps[2].values())
        res[pkg["name"]] = (snaps, list(tr._sentinel.events))
    # the same gradient element poisoned: the same event, the same names
    assert res["torch"][1] == res["jax"][1]
    _assert_params_close(res["torch"][0][-1], res["jax"][0][-1])


def test_trainer_attach_sentinel_and_eager_gauges():
    net, x, y = _nets(3)["torch"]
    tr = tgluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    sent = tsent.HealthSentinel(trainer=tr, mode="skip", rollback_steps=0)
    assert tr.attach_sentinel(sent) is tr
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(3):
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(4)
    gauges = ttel.registry().snapshot()["gauges"]
    assert gauges["train.eager.items_per_sec"] > 0
    assert gauges["sentinel.bad_streak"] == 0
    assert gauges["sentinel.loss_scale"] == 1.0


# ---------------------------------------------------------------------------
# units: loss scaler, rollback ring, bit flips, divergence, monitor, modes
# ---------------------------------------------------------------------------
def test_dynamic_loss_scaler_automaton():
    trace = {}
    for name, cls in (("jax", JScaler), ("torch", TScaler)):
        s = cls(init_scale=4.0, growth_interval=2, min_scale=1.0)
        seq = [s.update(found_inf=False), s.update(found_inf=False),
               s.update(found_inf=True), s.can_backoff()]
        s.backoff(), s.backoff(), s.backoff()
        seq += [s.loss_scale, s.can_backoff(), s.state_dict()]
        s2 = cls()
        s2.load_state_dict(s.state_dict())
        seq.append(s2.loss_scale)
        for bad in ({"backoff_factor": 1.5}, {"growth_factor": 1.0}):
            with pytest.raises(ValueError):
                cls(**bad)
        trace[name] = seq
    assert trace["torch"] == trace["jax"]
    assert trace["torch"][:4] == [4.0, 8.0, 4.0, True]


def test_rollback_ring_depth_eviction_and_walkback():
    net, x, y = _nets(3)["torch"]
    tr = tgluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.5, "momentum": 0.9})
    step = TFused(net, tgluon.loss.SoftmaxCrossEntropyLoss(), tr)
    ring = tsent.RollbackRing(2, params=list(tr._params),
                              updaters=list(tr._updaters))
    per_step = []
    for s in range(3):
        step(x, y).asnumpy()
        ring.snapshot(s)
        per_step.append(_host(net))
    assert len(ring) == 2 and ring.steps() == [1, 2]
    step(x, y).asnumpy()
    weights = [p.list_data()[0].data for p in tr._params]
    assert ring.restore() == 2
    for name, want in per_step[2].items():
        np.testing.assert_array_equal(_host(net)[name], want)
    assert ring.restore() == 1
    for name, want in per_step[1].items():
        np.testing.assert_array_equal(_host(net)[name], want)
    # restored into the same tensors
    assert all(p.list_data()[0].data is w
               for p, w in zip(tr._params, weights))
    with pytest.raises(IndexError):
        ring.restore()
    before = tprof.dispatch_stats()
    step(x, y).asnumpy()
    assert _delta(tprof, "recompile", before) == 0


def test_flip_param_bit_same_element_as_jax():
    nets = _nets(31)
    res = {}
    for pkg in (J, T):
        net = nets[pkg["name"]][0]
        params = list(net.collect_params().values())
        before = _host(net)
        with pkg["chaos"].inject("bitflip_param@0", seed=3) as plan:
            name = pkg["chaos"].flip_param_bit(0, params)
        assert plan.pending() == [] and name is not None
        after = _host(net)
        changed = {n for n in after
                   if after[n].tobytes() != before[n].tobytes()}
        assert changed == {name}
        raw = (after[name].reshape(-1).view(np.uint32)
               ^ before[name].reshape(-1).view(np.uint32))
        assert np.count_nonzero(raw) == 1
        assert bin(int(raw.max())).count("1") == 1
        res[pkg["name"]] = (name, int(np.flatnonzero(raw)[0]),
                            int(raw.max()))
    assert res["torch"] == res["jax"]


def test_bf16_parameters_are_left_alone_by_both():
    """The JAX package's numpy twin of bfloat16 is not a float kind, so
    its flip_param_bit and poison_grad skip a bf16 parameter (after
    consuming the fault); the port does the same."""
    jp = jmx.gluon.Parameter("w", shape=(4,), dtype="bfloat16")
    jp.initialize(jmx.init.One())
    tp = mt.gluon.Parameter("w", shape=(4,), dtype="bfloat16")
    tp.initialize(mt.init.One(), ctx=CPU)
    for chaos, p in ((jchaos, jp), (tchaos, tp)):
        before = p.data().asnumpy().astype(np.float32).copy()
        with chaos.inject("bitflip_param@0,nan_grad@0") as plan:
            assert chaos.flip_param_bit(0, [p]) is None
            assert chaos.poison_grad(0, [p]) is None
            assert plan.pending() == []
        np.testing.assert_array_equal(
            p.data().asnumpy().astype(np.float32), before)


def test_params_digest_and_nonfinite_counts_match():
    nets = _nets(41)
    jparams = list(nets["jax"][0].collect_params().values())
    tparams = list(nets["torch"][0].collect_params().values())
    assert tsent.params_digest(tparams) == jsent.params_digest(jparams)
    a = np.array([1.0, np.nan, np.inf, 2.0], np.float32)
    b = np.array([[np.nan, 1.0]], np.float32)
    got = tsent.nonfinite_counts([mt.nd.array(a, ctx=CPU),
                                  mt.nd.array(b, ctx=CPU)])
    want = jsent.nonfinite_counts([jmx.nd.array(a), jmx.nd.array(b)])
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.dtype == np.int32
    # bf16: the digest is over its raw 2-byte words, as the JAX package's
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert tsent.params_digest([mt.nd.array(w, ctx=CPU, dtype="bfloat16")]) \
        == jsent.params_digest([jmx.nd.array(w).astype("bfloat16")])


def test_divergence_detector_local_transport():
    nets = _nets(41)
    other = _nets(42, prefix="o_")
    for pkg in (J, T):
        sent, prof = pkg["sent"], pkg["prof"]
        pa = list(nets[pkg["name"]][0].collect_params().values())
        pb = list(other[pkg["name"]][0].collect_params().values())
        det = sent.DivergenceDetector(interval=2,
                                      transport=sent.LocalTransport())
        assert not det.due(0) and not det.due(3) and det.due(4)
        before = prof.dispatch_stats()
        assert det.check(2, pa) and det.check(2, pa)
        with pytest.warns(RuntimeWarning, match="divergence"):
            assert not det.check(2, pb)
        assert _delta(prof, "divergence_checks", before) == 3
        strict = sent.DivergenceDetector(interval=2, transport=det.transport,
                                         raise_on_divergence=True)
        with pytest.raises(sent.DivergenceError):
            strict.check(2, pb)


def test_monitor_deduplicates_nonfinite_events():
    for pkg in (J, T):
        mon, sent = pkg["monitor"], pkg["sent"]
        m = mon.Monitor(interval=1)
        try:
            s = sent.HealthSentinel(mode="skip", rollback_steps=0,
                                    monitor=m)
            s.observe(5, 1, [1, 0], ["a", "b"])
            mon.notify_nonfinite(5, ["a"], monitor=m)
            s.observe(6, 0, [0, 3], ["a", "b"])
            assert m.nonfinite_events == [(5, ("<loss>", "a")),
                                          (6, ("b",))]
            mon.notify_nonfinite(6, ["b"])
            assert len(m.nonfinite_events) == 2
        finally:
            mon._installed.remove(m)


def test_monitor_install_taps_the_executor():
    """Monitor.install over the port's Executor taps every op node, as
    the JAX package's eager monitored executor does: the same names and
    the same statistics."""
    stats = {}
    for pkg in (J, T):
        mx = pkg["mx"]
        kw = {"ctx": CPU} if pkg is T else {"ctx": jmx.cpu()}
        data = mx.sym.var("data")
        fc1 = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
        net = mx.sym.FullyConnected(mx.sym.Activation(fc1, act_type="relu",
                                                      name="relu1"),
                                    num_hidden=4, name="fc2")
        exe = net.simple_bind(grad_req="null", data=(4, 6), **kw)
        rng = np.random.RandomState(0)
        for name, arr in exe.arg_dict.items():
            arr[:] = rng.rand(*arr.shape).astype(np.float32)
        m = pkg["monitor"].Monitor(interval=1, pattern=".*fc.*", sort=True)
        try:
            m.install(exe)
            m.tic()
            exe.forward(is_train=False)
            stats[pkg["name"]] = m.toc()
        finally:
            pkg["monitor"]._installed.remove(m)
        exe.set_monitor_callback(None)
    jnames = [n for _, n, _ in stats["jax"]]
    assert [n for _, n, _ in stats["torch"]] == jnames
    assert any("fc1" in n for n in jnames) and any("fc2" in n
                                                   for n in jnames)
    np.testing.assert_allclose([float(s) for _, _, s in stats["torch"]],
                               [float(s) for _, _, s in stats["jax"]],
                               rtol=1e-5)


def test_guard_mode_resolution(monkeypatch):
    for sent in (jsent, tsent):
        assert sent.guard_mode("skip") == "skip"
        assert sent.guard_mode("off") == ""
        assert sent.guard_mode(False) == ""
        monkeypatch.setenv("MXNET_NUMERIC_GUARD", "warn")
        assert sent.guard_mode() == "warn"
        monkeypatch.setenv("MXNET_NUMERIC_GUARD", "bogus")
        with pytest.raises(ValueError, match="MXNET_NUMERIC_GUARD"):
            sent.guard_mode()
        monkeypatch.delenv("MXNET_NUMERIC_GUARD")


# ---------------------------------------------------------------------------
# the port's guard: bitwise on a finite step, the accountant
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_guarded_finite_step_is_bitwise_the_unguarded(dtype):
    """From one state, a finite guarded step leaves every parameter,
    BatchNorm statistic and optimizer-state buffer bit for bit where the
    unguarded step leaves them (bf16: the multi-precision update)."""
    digests = {}
    for guard in ("", "skip"):
        net, x, y = _nets(5, prefix="g_")["torch"]
        mp = dtype != "float32"
        if mp:
            net.cast(dtype)
            x = x.astype(dtype)
        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9,
                             "multi_precision": mp})
        step = TFused(net, tgluon.loss.SoftmaxCrossEntropyLoss(), tr,
                      numeric_guard=guard or False)
        for _ in range(3):
            step(x, y)
        step.check_health()
        states = []
        for i in sorted(tr._updaters[0].states):
            s = tr._updaters[0].states[i]
            states += list(s) if isinstance(s, tuple) else [s]
        digests[guard] = (tsent.params_digest(tr._params),
                          tsent.params_digest([s for s in states
                                               if s is not None]))
    assert digests["skip"] == digests[""]


def test_fused_step_accountant_counts_cost_from_the_shapes():
    net, x, y = _nets(6)["torch"]
    tr = tgluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9})
    step = TFused(net, tgluon.loss.SoftmaxCrossEntropyLoss(), tr)
    for _ in range(3):
        step(x, y)
    cost = step._accountant.cost
    # conv 3 -> 8, 3x3 on 8x8 (weight and bias gradients; the input needs
    # none) and dense 8 -> 10 (its input needs a gradient): 2 flops per
    # multiply-add
    conv = 2.0 * 4 * 8 * 8 * 8 * 3 * 3 * 3
    dense = 2.0 * 4 * 10 * 8
    assert cost["flops"] == 2 * conv + 3 * dense
    assert cost["bytes_accessed"] > 0
    gauges = ttel.registry().snapshot()["gauges"]
    for k in ("steps_per_sec", "items_per_sec", "mfu", "hbm_gbs",
              "hbm_util"):
        assert gauges["train.fused." + k] > 0, k
