"""The port's symbolic training path against the JAX package, on the CPU.

Both packages train the example's ResNet-20 (``num_classes=10``,
``image_shape="3,28,28"``) through ``Module`` for three steps of SGD with
momentum and weight decay, from the same numpy weights (carried into the
port by ``model.params_from_numpy``) on the same numpy batches, with a
``MultiFactorScheduler`` boundary after the second step.  The JAX Module
gets an SGD made with the parameter names and the symbol, as the
reference's ``Module.init_optimizer`` makes it (so only ``*_weight``
parameters decay); the port's Module makes that one itself from
``"sgd"``.  Beside it: SoftmaxOutput's gradient under each
``normalization`` and ``use_ignore``, BatchNorm in training with and
without ``fix_gamma``, the update ops, the optimizer's update count and lr
across a schedule boundary at aggregation size 4, the metrics, and the
initializers (compared by bounds and moments: the two packages draw
different numbers).  The ResNet-20 runs are made once for the module.

The ResNet-20 is also trained by the port in float64, from the same
numbers.  Against that run the port's f32 outputs, every gradient of the
first step and every parameter after the third are held to 2e-4 relative
L2, and the moving mean and variance after the third to 1e-5 (measured on
this CPU: 3.4e-6 and 2.5e-7).  The JAX package is further from it: XLA's
CPU reductions add in sequence, and the 28x28 stage's BatchNorm sums 3136
values per channel with heavy cancellation in the shifts' gradients, which
puts the JAX package's f32 gradients up to 5.8e-3, its parameters after
three steps at lr 0.1 up to 4.1e-3 and its moving statistics up to 9.5e-4
from the float64 answer.  So the port is held to JAX's answer at 1e-2
(gradients, parameters) and 2e-3 (moving statistics): a wrong formula
misses by far more.

Tolerances of the rest (relative L2 error):

* SoftmaxOutput and BatchNorm gradients of one op: 1e-5;
* the update ops: 1e-6 (the same f32 arithmetic in the same order);
* metrics: equal to 1e-12 (the same numpy arithmetic).
"""
import contextlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.symbol import symbol as jsymbol
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import resnet_symbol
from mxnet_tpu_torch.symbol import symbol as tsymbol

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = mt.cpu()
R20 = dict(num_classes=10, num_layers=20, image_shape="3,28,28")
BATCH = 4
STEPS = 3
SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
NET_REL = 2e-4
STATS_REL = 1e-5
JAX_GRAD_REL = 1e-2
JAX_STATS_REL = 2e-3
OP_REL = 1e-5
UPDATE_REL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@contextlib.contextmanager
def _fresh_names():
    saved = dict(jsymbol._NameManager._counts)
    jsymbol._NameManager.reset()
    tsymbol._NameManager.reset()
    try:
        yield
    finally:
        jsymbol._NameManager.reset()
        jsymbol._NameManager._counts.update(saved)


def _example_resnet():
    spec = importlib.util.spec_from_file_location(
        "example_resnet",
        REPO / "example/image-classification/symbols/resnet.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _weights(jsym, data_shape, rng):
    """He-normal weights, BN's gamma near 1 and beta near 0, moving mean
    0 and variance 1."""
    arg_shapes, _, aux_shapes = jsym.infer_shape(data=data_shape)
    args = {}
    for n, s in zip(jsym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight"):
            fan_in = int(np.prod(s[1:]))
            args[n] = (rng.randn(*s) * np.sqrt(2.0 / fan_in)).astype(
                np.float32)
        elif n.endswith("_gamma"):
            args[n] = (1 + 0.1 * rng.randn(*s)).astype(np.float32)
        else:
            args[n] = (0.1 * rng.randn(*s)).astype(np.float32)
    auxs = {n: (np.ones(s, np.float32) if n.endswith("_var")
                else np.zeros(s, np.float32))
            for n, s in zip(jsym.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def _scheduler(pkg):
    return pkg.lr_scheduler.MultiFactorScheduler(step=[2], factor=0.1)


def _train(pkg, sym, args, auxs, batches, f64=False):
    """Three Module steps: the first step's outputs and gradients, the
    parameters and moving statistics after the last, the optimizer's lr
    and update count.  ``f64`` (the port only) runs every array in
    float64."""
    ctx = CPU if pkg is mt else pkg.cpu()
    shape = batches[0][0].shape
    mod = pkg.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (shape[0],))])
    if pkg is mt:
        targs, tauxs = mt.model.params_from_numpy(args, auxs, ctx=CPU)
        mod.init_params(arg_params=targs, aux_params=tauxs)
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
            SGD, lr_scheduler=_scheduler(mt)))
    else:
        mod.init_params(
            arg_params={k: jmx.nd.array(v) for k, v in args.items()},
            aux_params={k: jmx.nd.array(v) for k, v in auxs.items()})
        mod.init_optimizer(optimizer=jmx.optimizer.SGD(
            rescale_grad=1.0 / shape[0], lr_scheduler=_scheduler(jmx),
            sym=sym, param_idx2name=dict(enumerate(mod._param_names)),
            **SGD))
    ex = mod._exec
    if f64:
        for a in ex.arg_arrays + ex.aux_arrays + ex.grad_arrays:
            if a is not None:
                a._set_data(a.data.double())
    res = {}
    for step, (x, y) in enumerate(batches):
        if f64:
            x, y = x.astype(np.float64), y.astype(np.float64)
        batch = ([mt.nd.NDArray(torch.from_numpy(x))],
                 [mt.nd.NDArray(torch.from_numpy(y))]) if pkg is mt \
            else ([jmx.nd.array(x)], [jmx.nd.array(y)])
        mod.forward_backward(pkg.io.DataBatch(*batch))
        if step == 0:
            res["out"] = mod.get_outputs()[0].asnumpy()
            res["grad"] = {n: g.asnumpy() for n, g in ex.grad_dict.items()
                           if g is not None}
        mod.update()
    arg, aux = mod.get_params()
    res["arg"] = {k: v.asnumpy() for k, v in arg.items()}
    res["aux"] = {k: v.asnumpy() for k, v in aux.items()}
    res["lr"] = mod._optimizer._get_lr(0)
    res["num_update"] = mod._optimizer.num_update
    return res


@pytest.fixture(scope="module")
def r20():
    """The three steps in the JAX package, in the port and in the port in
    float64."""
    with _fresh_names():
        jsym = _example_resnet().get_symbol(**R20)
        tsym = resnet_symbol.get_symbol(**R20)
    rng = np.random.RandomState(0)
    shape = (BATCH, 3, 28, 28)
    args, auxs = _weights(jsym, shape, rng)
    batches = [(rng.rand(*shape).astype(np.float32),
                rng.randint(0, 10, BATCH).astype(np.float32))
               for _ in range(STEPS)]
    return {"jax": _train(jmx, jsym, args, auxs, batches),
            "port": _train(mt, tsym, args, auxs, batches),
            "f64": _train(mt, tsym, args, auxs, batches, f64=True),
            "init_aux": auxs}


def _worst(got, want):
    errs = {n: _rel(got[n], want[n]) for n in want}
    return max(errs.values()), sorted(errs.items(), key=lambda kv: -kv[1])[:3]


def test_resnet20_outputs_match(r20):
    got = r20["port"]["out"]
    assert got.shape == r20["jax"]["out"].shape == (BATCH, 10)
    assert _rel(got, r20["jax"]["out"]) <= NET_REL
    assert _rel(got, r20["f64"]["out"]) <= NET_REL


@pytest.mark.parametrize("what,exact_tol,jax_tol", [
    ("grad", NET_REL, JAX_GRAD_REL), ("arg", NET_REL, JAX_GRAD_REL),
    ("aux", STATS_REL, JAX_STATS_REL)])
def test_resnet20_state_matches(r20, what, exact_tol, jax_tol):
    """Every gradient of the first step (``grad``), every parameter
    (``arg``) and moving statistic (``aux``) after the third: against the
    float64 run and against the JAX package."""
    got = r20["port"][what]
    assert set(got) == set(r20["jax"][what]) == set(r20["f64"][what])
    assert len(got) == {"grad": 64, "arg": 64, "aux": 40}[what]
    worst, top = _worst(got, r20["f64"][what])
    assert worst <= exact_tol, top
    worst, top = _worst(got, r20["jax"][what])
    assert worst <= jax_tol, top


def test_resnet20_fix_gamma_and_moving_statistics(r20):
    # fix_gamma: the data BatchNorm's gamma gets no gradient
    assert not r20["port"]["grad"]["bn_data_gamma"].any()
    # three EMA updates moved every statistic off its start
    aux = r20["port"]["aux"]
    assert all(not np.array_equal(aux[n], r20["init_aux"][n]) for n in aux)


def test_resnet20_schedule_crossed_its_boundary(r20):
    assert r20["port"]["num_update"] == r20["jax"]["num_update"] == STEPS
    assert r20["port"]["lr"] == pytest.approx(r20["jax"]["lr"], rel=1e-12)
    assert r20["port"]["lr"] == pytest.approx(0.01)


# ---------------------------------------------------------------------------
# one op at a time
# ---------------------------------------------------------------------------
def _op_grads(pkg, net, feed, is_port, out_grad=None):
    """Outputs, argument gradients and auxiliary states after one
    training forward and backward."""
    ctx = CPU if is_port else pkg.cpu()
    shapes = {k: v.shape for k, v in feed.items()}
    req = {k: ("null" if k.endswith("label") else "write") for k in feed}
    ex = net.simple_bind(ctx=ctx, grad_req=req, **shapes)
    for k, v in feed.items():
        (ex.arg_dict[k] if k in ex.arg_dict else ex.aux_dict[k])[:] = v
    outs = ex.forward(is_train=True)
    head = None if out_grad is None else pkg.nd.array(out_grad, ctx=ctx)
    ex.backward(head)
    return ([o.asnumpy() for o in outs],
            {k: g.asnumpy() for k, g in ex.grad_dict.items()
             if g is not None},
            {k: a.asnumpy() for k, a in ex.aux_dict.items()})


@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
@pytest.mark.parametrize("use_ignore", [False, True])
@pytest.mark.parametrize("multi_output", [False, True])
def test_softmax_output_gradient_matches(normalization, use_ignore,
                                         multi_output):
    rng = np.random.RandomState(1)
    if multi_output:
        x = rng.randn(3, 5, 4).astype(np.float32)
        y = rng.randint(0, 5, (3, 4)).astype(np.float32)
        y[0, 1] = y[2, 3] = -1.0
    else:
        x = rng.randn(6, 7).astype(np.float32)
        y = rng.randint(0, 7, 6).astype(np.float32)
        y[[1, 4]] = -1.0
    res = []
    for pkg in (jmx, mt):
        net = pkg.sym.SoftmaxOutput(
            pkg.sym.Variable("data"), pkg.sym.Variable("softmax_label"),
            grad_scale=2.0, ignore_label=-1.0, use_ignore=use_ignore,
            multi_output=multi_output, normalization=normalization,
            name="sm")
        res.append(_op_grads(pkg, net, {"data": x, "softmax_label": y},
                             pkg is mt))
    (jo, jg, _), (to, tg, _) = res
    assert _rel(to[0], jo[0]) <= OP_REL
    assert _rel(tg["data"], jg["data"]) <= OP_REL
    # the head gradient is ignored: ones in, the fused gradient out
    assert np.abs(tg["data"]).sum() > 0


@pytest.mark.parametrize("fix_gamma", [True, False])
def test_batchnorm_training_matches(fix_gamma):
    rng = np.random.RandomState(2)
    feed = {"data": (3 + 2 * rng.randn(4, 3, 5, 5)).astype(np.float32),
            "bn_gamma": (1 + 0.2 * rng.randn(3)).astype(np.float32),
            "bn_beta": (0.1 * rng.randn(3)).astype(np.float32),
            "bn_moving_mean": (0.1 * rng.randn(3)).astype(np.float32),
            "bn_moving_var": (1 + 0.1 * rng.rand(3)).astype(np.float32)}
    head = rng.randn(4, 3, 5, 5).astype(np.float32)
    res = []
    for pkg in (jmx, mt):
        net = pkg.sym.BatchNorm(pkg.sym.Variable("data"), fix_gamma=fix_gamma,
                                eps=2e-5, momentum=0.9, name="bn")
        res.append(_op_grads(pkg, net, feed, pkg is mt, head))
    (jo, jg, ja), (to, tg, ta) = res
    assert _rel(to[0], jo[0]) <= OP_REL
    for k in ("data", "bn_gamma", "bn_beta"):
        assert _rel(tg[k], jg[k]) <= OP_REL, k
    for k in ("bn_moving_mean", "bn_moving_var"):
        assert _rel(ta[k], ja[k]) <= OP_REL, k
    # the moving statistics: one EMA step of the batch's biased moments
    x = feed["data"].astype(np.float64)
    mean, var = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(
        ta["bn_moving_mean"], 0.9 * feed["bn_moving_mean"] + 0.1 * mean,
        rtol=1e-5)
    np.testing.assert_allclose(
        ta["bn_moving_var"], 0.9 * feed["bn_moving_var"] + 0.1 * var,
        rtol=1e-5)
    if fix_gamma:
        assert not tg["bn_gamma"].any()
    else:
        assert np.abs(tg["bn_gamma"]).sum() > 0


# ---------------------------------------------------------------------------
# update ops, optimizer, metrics, initializers
# ---------------------------------------------------------------------------
def _nd(pkg, a):
    return pkg.nd.array(a, ctx=CPU) if pkg is mt else pkg.nd.array(a)


def _update_inputs(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.randn(5, 3).astype(np.float32),
             rng.randn(5, 3).astype(np.float32),
             0.1 * rng.randn(5, 3).astype(np.float32),
             rng.rand(5, 3).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("clip", [None, 0.5])
def test_sgd_mom_update_matches(clip):
    (w, g, m, _), = _update_inputs(3, 1)
    params = dict(lr=0.1, momentum=0.9, wd=1e-3, rescale_grad=0.25)
    if clip:
        params["clip_gradient"] = clip
    res = []
    for pkg in (jmx, mt):
        W, G, M = (_nd(pkg, a) for a in (w, g, m))
        pkg.nd.sgd_mom_update(W, G, M, **params)
        res.append((W.asnumpy(), M.asnumpy()))
    for a, b in zip(res[1], res[0]):
        assert _rel(a, b) <= UPDATE_REL
    assert not np.array_equal(res[1][0], w)


def test_multi_sgd_mom_update_matches():
    ins = _update_inputs(4, 3)
    res = []
    for pkg in (jmx, mt):
        arrays = [[_nd(pkg, a) for a in t[:3]] for t in ins]
        pkg.nd.multi_sgd_mom_update(
            *[a for t in arrays for a in t], lrs=(0.1, 0.2, 0.05),
            wds=(1e-4, 0.0, 1e-3), momentum=0.9, rescale_grad=0.5,
            num_weights=3)
        res.append([a.asnumpy() for t in arrays for a in (t[0], t[2])])
    for a, b in zip(res[1], res[0]):
        assert _rel(a, b) <= UPDATE_REL


def test_adam_update_matches():
    (w, g, m, v), = _update_inputs(5, 1)
    res = []
    for pkg in (jmx, mt):
        W, G, M, V = (_nd(pkg, a) for a in (w, g, m, v))
        pkg.nd.adam_update(W, G, M, V, lr=0.01, beta1=0.9, beta2=0.999,
                           epsilon=1e-8, wd=1e-3, rescale_grad=0.5)
        res.append((W.asnumpy(), M.asnumpy(), V.asnumpy()))
    for a, b in zip(res[1], res[0]):
        assert _rel(a, b) <= UPDATE_REL


def test_optimizer_update_count_and_lr_across_a_schedule_boundary():
    """Ten parameters through the Updater at aggregation size 4 (chunks
    of 4, 4 and 2), a MultiFactorScheduler stepping at updates 2 and 3:
    the same weights, update count and lr as the JAX package's at every
    step."""
    names = ["p%d_weight" % i if i % 3 else "p%d_bias" % i
             for i in range(10)]
    rng = np.random.RandomState(6)
    ws = [rng.randn(4).astype(np.float32) for _ in names]
    gs = [[rng.randn(4).astype(np.float32) for _ in names]
          for _ in range(4)]
    trace = {}
    for pkg in (jmx, mt):
        opt = pkg.optimizer.SGD(
            learning_rate=0.1, momentum=0.9, wd=1e-3, rescale_grad=0.5,
            param_idx2name=dict(enumerate(names)),
            lr_scheduler=pkg.lr_scheduler.MultiFactorScheduler([2, 3], 0.5))
        assert opt.aggregate_num == 4
        upd = pkg.optimizer.get_updater(opt)
        W = [_nd(pkg, w) for w in ws]
        rows = []
        for step_grads in gs:
            upd(list(range(len(names))), [_nd(pkg, g) for g in step_grads],
                W)
            rows.append((opt.num_update,
                         [opt._get_lr(i) for i in range(len(names))],
                         [w.asnumpy() for w in W]))
        trace[pkg] = rows
    for (jn, jlr, jw), (tn, tlr, tw) in zip(trace[jmx], trace[mt]):
        assert tn == jn
        assert tlr == pytest.approx(jlr, rel=1e-12)
        for a, b in zip(tw, jw):
            assert _rel(a, b) <= UPDATE_REL
    assert [r[0] for r in trace[mt]] == [1, 2, 3, 4]
    assert [r[1][0] for r in trace[mt]] == pytest.approx(
        [0.1, 0.1, 0.05, 0.025])


def test_metrics_match():
    rng = np.random.RandomState(7)
    batches = []
    for _ in range(3):
        p = rng.rand(8, 5).astype(np.float32)
        batches.append((rng.randint(0, 5, 8).astype(np.float32),
                        p / p.sum(1, keepdims=True)))
    for make in (lambda pkg: pkg.metric.create("acc"),
                 lambda pkg: pkg.metric.Accuracy(),
                 lambda pkg: pkg.metric.CrossEntropy(),
                 lambda pkg: pkg.metric.TopKAccuracy(top_k=2),
                 lambda pkg: pkg.metric.create(["accuracy", "ce"])):
        vals = []
        for pkg in (jmx, mt):
            m = make(pkg)
            for y, p in batches:
                m.update([_nd(pkg, y)], [_nd(pkg, p)])
            vals.append(m.get_name_value())
        assert [n for n, _ in vals[1]] == [n for n, _ in vals[0]]
        np.testing.assert_allclose([v for _, v in vals[1]],
                                   [v for _, v in vals[0]], rtol=1e-12)


def test_initializer_name_dispatch():
    net = mt.sym.BatchNorm(mt.sym.FullyConnected(
        mt.sym.Variable("data"), num_hidden=6, name="fc"), name="bn")
    net = mt.sym.FullyConnected(
        net, mt.sym.Variable("w2_weight", init=mt.init.Constant(0.5)),
        num_hidden=3, name="out")
    mod = mt.mod.Module(net, label_names=(), context=CPU)
    mod.bind(data_shapes=[("data", (2, 4))])
    mod.init_params(initializer=mt.init.Uniform(0.3))
    arg, aux = mod.get_params()
    w = arg["fc_weight"].asnumpy()
    assert np.abs(w).max() <= 0.3 and np.abs(w).max() > 0
    assert not arg["fc_bias"].asnumpy().any()
    assert not arg["bn_beta"].asnumpy().any()
    assert (arg["bn_gamma"].asnumpy() == 1).all()
    assert not aux["bn_moving_mean"].asnumpy().any()
    assert (aux["bn_moving_var"].asnumpy() == 1).all()
    # the __init__ attribute wins over the suffix rule
    assert (arg["w2_weight"].asnumpy() == 0.5).all()
    assert mod.symbol.attr_dict()["w2_weight"]["__init__"] == \
        jmx.init.Constant(0.5).dumps()


@pytest.mark.parametrize("rnd_type", ["uniform", "gaussian"])
@pytest.mark.parametrize("factor_type", ["avg", "in", "out"])
def test_xavier_scale_rule_matches(rnd_type, factor_type):
    shape = (64, 32, 3, 3)
    draws = {}
    for pkg in (jmx, mt):
        arr = _nd(pkg, np.zeros(shape, np.float32))
        pkg.init.Xavier(rnd_type=rnd_type, factor_type=factor_type,
                        magnitude=2.0)("conv_weight", arr)
        draws[pkg] = arr.asnumpy()
    fan = {"avg": (32 * 9 + 64 * 9) / 2.0, "in": 32 * 9.0,
           "out": 64 * 9.0}[factor_type]
    scale = np.sqrt(2.0 / fan)
    std = scale / np.sqrt(3.0) if rnd_type == "uniform" else scale
    for pkg, w in draws.items():
        assert abs(w.mean()) < 0.05 * std, pkg
        assert abs(w.std() / std - 1) < 0.03, pkg
        if rnd_type == "uniform":
            assert np.abs(w).max() <= scale
            assert np.abs(w).max() > 0.99 * scale
    assert not np.array_equal(draws[jmx], draws[mt])   # not the same draws


def test_msra_prelu_and_seeded_draws():
    arr = mt.nd.zeros((256, 128), ctx=CPU)
    mt.random.seed(11)
    mt.init.MSRAPrelu(factor_type="in", slope=0.0)("fc_weight", arr)
    first = arr.asnumpy()
    assert abs(first.std() / np.sqrt(2.0 / 128) - 1) < 0.03
    mt.random.seed(11)
    mt.init.MSRAPrelu(factor_type="in", slope=0.0)("fc_weight", arr)
    np.testing.assert_array_equal(arr.asnumpy(), first)
    mixed = mt.init.Mixed(["fc.*", ".*"], [mt.init.Zero(), mt.init.One()])
    mixed("fc_weight", arr)
    assert not arr.asnumpy().any()
    mixed("conv_weight", arr)
    assert (arr.asnumpy() == 1).all()


def test_executor_grad_req_add_and_reshape():
    """``grad_req="add"`` accumulates over backward calls, ``write``
    replaces, ``null`` allocates nothing, as in the JAX package; a
    reshaped executor shares the parameters and their gradients."""
    rng = np.random.RandomState(8)
    x = rng.randn(3, 5).astype(np.float32)
    w = rng.randn(4, 5).astype(np.float32)
    head = rng.randn(3, 4).astype(np.float32)
    req = {"data": "null", "fc_weight": "add", "fc_bias": "write"}
    res = []
    for pkg in (jmx, mt):
        ctx = CPU if pkg is mt else pkg.cpu()
        net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=4,
                                     name="fc")
        ex = net.simple_bind(ctx=ctx, grad_req=req, data=(3, 5))
        ex.arg_dict["fc_weight"][:] = w
        assert ex.grad_dict["data"] is None
        for _ in range(2):
            ex.forward(is_train=True, data=_nd(pkg, x))
            ex.backward(_nd(pkg, head))
        res.append({k: ex.grad_dict[k].asnumpy()
                    for k in ("fc_weight", "fc_bias")})
    for k in res[0]:
        np.testing.assert_allclose(res[1][k], res[0][k], rtol=1e-5)
    np.testing.assert_allclose(res[1]["fc_weight"], 2 * head.T @ x,
                               rtol=1e-5)
    np.testing.assert_allclose(res[1]["fc_bias"], head.sum(0), rtol=1e-5)
    small = ex.reshape(data=(2, 5))
    assert small.arg_dict["data"].shape == (2, 5)
    assert small.arg_dict["fc_weight"] is ex.arg_dict["fc_weight"]
    assert small.grad_dict["fc_weight"] is ex.grad_dict["fc_weight"]
    out = small.forward(data=x[:2])[0].asnumpy()
    np.testing.assert_allclose(out, x[:2] @ w.T, rtol=1e-5, atol=1e-6)


def test_chip_smoke_module_gate_steps_in_float64_and_f32(monkeypatch):
    """``chip_smoke._module_gate`` takes the step in float64 and in f32 (the
    card's side run on the CPU here): the float64 step keeps every array,
    gradient and update in float64, its f32 gradients stand within
    ``NET_REL`` of it, and a change of 1e-6 relative to one float64
    gradient on the card's side fails the gate."""
    import chip_smoke

    monkeypatch.setattr(mt, "gpu", lambda i=0: CPU)
    net = resnet_symbol.get_symbol(**R20)
    rng = np.random.RandomState(0)
    arg_shapes, _, aux_shapes = net.infer_shape(data=(BATCH, 3, 28, 28))
    args = {n: (rng.randn(*s) * 0.1).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    auxs = {n: np.ones(s, np.float32) if n.endswith("_var")
            else np.zeros(s, np.float32)
            for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    x = rng.rand(2 * BATCH, 3, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, 2 * BATCH).astype(np.float32)
    f64 = chip_smoke._module_step(mt, net, CPU, args, auxs, x[:BATCH],
                                  y[:BATCH], "float64")
    f32 = chip_smoke._module_step(mt, net, CPU, args, auxs, x[:BATCH],
                                  y[:BATCH])
    for part in f64:
        assert {v.dtype for v in part.values()} == {np.dtype(np.float64)}
    assert {v.dtype for v in f32[0].values()} == {np.dtype(np.float32)}
    assert chip_smoke._compare_tensors(f32[0], f64[0], NET_REL)[0]

    ok, report = chip_smoke._module_gate(mt, net, args, auxs, x, y)
    assert ok, report
    assert report["float64"]["grad"]["joint_rel_l2"] == 0.0
    assert report["float32"]["grad_card_vs_float64"]["joint_rel_l2"] < NET_REL

    step = chip_smoke._module_step
    calls = []

    def nudged(mx_, net_, ctx, args_, auxs_, x_, y_, dtype="float32"):
        out = step(mx_, net_, ctx, args_, auxs_, x_, y_, dtype)
        calls.append(dtype)
        if len(calls) == 1:                  # the card's float64 step
            out[0]["stage1_unit1_conv1_weight"] *= 1 + 1e-6
        return out

    monkeypatch.setattr(chip_smoke, "_module_step", nudged)
    ok, report = chip_smoke._module_gate(mt, net, args, auxs, x, y)
    assert calls[0] == "float64" and not ok
    assert report["float64"]["grad"]["worst"][0] == \
        "stage1_unit1_conv1_weight"
