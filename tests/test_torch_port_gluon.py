"""The port's Gluon against the JAX package's, on the CPU.

Both packages build the same nets with the same explicit ``prefix=`` (the
``_BlockScope`` counters of two packages in one process would otherwise
name them apart); the JAX net is initialized and its ``collect_params()``,
read out as numpy, goes into the port's net through ``load_dict``.  Inputs
are seeded numpy arrays.

* A narrow ``ResNetV1(BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 32, 64],
  thumbnail=True, classes=10)`` and ``resnet18_v1(classes=10,
  thumbnail=True)`` at batch 2, 3x32x32: the forward (inference and
  training mode, imperative and hybridized) within 1e-5; the gradients of
  ``SoftmaxCrossEntropyLoss`` within 2e-4 of the port's own float64 run,
  and the JAX package's f32 gradients within 1e-2 of that float64 run.
  The float64 run the f32 gradients are held to takes each ReLU's mask
  from the f32 forward: a ReLU input within f32 rounding of 0 flips the
  derivative between the runs and moves every gradient below it (at the
  seed here one input of resnet18's stage-3 ReLU does, by 7.7e-3 on that
  layer), which says nothing of rounding.  The 1e-2 bound is ROADMAP's
  known quirk: XLA's CPU reductions put the JAX package's f32 ResNet
  gradients up to 5.8e-3 from float64 (``test_torch_port_module.py``,
  ``test_torch_port_f32_conditioning.py``), and a flipped ReLU there moves
  them as far.  Relative L2 errors, of all tensors together and of each
  tensor whose norm is at least 1e-3 of the whole's (a smaller one is a
  sum that cancels).
* One ``Trainer.step`` and one ``FusedTrainStep``, each hybridized and
  not, against the JAX package's ``Trainer.step`` (its FusedTrainStep is
  the same arithmetic, ``tests/test_fused_step.py``): losses within 1e-5,
  every update ``w_new - w_old`` within 1e-2 (it is ``lr`` times a
  gradient), BatchNorm's running statistics within 1e-5; the host scalars
  the port's fused step feeds its update ops equal to those the JAX
  package's fused step computes (``_host_scalars``).
* bf16 with ``multi_precision``: the four ``mp_*`` update ops bit-exact on
  identical inputs; a ``FusedTrainStep`` of the bf16 narrow ResNet in both
  packages (losses within 2^-7), then the optimizer step on identical bf16
  gradients: the bf16 weights within 2^-7 relative, the f32 masters within
  1e-5; BatchNorm's Parameters stay f32 after ``cast``.
* ``Parameter`` deferred init and ``cast``, and ``load_dict``.  Cases of
  ``tests/test_gluon.py`` and ``tests/test_fused_step.py``, named after
  them, run in both packages where both can, are in
  ``test_torch_port_gluon_layers.py``.
"""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu import gluon as jgluon
from mxnet_tpu_torch import gluon as tgluon

CPU = mt.cpu()
PKGS = {"jax": jmx, "torch": mt}
FWD_TOL = 1e-5
GRAD_F64_REL = 2e-4
GRAD_JAX_REL = 1e-2
UPDATE_JAX_REL = 1e-2
STATS_REL = 1e-5
CANCELLED_SHARE = 1e-3
NARROW = ([1, 1, 1, 1], [8, 8, 16, 32, 64])
SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}


@contextlib.contextmanager
def _on_cpu(mx):
    if mx is mt:
        with mt.cpu():
            yield
    else:
        yield


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_tensors(got, want, tol, what):
    """Relative L2 of all of ``want``'s tensors together, and of each whose
    norm is at least CANCELLED_SHARE of the whole's, within ``tol``."""
    names = sorted(want)
    assert sorted(got) == names
    total = np.sqrt(sum(np.square(np.asarray(want[n], np.float64)).sum()
                        for n in names))
    diff = np.sqrt(sum(np.square(np.asarray(got[n], np.float64)
                                 - np.asarray(want[n], np.float64)).sum()
                       for n in names))
    errs = {n: _rel(got[n], want[n]) for n in names
            if np.linalg.norm(np.asarray(want[n], np.float64))
            >= CANCELLED_SHARE * total}
    worst = max(errs.items(), key=lambda kv: kv[1])
    assert diff / total <= tol and worst[1] <= tol, (what, diff / total,
                                                     worst)


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _resnet(pkg, kind, prefix):
    g = pkg.gluon
    if kind == "narrow":
        from importlib import import_module
        res = import_module(pkg.__name__ + ".gluon.model_zoo.vision.resnet")
        return res.ResNetV1(res.BasicBlockV1, *NARROW, thumbnail=True,
                            classes=10, prefix=prefix)
    return g.model_zoo.vision.resnet18_v1(classes=10, thumbnail=True,
                                          prefix=prefix)


def _data(batch=2, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(batch, 3, 32, 32).astype(np.float32),
            rng.randint(0, 10, batch).astype(np.float32))


_CACHE = {}


def _jax_net(kind, prefix):
    """The JAX net, Xavier-initialized (seeded), deferred init finished."""
    jmx.random.seed(7)
    np.random.seed(7)                  # the JAX initializers draw from numpy
    net = _resnet(jmx, kind, prefix)
    net.initialize(jmx.init.Xavier())
    x, _ = _data()
    with jmx.autograd.pause():
        net(jmx.nd.array(x))
    return net


def _weights(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _set_jax(net, weights):
    for n, p in net.collect_params().items():
        p.set_data(jmx.nd.array(weights[n]))
    return net


def _port_net(kind, prefix, weights, dtype=None, hybridize=False):
    net = _resnet(mt, kind, prefix)
    net.load_dict(weights, ctx=CPU)
    if dtype is not None:
        net.cast(dtype)
    if hybridize:
        net.hybridize(static_alloc=True, static_shape=True)
    return net


def _grads(mx, net, x, y, dtype=None):
    """Loss vector and {name: gradient} of SoftmaxCrossEntropyLoss, one
    recorded forward in training mode."""
    with _on_cpu(mx):
        xa, ya = mx.nd.array(x), mx.nd.array(y)
        if dtype is not None:
            xa = mx.nd.NDArray(torch.from_numpy(x.astype(dtype)))
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        with mx.autograd.record():
            loss = loss_fn(net(xa), ya)
        loss.backward()
        return loss.asnumpy(), {
            n: p.grad().asnumpy() for n, p in net.collect_params().items()
            if p.grad_req != "null"}


def _reference(kind):
    """Per kind, once: the JAX net's weights, its forward outputs and its
    gradients at the seeded batch, and the port's float64 gradients."""
    if kind in _CACHE:
        return _CACHE[kind]
    prefix = "%sfwd_" % kind
    jnet = _jax_net(kind, prefix)
    w = _weights(jnet)
    x, y = _data()
    xj = jmx.nd.array(x)
    out = {"weights": w, "prefix": prefix}
    out["infer"] = jnet(xj).asnumpy()
    with jmx.autograd.train_mode():
        out["train"] = jnet(xj).asnumpy()
    # the forward above in training mode moved the running statistics:
    # gradients start from the weights as loaded
    _set_jax(jnet, w)
    out["loss"], out["grads"] = _grads(jmx, jnet, x, y)
    f64 = _port_net(kind, prefix, w, dtype="float64")
    out["loss64"], out["grads64"] = _grads(mt, f64, x, y, dtype=np.float64)
    # the float64 run again, each ReLU taking the f32 forward's mask: a
    # ReLU input within f32 rounding of 0 otherwise flips its derivative
    # between the two runs, which moves every gradient below it by up to
    # ~1e-2 (at this seed, one input of resnet18's stage-3 ReLU)
    masks = []
    with _relu_masks(masks, record=True):
        _grads(mt, _port_net(kind, prefix, w), x, y)
    with _relu_masks(masks, record=False):
        out["loss64m"], out["grads64m"] = _grads(
            mt, _port_net(kind, prefix, w, dtype="float64"), x, y,
            dtype=np.float64)
    _CACHE[kind] = out
    return out


@contextlib.contextmanager
def _relu_masks(masks, record):
    """Record each ReLU's mask (``record``) or apply the recorded ones in
    order, in the port's Activation op."""
    from mxnet_tpu_torch.ops.registry import OPS

    op = OPS["Activation"]
    fn, calls = op.fn, iter(masks)

    def relu(data, act_type="relu"):
        if act_type != "relu":
            return fn(data, act_type=act_type)
        if record:
            masks.append((data > 0).detach())
            return fn(data, act_type=act_type)
        return torch.where(next(calls), data, torch.zeros_like(data))

    op.fn = relu
    try:
        yield
    finally:
        op.fn = fn


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("kind", ["narrow", "resnet18"])
def test_resnet_forward_matches_jax(kind, hybridize):
    ref = _reference(kind)
    net = _port_net(kind, ref["prefix"], ref["weights"], hybridize=hybridize)
    x, _ = _data()
    xt = mt.nd.array(x, ctx=CPU)
    np.testing.assert_allclose(net(xt).asnumpy(), ref["infer"],
                               rtol=FWD_TOL, atol=FWD_TOL)
    with mt.autograd.train_mode():
        np.testing.assert_allclose(net(xt).asnumpy(), ref["train"],
                                   rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("kind", ["narrow", "resnet18"])
def test_resnet_gradients_match_float64_and_jax(kind, hybridize):
    ref = _reference(kind)
    net = _port_net(kind, ref["prefix"], ref["weights"], hybridize=hybridize)
    x, y = _data()
    loss, grads = _grads(mt, net, x, y)
    np.testing.assert_allclose(loss, ref["loss64"], rtol=1e-5)
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
    _assert_tensors(grads, ref["grads64m"], GRAD_F64_REL, "vs float64")
    _assert_tensors(ref["grads"], ref["grads64"], GRAD_JAX_REL,
                    "JAX vs the port's float64")


# ---------------------------------------------------------------------------
# one optimizer step
# ---------------------------------------------------------------------------
def _step_reference():
    """The JAX package's narrow ResNet: weights, one Trainer.step at batch
    2, and its fused step's host scalars."""
    if "step" in _CACHE:
        return _CACHE["step"]
    prefix = "stepnet_"
    jnet = _jax_net("narrow", prefix)
    w = _weights(jnet)
    x, y = _data(seed=1)
    tr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(SGD))
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    with jmx.autograd.record():
        loss = loss_fn(jnet(jmx.nd.array(x)), jmx.nd.array(y))
    loss.backward()
    tr.step(2)
    after = _weights(jnet)
    # the host scalars the JAX fused step feeds its update for the same
    # trainer state (building the step compiles nothing)
    jnet2 = _set_jax(_jax_net("narrow", prefix), w)
    tr2 = jgluon.Trainer(jnet2.collect_params(), "sgd", dict(SGD))
    step = jgluon.contrib.FusedTrainStep(jnet2, loss_fn, tr2)
    step._build(None, None)
    step._optimizer.rescale_grad = 1.0 / 2
    out = {"prefix": prefix, "weights": w, "x": x, "y": y,
           "loss": loss.asnumpy(), "after": after,
           "scalars": np.concatenate([[2.0, 1.0], step._host_scalars()])}
    _CACHE["step"] = out
    return out


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("path", ["trainer", "fused"])
def test_one_step_matches_jax(path, hybridize):
    ref = _step_reference()
    net = _port_net("narrow", ref["prefix"], ref["weights"],
                    hybridize=hybridize)
    tr = tgluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    x = mt.nd.array(ref["x"], ctx=CPU)
    y = mt.nd.array(ref["y"], ctx=CPU)
    if path == "trainer":
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(2)
    else:
        step = tgluon.contrib.FusedTrainStep(net, loss_fn, tr)
        loss = step(x, y)
        np.testing.assert_array_equal(step.last_scalars, ref["scalars"])
    want = ref["after"]
    np.testing.assert_allclose(loss.asnumpy(), ref["loss"], rtol=1e-5)
    got = _weights(net)
    stats = [n for n in want if "running" in n]
    weights = [n for n in want if n not in stats]
    _assert_tensors({n: got[n] - ref["weights"][n] for n in weights},
                    {n: want[n] - ref["weights"][n] for n in weights},
                    UPDATE_JAX_REL, "updates")
    _assert_tensors({n: got[n] for n in stats}, {n: want[n] for n in stats},
                    STATS_REL, "running statistics")


def test_fused_step_matches_trainer_step_in_the_port():
    """FusedTrainStep and record / backward / Trainer.step are the same
    arithmetic in the port: equal to f32 rounding over three steps."""
    ref = _step_reference()
    x = mt.nd.array(ref["x"], ctx=CPU)
    y = mt.nd.array(ref["y"], ctx=CPU)
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    nets = [_port_net("narrow", ref["prefix"], ref["weights"])
            for _ in range(2)]
    trs = [tgluon.Trainer(n.collect_params(), "sgd", dict(SGD))
           for n in nets]
    step = tgluon.contrib.FusedTrainStep(nets[0], loss_fn, trs[0])
    for _ in range(3):
        la = step(x, y).asnumpy()
        with mt.autograd.record():
            lb = loss_fn(nets[1](x), y)
        lb.backward()
        trs[1].step(2)
        np.testing.assert_allclose(la, lb.asnumpy(), rtol=1e-5, atol=1e-6)
    wa, wb = _weights(nets[0]), _weights(nets[1])
    for n in wa:
        np.testing.assert_allclose(wa[n], wb[n], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# bf16 with multi_precision
# ---------------------------------------------------------------------------
def _bf16_case(seed):
    rng = np.random.RandomState(seed)
    w32 = rng.randn(37, 41).astype(np.float32)
    g32 = rng.randn(37, 41).astype(np.float32)
    mom = (rng.randn(37, 41) * 0.01).astype(np.float32)
    return w32, g32, mom


def _bf16(mx, a):
    return mx.nd.array(a, dtype="bfloat16")


MP_KW = dict(lr=0.05, wd=1e-4, rescale_grad=0.25)


@pytest.mark.parametrize("op", ["mp_sgd_update", "mp_sgd_mom_update",
                                "multi_mp_sgd_update",
                                "multi_mp_sgd_mom_update"])
def test_mp_update_ops_bit_exact(op):
    cases = [_bf16_case(s) for s in (0, 1)]

    def run(mx):
        with _on_cpu(mx):
            ins, outs = [], []
            for w32, g32, mom in cases:
                w, g = _bf16(mx, w32), _bf16(mx, g32)
                m, master = mx.nd.array(mom), mx.nd.array(w32)
                group = [w, g, m, master] if "mom" in op else [w, g, master]
                ins += group
                outs.append(group)
            kw = dict(MP_KW, clip_gradient=1.5)
            if "mom" in op:
                kw["momentum"] = 0.9
            if op.startswith("multi"):
                kw.update(num_weights=2, lrs=(0.05, 0.1), wds=(1e-4, 0.0))
                del kw["lr"], kw["wd"]
                getattr(mx.nd, op)(*ins, **kw)
            else:
                for group in outs:
                    getattr(mx.nd, op)(*group, **kw)
            return [a.asnumpy().view(np.uint16) if str(a.dtype) == "bfloat16"
                    else a.asnumpy() for group in outs for a in group
                    if a is not group[1]]

    j, t = run(jmx), run(mt)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b, a)


def test_bf16_multi_precision_step_matches_jax():
    """The bf16 narrow ResNet with f32 masters in both packages, from the
    same weights and batch.  The port's FusedTrainStep against the JAX
    package's recorded forward: the losses within 2^-7 relative (one bf16
    rounding apart).  The two packages' bf16
    gradients then differ by ~20 % relative L2 (as each does from the
    float64 gradient of the same bf16 weights: BatchNorm's batch
    statistics at batch 4, rounded to bf16), so the optimizer half of the
    step is held on identical inputs: the same bf16 gradients into both
    trainers' ``step``; the bf16 weights within 2^-7 relative and the f32
    masters and momenta within 1e-5 (both come out bit-exact)."""
    prefix = "bf16net_"
    w = _weights(_jax_net("narrow", prefix))
    x, y = _data(seed=2)
    opts = {"learning_rate": 0.05, "momentum": 0.9, "multi_precision": True}

    def bf16_net(mx):
        net = _set_jax(_jax_net("narrow", prefix), w) if mx is jmx \
            else _port_net("narrow", prefix, w)
        with _on_cpu(mx):
            net.cast("bfloat16")
            tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(opts))
        return net, tr

    losses, grads, state = {}, None, {}
    for name in ("jax", "torch"):
        mx = PKGS[name]
        net, tr = bf16_net(mx)
        with _on_cpu(mx):
            loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
            xb, ya = mx.nd.array(x).astype("bfloat16"), mx.nd.array(y)
            params = [p for p in net.collect_params().values()
                      if p.grad_req != "null"]
            if mx is jmx:              # the JAX package's bf16 gradients
                with mx.autograd.record():
                    loss = loss_fn(net(xb), ya)
                loss.backward()
                losses[name] = _f32(loss.asnumpy())
                grads = [p.grad().asnumpy() for p in params]
                net, tr = bf16_net(mx)
                params = [p for p in net.collect_params().values()
                          if p.grad_req != "null"]
            else:
                step = mx.gluon.contrib.FusedTrainStep(net, loss_fn, tr)
                losses[name] = _f32(step(xb, ya).asnumpy())
                net, tr = bf16_net(mx)
                params = [p for p in net.collect_params().values()
                          if p.grad_req != "null"]
            # the optimizer half, on identical weights and gradients
            for _ in range(2):         # the second with momentum
                for p, g in zip(params, grads):
                    p.grad()[:] = mx.nd.array(g, dtype=p.dtype) \
                        if str(p.dtype) == "bfloat16" else mx.nd.array(g)
                tr.step(2)
            upd = tr._updaters[0]
            st = {p.name: upd.states[tr._param2idx[p.name]]
                  for p in params}
            state[name] = (_weights(net), {
                n: [a.asnumpy() for a in v] for n, v in st.items()
                if isinstance(v, tuple)})
    np.testing.assert_allclose(losses["torch"], losses["jax"],
                               rtol=2.0 ** -7)
    (jw, js), (tw, ts) = state["jax"], state["torch"]
    low = sorted(js)
    assert low and low == sorted(ts)
    for n in low:
        assert str(tw[n].dtype) == "bfloat16", n
        assert _rel(_f32(tw[n]), _f32(jw[n])) <= 2.0 ** -7, n
        for a, b in zip(ts[n], js[n]):          # momentum, f32 master
            assert a.dtype == np.float32 and _rel(a, b) <= 1e-5, n
    for n in jw:
        if n not in low:
            assert tw[n].dtype == np.float32 == jw[n].dtype, n


def test_batchnorm_stays_f32_after_cast():
    net = _resnet(mt, "narrow", "castnet_")
    net.initialize(mt.init.Xavier(), ctx=CPU)
    net.cast("bfloat16")
    x, _ = _data()
    with mt.autograd.pause():
        out = net(mt.nd.array(x, ctx=CPU).astype("bfloat16"))
    assert str(out.dtype) == "bfloat16"
    for name, p in net.collect_params().items():
        want = "float32" if "batchnorm" in name else "bfloat16"
        assert str(p.data().dtype) == want, name
        assert str(p.dtype) == want, name
        if p.grad_req != "null":
            assert str(p.grad().dtype) == want, name


def test_parameter_deferred_init_and_cast():
    p = tgluon.Parameter("w", shape=(4, 0), allow_deferred_init=True)
    p.initialize(init=mt.init.One(), ctx=CPU)
    with pytest.raises(tgluon.DeferredInitializationError):
        p.data()
    assert p.list_ctx() == [CPU]
    p.shape = (4, 3)
    p._finish_deferred_init()
    np.testing.assert_array_equal(p.data().asnumpy(), np.ones((4, 3)))
    assert p.data().data.requires_grad
    p.cast("float64")
    assert p.data().dtype == np.float64 and p.grad().dtype == np.float64
    assert p.data().data.is_leaf and p.data().data.requires_grad
    p.cast("bfloat16")
    assert str(p.data().dtype) == "bfloat16"
    np.testing.assert_array_equal(_f32(p.data().asnumpy()), np.ones((4, 3)))


def test_load_dict_carries_jax_weights():
    ref = _reference("narrow")
    net = _port_net("narrow", ref["prefix"], ref["weights"])
    got = net.collect_params().save_dict()
    assert sorted(got) == sorted(ref["weights"])
    for n, v in ref["weights"].items():
        np.testing.assert_array_equal(got[n], v)
    with pytest.raises(AssertionError):
        _resnet(mt, "narrow", "other_").load_dict(ref["weights"], ctx=CPU)
