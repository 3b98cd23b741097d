"""Cases of ``tests/test_gluon.py`` and ``tests/test_fused_step.py``, under
their names, for the port's Gluon on the CPU.

Where both packages can run a case, it runs in both from the same numpy
inputs (weights carried from the JAX package by ``load_dict``) and the
results are compared: f32 layers, losses and optimizer steps within 1e-6
relative (1e-5 after several steps, 1e-4 on parameters after four fused
steps, as the JAX package's own fused-vs-plain test holds them).  Cases of
the port alone check its own rules: the host value of a ``Constant``,
``load_states`` moving the optimizer state to the device at its next
update, the options ``FusedTrainStep`` does not port raising.  The
parity of whole ResNets is in ``test_torch_port_gluon.py``.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import gluon as tgluon
from test_torch_port_gluon import (CPU, FWD_TOL, PKGS, _data, _f32,
                                   _jax_net, _on_cpu, _weights)


def _both(fn):
    out = {}
    for name, mx in PKGS.items():
        with _on_cpu(mx):
            out[name] = fn(mx)
    return out


def test_parameter_basic():
    p = tgluon.Parameter("weight", shape=(10, 10))
    p.initialize(init="xavier", ctx=[CPU])
    assert len(p.list_data()) == 1 and len(p.list_grad()) == 1
    assert p.data(CPU).shape == (10, 10) and p.grad(CPU).shape == (10, 10)
    a = np.abs(p.data().asnumpy())
    assert 0 < a.max() <= np.sqrt(3.0 / 10)           # Xavier's bound


def test_parameter_dict_get_sharing():
    params = tgluon.ParameterDict("net_")
    p1 = params.get("w", shape=(2, 2))
    assert params.get("w") is p1 and p1.name == "net_w"
    shared = tgluon.ParameterDict("net_", shared=params)
    assert shared.get("w") is p1


def test_parameter_shape_inference_merge():
    params = tgluon.ParameterDict()
    p = params.get("w", shape=(4, 0))
    assert params.get("w", shape=(4, 5)) is p and p.shape == (4, 5)


def test_constant_parameter():
    const = tgluon.Constant("c", [[1, 2], [3, 4]])
    const.initialize(ctx=CPU)
    np.testing.assert_array_equal(const.data().asnumpy(), [[1, 2], [3, 4]])
    assert const.grad_req == "null"


def test_block_naming_and_collect():
    def names(mx):
        nn = mx.gluon.nn

        class Net(nn.HybridBlock):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                with self.name_scope():
                    self.dense0 = nn.Dense(5, in_units=3)
                    self.dense1 = nn.Dense(5, in_units=5)
                    self.bn = nn.BatchNorm()

            def hybrid_forward(self, F, x):
                return self.bn(self.dense1(self.dense0(x)))

        net = Net(prefix="net_")
        return (list(net.collect_params().keys()),
                list(net.collect_params(".*weight").keys()))

    res = _both(names)
    assert res["torch"] == res["jax"]
    assert "net_dense0_weight" in res["torch"][0]


def test_resnet_parameter_names_match_jax():
    def names(mx):
        net = mx.gluon.model_zoo.vision.resnet50_v1(prefix="r50_")
        return [(n, p.shape, p.grad_req)
                for n, p in net.collect_params().items()]

    res = _both(names)
    assert res["torch"] == res["jax"]
    assert len(res["torch"]) == 299


def test_dense_flatten_false():
    net = tgluon.nn.Dense(7, flatten=False, in_units=4)
    net.initialize(ctx=CPU)
    assert net(mt.nd.ones((2, 3, 4), ctx=CPU)).shape == (2, 3, 7)


def test_deferred_init_and_reinit():
    net = tgluon.nn.Dense(5)
    net.initialize(ctx=CPU)
    net(mt.nd.ones((4, 3), ctx=CPU))
    assert net.weight.shape == (5, 3)
    with pytest.raises(Exception):
        net.weight.shape = (5, 9)


def test_hybridize_matches_imperative():
    nn = tgluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu"), nn.Dense(3))
    net.initialize(ctx=CPU)
    x = mt.nd.array(np.random.RandomState(0).randn(2, 4), ctx=CPU)
    imp = net(x).asnumpy()
    net.hybridize()
    np.testing.assert_array_equal(net(x).asnumpy(), imp)
    assert net._cached_op is not None and net._cached_op._out_fmt == 0


def test_hybrid_backward_matches_imperative():
    nn = tgluon.nn
    x = mt.nd.array(np.random.RandomState(0).randn(4, 3), ctx=CPU)
    grads = []
    for hybridize in (False, True):
        net = nn.HybridSequential(prefix="hb_")
        net.add(nn.Dense(8, activation="tanh"), nn.Dense(1))
        net.initialize(mt.init.One(), ctx=CPU)
        if hybridize:
            net.hybridize()
        with mt.autograd.record():
            y = net(x).sum()
        y.backward()
        grads.append([v.grad().asnumpy()
                      for v in net.collect_params().values()])
    for a, b in zip(*grads):          # positional: the counters name apart
        np.testing.assert_array_equal(a, b)


def test_conv2d_shapes():
    layer = tgluon.nn.Conv2D(16, kernel_size=3, strides=2, padding=1)
    layer.initialize(ctx=CPU)
    assert layer(mt.nd.ones((2, 3, 32, 32), ctx=CPU)).shape == \
        (2, 16, 16, 16)
    assert layer.weight.shape == (16, 3, 3, 3)


def test_pooling_layers():
    xs = np.random.RandomState(3).randn(2, 3, 8, 8).astype(np.float32)

    def run(mx):
        nn = mx.gluon.nn
        x = mx.nd.array(xs)
        return [l(x).asnumpy() for l in (
            nn.MaxPool2D(2), nn.AvgPool2D(2), nn.GlobalAvgPool2D(),
            nn.GlobalMaxPool2D(), nn.MaxPool2D(3, 2, 1, ceil_mode=True),
            nn.AvgPool2D(3, 2, 1, count_include_pad=False))]

    res = _both(run)
    for a, b in zip(res["jax"], res["torch"]):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_batchnorm_train_eval():
    bn = tgluon.nn.BatchNorm(in_channels=4)
    bn.initialize(ctx=CPU)
    x = mt.nd.array(np.random.RandomState(0).randn(8, 4, 3, 3) * 3 + 1,
                    ctx=CPU)
    with mt.autograd.record():
        out = bn(x)
    np.testing.assert_allclose(out.asnumpy().mean(axis=(0, 2, 3)),
                               np.zeros(4), atol=1e-4)
    assert not np.allclose(bn(x).asnumpy(), out.asnumpy())
    np.testing.assert_allclose(bn.running_mean.data().asnumpy(),
                               0.1 * x.asnumpy().mean(axis=(0, 2, 3)),
                               rtol=1e-5)


def test_layernorm_embedding():
    xs = np.random.RandomState(0).randn(3, 6).astype(np.float32)

    def run(mx):
        nn = mx.gluon.nn
        ln = nn.LayerNorm(in_channels=6)
        ln.initialize()
        emb = nn.Embedding(10, 4)
        emb.initialize(mx.init.One())
        return [ln(mx.nd.array(xs)).asnumpy(),
                emb(mx.nd.array([1, 2, 1])).asnumpy()]

    res = _both(run)
    for a, b in zip(res["jax"], res["torch"]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_sequential_getitem_len():
    nn = tgluon.nn
    net = nn.Sequential()
    net.add(nn.Dense(3), nn.Dense(4), nn.Dense(5))
    assert len(net) == 3 and isinstance(net[1], nn.Dense)
    assert len(net[1:]) == 2


def test_save_load_parameters(tmp_path):
    nn = tgluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(5, in_units=3), nn.Dense(3, in_units=5))
    net.initialize(ctx=CPU)
    fname = str(tmp_path / "net.params")
    net.save_parameters(fname)
    net2 = nn.HybridSequential()
    net2.add(nn.Dense(5, in_units=3), nn.Dense(3, in_units=5))
    net2.load_parameters(fname, ctx=CPU)
    x = mt.nd.ones((2, 3), ctx=CPU)
    np.testing.assert_array_equal(net(x).asnumpy(), net2(x).asnumpy())
    pfile = str(tmp_path / "dict.params")
    net.collect_params().save(pfile)
    net3 = nn.HybridSequential(prefix=net.prefix)
    with net3.name_scope():
        pass
    net.collect_params().load(pfile, ctx=CPU)


def test_trainer_step_updates():
    def run(mx):
        nn = mx.gluon.nn
        net = nn.Dense(1, in_units=2)
        net.initialize(mx.init.One())
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.5, "wd": 0.1})
        x = mx.nd.array(np.arange(8, dtype=np.float32).reshape(4, 2))
        with mx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(4)
        return [net.weight.data().asnumpy(), net.bias.data().asnumpy(),
                tr.learning_rate]

    res = _both(run)
    for a, b in zip(res["jax"], res["torch"]):
        np.testing.assert_allclose(b, a, rtol=1e-6)


def test_trainer_learning_rate_and_set():
    net = tgluon.nn.Dense(1, in_units=2)
    net.initialize(ctx=CPU)
    tr = tgluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.5})
    assert tr.learning_rate == 0.5
    tr.set_learning_rate(0.25)
    assert tr.learning_rate == 0.25
    sched = tgluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.5,
        "lr_scheduler": mt.lr_scheduler.FactorScheduler(step=2, factor=0.1)})
    with pytest.raises(UserWarning):
        sched.set_learning_rate(0.1)


def test_trainer_save_load_states(tmp_path):
    nn = tgluon.nn
    net = nn.Dense(2, in_units=2)
    net.initialize(ctx=CPU)
    tr = tgluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9})
    x = mt.nd.ones((2, 2), ctx=CPU)
    with mt.autograd.record():
        loss = net(x).sum()
    loss.backward()
    tr.step(2)
    mom = tr._updaters[0].states[0].asnumpy()
    f = str(tmp_path / "trainer.states")
    tr.save_states(f)
    tr2 = tgluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9})
    tr2.load_states(f)
    assert 0 in tr2._updaters[0].states
    with mt.autograd.record():
        loss = net(x).sum()
    loss.backward()
    tr2.step(2)                      # the loaded state moves to the device
    assert tr2._updaters[0].states[0].context == CPU
    assert not np.allclose(tr2._updaters[0].states[0].asnumpy(), mom)


@pytest.mark.parametrize("loss_name", [
    "L2Loss", "L1Loss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
    "LogisticLoss"])
def test_regression_losses(loss_name):
    rng = np.random.RandomState(0)
    pred = rng.randn(4, 3).astype(np.float32)
    label = np.sign(rng.randn(4, 3)).astype(np.float32)

    def run(mx):
        p = mx.nd.array(pred)
        p.attach_grad()
        with mx.autograd.record():
            out = getattr(mx.gluon.loss, loss_name)()(p, mx.nd.array(label))
        out.backward()
        return [out.asnumpy(), p.grad.asnumpy()]

    res = _both(run)
    assert res["torch"][0].shape == (4,)
    for a, b in zip(res["jax"], res["torch"]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_softmax_ce_loss_values():
    rng = np.random.RandomState(0)
    pred = (rng.randn(5, 7) * 3).astype(np.float32)
    sparse = rng.randint(0, 7, 5).astype(np.float32)
    dense = np.eye(7, dtype=np.float32)[sparse.astype(int)]

    def run(mx):
        p = mx.nd.array(pred)
        ce = mx.gluon.loss.SoftmaxCrossEntropyLoss
        return [ce()(p, mx.nd.array(sparse)).asnumpy(),
                ce(sparse_label=False)(p, mx.nd.array(dense)).asnumpy(),
                ce(from_logits=True, weight=0.5)(
                    mx.nd.log_softmax(p), mx.nd.array(sparse)).asnumpy()]

    res = _both(run)
    for a, b in zip(res["jax"], res["torch"]):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(res["torch"][0], res["torch"][1], rtol=1e-6)


def test_kl_and_bce_losses():
    def run(mx):
        kl = mx.gluon.loss.KLDivLoss()
        q = mx.nd.array([[0.3, 0.7], [0.5, 0.5]])
        bce = mx.gluon.loss.SigmoidBCELoss()
        return [kl(mx.nd.log(mx.nd.array([[0.2, 0.8], [0.5, 0.5]])),
                   q).asnumpy(),
                bce(mx.nd.array([[2.0], [-1.0]]),
                    mx.nd.array([[1.0], [0.0]])).asnumpy()]

    res = _both(run)
    for a, b in zip(res["jax"], res["torch"]):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_split_and_load():
    data = mt.nd.array(np.arange(12).reshape(6, 2), ctx=CPU)
    parts = tgluon.utils.split_data(data, 3)
    assert len(parts) == 3 and parts[0].shape == (2, 2)
    np.testing.assert_array_equal(parts[2].asnumpy(), [[8, 9], [10, 11]])
    loaded = tgluon.utils.split_and_load(data, [CPU])
    assert loaded[0].shape == (6, 2)


def test_clip_global_norm():
    def run(mx):
        arrays = [mx.nd.ones((2, 2)) * 3, mx.nd.ones((3,)) * 4]
        total = mx.gluon.utils.clip_global_norm(arrays, 1.0)
        return [float(total)] + [a.asnumpy() for a in arrays]

    res = _both(run)
    for a, b in zip(res["jax"], res["torch"]):
        np.testing.assert_allclose(b, a, rtol=1e-6)
    new_norm = np.sqrt(sum((a ** 2).sum() for a in res["torch"][1:]))
    np.testing.assert_allclose(new_norm, 1.0, rtol=1e-4)


def test_model_zoo_constructs_and_runs():
    net = tgluon.model_zoo.vision.get_model("resnet18_v1", classes=10,
                                            thumbnail=True)
    net.initialize(ctx=CPU)
    assert net(mt.nd.ones((1, 3, 32, 32), ctx=CPU)).shape == (1, 10)


def test_model_zoo_resnet_v2_runs():
    ref = _jax_net("narrow", "v2probe_")     # warm the JAX side's names
    del ref
    xs, _ = _data()

    def run(mx):
        mx.random.seed(3)
        net = mx.gluon.model_zoo.vision.resnet18_v2(classes=7, thumbnail=True,
                                                    prefix="v2_")
        net.initialize(mx.init.Xavier())
        with mx.autograd.pause():
            net(mx.nd.array(xs))
        return net

    jnet = run(jmx)
    with mt.cpu():
        tnet = mt.gluon.model_zoo.vision.resnet18_v2(classes=7,
                                                     thumbnail=True,
                                                     prefix="v2_")
    tnet.load_dict(_weights(jnet), ctx=CPU)
    out = tnet(mt.nd.array(xs, ctx=CPU)).asnumpy()
    assert out.shape == (2, 7)
    np.testing.assert_allclose(out, jnet(jmx.nd.array(xs)).asnumpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_model_zoo_names():
    with pytest.raises(ValueError):
        tgluon.model_zoo.vision.get_model("not_a_model")
    with pytest.raises(NotImplementedError):
        tgluon.model_zoo.vision.resnet18_v1(pretrained=True)


def test_lambda_blocks():
    nn = tgluon.nn
    x = mt.nd.array([[-1.0, 2.0]], ctx=CPU)
    np.testing.assert_allclose(nn.Lambda("tanh")(x).asnumpy(),
                               np.tanh([[-1.0, 2.0]]), rtol=1e-6)
    np.testing.assert_array_equal(
        nn.HybridLambda(lambda F, x: F.relu(x))(x).asnumpy(), [[0.0, 2.0]])


def test_activations_layers():
    def run(mx):
        nn = mx.gluon.nn
        x = mx.nd.array([[-2.0, -0.5, 0.5, 2.0]])
        outs = [layer(x).asnumpy() for layer in (
            nn.LeakyReLU(0.1), nn.ELU(), nn.SELU(), nn.Swish(), nn.GELU(),
            nn.Activation("relu"), nn.Activation("sigmoid"),
            nn.Activation("tanh"), nn.Activation("softrelu"),
            nn.Activation("softsign"))]
        prelu = nn.PReLU()
        prelu.initialize()
        return outs + [prelu(x).asnumpy()]

    res = _both(run)
    for a, b in zip(res["jax"], res["torch"]):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_dropout_layer():
    nn = tgluon.nn
    x = mt.nd.ones((4, 1000), ctx=CPU)
    drop = nn.Dropout(0.5)
    np.testing.assert_array_equal(drop(x).asnumpy(), x.asnumpy())
    with mt.autograd.record():
        y = drop(x)
    vals = np.unique(y.asnumpy())
    assert set(vals.tolist()) <= {0.0, 2.0}
    assert 0.4 < (y.asnumpy() == 0).mean() < 0.6


def _fused_net(mx, prefix):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.GlobalAvgPool2D(), nn.Dense(10))
    return net


def _fused_pair(prefix):
    rng = np.random.RandomState(0)
    x = rng.rand(4, 3, 8, 8).astype(np.float32)
    y = rng.randint(0, 10, (4,)).astype(np.float32)
    jmx.random.seed(1)
    jnet = _fused_net(jmx, prefix)
    jnet.initialize(jmx.init.Xavier())
    with jmx.autograd.pause():
        jnet(jmx.nd.array(x))
    tnet = _fused_net(mt, prefix)
    tnet.load_dict(_weights(jnet), ctx=CPU)
    return jnet, tnet, x, y


@pytest.mark.parametrize("opt,opt_args", [
    ("sgd", {"learning_rate": 0.5, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
])
def test_fused_step_matches_plain_path(opt, opt_args):
    """Four fused steps of the port against four of the JAX package's
    (losses within 1e-5, parameters within 1e-4), and against four plain
    steps of the port."""
    jnet, tnet, x, y = _fused_pair("fused_%s_" % opt)
    losses = {}
    for name, mx, net in (("jax", jmx, jnet), ("torch", mt, tnet)):
        with _on_cpu(mx):
            tr = mx.gluon.Trainer(net.collect_params(), opt, dict(opt_args))
            step = mx.gluon.contrib.FusedTrainStep(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), tr)
            losses[name] = [float(step(mx.nd.array(x), mx.nd.array(y))
                                  .asnumpy().mean()) for _ in range(4)]
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5,
                               atol=1e-6)
    jw, tw = _weights(jnet), _weights(tnet)
    for n in jw:
        if opt == "adam" and n.endswith(("conv0_bias", "running_mean")):
            # BatchNorm follows the convolution: its bias's gradient is 0
            # in exact arithmetic, rounding noise in each package, which
            # Adam's m / sqrt(v) turns into steps of +-lr; the running mean
            # takes the bias in
            continue
        np.testing.assert_allclose(tw[n], jw[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_fused_step_lr_schedule_stays_live():
    jnet, tnet, x, y = _fused_pair("fused_sched_")
    losses = {}
    for name, mx, net in (("jax", jmx, jnet), ("torch", mt, tnet)):
        with _on_cpu(mx):
            tr = mx.gluon.Trainer(net.collect_params(), "sgd", {
                "learning_rate": 0.5,
                "lr_scheduler": mx.lr_scheduler.FactorScheduler(
                    step=2, factor=0.1)})
            step = mx.gluon.contrib.FusedTrainStep(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), tr)
            losses[name] = [float(step(mx.nd.array(x), mx.nd.array(y))
                                  .asnumpy().mean()) for _ in range(6)]
            if mx is mt:
                assert step.last_scalars[2] == pytest.approx(0.5 * 0.1 ** 2)
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("fused", [True, False])
def test_bf16_multi_precision_training(fused):
    """net.cast('bfloat16') + multi_precision trains in the port, fused
    (``test_bf16_multi_precision_training``) and through Trainer.step
    (``test_bf16_plain_path_multi_precision``): weights bf16, masters and
    BatchNorm f32, the loss falls."""
    _, net, x, y = _fused_pair("bf16train_%d_" % fused)
    net.cast("bfloat16")
    xb = mt.nd.array(x, ctx=CPU).astype("bfloat16")
    yt = mt.nd.array(y, ctx=CPU)
    tr = tgluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.5, "momentum": 0.9, "multi_precision": True})
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    step = tgluon.contrib.FusedTrainStep(net, loss_fn, tr)
    losses = []
    for _ in range(6):
        if fused:
            loss = step(xb, yt)
        else:
            with mt.autograd.record():
                loss = loss_fn(net(xb), yt)
            loss.backward()
            tr.step(4)
        losses.append(float(_f32(loss.asnumpy()).mean()))
    assert losses[-1] < losses[0] * 0.8, losses
    params = net.collect_params()
    conv_w = [p for n, p in params.items() if "conv" in n and "weight" in n]
    gamma = [p for n, p in params.items() if "gamma" in n]
    assert str(conv_w[0].data().dtype) == "bfloat16"
    assert gamma[0].data().dtype == np.float32
    st = tr._updaters[0].states[0]
    assert isinstance(st, tuple) and st[1].dtype == np.float32


@pytest.mark.parametrize("option", ["devices", "bucket", "watchdog",
                                    "preemption", "numeric_guard",
                                    "sentinel"])
def test_fused_step_unported_options_raise(option):
    """The options still unported raise; ``numeric_guard`` and
    ``sentinel``, ported since, take a guard mode or a HealthSentinel and
    refuse a bad mode as the JAX package does."""
    from mxnet_tpu_torch import sentinel

    _, net, _, _ = _fused_pair("opts_%s_" % option)
    tr = tgluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    if option in ("numeric_guard", "sentinel"):
        with pytest.raises(ValueError, match="MXNET_NUMERIC_GUARD"):
            tgluon.contrib.FusedTrainStep(net, loss_fn, tr,
                                          numeric_guard="bogus")
        given = ("skip" if option == "numeric_guard" else
                 sentinel.HealthSentinel(trainer=tr, mode="skip"))
        step = tgluon.contrib.FusedTrainStep(net, loss_fn, tr,
                                             **{option: given})
        assert step._guard_mode == "skip"
    else:
        with pytest.raises(NotImplementedError):
            tgluon.contrib.FusedTrainStep(net, loss_fn, tr,
                                          **{option: object()})
    tgluon.contrib.FusedTrainStep(net, loss_fn, tr, donate=True)
