"""The port's Gluon export and ``SymbolBlock`` against the JAX package's,
on the CPU.

Both packages build the same small nets with the same explicit ``prefix=``
(the JAX net initialized from numpy's seeded global RNG, its parameters
carried into the port's net by name through ``load_dict``), run them
hybridized on seeded numpy inputs, and export them after resetting both
packages' node-name counters, so that the graphs' names agree:

* ``HybridBlock.export`` of a single-input net (``data``), a two-input net
  (``data0`` / ``data1``), a net with two outputs (a ``Group``) and a net
  with BatchNorm (its moving statistics under ``aux:``): the same
  ``list_arguments``, ``list_auxiliary_states`` and ``list_outputs``, the
  same keys in the params file and the same values, bit for bit;
* each package's files load in the other through ``SymbolBlock.imports``
  and ``predict.Predictor``, and give the exporting net's outputs within
  ``FWD_TOL`` (f32 on both sides; the port's f32 convolutions stand about
  1e-7 from the JAX package's); within one package, bit for bit;
* the gradients of an imported ``SymbolBlock``'s Parameters under
  ``autograd.record`` (the graph interpreted op by op) within ``GRAD_REL``
  relative L2 of the JAX package's, the BatchNorm net in training mode:
  all together, and each whose norm is at least ``CANCELLED_SHARE`` of
  theirs (a smaller one is a sum that cancels, as the gradient of a
  convolution's bias ahead of BatchNorm, which is zero but for rounding);
* a ``SymbolBlock`` composed over Symbols (one block's graph spliced onto
  another's output) has the JAX package's arguments and outputs, and runs
  to the two blocks' outputs in turn;
* where the JAX package's symbol wrappers raise — a positional scalar
  parameter (MobileNet's ``F.clip(x, 0, 6)``) and a missing bias passed as
  ``None`` (``Dense(use_bias=False)``) — the port's compose, and their
  exports run to the Gluon net's outputs bit for bit.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu.symbol.symbol import _NameManager as JNames
from mxnet_tpu_torch.symbol.symbol import _NameManager as TNames

CPU = mt.cpu()
PKGS = {"jax": jmx, "torch": mt}
FWD_TOL = 1e-5
GRAD_REL = 1e-4
CANCELLED_SHARE = 1e-3
SHAPE = (2, 3, 8, 8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Two(object):
    """Factories of a two-input and a two-output block, in either
    package."""

    @staticmethod
    def inputs(mx):
        class TwoIn(mx.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.a = mx.gluon.nn.Dense(5)
                    self.b = mx.gluon.nn.Dense(5)

            def hybrid_forward(self, F, x, y):
                return F.relu(self.a(x)) * self.b(y) + 0.5

        return TwoIn(prefix="two_")

    @staticmethod
    def outputs(mx):
        class TwoOut(mx.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.body = mx.gluon.nn.Dense(6, activation="tanh")
                    self.head = mx.gluon.nn.Dense(3)

            def hybrid_forward(self, F, x):
                h = self.body(x)
                return [self.head(h), F.sigmoid(h) - 1.0]

        return TwoOut(prefix="out_")


def _net(mx, kind):
    nn = mx.gluon.nn
    if kind == "dense":
        net = nn.HybridSequential(prefix="mlp_")
        with net.name_scope():
            net.add(nn.Dense(16, activation="relu"), nn.Dropout(0.0),
                    nn.Dense(4))
        return net
    if kind == "conv_bn":
        net = nn.HybridSequential(prefix="cbn_")
        with net.name_scope():
            net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                    nn.Activation("relu"), nn.MaxPool2D(),
                    nn.Flatten(), nn.Dense(3))
        return net
    if kind == "two_inputs":
        return _Two.inputs(mx)
    return _Two.outputs(mx)


KINDS = ["dense", "conv_bn", "two_inputs", "two_outputs"]


def _inputs(kind):
    rng = np.random.RandomState(1)
    x = rng.rand(*SHAPE).astype(np.float32)
    if kind == "two_inputs":
        return [x.reshape(2, -1), rng.rand(2, 7).astype(np.float32)]
    return [x]


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _run(mx, net, xs):
    arrays = [mx.nd.array(x, ctx=CPU) if mx is mt else mx.nd.array(x)
              for x in xs]
    return [o.asnumpy() for o in _as_list(net(*arrays))]


def _build(kind, tmp):
    """Both packages' nets of ``kind`` with the JAX net's weights, run
    hybridized, and each package's export of them."""
    np.random.seed(0)
    jnet = _net(jmx, kind)
    jnet.initialize(jmx.init.Xavier())
    jnet.hybridize()
    xs = _inputs(kind)
    want = _run(jmx, jnet, xs)
    with CPU:
        tnet = _net(mt, kind)
        tnet.load_dict({k: v.data().asnumpy()
                        for k, v in jnet.collect_params().items()}, ctx=CPU)
        tnet.hybridize()
        got = _run(mt, tnet, xs)
    prefixes = {}
    for name, (mx, net, names) in {"jax": (jmx, jnet, JNames),
                                   "torch": (mt, tnet, TNames)}.items():
        names.reset()
        prefixes[name] = os.path.join(str(tmp), name)
        net.export(prefixes[name], 0)
    return dict(jnet=jnet, tnet=tnet, xs=xs, want=want, got=got,
                prefixes=prefixes)


@pytest.fixture(scope="module", params=KINDS)
def built(request, tmp_path_factory):
    return _build(request.param, tmp_path_factory.mktemp(request.param))


def test_gluon_forward_matches_jax(built):
    for g, w in zip(built["got"], built["want"]):
        np.testing.assert_allclose(g, w, rtol=FWD_TOL, atol=FWD_TOL)


def test_export_files_match_jax(built):
    jp, tp = built["prefixes"]["jax"], built["prefixes"]["torch"]
    jsym = jmx.sym.load(jp + "-symbol.json")
    tsym = mt.sym.load(tp + "-symbol.json")
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert tsym.list_outputs() == jsym.list_outputs()
    n_in = len(built["xs"])
    data = ["data"] if n_in == 1 else ["data%d" % i for i in range(n_in)]
    assert [a for a in tsym.list_arguments() if a.startswith("data")] \
        == data
    with CPU:
        tparams = mt.nd.load(tp + "-0000.params")
    jparams = jmx.nd.load(jp + "-0000.params")
    assert sorted(tparams) == sorted(jparams)
    for k, v in jparams.items():
        np.testing.assert_array_equal(tparams[k].asnumpy(), v.asnumpy())
    aux = {k[4:] for k in tparams if k.startswith("aux:")}
    assert aux == set(tsym.list_auxiliary_states())


@pytest.mark.parametrize("src", ["jax", "torch"])
def test_symbolblock_imports_in_the_other_package(built, src):
    """Each package's export through the other's (and its own)
    ``SymbolBlock.imports``: the exporting net's outputs."""
    prefix = built["prefixes"][src]
    sym_file, params = prefix + "-symbol.json", prefix + "-0000.params"
    n_in = len(built["xs"])
    names = ["data"] if n_in == 1 else ["data%d" % i for i in range(n_in)]
    with CPU:
        tsb = mt.gluon.SymbolBlock.imports(sym_file, names, params, ctx=CPU)
        tout = _run(mt, tsb, built["xs"])
    jsb = jmx.gluon.SymbolBlock.imports(sym_file, names, params)
    jout = _run(jmx, jsb, built["xs"])
    mine = built["got"] if src == "torch" else built["want"]
    for t, j, g, w in zip(tout, jout, built["got"], built["want"]):
        np.testing.assert_allclose(t, w, rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(j, g, rtol=FWD_TOL, atol=FWD_TOL)
    own = tout if src == "torch" else jout
    for o, m in zip(own, mine):
        np.testing.assert_array_equal(o, m)


@pytest.mark.parametrize("src", ["jax", "torch"])
def test_predictor_serves_the_other_packages_export(built, src):
    prefix = built["prefixes"][src]
    xs = built["xs"]
    names = ["data"] if len(xs) == 1 else ["data%d" % i
                                           for i in range(len(xs))]
    feed = dict(zip(names, xs))
    shapes = {k: v.shape for k, v in feed.items()}
    tp = mt.predict.Predictor(prefix + "-symbol.json",
                              prefix + "-0000.params", ctx=CPU,
                              input_shapes=shapes)
    tout = [o.asnumpy() for o in tp.forward(
        **{k: mt.nd.array(v, ctx=CPU) for k, v in feed.items()})]
    jp = jmx.predict.Predictor(prefix + "-symbol.json",
                               prefix + "-0000.params", input_shapes=shapes)
    jout = [o.asnumpy() for o in jp.forward(
        **{k: jmx.nd.array(v) for k, v in feed.items()})]
    for t, j, w in zip(tout, jout, built["want"]):
        np.testing.assert_allclose(t, w, rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(j, w, rtol=FWD_TOL, atol=FWD_TOL)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("kind", ["dense", "conv_bn"])
def test_symbolblock_gradients_match_jax(kind, tmp_path):
    """Fine-tuning an imported model: the same files in both packages,
    one recorded forward in training mode and the gradients of the
    summed squared outputs."""
    b = _build(kind, tmp_path)
    prefix = b["prefixes"]["jax"]
    x = b["xs"][0]
    grads = {}
    for name, mx in PKGS.items():
        kw = {"ctx": CPU} if mx is mt else {}
        sb = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                          prefix + "-0000.params", **kw)
        xa = mx.nd.array(x, **kw)
        with mx.autograd.record():
            loss = (sb(xa) ** 2).sum()
        loss.backward()
        grads[name] = {k: p.grad().asnumpy()
                       for k, p in sb.collect_params().items()
                       if p.grad_req != "null"}
        if mx is mt:
            aux = {k for k, p in sb.collect_params().items()
                   if p.grad_req == "null"}
            assert aux == set(mt.sym.load(prefix + "-symbol.json")
                              .list_auxiliary_states())
    got, want = grads["torch"], grads["jax"]
    assert got and set(got) <= set(want)
    total = np.sqrt(sum(np.square(want[k].astype(np.float64)).sum()
                        for k in got))
    diff = np.sqrt(sum(np.square(got[k].astype(np.float64) - want[k]).sum()
                       for k in got))
    assert diff <= GRAD_REL * total
    for k, g in got.items():
        if np.linalg.norm(want[k]) >= CANCELLED_SHARE * total:
            assert _rel_l2(g, want[k]) <= GRAD_REL, k


def test_symbolblock_composes_over_symbols(tmp_path):
    b = _build("dense", tmp_path)
    prefix = b["prefixes"]["torch"]
    outs, args = {}, {}
    for name, mx in PKGS.items():
        kw = {"ctx": CPU} if mx is mt else {}
        sb = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                          prefix + "-0000.params", **kw)
        inner = mx.gluon.SymbolBlock(mx.sym.var("x") * 2.0,
                                     [mx.sym.var("x")])
        composed = sb(inner(mx.sym.var("data")))
        assert isinstance(composed, mx.sym.Symbol)
        args[name] = (composed.list_arguments(), composed.list_outputs())
        block = mx.gluon.SymbolBlock(composed, [mx.sym.var("data")],
                                     params=sb.collect_params())
        xa = mx.nd.array(b["xs"][0], **kw)
        outs[name] = block(xa).asnumpy()
        np.testing.assert_array_equal(outs[name],
                                      sb(xa * 2.0).asnumpy())
    assert args["torch"] == args["jax"]
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("case", ["relu6", "dense_no_bias"])
def test_exports_the_jax_wrappers_refuse(case, tmp_path):
    """``F.clip(x, 0, 6)`` and a Dense without bias compose in the port
    (the JAX package's symbol wrappers raise for both) and export to the
    Gluon net's outputs."""
    nn = mt.gluon.nn
    with CPU:
        net = nn.HybridSequential(prefix="n_")
        with net.name_scope():
            if case == "relu6":
                net.add(nn.Dense(8), nn.HybridLambda(
                    lambda F, x: F.clip(x, 0, 6)))
            else:
                net.add(nn.Dense(8, use_bias=False), nn.Dense(3))
        net.initialize(mt.init.Xavier(), ctx=CPU)
        net.hybridize()
        x = mt.nd.array(20 * np.random.RandomState(2).randn(4, 5), ctx=CPU)
        want = net(x).asnumpy()
        prefix = str(tmp_path / case)
        net.export(prefix)
        sb = mt.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                          prefix + "-0000.params", ctx=CPU)
        np.testing.assert_array_equal(sb(x).asnumpy(), want)
    if case == "relu6":
        assert want.min() == 0.0 and want.max() == 6.0
    jx = jmx.sym.var("data")
    with pytest.raises((TypeError, AttributeError)):
        if case == "relu6":
            jmx.sym.clip(jx, 0, 6)
        else:
            jmx.sym.FullyConnected(jx, jmx.sym.var("w"), None, no_bias=True,
                                   num_hidden=3)


def test_positional_scalar_parameters_match_keywords():
    """``clip(x, 0, 6)`` is ``clip(x, a_min=0, a_max=6)`` in ``nd`` and in
    ``sym``, and both equal the JAX package's ``nd.clip``."""
    x = np.random.RandomState(3).uniform(-9, 9, (5, 7)).astype(np.float32)
    want = jmx.nd.clip(jmx.nd.array(x), 0, 6).asnumpy()
    with CPU:
        a = mt.nd.array(x, ctx=CPU)
        np.testing.assert_array_equal(mt.nd.clip(a, 0, 6).asnumpy(), want)
        np.testing.assert_array_equal(
            mt.nd.clip(a, a_min=0, a_max=6).asnumpy(), want)
        s = mt.sym.clip(mt.sym.var("x"), 0, 6)
        assert s._outputs[0][0].attrs == {"a_min": 0, "a_max": 6}
        out = s.bind(CPU, args={"x": a}, grad_req="null").forward()[0]
        np.testing.assert_array_equal(out.asnumpy(), want)
        # a None bound is a parameter, not a missing input
        np.testing.assert_array_equal(
            mt.nd.clip(a, None, 0.5).asnumpy(), np.minimum(x, 0.5))
        np.testing.assert_array_equal(
            mt.sym.clip(mt.sym.var("x"), None, 0.5).bind(
                CPU, args={"x": a}, grad_req="null").forward()[0].asnumpy(),
            np.minimum(x, 0.5))
    with pytest.raises(TypeError):
        mt.nd.clip(mt.nd.array(x, ctx=CPU), 0, 6, 7)


def test_parameter_var_matches_jax():
    np.random.seed(0)
    for mx in PKGS.values():
        p = mx.gluon.Parameter("w", shape=(3, 4), lr_mult=2.0, wd_mult=0.5,
                               init=mx.init.Normal(0.1))
        v = p.var()
        assert v is p.var()
        assert v.name == "w" and v.list_arguments() == ["w"]
        assert v.attr("__lr_mult__") == "2.0"
        assert v.attr("__wd_mult__") == "0.5"
        assert v.attr("__init__") == mx.init.Normal(0.1).dumps()


LAYERS = {
    # name: (layer factory over the nn module, input shape)
    "conv1d_maxpool1d": (lambda nn: [nn.Conv1D(4, 3, padding=1),
                                     nn.MaxPool1D(), nn.AvgPool1D(),
                                     nn.GlobalMaxPool1D()], (2, 3, 8)),
    "conv3d_pool3d": (lambda nn: [nn.Conv3D(4, 3, padding=1),
                                  nn.MaxPool3D(), nn.GlobalAvgPool3D()],
                      (2, 3, 4, 4, 4)),
    "conv2d_pools": (lambda nn: [nn.Conv2D(4, 3, strides=2, use_bias=False),
                                 nn.AvgPool2D(2, ceil_mode=True),
                                 nn.GlobalMaxPool2D(), nn.Flatten()],
                     (2, 3, 9, 9)),
    "reflection_pad": (lambda nn: [nn.Conv2D(2, 1), nn.ReflectionPad2D(1),
                                   nn.GlobalAvgPool2D()], (2, 3, 5, 5)),
    "norms": (lambda nn: [nn.InstanceNorm(), nn.LayerNorm(),
                          nn.BatchNorm(use_global_stats=True)],
              (2, 3, 4, 4)),
    "activations": (lambda nn: [nn.Dense(6, flatten=False), nn.LeakyReLU(0.1),
                                nn.PReLU(), nn.ELU(), nn.SELU(), nn.Swish(),
                                nn.GELU(), nn.Activation("softsign"),
                                nn.Dropout(0.0)], (2, 5, 7)),
    "embedding": (lambda nn: [nn.Embedding(11, 4), nn.Flatten()], (3, 5)),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_every_nn_layer_composes_and_exports(case, tmp_path):
    """Each ``gluon.nn`` layer composes over Symbols: its export runs to
    the Gluon net's outputs bit for bit through ``SymbolBlock``, with the
    JAX package's arguments; the Gluon outputs, from the JAX net's
    weights, within ``FWD_TOL`` of the JAX package's (the port's 1-D
    average pooling once raised: ``avg_pool1d`` takes no divisor)."""
    build, shape = LAYERS[case]
    rng = np.random.RandomState(5)
    x = rng.randint(0, 11, shape).astype(np.float32) if case == "embedding" \
        else rng.randn(*shape).astype(np.float32)
    args, outs, weights = {}, {}, None
    for name, mx in PKGS.items():
        net = mx.gluon.nn.HybridSequential(prefix="l_")
        with net.name_scope():
            net.add(*build(mx.gluon.nn))
        kw = {"ctx": CPU} if mx is mt else {}
        if weights is None:
            np.random.seed(0)
            net.initialize(mx.init.Xavier(), **kw)
        net.hybridize()
        xa = mx.nd.array(x, **kw)
        if weights is not None:
            net.load_dict(weights, ctx=CPU)
        want = outs[name] = net(xa).asnumpy()
        weights = {k: v.data().asnumpy()
                   for k, v in net.collect_params().items()}
        prefix = str(tmp_path / name)
        (TNames if mx is mt else JNames).reset()
        net.export(prefix)
        sb = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                          prefix + "-0000.params", **kw)
        np.testing.assert_array_equal(sb(xa).asnumpy(), want)
        sym = mx.sym.load(prefix + "-symbol.json")
        args[name] = (sym.list_arguments(), sym.list_auxiliary_states())
    assert args["torch"] == args["jax"]
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=FWD_TOL,
                               atol=FWD_TOL)
