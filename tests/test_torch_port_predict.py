"""The port's predict API (``Predictor`` and the ``MXPred*`` functions)
against the JAX package's, on the CPU.

The JAX package builds a seeded Gluon ``resnet18_v1(classes=10,
thumbnail=True)``, hybridizes it and exports it
(``prefix-symbol.json`` + ``prefix-0000.params``, the npz params file)
into a temporary directory, once per module.  The port's Predictor is
built from those files by path, from the params' bytes, from a dmlc
(``format="mxnet"``) copy of them, and through ``MXPredCreate``; each
output is held to the JAX Predictor's on the same seeded numpy input
within ``ATOL`` (f32 on both sides; the port's f32 ResNet forward stands
about 1e-7 from the JAX package's here).  ``reshape``, ``clone`` (the
parameter arrays shared), ``warm`` (no new input signature afterwards),
``health_check``, ``get_output_shape`` and the partial-output form are
held the same way, and the cases of ``tests/test_serving.py`` that
concern ``predict.py`` (the bytes regression, warm / health / clone) run
through both packages.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu import predict as jpredict
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import predict as tpredict
from mxnet_tpu_torch import profiler as tprof

CPU = mt.cpu()
ATOL = 1e-4
SHAPE = (2, 3, 32, 32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's ops here are small: on one thread they do not contend
    with the other test processes that share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    d = tmp_path_factory.mktemp("r18")
    np.random.seed(0)
    jmx.random.seed(0)
    net = jvision.resnet18_v1(classes=10, thumbnail=True)
    net.initialize(jmx.init.Xavier())
    net.hybridize()
    rng = np.random.RandomState(1)
    x = rng.rand(*SHAPE).astype(np.float32)
    net(jmx.nd.array(x))
    prefix = str(d / "r18")
    net.export(prefix)
    sym_file, params_file = prefix + "-symbol.json", prefix + "-0000.params"
    # the JAX Predictor's outputs at batch 2, 1 and 4 (one XLA compile
    # each, made once here for every test)
    jp = jpredict.Predictor(sym_file, params_file,
                            input_shapes={"data": SHAPE})
    want = np.asarray(jp.forward(data=jmx.nd.array(x))[0].asnumpy())
    x4 = rng.rand(4, *SHAPE[1:]).astype(np.float32)
    want4 = np.asarray(jp.reshape({"data": x4.shape}).forward(
        data=jmx.nd.array(x4))[0].asnumpy())
    want1 = np.asarray(jp.reshape({"data": (1,) + SHAPE[1:]}).forward(
        data=jmx.nd.array(x[:1]))[0].asnumpy())
    # the same parameters in the dmlc format
    dmlc_file = str(d / "r18-dmlc.params")
    jmx.nd.save(dmlc_file, jmx.nd.load(params_file), format="mxnet")
    return {"sym": sym_file, "params": params_file, "dmlc": dmlc_file,
            "x": x, "want": want, "x4": x4, "want4": want4,
            "want1": want1, "jp": jp}


def _port(exported, params=None, **kw):
    return tpredict.Predictor(exported["sym"],
                              params or exported["params"], ctx=CPU,
                              input_shapes={"data": SHAPE}, **kw)


@pytest.mark.parametrize("source", ["path", "bytes", "dmlc_path",
                                    "dmlc_bytes", "json_string"])
def test_predictor_matches_jax(exported, source):
    params = {"path": exported["params"], "dmlc_path": exported["dmlc"],
              "bytes": open(exported["params"], "rb").read(),
              "dmlc_bytes": open(exported["dmlc"], "rb").read(),
              "json_string": exported["params"]}[source]
    sym = open(exported["sym"]).read() if source == "json_string" \
        else exported["sym"]
    p = tpredict.Predictor(sym, params, ctx=CPU,
                           input_shapes={"data": SHAPE})
    got = p.forward(data=exported["x"])[0].asnumpy()
    assert got.shape == (SHAPE[0], 10)
    np.testing.assert_allclose(got, exported["want"], rtol=0, atol=ATOL)
    assert p.get_output_shape() == (SHAPE[0], 10)


def test_mxpred_c_api_matches_jax(exported):
    """The handle API in both packages: the port's outputs equal the JAX
    Predictor's, at the bound batch and after MXPredReshape; the JAX
    package's handle API gives its Predictor's outputs too."""
    blob = open(exported["params"], "rb").read()
    sym = open(exported["sym"]).read()
    h = tpredict.MXPredCreate(sym, blob, 1, 0, 1, ["data"], [SHAPE])
    assert tpredict.MXPredGetOutputShape(h, 0) == (SHAPE[0], 10)
    tpredict.MXPredSetInput(h, "data", exported["x"])
    tpredict.MXPredForward(h)
    np.testing.assert_allclose(tpredict.MXPredGetOutput(h, 0),
                               exported["want"], atol=ATOL, rtol=0)
    # reshape to one row: a new handle over the same weights
    h1 = tpredict.MXPredReshape(h, ["data"], [(1,) + SHAPE[1:]])
    tpredict.MXPredSetInput(h1, "data", exported["x"][:1])
    tpredict.MXPredForward(h1)
    np.testing.assert_allclose(tpredict.MXPredGetOutput(h1, 0),
                               exported["want1"], atol=ATOL, rtol=0)
    for handle in (h1, h):
        tpredict.MXPredFree(handle)
        assert handle not in tpredict._handles
    hj = jpredict.MXPredCreate(sym, blob, 1, 0, 1, ["data"], [SHAPE])
    jpredict.MXPredSetInput(hj, "data", exported["x"])
    jpredict.MXPredForward(hj)
    np.testing.assert_allclose(np.asarray(jpredict.MXPredGetOutput(hj, 0)),
                               exported["want"], atol=ATOL, rtol=0)
    jpredict.MXPredFree(hj)


def test_partial_output_matches_jax(exported):
    sym = open(exported["sym"]).read()
    blob = open(exported["params"], "rb").read()
    head = jmx.sym.load_json(sym).list_outputs()[0]
    h = tpredict.MXPredCreatePartialOut(sym, blob, 1, 0, ["data"], [SHAPE],
                                        [head])
    tpredict.MXPredSetInput(h, "data", exported["x"])
    tpredict.MXPredForward(h)
    np.testing.assert_allclose(tpredict.MXPredGetOutput(h, 0),
                               exported["want"], atol=ATOL, rtol=0)
    tpredict.MXPredFree(h)
    for mod, kw in ((jpredict, {}), (tpredict, {"ctx": CPU})):
        with pytest.raises(ValueError, match="not found"):
            mod.Predictor(sym, blob, input_shapes={"data": SHAPE},
                          output_names=[head + "_bogus"], **kw)


def test_reshape_clone_share_parameters(exported):
    p = _port(exported)
    c = p.clone()
    r = p.reshape({"data": (1,) + SHAPE[1:]})
    for other in (c, r):
        for k, v in p._shared_params().items():
            assert other._shared_params()[k] is v, k
    x = exported["x"]
    a = p.forward(data=x)[0].asnumpy()
    b = c.forward(data=x)[0].asnumpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(r.forward(data=x[:1])[0].asnumpy(),
                               exported["want1"], atol=ATOL, rtol=0)


def test_warm_then_no_new_signature_and_health(exported):
    p = _port(exported)
    assert p.warm([1, 2, 4]) == [1, 2, 4]
    before = tprof.dispatch_stats()["recompile"]
    got = p.forward(data=exported["x4"])[0].asnumpy()
    assert tprof.dispatch_stats()["recompile"] == before
    np.testing.assert_allclose(got, exported["want4"], atol=ATOL, rtol=0)
    assert p.health_check() is True
    assert exported["jp"].health_check() is True
    # a poisoned weight makes the zeros probe non-finite
    [w] = [a for n, a in p._executor.arg_dict.items()
           if n.endswith("dense0_weight")]
    saved = w.asnumpy().copy()
    w[:] = np.nan
    try:
        assert p.health_check() is False
    finally:
        w[:] = saved


def _fc_model(mx, ctx=None, seed=3):
    data = mx.sym.var("data")
    w = mx.sym.var("fc_weight")
    b = mx.sym.var("fc_bias")
    out = mx.sym.FullyConnected(data, w, b, num_hidden=5, name="fc")
    wn = np.random.RandomState(seed).rand(5, 4).astype(np.float32)
    kw = {} if ctx is None else {"ctx": ctx}
    params = {"arg:fc_weight": mx.nd.array(wn, **kw),
              "arg:fc_bias": mx.nd.zeros((5,), **kw)}
    return out, params, wn


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_load_params_from_bytes_regression(tmp_path, pkg):
    """tests/test_serving.py's case, through each package."""
    mx, mod, kw = ((jmx, jpredict, {}) if pkg == "jax"
                   else (mt, tpredict, {"ctx": CPU}))
    sym, params, wn = _fc_model(mx, kw.get("ctx"))
    path = str(tmp_path / "m.params")
    mx.nd.save(path, params)
    blob = open(path, "rb").read()
    arg, aux = mod._load_params(blob, **kw)
    np.testing.assert_array_equal(arg["fc_weight"].asnumpy(), wn)
    assert aux == {}
    arg2, _ = mod._load_params(bytearray(blob), **kw)
    np.testing.assert_array_equal(arg2["fc_weight"].asnumpy(), wn)
    p = mod.Predictor(sym, blob, input_shapes={"data": (2, 4)}, **kw)
    x = np.random.RandomState(14).rand(2, 4).astype(np.float32)
    got = p.forward(data=mx.nd.array(x, **kw))[0].asnumpy()
    np.testing.assert_allclose(got, x @ wn.T, rtol=1e-5)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_predictor_warm_health_clone(pkg):
    """tests/test_serving.py's case, through each package."""
    mx, mod, prof, kw = ((jmx, jpredict, jmx.profiler, {}) if pkg == "jax"
                         else (mt, tpredict, tprof, {"ctx": CPU}))
    sym, params, wn = _fc_model(mx, kw.get("ctx"))
    p = mod.Predictor(sym, params, input_shapes={"data": (1, 4)}, **kw)
    assert p.warm([1, 2, 4]) == [1, 2, 4]
    before = prof.dispatch_stats()["recompile"]
    x = np.random.RandomState(15).rand(2, 4).astype(np.float32)
    out = p.forward(data=mx.nd.array(x, **kw))[0].asnumpy()
    np.testing.assert_allclose(out, x @ wn.T, rtol=1e-5)
    assert prof.dispatch_stats()["recompile"] == before
    assert p.health_check() is True
    c = p.clone()
    out2 = c.forward(data=mx.nd.array(x, **kw))[0].asnumpy()
    np.testing.assert_allclose(out2, out, rtol=0, atol=0)


def test_defaults_and_unported_options(exported):
    """The default context is the card (the JAX package's is the CPU):
    without one the Predictor raises; the sharded mode raises and names
    its ROADMAP item; a missing data input shape is refused in both."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpredict.Predictor(exported["sym"], exported["params"],
                               input_shapes={"data": SHAPE})
    for kw in ({"mesh": object()}, {"rules": []}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            tpredict.Predictor(exported["sym"], exported["params"],
                               ctx=CPU, input_shapes={"data": SHAPE}, **kw)
    for mod, kw in ((jpredict, {}), (tpredict, {"ctx": CPU})):
        with pytest.raises(ValueError, match="input_shapes must cover"):
            mod.Predictor(exported["sym"], exported["params"], **kw)
    p = _port(exported)
    with pytest.raises(ValueError, match="unknown input"):
        p.set_input("bogus", exported["x"])
    with pytest.raises(RuntimeError, match="forward"):
        tpredict.Predictor(exported["sym"], exported["params"], ctx=CPU,
                           input_shapes={"data": SHAPE},
                           aot=False).get_output()
