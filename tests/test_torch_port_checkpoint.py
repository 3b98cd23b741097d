"""The port's checkpoints against the JAX package's, on the CPU.

* ``model.save_checkpoint`` / ``load_checkpoint``: each package's files
  load in the other, with the same symbol (``list_arguments``,
  ``list_auxiliary_states``, ``list_outputs``) and the same ``arg:`` /
  ``aux:`` arrays, bit for bit.
* ``Module.fit`` of a small MLP with BatchNorm (its first product without
  bias, whose gradient BatchNorm would cancel) for two epochs with the
  ``do_checkpoint`` and ``module_checkpoint(save_optimizer_states=True)``
  callbacks, then ``Module.load(..., load_optimizer_states=True)`` and
  ``fit(begin_epoch=2)`` for two more: in the port the parameters, moving
  statistics and SGD momenta equal those of four uninterrupted epochs bit
  for bit (the loaded state is what the next update reads), and those of
  the JAX package's four epochs from the same initial numbers within
  ``FIT_REL`` relative L2 (16 SGD steps of f32 arithmetic done in two
  orders; the JAX Module gets an SGD made the reference's way, as in
  ``test_torch_port_module.py``: ROADMAP's known quirk).  The JAX package's own resumed run is not the reference: its
  ``Updater`` keeps the loaded momenta as numpy arrays, which its
  aggregated SGD update cannot write (ROADMAP Queue 3).
* bench.py's ``_build_int8_net`` chain on a narrow VGG11 (five stages of
  8-32 filters, the 4096-wide classifier kept) at 32 x 32: ``export``,
  ``load_checkpoint``, ``quantize_model`` (naive calibration on 4 images,
  ``fold_bn``, ``fuse_int8``), ``save_checkpoint`` and
  ``SymbolBlock.imports``, in each package.  Either package's quantized
  files, imported into the other, give that package's int8 outputs: the
  integer outputs bit-exact and the f32 ones within 1e-6 relative, as in
  ``tests/test_torch_port_int8.py``.  The two packages' chains rewrite the
  graph into the same nodes and parameters, their calibrated ranges within
  ``RANGE_REL`` of each other (the fp32 calibration forwards differ in the
  last bits), and their outputs agree within ``INT8_ATOL``: a range one
  ulp apart may move an int8 rounding tie by one step.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu.contrib.quantization import quantize_model as jquantize
from mxnet_tpu.gluon.model_zoo.vision.vgg import VGG as JVGG
from mxnet_tpu.symbol.symbol import _NameManager as JNames
from mxnet_tpu_torch.contrib.quantization import quantize_model as tquantize
from mxnet_tpu_torch.gluon.model_zoo.vision.vgg import VGG as TVGG
from mxnet_tpu_torch.symbol.symbol import _NameManager as TNames

CPU = mt.cpu()
PKGS = {"jax": jmx, "torch": mt}
FIT_REL = 1e-4
F32_REL = 1e-6
RANGE_REL = 1e-6
INT8_ATOL = 0.05
SGD = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp(mx):
    data = mx.sym.var("data")
    h = mx.sym.FullyConnected(data, num_hidden=16, no_bias=True, name="fc1")
    h = mx.sym.BatchNorm(h, name="bn1")
    h = mx.sym.Activation(h, act_type="relu", name="relu1")
    h = mx.sym.FullyConnected(h, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _init_params(seed=0):
    rng = np.random.default_rng(seed)
    args = {"fc1_weight": rng.normal(0, 0.3, (16, 10)),
            "bn1_gamma": np.ones(16),
            "bn1_beta": np.zeros(16),
            "fc2_weight": rng.normal(0, 0.3, (4, 16)),
            "fc2_bias": np.zeros(4)}
    auxs = {"bn1_moving_mean": np.zeros(16), "bn1_moving_var": np.ones(16)}
    return ({k: v.astype(np.float32) for k, v in args.items()},
            {k: v.astype(np.float32) for k, v in auxs.items()})


def _data(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(32, 10)).astype(np.float32)
    y = rng.integers(0, 4, 32).astype(np.float32)
    return x, y


def _nd(mx, v):
    return mx.nd.array(v, ctx=CPU) if mx is mt else mx.nd.array(v)


def _ctx(mx):
    return CPU if mx is mt else jmx.cpu()


def test_checkpoint_files_cross_load(tmp_path):
    args, auxs = _init_params()
    loaded = {}
    for src, mx in PKGS.items():
        prefix = str(tmp_path / src)
        with CPU:
            mx.model.save_checkpoint(
                prefix, 3, _mlp(mx), {k: _nd(mx, v) for k, v in args.items()},
                {k: _nd(mx, v) for k, v in auxs.items()})
        for dst, my in PKGS.items():
            with CPU:
                loaded[src, dst] = my.model.load_checkpoint(prefix, 3)
    for (src, dst), (sym, a, x) in loaded.items():
        ref = loaded["jax", "jax"][0]
        assert sym.list_arguments() == ref.list_arguments()
        assert sym.list_auxiliary_states() == ref.list_auxiliary_states()
        assert sym.list_outputs() == ref.list_outputs()
        assert sorted(a) == sorted(args) and sorted(x) == sorted(auxs)
        for k in args:
            np.testing.assert_array_equal(a[k].asnumpy(), args[k])
        for k in auxs:
            np.testing.assert_array_equal(x[k].asnumpy(), auxs[k])
    assert os.path.exists(str(tmp_path / "torch-0003.params"))


def _iter(mx):
    x, y = _data()
    return mx.io.NDArrayIter(x, y, 8, shuffle=False)


def _fit(mx, num_epoch, begin_epoch=0, mod=None, prefix=None):
    """A Module fitted from the same initial numbers; returns it."""
    args, auxs = _init_params()
    if mod is None:
        mod = mx.mod.Module(_mlp(mx), context=_ctx(mx))
    cbs = None
    if prefix is not None:
        cbs = [mx.callback.do_checkpoint(prefix),
               mx.callback.module_checkpoint(mod, prefix,
                                             save_optimizer_states=True)]
    optimizer = "sgd"
    if mx is jmx:       # the reference's SGD: only *_weight decays
        optimizer = jmx.optimizer.SGD(
            rescale_grad=1.0 / 8, sym=mod.symbol,
            param_idx2name=dict(enumerate(mod._param_names)), **dict(SGD))
    mod.fit(_iter(mx), num_epoch=num_epoch, begin_epoch=begin_epoch,
            optimizer=optimizer, optimizer_params=SGD,
            arg_params=None if begin_epoch else
            {k: _nd(mx, v) for k, v in args.items()},
            aux_params=None if begin_epoch else
            {k: _nd(mx, v) for k, v in auxs.items()},
            epoch_end_callback=cbs)
    return mod


def _state(mod):
    args, auxs = mod.get_params()
    out = {k: v.asnumpy() for k, v in list(args.items())
           + list(auxs.items())}
    for i, s in mod._updater.states.items():
        out["mom%d" % i] = np.asarray(s.asnumpy() if hasattr(s, "asnumpy")
                                      else s)
    return out


def _resumed(mx, tmp_path):
    prefix = str(tmp_path / ("ck_" + mx.__name__))
    _fit(mx, 2, prefix=prefix)
    assert os.path.exists(prefix + "-0002.params")
    assert os.path.exists(prefix + "-0002.states")
    mod = mx.mod.Module.load(prefix, 2, load_optimizer_states=True,
                             context=_ctx(mx))
    return _fit(mx, 4, begin_epoch=2, mod=mod)


def test_module_resume_is_bitwise_in_the_port_and_matches_jax(tmp_path):
    with CPU:
        whole = _state(_fit(mt, 4))
        resumed = _state(_resumed(mt, tmp_path))
    assert sorted(resumed) == sorted(whole)
    for k, v in whole.items():
        np.testing.assert_array_equal(resumed[k], v, err_msg=k)
    jax_whole = _state(_fit(jmx, 4))
    for k, v in resumed.items():
        want = jax_whole[k]
        err = np.linalg.norm(v - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= FIT_REL, (k, err)


def test_loaded_optimizer_state_is_what_the_next_update_reads(tmp_path):
    """After ``Module.load(load_optimizer_states=True)`` and
    ``init_optimizer`` the Updater holds the saved momenta; without the
    states it starts from zero and the next step differs."""
    prefix = str(tmp_path / "ck")
    with CPU:
        mod = _fit(mt, 1)
        mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
        saved = _state(mod)
        for with_states in (True, False):
            m2 = mt.mod.Module.load(prefix, 1,
                                    load_optimizer_states=with_states,
                                    context=CPU)
            it = _iter(mt)
            m2.bind(it.provide_data, it.provide_label)
            m2.init_optimizer(optimizer="sgd", optimizer_params=SGD)
            batch = next(iter(it))
            m2.forward_backward(batch)
            m2.update()
            mod_next = m2.get_params()[0]["fc2_weight"].asnumpy()
            if with_states:
                loaded = {"mom%d" % i: np.asarray(s.asnumpy())
                          for i, s in m2._updater.states.items()}
                assert sorted(loaded) == sorted(
                    k for k in saved if k.startswith("mom"))
                with_mom = mod_next
            else:
                without_mom = mod_next
    assert not np.array_equal(with_mom, without_mom)


# ---------------------------------------------------------------------------
# bench.py's _build_int8_net chain on a narrow VGG11
# ---------------------------------------------------------------------------
VGG11_NARROW = ([1, 1, 2, 2, 2], [8, 16, 16, 32, 32])


def _int8_chain(mx, quantize, vgg, tmp, jnet=None):
    """export -> load_checkpoint -> quantize_model -> save_checkpoint ->
    SymbolBlock.imports; returns the quantized prefix and the symbol."""
    rng = np.random.RandomState(0)
    calib_x = rng.rand(4, 3, 32, 32).astype(np.float32)
    net = vgg(*VGG11_NARROW, classes=10, prefix="vgg_")
    if jnet is None:
        net.initialize(jmx.init.Xavier())
    else:
        net.load_dict({k: v.data().asnumpy()
                       for k, v in jnet.collect_params().items()}, ctx=CPU)
    net.hybridize()
    net(_nd(mx, calib_x[:1]))
    prefix = os.path.join(tmp, mx.__name__)
    # node names come from a process-wide counter in each package
    (TNames if mx is mt else JNames).reset()
    net.export(prefix, 0)
    sym, args, auxs = mx.model.load_checkpoint(prefix, 0)
    calib = mx.io.NDArrayIter(calib_x, np.zeros(4), 2)
    kw = {"ctx": CPU} if mx is mt else {}
    qsym, qargs, qauxs = quantize(
        sym, args, auxs, calib_mode="naive", calib_data=calib,
        num_calib_examples=4, fold_bn=True, fuse_int8=True, **kw)
    mx.model.save_checkpoint(prefix + "_q", 0, qsym, qargs, qauxs)
    return net, prefix + "_q", qsym


@pytest.fixture(scope="module")
def int8_chains(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("int8"))
    np.random.seed(0)
    jnet, jprefix, jsym = _int8_chain(jmx, jquantize, JVGG, tmp)
    with CPU:
        _, tprefix, tsym = _int8_chain(mt, tquantize, TVGG, tmp, jnet)
    x = np.random.RandomState(5).rand(4, 3, 32, 32).astype(np.float32)
    return {"jax": (jprefix, jsym), "torch": (tprefix, tsym), "x": x}


def _internals(mx, prefix, x):
    """Every output of the quantized graph's nodes on ``x``, by name."""
    kw = {"ctx": CPU} if mx is mt else {}
    sym = mx.sym.load(prefix + "-symbol.json")
    inner = sym.get_internals()
    names = [n for n in inner.list_outputs() if not n.startswith("data")
             and n in {o for o in inner.list_outputs()}
             and not n.endswith(("_weight", "_bias", "_quantize", "min",
                                 "max", "_gamma", "_beta", "_mean", "_var"))]
    picked = mx.sym.Group([inner[n] for n in names])
    sb = mx.gluon.SymbolBlock(picked, [mx.sym.var("data")])
    loaded = mx.nd.load(prefix + "-0000.params", **kw)
    for name, p in sb.collect_params().items():
        value = loaded.get("arg:" + name, loaded.get("aux:" + name))
        if mx is mt:
            p.cast(value.dtype)
            if not value.data.is_floating_point():
                p.grad_req = "null"
        p._load_init_data(value, CPU if mx is mt else None)
    outs = sb(_nd(mx, x))
    return dict(zip(names, [o.asnumpy() for o in outs]))


def _held(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=F32_REL, atol=0,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("src", ["jax", "torch"])
def test_int8_files_run_the_same_in_both(int8_chains, src):
    """One package's quantized checkpoint in both packages: every node's
    outputs (ints bit-exact, f32 within 1e-6), and through
    ``SymbolBlock.imports`` the logits."""
    prefix, _ = int8_chains[src]
    x = int8_chains["x"]
    with CPU:
        got = _internals(mt, prefix, x)
    want = _internals(jmx, prefix, x)
    assert sorted(got) == sorted(want)
    assert any(v.dtype == np.int8 for v in got.values())
    assert any(v.dtype == np.int32 for v in got.values())
    for k in want:
        _held(got[k], want[k], k)
    with CPU:
        tsb = mt.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                           prefix + "-0000.params", ctx=CPU)
        tout = tsb(mt.nd.array(x, ctx=CPU)).asnumpy()
        assert np.dtype(np.int8) in {np.dtype(p.dtype) for p in
                                     tsb.collect_params().values()}
    jsb = jmx.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                        prefix + "-0000.params")
    _held(tout, jsb(jmx.nd.array(x)).asnumpy(), "logits")


def test_int8_chains_rewrite_alike(int8_chains):
    (_, jsym), (_, tsym) = int8_chains["jax"], int8_chains["torch"]
    jnodes = [(n.op.name if not n.is_var else None, n.name)
              for n in jsym._topo()]
    tnodes = [(n.op.name if not n.is_var else None, n.name)
              for n in tsym._topo()]
    assert tnodes == jnodes
    ops = {}
    for op, _ in tnodes:
        if op:
            ops[op] = ops.get(op, 0) + 1
    assert ops["_contrib_quantized_fully_connected"] == 3
    assert ops["_contrib_quantized_conv"] == 8
    for jn, tn in zip(jsym._topo(), tsym._topo()):
        assert sorted(tn.attrs) == sorted(jn.attrs), tn.name
        for k, v in jn.attrs.items():
            if k.endswith("calib_range"):
                assert abs(tn.attrs[k] - v) <= RANGE_REL * abs(v), tn.name
            else:
                assert tn.attrs[k] == v, (tn.name, k)
    x = int8_chains["x"]
    with CPU:
        tsb = mt.gluon.SymbolBlock.imports(
            int8_chains["torch"][0] + "-symbol.json", ["data"],
            int8_chains["torch"][0] + "-0000.params", ctx=CPU)
        got = tsb(mt.nd.array(x, ctx=CPU)).asnumpy()
    jp = int8_chains["jax"][0]
    jsb = jmx.gluon.SymbolBlock.imports(jp + "-symbol.json", ["data"],
                                        jp + "-0000.params")
    want = jsb(jmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=INT8_ATOL
                               * np.abs(want).max())
