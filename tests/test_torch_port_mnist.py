"""BASELINE.json's LeNet MNIST config: ``train_mnist.py``'s networks
through ``Module`` in the port against the JAX package's, on the CPU.

``example/image-classification/symbols/mlp.py`` (train_mnist.py's default
network) and ``symbols/lenet.py`` are the examples' own ``get_symbol``,
run once with the JAX package and once with the port as their ``mx``.
The data is ``common/data.py``'s seeded synthetic MNIST-shaped set (1 x 28
x 28, 10 classes); the settings are train_mnist.py's and fit.py's: batch
64, SGD lr 0.05, momentum 0.9, wd 1e-4, ``rescale_grad`` 1/64.  From the
JAX package's initial parameters, 3 ``forward_backward`` / ``update``
steps: each step's output within ``FWD_REL`` of its largest entry and
every parameter after each step within ``PARAM_REL`` of its largest
entry.  The JAX Module is given an SGD made the reference's way (with the
parameter names, so only ``*_weight`` decays), as ``test_torch_port_
module.py`` does (ROADMAP Queue 3).
"""
import argparse
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt

torch.set_num_threads(1)

CPU = mt.cpu()
FWD_REL = 1e-5
PARAM_REL = 1e-4
BATCH = 64
STEPS = 3
SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
EXAMPLE = (pathlib.Path(__file__).resolve().parents[1] / "example"
           / "image-classification")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _symbol(network, mx):
    """The example's ``get_symbol`` with ``mx`` as its package."""
    get = _load(EXAMPLE / "symbols" / ("%s.py" % network),
                "mnist_" + network).get_symbol
    return types.FunctionType(get.__code__, {"mx": mx})(num_classes=10)


def _data():
    args = argparse.Namespace(image_shape="1,28,28", num_classes=10,
                              num_examples=BATCH * STEPS)
    return _load(EXAMPLE / "common" / "data.py", "mnist_data")._synthetic(
        args)


def _steps(mx, sym, args, x, y):
    mod = mx.mod.Module(sym, **({"context": CPU} if mx is mt else {}))
    mod.bind(data_shapes=[("data", (BATCH,) + x.shape[1:])],
             label_shapes=[("softmax_label", (BATCH,))])
    if mx is mt:
        mod.init_params(arg_params=mt.model.params_from_numpy(
            args, ctx=CPU)[0])
        mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    else:
        mod.init_params(arg_params={k: jmx.nd.array(v)
                                    for k, v in args.items()})
        mod.init_optimizer(optimizer=jmx.optimizer.SGD(
            rescale_grad=1.0 / BATCH, sym=sym,
            param_idx2name=dict(enumerate(mod._param_names)), **SGD))
    ctx = {"ctx": CPU} if mx is mt else {}
    outs, params = [], []
    for s in range(STEPS):
        sl = slice(s * BATCH, (s + 1) * BATCH)
        mod.forward_backward(mx.io.DataBatch([mx.nd.array(x[sl], **ctx)],
                                             [mx.nd.array(y[sl], **ctx)]))
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
        params.append({k: v.asnumpy()
                       for k, v in mod.get_params()[0].items()})
    return outs, params


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, (what, err)


@pytest.mark.parametrize("network", ["mlp", "lenet"])
def test_mnist_module_steps_match_jax(network):
    x, y = _data()
    jsym = _symbol(network, jmx)
    tsym = _symbol(network, mt)
    assert tsym.list_arguments() == jsym.list_arguments()
    jmod = jmx.mod.Module(jsym)
    jmod.bind(data_shapes=[("data", (BATCH,) + x.shape[1:])],
              label_shapes=[("softmax_label", (BATCH,))])
    jmx.random.seed(0)
    jmod.init_params(jmx.init.Xavier())
    args = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    want = _steps(jmx, jsym, args, x, y)
    got = _steps(mt, tsym, args, x, y)
    for s in range(STEPS):
        _close(got[0][s], want[0][s], FWD_REL, (s, "output"))
        assert sorted(got[1][s]) == sorted(want[1][s])
        for name, w in want[1][s].items():
            _close(got[1][s][name], w, PARAM_REL, (s, name))
    # the updates are real: the parameters moved
    assert not np.array_equal(got[1][-1]["fc1_weight"], args["fc1_weight"])
