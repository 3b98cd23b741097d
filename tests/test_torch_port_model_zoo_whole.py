"""The port's vision model zoo against the JAX package's, on the CPU:
whole nets by their graphs, and the model store.

* Every published configuration of ``get_model`` (all families, ResNets
  included), whole and at full width: the graph each package composes
  over ``sym.var("data")`` (explicit ``prefix=``, the node-name counters
  reset) is the same JSON node for node, so that the stems, the stage
  assembly, the channel lists and the asymmetric kernels and pads are the
  JAX package's.  With the blocks' logits of
  ``test_torch_port_model_zoo.py`` this holds each family's logits to the
  JAX package's without compiling a whole net there (8-30 s each on the
  CPU).
* In the port alone, the whole ``inception_v3`` (299 x 299), a DenseNet
  of two layers a block (224 x 224), MobileNet V1 and V2 at 0.25 and
  SqueezeNet 1.0 and 1.1 (64 x 64) through ``export``,
  ``SymbolBlock.imports`` and ``predict.Predictor``: the Gluon logits, bit
  for bit.
* ``get_model``'s names are the JAX package's.  ``pretrained=True`` with
  ``root=`` loads a ``.params`` file the test writes (the port's npz, and
  the reference's dmlc format) in both packages, to the written values bit
  for bit, for a ResNet, a SqueezeNet and a MobileNet; for every family a
  missing file raises in both, naming the file the model store looked for
  (so each family goes through the store), and a sha256 sidecar that does
  not match raises in both.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon.model_zoo import model_store as jstore
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.symbol.symbol import _NameManager as JNames
from mxnet_tpu_torch.gluon.model_zoo import model_store as tstore
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.symbol.symbol import _NameManager as TNames

CPU = mt.cpu()
PKGS = {"jax": (jmx, jvision), "torch": (mt, tvision)}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _composed(mx, vision, names, name):
    """``name``'s graph, composed over ``sym.var("data")`` with the node-name
    counter reset, as parsed JSON."""
    net = vision.get_model(name, classes=10, prefix="net_")
    names.reset()
    return json.loads(net(mx.sym.var("data")).tojson())


@pytest.mark.parametrize("name", sorted(jvision._models))
def test_whole_net_graph_matches_jax(name, monkeypatch):
    """Every published configuration, at full depth and width: the graph
    each package composes is the same JSON, node for node (operators,
    their attributes — channels, kernels, strides, pads, groups, pooling
    conventions —, inputs and parameter names).  The JAX package's symbol
    wrappers take no positional scalar parameter, so MobileNet V2's
    ``F.clip(x, 0, 6)`` is passed on to its ``clip`` by keyword there."""
    jclip = jmx.symbol.clip
    monkeypatch.setattr(jmx.symbol, "clip", lambda x, a_min, a_max, **kw:
                        jclip(x, a_min=a_min, a_max=a_max, **kw))
    want = _composed(jmx, jvision, JNames, name)
    got = _composed(mt, tvision, TNames, name)
    assert [n["op"] for n in got["nodes"]] == [n["op"] for n in
                                               want["nodes"]]
    assert got == want


WHOLE = {"inceptionv3": (lambda: tvision.inception_v3(classes=10), 299),
         "densenet": (lambda: tvision.DenseNet(8, 4, [2, 2, 2, 2],
                                               classes=10), 224),
         "mobilenet0.25": (lambda: tvision.mobilenet0_25(classes=10), 64),
         "mobilenetv2_0.25": (lambda: tvision.mobilenet_v2_0_25(classes=10),
                              64),
         "squeezenet1.0": (lambda: tvision.squeezenet1_0(classes=10), 64),
         "squeezenet1.1": (lambda: tvision.squeezenet1_1(classes=10), 64)}


@pytest.mark.parametrize("name", sorted(WHOLE))
def test_whole_net_exports_and_serves_in_the_port(name, tmp_path):
    build, size = WHOLE[name]
    x = np.random.RandomState(1).rand(1, 3, size, size).astype(np.float32)
    with CPU:
        net = build()
        net.initialize(mt.init.Xavier(), ctx=CPU)
        net.hybridize()
        xa = mt.nd.array(x, ctx=CPU)
        want = net(xa).asnumpy()
        prefix = str(tmp_path / "net")
        net.export(prefix)
        sb = mt.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                          prefix + "-0000.params", ctx=CPU)
        np.testing.assert_array_equal(sb(xa).asnumpy(), want)
        pred = mt.predict.Predictor(prefix + "-symbol.json",
                                    prefix + "-0000.params", ctx=CPU,
                                    input_shapes={"data": x.shape})
        np.testing.assert_array_equal(pred.forward(data=xa)[0].asnumpy(),
                                      want)
    assert want.shape == (1, 10) and np.isfinite(want).all()


def test_get_model_names_match_jax():
    assert sorted(tvision._models) == sorted(jvision._models)
    for name in ("vgg16", "squeezenet1.1", "mobilenetv2_0.5", "inceptionv3",
                 "densenet121", "alexnet", "resnet18_v1"):
        t = tvision.get_model(name, classes=10)
        j = jvision.get_model(name, classes=10)
        assert type(t).__name__ == type(j).__name__
    for mx, vision in PKGS.values():
        with pytest.raises(ValueError, match="not supported"):
            vision.get_model("vgg17")


# the smaller families load whole; every family's missing file is looked
# for under its own name
LOADED = {"resnet18_v1": dict(thumbnail=True, classes=10, size=32),
          "squeezenet1.1": dict(classes=10, size=64),
          "mobilenet0.25": dict(classes=10, size=32)}
STORE_NAMES = {"vgg11": "vgg11", "vgg16_bn": "vgg16_bn",
               "alexnet": "alexnet", "squeezenet1.0": "squeezenet1.0",
               "mobilenet0.5": "mobilenet0.5",
               "mobilenetv2_0.75": "mobilenetv2_0.75",
               "densenet169": "densenet169", "inceptionv3": "inceptionv3",
               "resnet50_v2": "resnet50_v2"}


def _written(name, root, fmt):
    """Write ``name``'s parameters under ``root`` (from a port net run once
    on the CPU), as ``<name>.params`` in ``fmt``; returns them."""
    kw = dict(LOADED[name])
    size = kw.pop("size")
    with CPU:
        net = tvision.get_model(name, **kw)
        net.initialize(mt.init.Xavier(), ctx=CPU)
        net(mt.nd.array(np.random.RandomState(0).rand(1, 3, size, size),
                        ctx=CPU))
        params = {k: v._reduce()
                  for k, v in net._collect_params_with_prefix().items()}
        mt.nd.save(os.path.join(root, name + ".params"), params,
                   **({"format": "mxnet"} if fmt == "dmlc" else {}))
    return {k: v.asnumpy() for k, v in params.items()}


@pytest.mark.parametrize("name,fmt", [("resnet18_v1", "dmlc"),
                                      ("squeezenet1.1", "npz"),
                                      ("mobilenet0.25", "dmlc")])
def test_pretrained_loads_a_local_file_in_both(name, fmt, tmp_path):
    want = _written(name, str(tmp_path), fmt)
    kw = {k: v for k, v in LOADED[name].items() if k != "size"}
    with CPU:
        tnet = tvision.get_model(name, pretrained=True, root=str(tmp_path),
                                 ctx=CPU, **kw)
    jnet = jvision.get_model(name, pretrained=True, root=str(tmp_path), **kw)
    for net in (tnet, jnet):
        got = {k: v.data().asnumpy()
               for k, v in net._collect_params_with_prefix().items()}
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("name", sorted(STORE_NAMES))
def test_missing_pretrained_file_raises_in_both(name, tmp_path):
    for mx, vision in PKGS.values():
        with pytest.raises(RuntimeError, match="'%s'" % STORE_NAMES[name]):
            vision.get_model(name, pretrained=True, root=str(tmp_path))


def test_sha256_sidecar_is_checked_in_both(tmp_path):
    path = tmp_path / "mobilenet0.25.params"
    path.write_bytes(b"weights")
    sidecar = tmp_path / "mobilenet0.25.sha256"
    for store in (tstore, jstore):
        sidecar.write_text("0" * 64 + "\n")
        with pytest.raises(ValueError, match="sha256"):
            store.get_model_file("mobilenet0.25", root=str(tmp_path))
        sidecar.write_text(hashlib.sha256(b"weights").hexdigest())
        assert store.get_model_file("mobilenet0.25", root=str(tmp_path)) \
            == str(path)
        sidecar.write_text("")
        with pytest.raises(ValueError, match="empty"):
            store.get_model_file("mobilenet0.25", root=str(tmp_path))


def test_store_resolves_hashed_names_and_purges_in_both(tmp_path):
    for store in (tstore, jstore):
        hashed = tmp_path / "alexnet-44335d1f.params"
        hashed.write_bytes(b"w")
        (tmp_path / "alexnet.sha256").write_text(
            hashlib.sha256(b"w").hexdigest())
        assert store.get_model_file("alexnet", root=str(tmp_path)) \
            == str(hashed)
        store.purge(root=str(tmp_path))
        assert not os.listdir(tmp_path)
        with pytest.raises(RuntimeError, match="not found"):
            store.get_model_file("alexnet", root=str(tmp_path))
