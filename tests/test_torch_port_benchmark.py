"""The port's throughput harness (``mxnet_tpu_torch.benchmark``) against the
JAX package's, on the CPU.

``compiled_throughput`` and ``percall_throughput`` return the same
``{median, min, max, draws}`` summaries as the JAX package's over the cases
of ``tests/test_benchmark.py`` (a hybridized Dense / BatchNorm / Dense net;
its BatchNorm stays usable eagerly afterwards).  On the CPU the K-step
chained loop runs eagerly: its carry equals the input bit for bit (the
runtime-zero probe adds ``out[0] * 0``), and its last output equals K eager
forwards of the net on the input and, within ``ATOL``, the JAX package's
forward of the same weights.  The card's CUDA-graph form is held to the
eager chain in ``tests/test_torch_port_cuda.py``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu import benchmark as jbench
from mxnet_tpu import gluon as jgluon
from mxnet_tpu_torch import benchmark as tbench
from mxnet_tpu_torch import gluon as tgluon

CPU = mt.cpu()
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's ops here are small: on one thread they do not contend
    with the other test processes that share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nets():
    """The test_benchmark.py net in both packages, the port's carrying the
    JAX package's initialized weights, and each one's input."""
    x = np.random.RandomState(0).rand(16, 8).astype(np.float32)
    nets = {}
    for name, g, mx, kw in (("jax", jgluon, jmx, {}),
                            ("torch", tgluon, mt, {"ctx": CPU})):
        net = g.nn.HybridSequential(prefix="b_")
        with net.name_scope():
            net.add(g.nn.Dense(8), g.nn.BatchNorm(), g.nn.Dense(4))
        net.initialize(**kw)
        net.hybridize()
        xa = mx.nd.array(x, **kw)
        with mx.autograd.pause():
            net(xa)
        nets[name] = (net, xa)
    weights = {k: v.data().asnumpy()
               for k, v in nets["jax"][0].collect_params().items()}
    nets["torch"][0].load_dict(weights, ctx=CPU)
    return nets


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_compiled_throughput_shape_and_stability(pkg):
    net, x = _nets()[pkg]
    bench = jbench if pkg == "jax" else tbench
    r = bench.compiled_throughput(net, x, steps=4, draws=3)
    assert set(r) == {"median", "min", "max", "draws"}
    assert 0 < r["min"] <= r["median"] <= r["max"]
    assert r["draws"] == 3
    net(x).asnumpy()               # the net stays usable eagerly


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_percall_throughput_runs(pkg):
    net, x = _nets()[pkg]
    bench = jbench if pkg == "jax" else tbench
    r = bench.percall_throughput(net, x, steps=2, draws=2)
    assert set(r) == {"median", "min", "max", "draws"}
    assert 0 < r["min"] <= r["median"] <= r["max"] and r["draws"] == 2


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_interleaved_throughput_one_median_per_pair(pkg):
    nets = _nets()
    net, x = nets[pkg]
    bench = jbench if pkg == "jax" else tbench
    got = bench.interleaved_throughput([(net, x), (net, x)], steps=2,
                                       reps=2)
    assert len(got) == 2 and all(v > 0 for v in got)


def test_cpu_chained_loop_equals_k_eager_forwards():
    nets = _nets()
    net, x = nets["torch"]
    steps = 5
    loop = tbench.compiled_loop(net, x, steps)
    assert not hasattr(loop, "graph")          # the CPU runs it eagerly
    assert torch.equal(loop.carry, x.data)      # the probe adds zero
    with mt.autograd.pause():
        eager = [net(x).data for _ in range(steps)]
    assert all(torch.equal(e, eager[0]) for e in eager)
    assert torch.equal(loop.out, eager[-1])
    assert loop.draw() > 0
    jnet, jx = nets["jax"]
    with jmx.autograd.pause():
        want = np.asarray(jnet(jx).asnumpy())
    np.testing.assert_allclose(loop.out.numpy(), want, atol=ATOL, rtol=0)
    # the chain is really chained: a non-zero probe moves the carry
    carry, _ = tbench.chained_forward(net, x.data, torch.ones(()), 2)
    assert not torch.equal(carry, x.data)


def test_graph_replay_counter_only_counts_the_card():
    """On the CPU no graph exists, so nothing counts as a replay."""
    net, x = _nets()["torch"]
    before = tbench.graph_replays()
    tbench.compiled_throughput(net, x, steps=2, draws=2)
    assert tbench.graph_replays() == before


def test_bf16_chain_and_percall_on_a_hybridized_resnet():
    """The inference leg's shape at a tiny size: a hybridized bf16 narrow
    ResNet-v1 (BatchNorm in f32, global average pooling) runs both
    disciplines, and the chain's output equals an eager forward."""
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        BasicBlockV1, ResNetV1)

    mt.random.seed(0)
    net = ResNetV1(BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 32, 64],
                   classes=10, thumbnail=True)
    net.initialize(mt.init.Xavier(), ctx=CPU)
    net.hybridize(static_alloc=True, static_shape=True)
    x32 = mt.nd.array(np.random.RandomState(1).rand(2, 3, 16, 16)
                      .astype(np.float32), ctx=CPU)
    with mt.autograd.pause():
        net(x32)
    net.cast("bfloat16")
    x = x32.astype("bfloat16")
    loop = tbench.compiled_loop(net, x, 3)
    with mt.autograd.pause():
        want = net(x).data
    assert loop.out.dtype == torch.bfloat16
    assert torch.equal(loop.out, want) and torch.equal(loop.carry, x.data)
    r = tbench.percall_throughput(net, x, steps=2, draws=2)
    assert r["draws"] == 2 and r["median"] > 0
