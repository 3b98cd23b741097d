"""The port's vision model zoo against the JAX package's, on the CPU: the
families' logits.

Each family is built in both packages with the same explicit ``prefix=``;
the JAX net is initialized (numpy's global RNG, seeded) and run once, and
its parameters, read out as numpy, go into the port's net by name
(``load_dict``).  Both run hybridized on the same seeded numpy
input, and the logits agree within ``FWD_REL`` of their largest entry (f32
on both sides; the port's convolutions and products stand 1e-7 to 1e-6
from the JAX package's).  Sizes are cut to run in seconds, widths kept
where the family fixes them:

* whole nets: VGG at two stages of 8 and 16 filters (the 4096-wide
  classifier kept), with and without BatchNorm, at 16 x 16; AlexNet as
  published, at 63 x 63;
* SqueezeNet, DenseNet, MobileNet and Inception V3 by their blocks
  (SqueezeNet's stem with its ``ceil_mode`` pool and a fire module;
  DenseNet's dense layer and transition; MobileNet V1's
  depthwise-separable unit with relu6, V2's bottleneck with and without its
  shortcut; Inception's A, B, C, D and E as published, on a 9 x 9 map of
  16 channels): the JAX package compiles such a whole net for 8-30 s on the
  CPU.  What these blocks do not reach (the stems, the stage assembly, the
  channel lists of each configuration) is held to the JAX package's graph
  in ``test_torch_port_model_zoo_whole.py``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.gluon.model_zoo.vision import densenet as jdense
from mxnet_tpu.gluon.model_zoo.vision import inception as jinc
from mxnet_tpu.gluon.model_zoo.vision import mobilenet as jmob
from mxnet_tpu.gluon.model_zoo.vision import squeezenet as jsq
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.model_zoo.vision import densenet as tdense
from mxnet_tpu_torch.gluon.model_zoo.vision import inception as tinc
from mxnet_tpu_torch.gluon.model_zoo.vision import mobilenet as tmob
from mxnet_tpu_torch.gluon.model_zoo.vision import squeezenet as tsq

CPU = mt.cpu()
FWD_REL = 1e-5
MODULES = {"jax": {"nn": jnn, "inception": jinc, "mobilenet": jmob,
                   "densenet": jdense, "squeezenet": jsq},
           "torch": {"nn": tnn, "inception": tinc, "mobilenet": tmob,
                     "densenet": tdense, "squeezenet": tsq}}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


FAMILIES = {
    # name: (factory(vision module, the family modules), input shape)
    "vgg": (lambda v, m: v.VGG([1, 1], [8, 16], classes=10, prefix="vgg_"),
            (2, 3, 16, 16)),
    "vgg_bn": (lambda v, m: v.VGG([1, 1], [8, 16], classes=10,
                                  batch_norm=True, prefix="vggbn_"),
               (2, 3, 16, 16)),
    "alexnet": (lambda v, m: v.AlexNet(classes=10, prefix="alex_"),
                (2, 3, 63, 63)),
    "squeezenet_stem_fire": (lambda v, m: _stem_fire(m), (2, 3, 20, 20)),
    "densenet_layer": (lambda v, m: _dense_layer(m), (2, 8, 9, 9)),
    "densenet_transition": (lambda v, m: _transition(m), (2, 16, 8, 8)),
    "mobilenet_conv_dw_relu6": (lambda v, m: _conv_dw(m), (2, 8, 9, 9)),
    "mobilenetv2_bottleneck": (
        lambda v, m: m["mobilenet"].LinearBottleneck(8, 8, 6, 1,
                                                     prefix="lb1_"),
        (2, 8, 9, 9)),
    "mobilenetv2_bottleneck_stride2": (
        lambda v, m: m["mobilenet"].LinearBottleneck(8, 16, 6, 2,
                                                     prefix="lb2_"),
        (2, 8, 9, 9)),
    "inception_A": (lambda v, m: m["inception"]._make_A(32, "A_"),
                    (1, 16, 9, 9)),
    "inception_B": (lambda v, m: m["inception"]._make_B("B_"),
                    (1, 16, 9, 9)),
    "inception_C": (lambda v, m: m["inception"]._make_C(128, "C_"),
                    (1, 16, 9, 9)),
    "inception_D": (lambda v, m: m["inception"]._make_D("D_"),
                    (1, 16, 9, 9)),
    "inception_E": (lambda v, m: m["inception"]._make_E("E_"),
                    (1, 16, 9, 9)),
}


def _stem_fire(m):
    """SqueezeNet's stem (a pool with ``ceil_mode``) and a fire module."""
    nn = m["nn"]
    net = nn.HybridSequential(prefix="sq_")
    with net.name_scope():
        net.add(nn.Conv2D(16, kernel_size=3, strides=2),
                nn.Activation("relu"),
                nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True),
                m["squeezenet"]._make_fire(8, 16, 16))
    return net


def _dense_layer(m):
    """DenseNet's dense layer.  It builds its body outside its own name
    scope, so it is built inside one here: its layers' names then do not
    depend on how many unnamed blocks each package made before."""
    net = m["nn"].HybridSequential(prefix="dl_")
    with net.name_scope():
        net.add(m["densenet"]._DenseLayer(4, 2, 0))
    return net


def _transition(m):
    net = m["nn"].HybridSequential(prefix="tr_")
    with net.name_scope():
        net.add(m["densenet"]._make_transition(8))
    return net


def _conv_dw(m):
    """MobileNet V1's depthwise-separable unit, with relu6 (V2's) after
    each convolution."""
    net = m["nn"].HybridSequential(prefix="dw_")
    with net.name_scope():
        m["mobilenet"]._add_conv_dw(net, dw_channels=8, channels=16,
                                    stride=2, relu6=True)
    return net


def _jax_weights(net):
    return {k: v.data().asnumpy() for k, v in net.collect_params().items()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_logits_match_jax(family):
    build, shape = FAMILIES[family]
    np.random.seed(0)
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    jnet = build(jvision, MODULES["jax"])
    jnet.initialize(jmx.init.Xavier())
    jnet.hybridize()
    want = jnet(jmx.nd.array(x)).asnumpy()
    with CPU:
        tnet = build(tvision, MODULES["torch"])
        tnet.load_dict(_jax_weights(jnet), ctx=CPU)
        tnet.hybridize()
        got = tnet(mt.nd.array(x, ctx=CPU)).asnumpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FWD_REL * np.abs(want).max())
