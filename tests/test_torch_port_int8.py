"""The port's INT8 operators against the JAX package, on the CPU.

The same numpy inputs (from a seed) go through ``mxnet_tpu``'s functions
and through ``mxnet_tpu_torch``'s, whose CPU tensors run the plain PyTorch
versions of the kernels.  The hand-written CUDA kernels are held bit for
bit against those plain versions on the card (tests/test_torch_port_cuda.py
and ``chip_smoke.py``).

Tolerances:

* the int8 matmul, both variants, is bit-exact against ``int8_matmul_lax``
  and against the Pallas kernel through the interpreter: the int32 sum is
  exact, and the dequant is one rounding to f32 and one f32 product;
* every integer output of ``ops/quantization.py`` is bit-exact: the f32
  arithmetic before each rounding to int8 is the reference's, operation for
  operation (divisions by tensors, as XLA divides);
* f32 outputs (dequantize, quantized_dense, the ranges) within 1e-6
  relative;
* avg ``quantized_pooling`` may differ by 1 LSB at rounding ties only, on at
  most 0.1 % of the elements: the window sum of int8 values is exact in f32
  in any order, so the f32 average, and with it the tie, is the same on
  both sides unless a division rounds differently.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.contrib import quantization as jcq
from mxnet_tpu.ops import quantization as jq
from mxnet_tpu.ops.pallas.int8_matmul import (_int8_matmul_pallas,
                                              int8_matmul_lax)
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.contrib import quantization as tcq
from mxnet_tpu_torch.ops import quantization as tq
from mxnet_tpu_torch.ops.kernels import (common, int8_matmul,
                                         int8_matmul_reference)

F32_REL = dict(rtol=1e-6, atol=0)
RAGGED = [(7, 20, 6), (33, 301, 17), (129, 48, 140)]     # (M, K, N)
SCALES = ["none", "scale_a", "scale_b", "both"]


def _i8(shape, seed):
    return np.random.default_rng(seed).integers(
        -127, 128, shape).astype(np.int8)


def _f32(shape, seed, lo=-3.0, hi=3.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _bits_equal(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want)


def _scales(mode, n, seed):
    sa = np.float32([0.05]) if mode in ("scale_a", "both") else None
    sb = (_f32(n, seed, 0.01, 0.11) if mode in ("scale_b", "both")
          else None)
    return sa, sb


# ---------------------------------------------------------------------------
# the int8 matmul kernel's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scales", SCALES)
@pytest.mark.parametrize("M,K,N", RAGGED)
def test_int8_matmul_bit_exact_vs_lax_and_pallas(M, K, N, scales):
    a, b = _i8((M, K), 1), _i8((N, K), 2)
    sa, sb = _scales(scales, N, 3)
    got = int8_matmul(*_t(a, b, sa, sb))
    _bits_equal(got, int8_matmul_lax(*_j(a, b, sa, sb)))
    _bits_equal(got, _int8_matmul_pallas(*_j(a, b, sa, sb),
                                         interpret=True))


def test_int8_matmul_routes_cpu_tensors_to_the_plain_version():
    a, b = _t(_i8((4, 8), 1), _i8((3, 8), 2))
    common.reset_counts()
    out = int8_matmul(a, b)
    assert out.dtype == torch.int32
    assert common.selection_counts() == {
        "kernels.select.int8_matmul.reference": 1}
    assert common.launch_counts() == {}
    np.testing.assert_array_equal(
        out.numpy(), a.numpy().astype(np.int32) @ b.numpy().T.astype(
            np.int32))


def test_int8_matmul_reference_rejects_mismatched_scales():
    a, b = _t(_i8((4, 8), 1), _i8((3, 8), 2))
    with pytest.raises(ValueError, match="scales"):
        int8_matmul_reference(a, b, None, torch.ones(5))


# ---------------------------------------------------------------------------
# every op of ops/quantization.py
# ---------------------------------------------------------------------------
def _cmp(got, want, f32_tol=F32_REL):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **f32_tol)


def _range(v):
    return np.float32([-v]), np.float32([v])


@pytest.mark.parametrize("calib", [None, (-2.5, 1.75)])
def test_quantize_v2(calib):
    x = _f32((5, 7, 3), 4)
    kw = {} if calib is None else dict(min_calib_range=calib[0],
                                       max_calib_range=calib[1])
    _cmp(tq._quantize_v2(*_t(x), **kw), jq._quantize_v2(*_j(x), **kw))


@pytest.mark.parametrize("dtype", ["int8", "int32"])
def test_dequantize(dtype):
    q = (_i8((6, 9), 5) if dtype == "int8" else
         np.random.default_rng(5).integers(-2**30, 2**30, (6, 9))
         .astype(np.int32))
    mn, mx = _range(1.7)
    _cmp(tq._dequantize(*_t(q, mn, mx)), jq._dequantize(*_j(q, mn, mx)))


@pytest.mark.parametrize("calib", [None, (-0.8, 0.9)])
def test_requantize(calib):
    acc = np.random.default_rng(6).integers(-2**28, 2**28, (4, 11)) \
        .astype(np.int32)
    mn, mx = _range(3.0)
    kw = {} if calib is None else dict(min_calib_range=calib[0],
                                       max_calib_range=calib[1])
    _cmp(tq._requantize(*_t(acc, mn, mx), **kw),
         jq._requantize(*_j(acc, mn, mx), **kw))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("data_shape", [(8, 24), (5, 2, 3, 4)])
def test_quantized_fully_connected(data_shape, bias):
    x = _i8(data_shape, 7)
    w = _i8((6, int(np.prod(data_shape[1:]))), 8)
    args = [x, w, *_range(1.5), *_range(0.8)]
    if bias:
        args += [_i8((6,), 9), *_range(0.4)]
    kw = dict(num_hidden=6, no_bias=not bias)
    _cmp(tq._quantized_fc(*_t(*args), **kw), jq._quantized_fc(*_j(*args),
                                                               **kw))


@pytest.mark.parametrize("per_channel,bias", [(False, False), (True, False),
                                              (True, True)])
def test_quantized_dense(per_channel, bias):
    x, w = _i8((9, 20), 10), _i8((5, 20), 11)
    tw = _f32(5, 12, 0.5, 1.5) if per_channel else np.float32([0.8])
    args = [x, w, *_range(2.0), -tw, tw]
    if bias:
        args.append(_f32(5, 13))
    kw = dict(num_hidden=5, no_bias=not bias)
    _cmp(tq._quantized_dense(*_t(*args), **kw),
         jq._quantized_dense(*_j(*args), **kw))


def test_quantized_dense_matches_dequantized_fc():
    # the reference's oracle (tests/test_quantization.py), on the port
    x, w = _i8((8, 16), 14), _i8((4, 16), 15)
    ranges = [*_range(1.5), *_range(0.8)]
    dense = tq._quantized_dense(*_t(x, w, *ranges), num_hidden=4,
                                no_bias=True)
    fc = tq._quantized_fc(*_t(x, w, *ranges), num_hidden=4, no_bias=True)
    _cmp(dense, tq._dequantize(*fc))


CONV_CASES = [
    # (data NCHW, num_filter, kernel, stride, pad, dilate, groups, bias)
    ((2, 3, 9, 9), 4, (3, 3), (1, 1), (1, 1), (1, 1), 1, False),
    ((1, 4, 11, 8), 6, (3, 3), (2, 2), (1, 1), (1, 1), 2, True),
    ((2, 2, 10, 10), 3, (3, 3), (1, 1), (2, 2), (2, 2), 1, True),
    ((1, 8, 7, 7), 5, (1, 1), (2, 2), (0, 0), (1, 1), 1, False),
]


@pytest.mark.parametrize("case", CONV_CASES)
def test_quantized_conv(case):
    shape, nf, k, s, p, d, g, bias = case
    x = _i8(shape, 16)
    w = _i8((nf, shape[1] // g) + k, 17)
    args = [x, w, *_range(1.2), *_range(0.6)]
    if bias:
        args += [_i8((nf,), 18), *_range(0.3)]
    kw = dict(kernel=k, stride=s, pad=p, dilate=d, num_filter=nf,
              num_group=g, no_bias=not bias)
    _cmp(tq._quantized_conv(*_t(*args), **kw),
         jq._quantized_conv(*_j(*args), **kw))


def test_quantized_conv_exact_past_f32_accumulation():
    # |acc| up to 127^2 * 4608 (ResNet-50's 3x3x512): past f32's 2^24
    x = np.full((1, 512, 3, 3), 127, np.int8)
    w = np.full((2, 512, 3, 3), -127, np.int8)
    w[1, 0, 0, 0] = -126
    args = [x, w, *_range(1.0), *_range(1.0)]
    kw = dict(kernel=(3, 3), num_filter=2, no_bias=True)
    got = tq._quantized_conv(*_t(*args), **kw)
    _cmp(got, jq._quantized_conv(*_j(*args), **kw))
    assert int(got[0][0, 0, 0, 0]) - int(got[0][0, 1, 0, 0]) == -127


POOL_CASES = [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(2, 2), stride=(2, 2), pool_type="avg"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         pooling_convention="full"),
    dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), pool_type="avg",
         count_include_pad=False),
    dict(kernel=(7, 7), global_pool=True, pool_type="avg"),
    dict(kernel=(3, 3), stride=(2, 2), pool_type="max",
         pooling_convention="full"),
]


@pytest.mark.parametrize("kw", POOL_CASES)
def test_quantized_pooling(kw):
    x = _i8((2, 3, 9, 10), 19)
    mn, mx = _range(2.0)
    got = tq._quantized_pooling(*_t(x, mn, mx), **kw)
    want = jq._quantized_pooling(*_j(x, mn, mx), **kw)
    _cmp(got[1:], want[1:])
    g, w = _np(got[0]), _np(want[0])
    assert g.dtype == w.dtype == np.int8 and g.shape == w.shape
    diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
    if kw["pool_type"] == "max":
        assert diff.max() == 0
    else:   # 1 LSB at rounding ties only, on at most 0.1 % of elements
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_quantized_act_and_flatten():
    x = _i8((2, 3, 4, 5), 20)
    mn, mx = _range(1.0)
    _cmp(tq._quantized_act(*_t(x, mn, mx)), jq._quantized_act(*_j(x, mn,
                                                                     mx)))
    _cmp(tq._quantized_flatten(*_t(x, mn, mx)),
         jq._quantized_flatten(*_j(x, mn, mx)))


@pytest.mark.parametrize("rhs_dtype", ["int8", "int32"])
@pytest.mark.parametrize("calib", [None, (-3.0, 2.5)])
@pytest.mark.parametrize("with_relu", [False, True])
def test_quantized_elemwise_add(rhs_dtype, calib, with_relu):
    a = _i8((4, 6, 5), 21)
    b = (_i8((4, 6, 5), 22) if rhs_dtype == "int8" else
         np.random.default_rng(22).integers(-2**29, 2**29, (4, 6, 5))
         .astype(np.int32))
    args = [a, b, *_range(1.0), *_range(2.0)]
    kw = dict(with_relu=with_relu)
    if calib is not None:
        kw.update(min_calib_range=calib[0], max_calib_range=calib[1])
    _cmp(tq._quantized_elemwise_add(*_t(*args), **kw),
         jq._quantized_elemwise_add(*_j(*args), **kw))


@pytest.mark.parametrize("calib", [None, (-4.0, 4.0)])
def test_quantized_concat(calib):
    d0, d1 = _i8((2, 3, 4), 23), _i8((2, 5, 4), 24)
    d2 = np.random.default_rng(25).integers(-2**30, 2**30, (2, 2, 4)) \
        .astype(np.int32)
    args = [d0, d1, d2, *_range(1.0), *_range(3.0), *_range(0.5)]
    kw = dict(dim=1, num_args=3)
    if calib is not None:
        kw.update(min_calib_range=calib[0], max_calib_range=calib[1])
    _cmp(tq._quantized_concat(*_t(*args), **kw),
         jq._quantized_concat(*_j(*args), **kw))


def test_nd_contrib_namespace_runs_the_ops():
    """The generated ``nd.contrib`` functions: the reference's quantize /
    dequantize round trip and its fused-dense oracle, on the CPU."""
    nd, cpu = mt.nd, mt.cpu()
    x = _f32((4, 5), 26)
    q, mn, mx_ = nd.contrib.quantize_v2(nd.array(x, ctx=cpu))
    assert q.dtype == np.int8
    back = nd.contrib.dequantize(q, mn, mx_)
    np.testing.assert_allclose(back.asnumpy(), x, atol=3.0 / 127 + 1e-6)
    qx, qw = _i8((8, 16), 27), _i8((4, 16), 28)
    ranges = [nd.array(r, ctx=cpu) for r in (*_range(1.5), *_range(0.8))]
    fused = nd.contrib.quantized_dense(nd.array(qx, ctx=cpu),
                                       nd.array(qw, ctx=cpu), *ranges,
                                       num_hidden=4, no_bias=True)
    fc = nd.contrib.quantized_fully_connected(
        nd.array(qx, ctx=cpu), nd.array(qw, ctx=cpu), *ranges,
        num_hidden=4, no_bias=True)
    _cmp(fused.asnumpy(), nd.contrib.dequantize(*fc).asnumpy())


# ---------------------------------------------------------------------------
# calibration math (numpy on both sides)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_optimal_threshold_matches(seed):
    r = np.random.RandomState(seed)
    arr = np.concatenate([r.randn(20000), r.exponential(3.0, 200),
                          np.array([40.0])])
    assert tcq._get_optimal_threshold(arr) == \
        jcq._get_optimal_threshold(arr)
    p = np.array([0.0, 3.0, 0.0, 1.0])
    np.testing.assert_array_equal(tcq._smooth_distribution(p),
                                  jcq._smooth_distribution(p))


def test_quantize_weight_matches():
    w = _f32((6, 3, 3, 3), 29)
    for got, want in zip(tcq._quantize_weight(w), jcq._quantize_weight(w)):
        np.testing.assert_array_equal(got, want)
