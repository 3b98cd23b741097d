"""The port's spatial operators (``mxnet_tpu_torch/ops/spatial.py``)
against the JAX package's on the CPU, from the same seeded numpy inputs:
forward, and backward where the JAX package differentiates.

Tolerances: f32 outputs and gradients within 1e-5 (the same arithmetic,
sums in another order), gradients through bilinear sampling within 1e-4
(the weights' products reassociate across the four taps).  ROIPooling is
held to the JAX package's masked max per bin on ROIs that meet at bin
edges, at C rounding's halves and outside the image, with ties in the
data (the gradient splits evenly over a bin's equal maxima).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import spatial
from torch_port_op_util import F32, compare

BILINEAR_GRAD = dict(rtol=1e-4, atol=1e-4)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def test_c_round_is_half_away_from_zero():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 2.4, -2.6])
    np.testing.assert_array_equal(spatial.c_round(x).numpy(),
                                  [1, 2, 3, -1, -2, -3, 2, -3])
    from mxnet_tpu.ops.tensor import c_round
    np.testing.assert_array_equal(spatial.c_round(x).numpy(),
                                  np.asarray(c_round(x.numpy())))


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_upsampling(mode):
    compare("UpSampling", [_rand(2, 3, 5, 4)],
            dict(scale=2, sample_type=mode), wrt=(0,))


@pytest.mark.parametrize("scale", [3])
def test_upsampling_bilinear_odd_scale(scale):
    compare("UpSampling", [_rand(1, 2, 4, 6)],
            dict(scale=scale, sample_type="bilinear"), wrt=(0,))


def test_grid_generator_affine():
    theta = np.array([[1.1, 0.2, 0.1, -0.1, 0.9, 0.05],
                      [0.8, -0.3, -0.2, 0.25, 1.2, 0.1]], np.float32)
    compare("GridGenerator", [theta],
            dict(transform_type="affine", target_shape=(5, 7)), wrt=(0,))


def test_grid_generator_warp():
    compare("GridGenerator", [_rand(2, 2, 4, 6)],
            dict(transform_type="warp"), wrt=(0,))


def test_bilinear_sampler_inside_and_outside():
    data = _rand(2, 3, 6, 7)
    grid = np.random.RandomState(1).uniform(-1.3, 1.3, (2, 2, 5, 4)) \
        .astype(np.float32)
    compare("BilinearSampler", [data, grid], wrt=(0, 1),
            grad_tol=BILINEAR_GRAD)


def test_spatial_transformer():
    data = _rand(2, 3, 8, 8)
    loc = np.array([[0.9, 0.1, 0.05, -0.1, 1.05, 0.0],
                    [0.7, 0.0, -0.2, 0.0, 0.7, 0.3]], np.float32)
    compare("SpatialTransformer", [data, loc],
            dict(target_shape=(6, 5)), wrt=(0, 1), grad_tol=BILINEAR_GRAD)


ROIS = np.array([[0, 0.0, 0.0, 15.0, 11.0],      # the whole image
                 [1, 2.5, 1.5, 9.5, 7.5],        # C rounding's halves
                 [0, 3.0, 2.0, 3.0, 2.0],        # one pixel
                 [1, -4.0, -3.0, 30.0, 20.0],    # beyond the image
                 [0, 6.2, 4.9, 13.7, 10.1]], np.float32)


@pytest.mark.parametrize("pooled,scale", [((3, 3), 1.0), ((2, 4), 0.5),
                                          ((7, 7), 1.0)])
def test_roi_pooling(pooled, scale):
    data = _rand(2, 3, 12, 16)
    compare("ROIPooling", [data, ROIS], dict(pooled_size=pooled,
                                             spatial_scale=scale), wrt=(0,))


def test_roi_pooling_ties_split_the_gradient_evenly():
    """A constant plane: every position of a bin holds its max, so each
    gets an equal share of the bin's cotangent, as ``amax`` gives it."""
    data = np.ones((1, 2, 6, 6), np.float32)
    data[0, 1] = np.arange(36, dtype=np.float32).reshape(6, 6) % 3
    rois = np.array([[0, 0, 0, 5, 5], [0, 1, 1, 4, 3]], np.float32)
    compare("ROIPooling", [data, rois], dict(pooled_size=(2, 2)), wrt=(0,))


def test_roi_pooling_chunks_agree(monkeypatch):
    """ROI chunks of one ROI give what one chunk gives."""
    data = torch.from_numpy(_rand(2, 3, 12, 16)).requires_grad_(True)
    rois = torch.from_numpy(ROIS)
    g = torch.from_numpy(_rand(5, 3, 3, 3, seed=4))
    whole = spatial._roi_pooling(data, rois, pooled_size=(3, 3))
    (gw,) = torch.autograd.grad(whole, data, g)
    monkeypatch.setattr(spatial, "_ROI_CHUNK_BYTES", 1)
    parts = spatial._roi_pooling(data, rois, pooled_size=(3, 3))
    (gp,) = torch.autograd.grad(parts, data, g)
    assert torch.equal(whole, parts) and torch.equal(gw, gp)


@pytest.mark.parametrize("kw", [dict(h_w=(3, 4), offset=(1, 2)),
                                dict(h_w=(3, 4), center_crop=True)])
def test_crop(kw):
    compare("Crop", [_rand(2, 3, 7, 9)], kw, wrt=(0,))


def test_crop_like():
    compare("Crop", [_rand(1, 2, 6, 6), _rand(1, 1, 4, 3)],
            dict(center_crop=True), wrt=(0,))


@pytest.mark.parametrize("norm", ["null", "batch", "valid"])
def test_make_loss(norm):
    compare("MakeLoss", [_rand(4, 5)], dict(grad_scale=0.5,
                                            normalization=norm), wrt=(0,))


@pytest.mark.parametrize("linear", [False, True])
def test_svm_output(linear):
    data = _rand(6, 4)
    label = np.array([0, 3, 1, 2, 2, 0], np.float32)
    compare("SVMOutput", [data, label], dict(margin=1.5, use_linear=linear,
                                             regularization_coefficient=0.7),
            wrt=(0,))


@pytest.mark.parametrize("kw", [
    dict(kernel_size=1, max_displacement=2, stride1=1, stride2=1, pad_size=2),
    dict(kernel_size=3, max_displacement=2, stride1=2, stride2=2, pad_size=3),
    dict(kernel_size=3, max_displacement=1, pad_size=2, is_multiply=False),
])
def test_correlation(kw):
    compare("Correlation", [_rand(2, 3, 9, 10), _rand(2, 3, 9, 10, seed=1)],
            kw, wrt=(0, 1))


def test_spatial_ops_through_nd_and_autograd():
    """The NDArray surface: ``nd.ROIPooling`` under ``record`` gives the
    gradient ``backward`` leaves on the data."""
    data = _rand(2, 3, 12, 16)
    want = compare("ROIPooling", [data, ROIS], dict(pooled_size=(2, 2)))[0]
    with mt.cpu():
        x = mt.nd.array(data)
        x.attach_grad()
        with mt.autograd.record():
            y = mt.nd.ROIPooling(x, mt.nd.array(ROIS), pooled_size=(2, 2))
        y.backward()
    jx = jmx.nd.array(data)
    jx.attach_grad()
    with jmx.autograd.record():
        jy = jmx.nd.ROIPooling(jx, jmx.nd.array(ROIS), pooled_size=(2, 2))
    jy.backward()
    np.testing.assert_array_equal(y.asnumpy(), want)
    np.testing.assert_allclose(x.grad.asnumpy(), jx.grad.asnumpy(), **F32)
