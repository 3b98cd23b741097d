"""The port's contrib operators (``mxnet_tpu_torch/ops/contrib_ops.py``)
against the JAX package's on the CPU, from the same seeded numpy inputs:
forward, and backward where the JAX package differentiates; and the plain
greedy NMS (``ops/kernels/nms.py``) against the JAX package's three greedy
loops, run as the JAX package runs them.

Tolerances: f32 within 1e-5; gradients through ROIAlign's bilinear
sampling within 1e-4; fft / ifft within 1e-5 of the spectrum's scale.
Index, id and keep outputs (box_nms's order and scores, the matchings,
index_array, boolean_mask) are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import contrib_ops as jcontrib
from mxnet_tpu.ops import detection as jdet
from mxnet_tpu_torch.ops.kernels import nms
from torch_port_op_util import F32, compare, jax_run, port_run

BILINEAR_GRAD = dict(rtol=1e-4, atol=1e-4)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _boxes(B, N, seed=0, span=1.0, min_wh=0.02, max_wh=0.4):
    """Corner boxes, many overlapping; a few degenerate (x2 < x1)."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, span, (B, N, 2))
    wh = rng.uniform(min_wh, max_wh, (B, N, 2)) * span
    out = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    out[:, ::17, 2] = out[:, ::17, 0] - 0.01          # negative width
    return out


# ---------------------------------------------------------------------------
# ROIAlign
# ---------------------------------------------------------------------------
ROIS = np.array([[0, 0.0, 0.0, 15.0, 11.0],
                 [1, 2.5, 1.5, 9.5, 7.5],
                 [0, 3.0, 2.0, 3.2, 2.1],
                 [1, -4.0, -3.0, 30.0, 20.0],
                 [0, 6.2, 4.9, 13.7, 10.1]], np.float32)


@pytest.mark.parametrize("kw", [
    dict(pooled_size=(2, 2), spatial_scale=1.0, sample_ratio=1),
    dict(pooled_size=(1, 2), spatial_scale=0.5, sample_ratio=2,
         aligned=True),
    dict(pooled_size=(2, 2), spatial_scale=1.0, sample_ratio=1,
         position_sensitive=True),
])
def test_roi_align(kw):
    compare("_contrib_ROIAlign", [_rand(2, 8, 12, 16), ROIS], kw, wrt=(0,),
            grad_tol=BILINEAR_GRAD)


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    compare("_contrib_box_iou", [_boxes(1, 7)[0], _boxes(1, 5, seed=1)[0]],
            dict(format=fmt), wrt=(0, 1))


def test_box_iou_batched():
    compare("_contrib_box_iou", [_boxes(3, 6), _boxes(3, 4, seed=2)])


def _nms_data(B, N, seed=0, classes=3, ties=True):
    rng = np.random.RandomState(seed)
    d = np.zeros((B, N, 6), np.float32)
    d[..., 0] = rng.randint(0, classes, (B, N))
    d[..., 1] = rng.uniform(0, 1, (B, N))
    if ties:
        d[:, 1::5, 1] = d[:, ::5, 1][:, :d[:, 1::5].shape[1]]   # equal scores
    d[..., 2:] = _boxes(B, N, seed + 1)
    return d


@pytest.mark.parametrize("kw", [
    dict(overlap_thresh=0.5),
    dict(overlap_thresh=0.3, valid_thresh=0.2, topk=12, id_index=0),
    dict(overlap_thresh=0.4, id_index=0, background_id=1),
    dict(overlap_thresh=0.4, id_index=0, force_suppress=True),
    dict(overlap_thresh=0.45, coord_start=2, in_format="center",
         out_format="center"),
    dict(overlap_thresh=0.45, in_format="corner", out_format="center"),
    dict(overlap_thresh=0.45, in_format="center", out_format="corner"),
])
def test_box_nms(kw):
    compare("_contrib_box_nms", [_nms_data(2, 40)], kw, exact=(0,))


def test_box_nms_through_nd_contrib():
    d = _nms_data(3, 30, seed=5)
    with mt.cpu():
        got = mt.nd.contrib.box_nms(mt.nd.array(d), overlap_thresh=0.3,
                                    id_index=0).asnumpy()
    want = jmx.nd.contrib.box_nms(jmx.nd.array(d), overlap_thresh=0.3,
                                  id_index=0).asnumpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(threshold=0.3), dict(threshold=-0.5,
                                                         is_ascend=True),
                                dict(threshold=0.1, topk=2)])
def test_bipartite_matching(kw):
    data = _rand(2, 5, 4)
    data[0, 1, 2] = data[0, 3, 0] = 3.0                     # a tie
    compare("_contrib_bipartite_matching", [data], kw, exact=(0, 1))


# ---------------------------------------------------------------------------
# the plain greedy NMS against the JAX package's three loops
# ---------------------------------------------------------------------------
def _jax_box_nms_keep(boxes, valid, ids, thresh):
    """box_nms's loop body (contrib_ops.py:145-153) over sorted boxes."""
    n = boxes.shape[0]
    ious = jcontrib._iou_corner(boxes[:, None, :], boxes[None, :, :])
    same = (jnp.ones((n, n), bool) if ids is None
            else ids[:, None] == ids[None, :])

    def body(i, keep):
        sup = (ious[i] > thresh) & same[i] & (jnp.arange(n) > i) & keep[i] \
            & valid
        return keep & ~sup

    return jax.lax.fori_loop(0, n, body, valid)


def _jax_mbd_keep(boxes, cid, thresh, force):
    """MultiBoxDetection's loop body (detection.py:284-292)."""
    n = boxes.shape[0]

    def body(i, cid_cur):
        same = force | (cid_cur == cid_cur[i])
        iou = jdet._pair_iou(boxes[i][None, :], boxes)[0]
        kill = (cid_cur[i] >= 0) & same & (iou >= thresh) & \
            (jnp.arange(n) > i) & (cid_cur >= 0)
        return jnp.where(kill, -1.0, cid_cur)

    return jax.lax.fori_loop(0, n, body, cid) >= 0


def _jax_proposal_keep(boxes, alive, thresh):
    """Proposal's loop body (detection.py:381-387)."""
    n = boxes.shape[0]

    def body(i, alive):
        iou = jdet._pair_iou(boxes[i][None, :], boxes)[0]
        return alive & ~(alive[i] & (iou > thresh) & (jnp.arange(n) > i))

    return jax.lax.fori_loop(0, n, body, alive)


def _valid_ids(B, N, seed, topk):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 3, (B, N)).astype(np.float32)
    valid = rng.uniform(size=(B, N)) > 0.2
    if topk > 0:
        valid[:, topk:] = False
    return valid, ids


@pytest.mark.parametrize("topk", [-1, 9])
@pytest.mark.parametrize("loop,classes", [
    ("box_nms", False), ("box_nms", True), ("mbd", False), ("mbd", True),
    ("proposal", False)])          # Proposal's loop compares no classes
def test_plain_nms_equals_the_jax_loops(loop, classes, topk):
    B, N = 2, 45
    boxes = _boxes(B, N, seed=3)
    boxes[0, 5] = boxes[0, 2]                        # IoU exactly 1
    valid, ids = _valid_ids(B, N, 4, topk)
    thresh = {"box_nms": 0.3, "mbd": 0.45, "proposal": 0.35}[loop]
    want = []
    for b in range(B):
        bx, v, c = (jnp.asarray(boxes[b]), jnp.asarray(valid[b]),
                    jnp.asarray(ids[b]))
        if loop == "box_nms":
            k = _jax_box_nms_keep(bx, v, c if classes else None, thresh)
        elif loop == "mbd":
            k = _jax_mbd_keep(bx, jnp.where(v, c, -1.0), thresh,
                              not classes)
        else:
            k = _jax_proposal_keep(bx, v, thresh)
        want.append(np.asarray(k))
    iou, cmp = {"box_nms": ("corner", "gt"), "mbd": ("pair", "ge"),
                "proposal": ("pair", "gt")}[loop]
    got = nms.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(valid),
                         torch.from_numpy(ids) if classes else None, thresh,
                         iou=iou, cmp=cmp)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


@pytest.mark.parametrize("iou", ["pair", "corner"])
def test_iou_row_equals_the_jax_formulas(iou):
    boxes = _boxes(1, 30, seed=7)[0]
    got = nms.iou_row(torch.from_numpy(boxes[:, None, :]),
                      torch.from_numpy(boxes[None]), iou).numpy()
    fn = jdet._pair_iou if iou == "pair" else (
        lambda a, b: jcontrib._iou_corner(a[:, None, :], b[None, :, :]))
    np.testing.assert_array_equal(got, np.asarray(fn(boxes, boxes)))


def test_greedy_nms_cpu_tensor_takes_the_plain_version():
    from mxnet_tpu_torch.ops.kernels import common
    common.reset_counts()
    b = torch.from_numpy(_boxes(1, 8))
    nms.greedy_nms(b, torch.ones(1, 8, dtype=torch.bool), None, 0.5)
    assert common.selection_counts() == {
        "kernels.select.greedy_nms.reference": 1}
    assert common.launch_counts() == {}


def test_greedy_nms_refuses_bad_arguments():
    b = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError):
        nms.greedy_nms(b, torch.ones(1, 5, dtype=torch.bool))
    with pytest.raises(ValueError):
        nms.greedy_nms(b, torch.ones(1, 4, dtype=torch.bool), iou="giou")


def test_greedy_nms_kernel_raises_when_its_build_fails(monkeypatch):
    """No nvcc (or a failed build): the CUDA wrapper raises, it does not
    fall back to the plain version."""
    from mxnet_tpu_torch.ops.kernels import _build

    def no_build(names=()):
        raise RuntimeError("mxnet_tpu_torch: nvcc failed for nms")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        nms._greedy_nms_cuda(torch.from_numpy(_boxes(1, 8)),
                             torch.ones(1, 8, dtype=torch.bool))


# ---------------------------------------------------------------------------
# pooling / resize
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", [(1, 1), (3, 2), 4])
def test_adaptive_avg_pooling(size):
    compare("_contrib_AdaptiveAvgPooling2D", [_rand(2, 3, 7, 9)],
            dict(output_size=size), wrt=(0,))


@pytest.mark.parametrize("kw", [dict(height=9, width=5),
                                dict(scale_height=1.5, scale_width=2.0),
                                dict(height=3, width=4)])
def test_bilinear_resize(kw):
    compare("_contrib_BilinearResize2D", [_rand(2, 3, 6, 7)], kw, wrt=(0,))


def test_bilinear_resize_refuses_other_modes():
    with pytest.raises(NotImplementedError):
        port_run("_contrib_BilinearResize2D", [_rand(1, 1, 4, 4)],
                 dict(height=2, width=2, mode="odd_scale"))


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis", [0, 1])
def test_boolean_mask(axis):
    data = _rand(5, 4)
    index = np.array([1, 0, 1, 1, 0][:data.shape[axis]], np.float32)
    compare("_contrib_boolean_mask", [data, index], dict(axis=axis),
            exact=(0,))


def test_boolean_mask_gradient_through_nd_contrib():
    """The gather keeps the gradient, as the JAX package's
    ``nd.contrib.boolean_mask`` (a ``take``) does."""
    data = _rand(5, 3)
    index = np.array([0, 1, 1, 0, 1], np.float32)
    grads = []
    for mx, ctx in ((jmx, None), (mt, mt.cpu())):
        x = mx.nd.array(data, ctx=ctx)
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.contrib.boolean_mask(x, mx.nd.array(index, ctx=ctx))
            loss = (y * y).sum()
        loss.backward()
        grads.append(x.grad.asnumpy())
    np.testing.assert_allclose(grads[1], grads[0], **F32)


def test_index_copy():
    old = _rand(6, 3)
    compare("_contrib_index_copy", [old, np.array([4, 0, 2], np.float32),
                                    _rand(3, 3, seed=1)], wrt=(0, 2))


@pytest.mark.parametrize("axes", [None, (1,), (2, 0)])
def test_index_array(axes):
    compare("_contrib_index_array", [_rand(2, 3, 4)], dict(axes=axes),
            exact=(0,))


# ---------------------------------------------------------------------------
# arithmetic helpers
# ---------------------------------------------------------------------------
def test_quadratic():
    compare("_contrib_quadratic", [_rand(3, 4)], dict(a=0.5, b=-2.0, c=3.0),
            wrt=(0,))


def test_fft_and_ifft():
    x = _rand(3, 16)
    out = compare("_contrib_fft", [x], wrt=(0,),
                  tol=dict(rtol=1e-5, atol=1e-5 * 16),
                  grad_tol=dict(rtol=1e-5, atol=1e-4))
    compare("_contrib_ifft", [out[0]], wrt=(0,),
            tol=dict(rtol=1e-5, atol=1e-4),
            grad_tol=dict(rtol=1e-5, atol=1e-4))


def test_div_sqrt_dim():
    compare("_contrib_div_sqrt_dim", [_rand(2, 3, 10)], wrt=(0,))


@pytest.mark.parametrize("scalar", [0.5, -1.0])
def test_gradientmultiplier(scalar):
    compare("_contrib_gradientmultiplier", [_rand(3, 5)],
            dict(scalar=scalar), wrt=(0,))


@pytest.mark.parametrize("delta,equal_nan", [(0.0, True), (1e-6, True),
                                             (1e-3, True), (np.nan, False),
                                             (np.nan, True)])
def test_allclose(delta, equal_nan):
    a = _rand(4, 3)
    b = a + np.float32(delta)
    if np.isnan(delta):
        a, b = a.copy(), a.copy()
        a[1, 1] = b[1, 1] = np.nan
    compare("_contrib_allclose", [a, b], dict(equal_nan=equal_nan),
            exact=(0,))


@pytest.mark.parametrize("kw", [dict(), dict(start=2.0, step=0.5, repeat=2),
                                dict(start=-1.0, step=3.0, axis=1)])
def test_arange_like(kw):
    compare("_contrib_arange_like", [_rand(3, 4)], kw, exact=(0,))


def test_count_sketch():
    rng = np.random.RandomState(3)
    data = _rand(2, 3, 8)
    h = rng.randint(0, 5, 8).astype(np.float32)
    s = rng.choice([-1.0, 1.0], 8).astype(np.float32)
    compare("_contrib_count_sketch", [data, h, s], dict(out_dim=5),
            wrt=(0,))


def test_contrib_names_and_flags_match_the_jax_package():
    """Each op of the three ported modules (and L2Normalization) under the
    JAX package's names and aliases, with its inputs, output count and
    no_grad flag; 141 distinct ops in all."""
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg

    mods = ("mxnet_tpu.ops.spatial", "mxnet_tpu.ops.contrib_ops",
            "mxnet_tpu.ops.detection")
    names = sorted({op.name for op in jreg.OPS.values()
                    if op.fn.__module__ in mods} | {"L2Normalization"})
    assert len(names) == 34
    for name in names:
        j, t = jreg.get_op(name), treg.get_op(name)
        assert (t.input_names, t.num_outputs, t.no_grad) == \
            (j.input_names, j.num_outputs, j.no_grad), name
        assert set(t.aliases) == set(j.aliases), name
        for alias in j.aliases:
            assert treg.get_op(alias) is t
    assert len(treg.list_ops()) == 141
    for short in ("ROIAlign", "box_nms", "MultiBoxPrior", "MultiProposal",
                  "DeformableConvolution", "fft", "count_sketch"):
        assert callable(getattr(mt.nd.contrib, short))
        assert callable(getattr(mt.sym.contrib, short))


def test_run_helpers_agree_on_a_plain_op():
    jo, _ = jax_run("_contrib_quadratic", [np.ones(2, np.float32)],
                    dict(a=1.0))
    to, _ = port_run("_contrib_quadratic", [np.ones(2, np.float32)],
                     dict(a=1.0))
    np.testing.assert_array_equal(jo[0], to[0])
