"""The port's detection operators (``mxnet_tpu_torch/ops/detection.py``),
``L2Normalization`` and the SSD model (``models/ssd.py``) against the JAX
package on the CPU, from the same seeded numpy inputs.

Tolerances: f32 outputs and gradients within 1e-5, gradients through
bilinear sampling (the deformable ops) within 1e-4; class ids, mined
targets, masks and keep decisions exact.  ``example/object-detection/
ssd.py``'s net, built in both packages on the same weights, takes the
same training step (loss and every gradient within 1e-4 relative L2) and
decodes to the same ids.  MultiBoxPrior at SSD-300's six scales gives the
JAX package's 8732 anchors within 1e-6, and so does the port's SSD-300
(built narrow: the anchors depend on the feature maps' sizes only).

Where sorting meets ties (MultiBoxDetection's order, the negative-mining
rank, Proposal's pre- and post-NMS top-K, box_nms's sort in
``test_torch_port_contrib_ops.py``), the inputs hold equal scores and the
port's stable sorts give the JAX package's order.
"""
import pathlib
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import ssd
from torch_port_op_util import compare, jax_run, port_run

REPO = pathlib.Path(__file__).resolve().parents[1]
BILINEAR_GRAD = dict(rtol=1e-4, atol=1e-4)
SSD_REL = 1e-4
SSD300_SHAPES = (38, 19, 10, 5, 3, 1)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# MultiBoxPrior
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(sizes=(0.5, 0.25), ratios=(1, 2, 0.5)),
    dict(sizes=(0.9,), clip=True),
    dict(sizes=(0.3, 0.4), ratios=(1, 3), steps=(0.1, 0.2),
         offsets=(0.3, 0.7)),
])
def test_multibox_prior(kw):
    compare("_contrib_MultiBoxPrior", [np.zeros((1, 3, 4, 6), np.float32)],
            kw, tol=dict(rtol=0, atol=1e-6))


def _ssd300_anchors(mx, ctx=None):
    outs = []
    for s, sizes, ratios, step in zip(SSD300_SHAPES, ssd.SSD300_SIZES,
                                      ssd.SSD300_RATIOS, ssd.SSD300_STEPS):
        feat = mx.nd.zeros((1, 1, s, s), ctx=ctx)
        outs.append(mx.nd.contrib.MultiBoxPrior(
            feat, sizes=sizes, ratios=ratios, steps=(step, step)).asnumpy())
    return np.concatenate(outs, axis=1)


def test_ssd300_anchors_equal_the_jax_package():
    want = _ssd300_anchors(jmx)
    got = _ssd300_anchors(mt, mt.cpu())
    assert want.shape == got.shape == (1, 8732, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


NARROW = dict(filters=(4, 4, 8, 8, 8), fc=16,
              extras=((16, 2, 1), (8, 2, 1), (8, 1, 0), (8, 1, 0)))


def test_ssd300_model_anchors_shapes_and_a_step():
    """The port's SSD-300 (narrow widths) gives the six scales' 8732
    anchors, the heads' layouts, and a finite loss whose step changes the
    weights."""
    mt.random.seed(0)
    np.random.seed(0)
    ctx = mt.cpu()
    net = ssd.ssd_300_vgg16_reduced(classes=20, **NARROW)
    net.initialize(mt.init.Xavier(), ctx=ctx)
    x = mt.nd.array(np.random.RandomState(1).rand(2, 3, 300, 300)
                    .astype(np.float32), ctx=ctx)
    labels = np.full((2, 3, 5), -1, np.float32)
    labels[0, :2] = [[3, .1, .1, .5, .6], [7, .4, .3, .9, .8]]
    labels[1, 0] = [0, .2, .2, .4, .7]
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 1e-3})
    with mt.autograd.record():
        anchors, cls_preds, box_preds = net(x)
        loss = ssd.multibox_loss(anchors, cls_preds, box_preds,
                                 mt.nd.array(labels, ctx=ctx))
    loss.backward()
    before = net.norm_scale.data().asnumpy().copy()
    trainer.step(2)
    assert anchors.shape == (1, 8732, 4)
    assert cls_preds.shape == (2, 8732, 21) and box_preds.shape == (2, 34928)
    np.testing.assert_allclose(anchors.asnumpy(), _ssd300_anchors(jmx),
                               rtol=0, atol=1e-6)
    assert np.isfinite(float(loss.asscalar()))
    assert np.allclose(before, 20.0) and \
        not np.array_equal(net.norm_scale.data().asnumpy(), before)
    dets = ssd.detect(anchors, cls_preds, box_preds, nms_topk=50).asnumpy()
    assert dets.shape == (2, 8732, 6) and (dets[:, 50:, 0] == -1).all()


# ---------------------------------------------------------------------------
# MultiBoxTarget
# ---------------------------------------------------------------------------
def _anchors(n, seed=0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 0.8, (n, 2))
    wh = rng.uniform(0.05, 0.35, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)[None]


def _labels(B, M, seed=0):
    rng = np.random.RandomState(seed)
    lab = np.full((B, M, 5), -1.0, np.float32)
    for b in range(B):
        for m in range(rng.randint(1, M + 1)):
            xy = rng.uniform(0, 0.6, 2)
            wh = rng.uniform(0.1, 0.4, 2)
            lab[b, m] = [rng.randint(0, 4), *xy, *(xy + wh)]
    return lab


@pytest.mark.parametrize("kw", [
    dict(),
    dict(overlap_threshold=0.4, negative_mining_ratio=3,
         negative_mining_thresh=0.5),
    dict(overlap_threshold=0.3, negative_mining_ratio=2,
         negative_mining_thresh=0.4, minimum_negative_samples=5,
         ignore_label=-2, variances=(0.2, 0.2, 0.3, 0.3)),
])
def test_multibox_target(kw):
    cls = _rand(3, 5, 60, seed=2)
    cls[:, :, 40:50] = cls[:, :, 30:40]            # tied mining scores
    compare("_contrib_MultiBoxTarget",
            [_anchors(60), _labels(3, 4, seed=1), cls], kw, exact=(1, 2))


def test_multibox_target_reference_oracle():
    """tests/test_detection.py's oracle (the reference's own unit test)."""
    anchors = np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8],
                       np.float32).reshape(1, -1, 4)
    cls_pred = np.arange(10, dtype=np.float32).reshape(1, -1, 2)
    label = np.array([1, 0.1, 0.1, 0.5, 0.6], np.float32).reshape(1, -1, 5)
    lt, lm, ct = compare("_contrib_MultiBoxTarget", [anchors, label,
                                                     cls_pred],
                         dict(overlap_threshold=0.5, negative_mining_ratio=3,
                              negative_mining_thresh=0.4), exact=(1, 2))
    np.testing.assert_allclose(lt, [[5.0, 2.5000005, 3.4657357, 4.581454,
                                     0, 0, 0, 0]], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ct, [[2, 0]])


# ---------------------------------------------------------------------------
# MultiBoxDetection
# ---------------------------------------------------------------------------
def _mbd_inputs(B, C, N, seed=0, ties=True):
    rng = np.random.RandomState(seed)
    logits = rng.standard_normal((B, C, N)) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    prob = prob.astype(np.float32)
    if ties:
        prob[:, :, 10:20] = prob[:, :, 0:10]          # tied scores
    loc = (rng.standard_normal((B, 4 * N)) * 0.5).astype(np.float32)
    # clustered anchors, so that NMS has work to do
    anchors = _anchors(N, seed + 1)
    anchors[0, 1::3] = anchors[0, ::3][:anchors[0, 1::3].shape[0]] + 0.01
    return prob, loc, anchors


@pytest.mark.parametrize("kw", [
    dict(nms_threshold=0.45),
    dict(nms_threshold=0.45, nms_topk=25, threshold=0.05),
    dict(nms_threshold=0.3, force_suppress=True),
    dict(nms_threshold=0.5, background_id=1),
    dict(nms_threshold=0.5, clip=False, variances=(0.2, 0.2, 0.1, 0.1)),
    dict(nms_threshold=1.5),                         # no NMS
])
def test_multibox_detection(kw):
    _compare_detection(list(_mbd_inputs(2, 5, 90)), kw)


def _compare_detection(inputs, kw):
    """MultiBoxDetection in both packages: scores and boxes within 1e-5
    (XLA's fused decode may round its boxes an ulp apart), the class ids,
    and so every keep decision, bit for bit."""
    name = "_contrib_MultiBoxDetection"
    compare(name, inputs, kw, tol=dict(rtol=1e-5, atol=1e-6))
    np.testing.assert_array_equal(port_run(name, inputs, kw)[0][0][..., 0],
                                  jax_run(name, inputs, kw)[0][0][..., 0])


# ---------------------------------------------------------------------------
# Proposal
# ---------------------------------------------------------------------------
def _rpn_inputs(B, A, H, W, seed=0, ties=True):
    rng = np.random.RandomState(seed)
    cls = rng.uniform(0, 1, (B, 2 * A, H, W)).astype(np.float32)
    if ties:
        cls[:, A:, :2] = cls[:, A:, 2:4]               # tied fg scores
    bbox = rng.uniform(-0.3, 0.3, (B, 4 * A, H, W)).astype(np.float32)
    info = np.array([[H * 16, W * 16, 1.0], [H * 16 - 20, W * 16, 0.8]][:B],
                    np.float32)
    return [cls, bbox, info]


@pytest.mark.parametrize("name,kw", [
    ("_contrib_Proposal", dict(rpn_pre_nms_top_n=120, rpn_post_nms_top_n=40,
                               threshold=0.7, rpn_min_size=4)),
    ("_contrib_Proposal", dict(rpn_pre_nms_top_n=600, rpn_post_nms_top_n=500,
                               threshold=0.5, rpn_min_size=8,
                               output_score=True)),
    ("_contrib_Proposal", dict(rpn_pre_nms_top_n=80, rpn_post_nms_top_n=30,
                               threshold=0.6, iou_loss=True,
                               scales=(2, 4), ratios=(0.5, 1, 2))),
    ("MultiProposal", dict(rpn_pre_nms_top_n=100, rpn_post_nms_top_n=20,
                           threshold=0.7, rpn_min_size=4)),
])
def test_proposal(name, kw):
    A = len(kw.get("scales", (4, 8, 16, 32))) * 3
    compare(name, _rpn_inputs(2, A, 6, 7), kw)


# ---------------------------------------------------------------------------
# PSROIPooling, deformable ops
# ---------------------------------------------------------------------------
PS_ROIS = np.array([[0, 0, 0, 11, 9], [1, 2.5, 1.5, 8.5, 7.5],
                    [0, 4, 3, 4, 3], [1, -3, -2, 20, 15]], np.float32)


@pytest.mark.parametrize("kw", [
    dict(spatial_scale=1.0, output_dim=2, pooled_size=3),
    dict(spatial_scale=0.5, output_dim=3, pooled_size=2, group_size=2),
])
def test_psroi_pooling(kw):
    g = kw.get("group_size") or kw["pooled_size"]
    compare("_contrib_PSROIPooling",
            [_rand(2, kw["output_dim"] * g * g, 10, 12), PS_ROIS], kw,
            wrt=(0,))


@pytest.mark.parametrize("kw,shapes", [
    (dict(kernel=(3, 3), num_filter=4, pad=(1, 1)),
     ((2, 3, 6, 7), (2, 18, 6, 7), (4, 3, 3, 3))),
    (dict(kernel=(3, 3), num_filter=4, stride=(2, 2), dilate=(2, 1),
          num_group=2, num_deformable_group=2, no_bias=True),
     ((1, 4, 9, 8), (1, 36, 3, 3), (4, 2, 3, 3))),
])
def test_deformable_convolution(kw, shapes):
    d, o, w = shapes
    inputs = [_rand(*d), _rand(*o, seed=1) * 1.5, _rand(*w, seed=2)]
    if not kw.get("no_bias"):
        inputs.append(_rand(kw["num_filter"], seed=3))
    compare("_contrib_DeformableConvolution", inputs, kw,
            wrt=tuple(range(len(inputs))), grad_tol=BILINEAR_GRAD)


@pytest.mark.parametrize("kw,trans", [
    (dict(spatial_scale=1.0, output_dim=2, group_size=2, pooled_size=2,
          part_size=2, sample_per_part=2, trans_std=0.1), (4, 2, 2, 2)),
    (dict(spatial_scale=0.5, output_dim=4, group_size=3, pooled_size=3,
          part_size=3, sample_per_part=1, trans_std=0.2), (4, 4, 3, 3)),
    (dict(spatial_scale=1.0, output_dim=2, group_size=2, pooled_size=2,
          sample_per_part=2, no_trans=True), None),
])
def test_deformable_psroi_pooling(kw, trans):
    g, od = kw["group_size"], kw["output_dim"]
    inputs = [_rand(2, od * g * g, 10, 12), PS_ROIS]
    if trans is not None:
        inputs.append(_rand(*trans, seed=4))
    compare("_contrib_DeformablePSROIPooling", inputs, kw,
            wrt=(0, 2) if trans is not None else (0,),
            grad_tol=BILINEAR_GRAD)


@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
def test_l2_normalization(mode):
    compare("L2Normalization", [_rand(2, 3, 4, 5)], dict(mode=mode),
            wrt=(0,))


# ---------------------------------------------------------------------------
# example/object-detection/ssd.py in both packages
# ---------------------------------------------------------------------------
def _example(pkg):
    """The example's module, importing ``pkg`` in place of ``mxnet_tpu``."""
    src = (REPO / "example" / "object-detection" / "ssd.py").read_text()
    if pkg == "mxnet_tpu_torch":
        src = src.replace("import mxnet_tpu as mx",
                          "import mxnet_tpu_torch as mx") \
            .replace("from mxnet_tpu import autograd, gluon",
                     "from mxnet_tpu_torch import autograd, gluon")
    mod = types.ModuleType("ssd_example_" + pkg)
    mod.__file__ = str(REPO / "example" / "object-detection" / "ssd.py")
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


def _example_step(ex, net, x, y):
    """The training step of the example's ``train``: the loss and the
    gradients (numpy, by parameter name)."""
    mx = ex.mx
    box_loss = ex.gluon.loss.HuberLoss(rho=1.0)
    with ex.autograd.record():
        anchors, cls_preds, box_preds = net(x)
        loc_t, loc_m, cls_t = mx.nd.contrib.MultiBoxTarget(
            anchors, y, cls_preds.transpose((0, 2, 1)),
            overlap_threshold=0.5, negative_mining_ratio=3,
            negative_mining_thresh=0.5)
        valid = cls_t >= 0
        n_pos = loc_m.sum() / 4.0 + 1e-6
        logp = mx.nd.log_softmax(cls_preds, axis=-1)
        ce = -mx.nd.pick(logp, cls_t * valid, axis=-1)
        lc = (ce * valid).sum() / n_pos
        lb = box_loss(box_preds * loc_m, loc_t * loc_m).sum() / n_pos
        loss = lc + lb
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()}
    targets = [t.asnumpy() for t in (loc_t, loc_m, cls_t)]
    return float(loss.asnumpy()), grads, targets, \
        [t.asnumpy() for t in (anchors, cls_preds, box_preds)]


def test_ssd_example_step_and_decode_match_the_jax_package():
    jex, tex = _example("mxnet_tpu"), _example("mxnet_tpu_torch")
    imgs, labels = jex.synthetic_scene(np.random.RandomState(0), 4)
    jmx.random.seed(3)
    np.random.seed(3)                 # the JAX initializers draw from numpy
    jnet = jex.SSDNet(prefix="ssd_")
    jnet.initialize(jmx.init.Xavier())
    with jmx.autograd.pause():
        jnet(jmx.nd.array(imgs))
    weights = {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()}
    tnet = tex.SSDNet(prefix="ssd_")
    tnet.load_dict(weights, ctx=mt.cpu())
    with mt.cpu():
        t_loss, t_grads, t_tgt, t_out = _example_step(
            tex, tnet, mt.nd.array(imgs), mt.nd.array(labels))
    j_loss, j_grads, j_tgt, j_out = _example_step(
        jex, jnet, jmx.nd.array(imgs), jmx.nd.array(labels))
    assert abs(t_loss - j_loss) <= SSD_REL * abs(j_loss)
    assert set(t_grads) == set(j_grads)
    for k in j_grads:
        assert _rel(t_grads[k], j_grads[k]) <= SSD_REL, k
    np.testing.assert_array_equal(t_tgt[1], j_tgt[1])        # loc mask
    np.testing.assert_array_equal(t_tgt[2], j_tgt[2])        # mined classes
    # the decode: the same inputs give the same ids in both packages
    anchors, cls_preds, box_preds = j_out
    e = np.exp(cls_preds - cls_preds.max(-1, keepdims=True))
    prob = (e / e.sum(-1, keepdims=True)).transpose(0, 2, 1).astype(
        np.float32)
    kw = dict(nms_threshold=0.45, force_suppress=False, nms_topk=50)
    _compare_detection([prob, box_preds, anchors], kw)


def test_detection_ops_through_nd_and_sym_contrib():
    """``nd.contrib`` and ``sym.contrib`` reach the detection ops, and a
    symbol of MultiBoxPrior binds and runs on the CPU."""
    x = np.zeros((1, 2, 3, 4), np.float32)
    with mt.cpu():
        nd_out = mt.nd.contrib.MultiBoxPrior(mt.nd.array(x),
                                             sizes=(0.4, 0.2)).asnumpy()
    s = mt.sym.contrib.MultiBoxPrior(mt.sym.var("data"), sizes=(0.4, 0.2))
    exe = s.bind(mt.cpu(), {"data": mt.nd.array(x, ctx=mt.cpu())})
    sym_out = exe.forward()[0].asnumpy()
    want = jmx.nd.contrib.MultiBoxPrior(jmx.nd.array(x),
                                        sizes=(0.4, 0.2)).asnumpy()
    np.testing.assert_array_equal(nd_out, sym_out)
    np.testing.assert_allclose(nd_out, want, rtol=0, atol=1e-6)


def test_detection_constants_take_no_gradient():
    """MultiBoxTarget's targets are data, not graph, as in the JAX
    package (no_grad): under ``record`` they carry no gradient."""
    with mt.cpu():
        cls = mt.nd.array(_rand(1, 3, 4))
        cls.attach_grad()
        with mt.autograd.record():
            out = mt.nd.contrib.MultiBoxTarget(
                mt.nd.array(_anchors(4)), mt.nd.array(_labels(1, 2)), cls,
                negative_mining_ratio=1.0)
    assert all(not o.data.requires_grad for o in out)


def test_roi_ops_ignore_rois_gradient():
    """The ROI ops differentiate in the data only: the JAX package's
    gradient with respect to the ROIs is zero (rounding and floor)."""
    data = torch.from_numpy(_rand(2, 8, 10, 12)).requires_grad_(True)
    rois = torch.from_numpy(PS_ROIS).requires_grad_(True)
    from mxnet_tpu_torch.ops import registry
    out = registry.get_op("_contrib_PSROIPooling").fn(
        data, rois, output_dim=2, pooled_size=2)
    g_d, g_r = torch.autograd.grad(out.sum(), [data, rois],
                                   allow_unused=True)
    assert g_d is not None and (g_r is None or not g_r.any())


def test_detection_symbols_infer_shapes():
    """The symbol layer infers the detection ops' shapes on meta tensors
    (the NMS gives its mask's shape there), as the JAX package's graph
    composition does."""
    an, lab = mt.sym.var("anchor"), mt.sym.var("label")
    cases = [
        (mt.sym.contrib.MultiBoxDetection(mt.sym.var("cls_prob"),
                                          mt.sym.var("loc_pred"), an,
                                          nms_topk=10),
         dict(cls_prob=(2, 4, 30), loc_pred=(2, 120), anchor=(1, 30, 4)),
         [(2, 30, 6)]),
        (mt.sym.contrib.Proposal(mt.sym.var("c"), mt.sym.var("b"),
                                 mt.sym.var("i"), rpn_pre_nms_top_n=50,
                                 rpn_post_nms_top_n=10),
         dict(c=(1, 24, 5, 6), b=(1, 48, 5, 6), i=(1, 3)), [(10, 5)]),
        (mt.sym.contrib.MultiBoxTarget(an, lab, mt.sym.var("cls"),
                                       negative_mining_ratio=3),
         dict(anchor=(1, 30, 4), label=(2, 3, 5), cls=(2, 4, 30)),
         [(2, 120), (2, 120), (2, 30)]),
        (mt.sym.contrib.box_nms(mt.sym.var("d"), overlap_thresh=0.3),
         dict(d=(2, 40, 6)), [(2, 40, 6)]),
    ]
    for sym, shapes, want in cases:
        _, outs, _ = sym.infer_shape(**shapes)
        assert [tuple(o) for o in outs] == want


# ---------------------------------------------------------------------------
# where trouble is likely: ties in sorting, the declared background row
# ---------------------------------------------------------------------------
def test_ties_multibox_detection_keep_index_order():
    """Every score equal: jnp.argsort's stable order (lower index first)
    decides which box NMS keeps."""
    prob = np.full((1, 3, 40), 0.3, np.float32)
    prob[:, 0] = 0.4
    _, loc, anchors = _mbd_inputs(1, 3, 40, seed=3, ties=False)
    _compare_detection([prob, loc, anchors],
                       dict(nms_threshold=0.3, nms_topk=30))


def test_ties_negative_mining_rank():
    """Equal background probabilities: the mined negatives are the
    candidates of lowest index, as the JAX package's stable ranking
    gives them."""
    cls = np.zeros((2, 4, 60), np.float32)
    compare("_contrib_MultiBoxTarget",
            [_anchors(60, seed=4), _labels(2, 3, seed=5), cls],
            dict(negative_mining_ratio=2, negative_mining_thresh=0.5),
            exact=(1, 2))


def test_ties_proposal_top_k_take_the_lower_index():
    """Equal foreground scores: lax.top_k's order, pre- and post-NMS."""
    cls, bbox, info = _rpn_inputs(1, 12, 5, 6, seed=6, ties=False)
    cls[:, 12:] = 0.5
    compare("_contrib_Proposal", [cls, bbox, info[:1]],
            dict(rpn_pre_nms_top_n=100, rpn_post_nms_top_n=60,
                 threshold=0.6, rpn_min_size=4), exact=(0,))


def test_background_id_is_the_declared_row():
    """MultiBoxDetection takes the declared background row (the reference
    kernel hard-codes 0); the port matches the JAX package."""
    _compare_detection(list(_mbd_inputs(1, 4, 50, seed=7)),
                       dict(nms_threshold=0.45, background_id=2))
