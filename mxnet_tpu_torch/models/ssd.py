"""SSD (Liu et al., 2016) as a Gluon block: MXNet ``example/ssd``'s
VGG16-reduced SSD-300, and the multibox loss its training uses.

:func:`ssd_300_vgg16_reduced` is ``symbol_factory.get_config(
'vgg16_reduced', 300)`` of the reference example: the VGG16 conv stack
(``gluon.model_zoo.vision.vgg.vgg_spec[16]``) with pool3 in ceil mode,
pool5 at 3x3 stride 1, a dilated-6 3x3 ``fc6`` conv and a 1x1 ``fc7`` conv
of 1024 filters; conv4_3 channel-L2-normalized with a learned scale
initialized at 20; four extra stages (a 1x1 conv of half the width, at
least 128, then a 3x3 conv of 512 / 256 / 256 / 256 at stride 2, 2, 1, 1);
six detection scales at 38 / 19 / 10 / 5 / 3 / 1 on a 300x300 input with
the published sizes, ratios and steps: 8732 anchors.  :class:`SSD` takes
the widths as arguments (the tests build it narrow).

``SSD.forward(x)`` returns ``(anchors [1, N, 4], cls_preds [B, N,
classes + 1], box_preds [B, 4N])``, the layout of
``example/object-detection/ssd.py``; :func:`multibox_loss` is that
example's training loss (``MultiBoxTarget`` with hard-negative mining,
softmax cross-entropy on the kept anchors plus smooth L1 on the positive
ones, each over the positive count) and :func:`detect` its decode
(``MultiBoxDetection`` with per-class NMS)."""
from __future__ import annotations

from .. import initializer as init
from .. import ndarray as nd
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..gluon.loss import HuberLoss
from ..gluon.model_zoo.vision.vgg import vgg_spec

__all__ = ["SSD", "ssd_300_vgg16_reduced", "multibox_loss", "detect",
           "SSD300_SIZES", "SSD300_RATIOS", "SSD300_STEPS"]

SSD300_SIZES = ((.1, .141), (.2, .272), (.37, .447), (.54, .619),
                (.71, .79), (.88, .961))
_R3, _R5 = (1, 2, .5), (1, 2, .5, 3, 1. / 3)
SSD300_RATIOS = (_R3, _R5, _R5, _R5, _R3, _R3)
SSD300_STEPS = tuple(x / 300.0 for x in (8, 16, 32, 64, 100, 300))
SSD300_EXTRAS = ((512, 2, 1), (256, 2, 1), (256, 1, 0), (256, 1, 0))
SSD300_NORM_SCALE = 20.0        # conv4_3's L2-norm scale at initialization


def _conv(channels, kernel, **kw):
    return nn.Conv2D(channels, kernel, activation="relu",
                     weight_initializer=init.Xavier(
                         rnd_type="gaussian", factor_type="out",
                         magnitude=2), bias_initializer="zeros", **kw)


class SSD(HybridBlock):
    """SSD on the VGG16-reduced trunk.

    ``filters``: the five VGG stages' widths (``vgg_spec[16]``'s by
    default); ``fc``: fc6 / fc7's width; ``extras``: ``(width, stride,
    pad)`` of each extra stage.  The anchors are SSD-300's at each of the
    six scales."""

    def __init__(self, classes, filters=None, fc=1024, extras=SSD300_EXTRAS,
                 **kwargs):
        super().__init__(**kwargs)
        layers, default = vgg_spec[16]
        filters = tuple(filters or default)
        self.classes = classes
        self._anchor_args = [dict(sizes=s, ratios=r, steps=(t, t))
                             for s, r, t in zip(SSD300_SIZES, SSD300_RATIOS,
                                                SSD300_STEPS)]
        with self.name_scope():
            self.stage4 = nn.HybridSequential(prefix="")    # to relu4_3
            self.stage7 = nn.HybridSequential(prefix="")    # to relu7
            for i, (num, width) in enumerate(zip(layers, filters)):
                blk = self.stage4 if i < 4 else self.stage7
                if i in (1, 2, 4):
                    blk.add(nn.MaxPool2D(2, 2))
                elif i == 3:                                  # 75 -> 38
                    blk.add(nn.MaxPool2D(2, 2, ceil_mode=True))
                for _ in range(num):
                    blk.add(_conv(width, 3, padding=1))
            self.stage7.add(nn.MaxPool2D(3, 1, 1),
                            _conv(fc, 3, padding=6, dilation=6),
                            _conv(fc, 1))
            self.norm_scale = self.params.get(
                "conv4_3_norm_scale", shape=(1, filters[3], 1, 1),
                init=init.Constant(SSD300_NORM_SCALE))
            self.extras = nn.HybridSequential(prefix="")
            for k, (width, stride, pad) in enumerate(extras):
                stage = nn.HybridSequential(prefix="multi_feat_%d_" % k)
                stage.add(_conv(max(128, width // 2), 1),
                          _conv(width, 3, strides=stride, padding=pad))
                self.extras.add(stage)
            self.cls_heads = nn.HybridSequential(prefix="")
            self.box_heads = nn.HybridSequential(prefix="")
            for k, args in enumerate(self._anchor_args):
                a = len(args["sizes"]) - 1 + len(args["ratios"])
                self.cls_heads.add(nn.Conv2D(a * (classes + 1), 3, padding=1,
                                             prefix="cls%d_" % k))
                self.box_heads.add(nn.Conv2D(a * 4, 3, padding=1,
                                             prefix="box%d_" % k))

    def hybrid_forward(self, F, x, norm_scale):
        x = self.stage4(x)
        feats = [F.broadcast_mul(F.L2Normalization(x, mode="channel"),
                                 norm_scale)]
        x = self.stage7(x)
        feats.append(x)
        for k in range(len(self.extras)):
            x = self.extras[k](x)
            feats.append(x)
        anchors, cls_preds, box_preds = [], [], []
        for k, (feat, args) in enumerate(zip(feats, self._anchor_args)):
            anchors.append(F.contrib.MultiBoxPrior(feat, **args))
            cls_preds.append(F.reshape(F.transpose(self.cls_heads[k](feat),
                                                   (0, 2, 3, 1)),
                                       (0, -1, self.classes + 1)))
            box_preds.append(F.reshape(F.transpose(self.box_heads[k](feat),
                                                   (0, 2, 3, 1)), (0, -1)))
        return (F.concat(*anchors, dim=1), F.concat(*cls_preds, dim=1),
                F.concat(*box_preds, dim=1))


def ssd_300_vgg16_reduced(classes=20, **kwargs):
    """SSD-300 on VGG16-reduced at its published widths (``example/ssd``'s
    ``vgg16_reduced`` at 300): 8732 anchors on a 3x300x300 input."""
    return SSD(classes, **kwargs)


def multibox_loss(anchors, cls_preds, box_preds, labels,
                  negative_mining_ratio=3, overlap_threshold=0.5,
                  negative_mining_thresh=0.5):
    """The training loss of ``example/object-detection/ssd.py``, as written
    there: targets from ``MultiBoxTarget`` (no gradient), softmax
    cross-entropy over the positive and mined-negative anchors plus
    ``gluon.loss.HuberLoss(rho=1)`` on the positive anchors' offsets, each
    summed over the batch and divided by the positive count.  Returns the
    scalar loss NDArray."""
    loc_t, loc_m, cls_t = nd.contrib.MultiBoxTarget(
        anchors, labels, cls_preds.transpose((0, 2, 1)),
        overlap_threshold=overlap_threshold,
        negative_mining_ratio=negative_mining_ratio,
        negative_mining_thresh=negative_mining_thresh)
    # the ignore label (-1) masked out of the cross-entropy
    valid = cls_t >= 0
    n_pos = loc_m.sum() / 4.0 + 1e-6
    ce = -nd.pick(nd.log_softmax(cls_preds, axis=-1), cls_t * valid, axis=-1)
    box = HuberLoss(rho=1.0)(box_preds * loc_m, loc_t * loc_m)
    return (ce * valid).sum() / n_pos + box.sum() / n_pos


def detect(anchors, cls_preds, box_preds, nms_threshold=0.45, nms_topk=400,
           **kwargs):
    """Decode with per-class NMS: ``MultiBoxDetection`` on the softmax of
    ``cls_preds``; [B, N, 6] rows (class id, score, x1, y1, x2, y2)."""
    cls_prob = nd.softmax(cls_preds, axis=-1).transpose((0, 2, 1))
    return nd.contrib.MultiBoxDetection(
        cls_prob, box_preds, anchors, nms_threshold=nms_threshold,
        nms_topk=nms_topk, **kwargs)
