"""Greedy non-maximum suppression: ``csrc/nms.cu`` and its plain version.

Not the port of a TPU kernel: the JAX package runs the three greedy loops
of its detection ops (MultiBoxDetection, Proposal, ``box_nms``) as
``lax.fori_loop`` over every box, one device program under XLA.  Eager
PyTorch would run that loop as thousands of small launches, so the port
runs all three through one kernel, :func:`greedy_nms`, which takes the
loop's IoU formula, comparison and class rule as arguments:

* ``iou="pair"`` — ``_pair_iou`` (mxnet_tpu/ops/detection.py:91): areas as
  they are, IoU 0 where the union is not positive;
* ``iou="corner"`` — ``_iou_corner`` (mxnet_tpu/ops/contrib_ops.py:86):
  areas clamped at 0, the union at least 1e-12;
* ``cmp="ge"`` suppresses at ``iou >= threshold`` (MultiBoxDetection),
  ``cmp="gt"`` at ``iou > threshold`` (Proposal, ``box_nms``);
* ``ids`` (optional): a box suppresses only boxes of its own class.

The kernel is bit for bit its plain version, :func:`greedy_nms_reference`
(the JAX loop written in torch, vectorised over the batch and the later
boxes); each call of the kernel counts as ``kernels.launch.greedy_nms``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .common import count_launch, register_impl, select_impl

__all__ = ["greedy_nms", "greedy_nms_reference", "iou_row", "MAX_BOXES"]

_IOU = {"pair": 0, "corner": 1}
_CMP = {"gt": 0, "ge": 1}
MAX_BOXES = 65536          # the scan's bitset and the mask's grid


def iou_row(a, b, iou):
    """IoU of boxes ``a`` [..., 1, 4] against ``b`` [..., N, 4] -> [..., N],
    in the JAX package's order of operations (``iou`` names the
    formula)."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                     min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                     min=0.0)
    inter = iw * ih
    if iou == "pair":
        union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
        return torch.where(union > 0, inter / union, 0.0)
    area_a = torch.clamp(ax2 - ax1, min=0.0) * torch.clamp(ay2 - ay1, min=0.0)
    area_b = torch.clamp(bx2 - bx1, min=0.0) * torch.clamp(by2 - by1, min=0.0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


def _check(boxes, valid, ids, iou, cmp):
    if iou not in _IOU or cmp not in _CMP:
        raise ValueError("greedy_nms: iou %r (pair, corner), cmp %r (ge, gt)"
                         % (iou, cmp))
    if valid.dim() != 2 or tuple(boxes.shape) != tuple(valid.shape) + (4,):
        raise ValueError("greedy_nms: boxes %s, valid %s: expected [B, N, 4] "
                         "and [B, N]" % (tuple(boxes.shape),
                                         tuple(valid.shape)))
    if ids is not None and tuple(ids.shape) != tuple(valid.shape):
        raise ValueError("greedy_nms: ids %s, expected %s"
                         % (tuple(ids.shape), tuple(valid.shape)))
    for t in (valid,) + ((ids,) if ids is not None else ()):
        if t.device != boxes.device:
            raise ValueError("greedy_nms: inputs on %s and %s"
                             % (boxes.device, t.device))


def greedy_nms_reference(boxes, valid, ids=None, threshold=0.5, iou="pair",
                         cmp="ge"):
    """The greedy loop: for each box ``i`` in order, a still-kept box ``i``
    suppresses every later box whose IoU with it passes ``cmp`` against
    ``threshold`` (and, with ``ids``, that has its class).  boxes
    [B, N, 4]; valid [B, N] bool, the boxes that start kept.  Returns the
    keep mask [B, N] bool.  The loop stops after the last valid box (one
    read of the mask on the host)."""
    _check(boxes, valid, ids, iou, cmp)
    keep = valid.clone().bool()
    B, N = keep.shape
    if B * N == 0:
        return keep
    any_valid = keep.any(0)
    n_end = int(torch.nonzero(any_valid).max()) + 1 if bool(
        any_valid.any()) else 0
    later = torch.arange(N, device=boxes.device)
    for i in range(n_end):
        row = iou_row(boxes[:, i:i + 1], boxes, iou)
        sup = (row >= threshold) if cmp == "ge" else (row > threshold)
        sup = sup & (later > i) & keep[:, i:i + 1]
        if ids is not None:
            sup = sup & (ids == ids[:, i:i + 1])
        keep = keep & ~sup
    return keep


def _configure(lib):
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mxt_greedy_nms.argtypes = [vp, vp, vp, vp, vp, i, i, f, i, i, vp]
    lib.mxt_greedy_nms.restype = ctypes.c_int
    lib.mxt_greedy_nms_error_string.argtypes = [ctypes.c_int]
    lib.mxt_greedy_nms_error_string.restype = ctypes.c_char_p


def _greedy_nms_cuda(boxes, valid, ids=None, threshold=0.5, iou="pair",
                     cmp="ge"):
    """Launch ``csrc/nms.cu`` (the suppression bitmask, then the scan) on
    CUDA tensors; f32 boxes only."""
    _check(boxes, valid, ids, iou, cmp)
    if boxes.dtype != torch.float32 or (ids is not None
                                        and ids.dtype != torch.float32):
        raise TypeError("greedy_nms: the kernel takes float32 boxes and ids, "
                        "got %s / %s" % (boxes.dtype,
                                         None if ids is None else ids.dtype))
    B, N = valid.shape
    if N > MAX_BOXES or B > 65535:
        raise ValueError("greedy_nms: %d images of %d boxes (at most 65535 "
                         "of %d)" % (B, N, MAX_BOXES))
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:                      # float4 loads
        boxes = boxes.clone()
    valid8 = valid.to(torch.uint8).contiguous()
    ids = ids.contiguous() if ids is not None else None
    keep = torch.empty((B, N), dtype=torch.bool, device=boxes.device)
    if B * N == 0:
        return keep
    words = -(-N // 64)
    mask = torch.empty((B, N, words), dtype=torch.int64, device=boxes.device)
    lib = _build.load("nms", _configure)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    count_launch("greedy_nms")
    rc = lib.mxt_greedy_nms(boxes.data_ptr(), valid8.data_ptr(),
                            ids.data_ptr() if ids is not None else None,
                            mask.data_ptr(), keep.data_ptr(), B, N,
                            float(threshold), _IOU[iou], _CMP[cmp], stream)
    _build.check(lib, "mxt_greedy_nms", rc)
    return keep


def greedy_nms(boxes, valid, ids=None, threshold=0.5, iou="pair", cmp="ge"):
    """Greedy NMS over score-sorted ``boxes`` [B, N, 4]: the keep mask
    [B, N] bool (see the module's docstring for ``iou``, ``cmp`` and
    ``ids``).  The CUDA kernel on a CUDA tensor, the plain loop on a CPU
    tensor; a ``meta`` tensor (the symbol layer's shape inference) gets
    the mask's shape only."""
    if boxes.device.type == "meta":
        _check(boxes, valid, ids, iou, cmp)
        return torch.empty(valid.shape, dtype=torch.bool, device="meta")
    fn, _ = select_impl("greedy_nms", boxes)
    return fn(boxes, valid, ids, threshold, iou, cmp)


register_impl("greedy_nms", cuda=_greedy_nms_cuda,
              reference=greedy_nms_reference)
