"""Neural-network operators of the symbolic path, inference and training.

Counterpart of the ops of ``mxnet_tpu/ops/nn.py`` that the symbolic
ResNet path and the Gluon layers run: Convolution, FullyConnected,
Pooling, BatchNorm (with the moving statistics), Activation, LeakyReLU,
softmax / log_softmax, Dropout, LayerNorm, InstanceNorm, L2Normalization,
Embedding and SoftmaxOutput.  Layouts are the
reference's (NCHW data, OIHW weights, ``(num_hidden, input_dim)`` FC
weights).  Convolutions go to cuDNN and products to cuBLAS through
PyTorch, forward and backward (the JAX package leaves both to XLA); the
executor turns TF32 off for both on the card, so f32 stays f32 as JAX's
"highest" precision keeps it.

Gradients come from autograd, except SoftmaxOutput's, which is the
reference's fused softmax-cross-entropy gradient (an
:class:`torch.autograd.Function` that ignores the head gradient).
BatchNorm in training (``_train=True``) normalizes with the batch
statistics and returns the new moving statistics for the executor to write
back.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from .registry import register


def _tup(v, n, default):
    if v is None or v == () or v == []:
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _attr_bool(v):
    return str(v).lower() in ("true", "1")


# ---------------------------------------------------------------------------
# FullyConnected / Convolution
# ---------------------------------------------------------------------------
@register("FullyConnected", input_names=("data", "weight", "bias"))
def _fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                     flatten=True):
    """y = x·Wᵀ + b (src/operator/nn/fully_connected.cc)."""
    if _attr_bool(flatten) and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    y = torch.matmul(data, weight.t())
    if not _attr_bool(no_bias) and bias is not None:
        y = y + bias
    return y


def conv_nd(data, weight, kernel, stride, dilate, pad, num_group):
    """N-d convolution in the dtype of its inputs, NC(D)HW / OI(D)HW."""
    n = len(kernel)
    if n not in (1, 2, 3):
        raise ValueError("Convolution: %d spatial dims" % n)
    return getattr(F, "conv%dd" % n)(
        data, weight, stride=_tup(stride, n, 1), padding=_tup(pad, n, 0),
        dilation=_tup(dilate, n, 1), groups=int(num_group))


@register("Convolution", input_names=("data", "weight", "bias"))
def _convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=1, num_group=1, no_bias=False,
                 cudnn_tune=None, cudnn_off=False, workspace=1024,
                 layout=None):
    """src/operator/nn/convolution.cc: grouped, dilated N-d convolution."""
    n = len(kernel)
    if data.dim() == n + 1:          # unbatched
        data = data[None]
    out = conv_nd(data, weight, kernel, stride, dilate, pad, num_group)
    if not _attr_bool(no_bias) and bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------
def _window_sum(x, kernel, stride):
    """Each window's sum: an average pool with divisor 1 (in 1-D a 2-D one
    over windows of height 1: ``avg_pool1d`` takes no divisor)."""
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(-2), (1,) + tuple(kernel),
                            (1,) + tuple(stride),
                            divisor_override=1).squeeze(-2)
    return getattr(F, "avg_pool%dd" % len(kernel))(
        x, kernel, stride, divisor_override=1)


@register("Pooling", input_names=("data",))
def _pooling(data, kernel=(), pool_type="max", global_pool=False, stride=(),
             pad=(), pooling_convention="valid", count_include_pad=True,
             cudnn_off=False, p_value=2, layout=None):
    """src/operator/nn/pooling.cc, NC(D)HW or NCW: max, avg or sum.

    As in the reference's lowering, the input is padded explicitly (with
    -inf for max, 0 for avg/sum), with ``pooling_convention="full"`` adding
    the extra high-side padding that turns floor into ceil; avg is the
    window sum divided by the window size (or, without
    ``count_include_pad``, by the count of real elements), one IEEE
    division, as in the reference."""
    n = data.dim() - 2
    if n not in (1, 2, 3):
        raise ValueError("Pooling: %d spatial dims" % n)
    if _attr_bool(global_pool):
        kernel, stride, pad = tuple(data.shape[2:]), (1,) * n, (0,) * n
    else:
        kernel, stride, pad = (_tup(kernel, n, 1), _tup(stride, n, 1),
                               _tup(pad, n, 0))
    pads = []                         # F.pad order: last dim first
    for i in reversed(range(n)):
        extra = 0
        if pooling_convention == "full" and not _attr_bool(global_pool):
            rem = (data.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            extra = (stride[i] - rem) % stride[i] if rem else 0
        pads += [pad[i], pad[i] + extra]
    if pool_type == "max":
        x = F.pad(data, pads, value=float("-inf")) if any(pads) else data
        return getattr(F, "max_pool%dd" % n)(x, kernel, stride)
    if pool_type not in ("avg", "sum"):
        raise ValueError("unknown pool_type %r" % pool_type)
    window_sum = functools.partial(_window_sum, kernel=kernel,
                                   stride=stride)
    out = window_sum(F.pad(data, pads) if any(pads) else data)
    if pool_type == "sum":
        return out
    if _attr_bool(count_include_pad):
        # the window size as a 0-dim tensor made on the device (a fill, no
        # host-to-device copy, so a CUDA graph can capture it); a true
        # division, where a CPU scalar divisor would multiply by its
        # reciprocal on the card
        return out / torch.full((), float(math.prod(kernel)),
                                dtype=out.dtype, device=out.device)
    ones = torch.ones_like(data)
    return out / window_sum(F.pad(ones, pads) if any(pads) else ones)


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------
@register("BatchNorm", input_names=("data", "gamma", "beta", "moving_mean",
                                    "moving_var"),
          mutate={3: 3, 4: 4}, num_outputs=5, train_aware=True,
          visible_out=lambda attrs: [0, 1, 2]
          if _attr_bool(attrs.get("output_mean_var", False)) else [0])
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False, _train=False):
    """src/operator/nn/batch_norm.cc: ``(x − mean)·(γ·rsqrt(var + eps)) +
    β`` (γ = 1 under ``fix_gamma``, so γ's gradient is 0), subtract first as
    the reference does.

    In training (``_train`` without ``use_global_stats``) mean and the
    biased variance are the batch's over every axis but ``axis``, the
    gradient flows through both, and the new moving statistics are
    ``momentum·old + (1 − momentum)·batch``, without gradient; otherwise
    the moving statistics normalize and come back unchanged.  Returns
    ``(out, mean, var, new_moving_mean, new_moving_var)``; f16/bf16 data
    is normalized in f32."""
    low = data.dtype in (torch.float16, torch.bfloat16)
    x = data.float() if low else data
    g = torch.ones_like(gamma) if _attr_bool(fix_gamma) else gamma
    ax = int(axis) % data.dim()
    bshape = [1] * data.dim()
    bshape[ax] = data.shape[ax]
    if _train and not _attr_bool(use_global_stats):
        red = [i for i in range(data.dim()) if i != ax]
        mean = x.mean(dim=red)
        var = x.var(dim=red, unbiased=False)
        new_mean = (momentum * moving_mean
                    + (1 - momentum) * mean.detach())
        new_var = (momentum * moving_var
                   + (1 - momentum) * var.detach())
    else:
        mean, var = moving_mean, moving_var
        new_mean, new_var = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    out = (x - mean.reshape(bshape)) * (g * inv).reshape(bshape) \
        + beta.reshape(bshape)
    return (out.to(data.dtype), mean.detach(), var.detach(), new_mean,
            new_var)


# ---------------------------------------------------------------------------
# Activation / SoftmaxOutput
# ---------------------------------------------------------------------------
_ACTIVATIONS = {
    "relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "softrelu": F.softplus, "softsign": F.softsign,
}


@register("Activation", input_names=("data",))
def _activation(data, act_type="relu"):
    """src/operator/nn/activation.cc: relu, sigmoid, tanh, softrelu
    (softplus) or softsign."""
    if act_type not in _ACTIVATIONS:
        raise ValueError("unknown act_type %r" % (act_type,))
    return _ACTIVATIONS[act_type](data)


@register("LeakyReLU", input_names=("data", "gamma"))
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334):
    """src/operator/leaky_relu.cc: leaky, elu, prelu (``gamma`` per
    channel), selu, gelu (exact)."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 else gamma
        return torch.where(data >= 0, data, g * data)
    if act_type == "selu":
        return F.selu(data)
    if act_type == "gelu":
        return F.gelu(data)
    raise ValueError("unknown act_type %r" % (act_type,))


@register("softmax")
def _softmax(x, axis=-1, temperature=None):
    if temperature:
        x = x / temperature
    return torch.softmax(x, dim=int(axis))


@register("log_softmax")
def _log_softmax(x, axis=-1, temperature=None):
    """The log-softmax; f16/bf16 logits accumulate in f32 and come back in
    their dtype, as in the reference."""
    if temperature:
        x = x / temperature
    if x.dtype in (torch.float16, torch.bfloat16):
        return torch.log_softmax(x.float(), dim=int(axis)).to(x.dtype)
    return torch.log_softmax(x, dim=int(axis))


@register("Dropout", input_names=("data",), train_aware=True)
def _dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False,
             _train=False):
    """src/operator/nn/dropout.cc: inverted dropout in training (or always
    with ``mode="always"``), one mask entry per position, broadcast along
    ``axes``; the mask comes from the device's generator in
    ``mx.random``."""
    from .. import random as _random

    if (not _train and mode != "always") or p <= 0:
        return data
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    keep = torch.rand(shape, generator=_random.generator(data.device),
                      device=data.device) < (1.0 - p)
    return torch.where(keep, data / (1.0 - p), torch.zeros((), dtype=data.dtype,
                                                           device=data.device))


@register("LayerNorm", input_names=("data", "gamma", "beta"))
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """src/operator/nn/layer_norm.cc, with the biased variance."""
    ax = int(axis)
    mean = data.mean(dim=ax, keepdim=True)
    var = data.var(dim=ax, unbiased=False, keepdim=True)
    out = (data - mean) * torch.rsqrt(var + eps)
    bshape = [1] * data.dim()
    bshape[ax % data.dim()] = data.shape[ax]
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


@register("InstanceNorm", input_names=("data", "gamma", "beta"))
def _instance_norm(data, gamma, beta, eps=1e-3):
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    var = data.var(dim=red, unbiased=False, keepdim=True)
    out = (data - mean) * torch.rsqrt(var + eps)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


@register("L2Normalization", input_names=("data",))
def _l2_normalization(data, eps=1e-10, mode="instance"):
    """src/operator/l2_normalization.cc: ``data / sqrt(sum(data²) + eps)``
    over every axis but the batch (``instance``), over the channels
    (``channel``: SSD's conv4_3 norm) or over the spatial axes
    (``spatial``)."""
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    else:
        red = tuple(range(2, data.dim()))
    return data / torch.sqrt(torch.square(data).sum(dim=red, keepdim=True)
                             + eps)


@register("Embedding", input_names=("data", "weight"))
def _embedding(data, weight, input_dim=None, output_dim=None, dtype="float32",
               sparse_grad=False):
    """src/operator/tensor/indexing_op.cc: rows of the (input_dim,
    output_dim) table; the gradient is a dense scatter-add."""
    return weight[data.long()]


def softmax_output_grad(p, label, grad_scale=1.0, ignore_label=-1.0,
                        use_ignore=False, multi_output=False,
                        normalization="null"):
    """The reference's fused softmax-cross-entropy gradient
    (softmax_output-inl.h; ``_softmax_out_grad`` in the JAX package):
    ``(p − onehot(label))·grad_scale / norm``, rows whose label is
    ``ignore_label`` zeroed under ``use_ignore``; ``norm`` is 1 (``null``),
    the batch (``batch``), or the count of labels, of kept labels under
    ``use_ignore`` (``valid``)."""
    ax = 1 if multi_output else p.dim() - 1
    shape = [1] * p.dim()
    shape[ax] = p.shape[ax]
    classes = torch.arange(p.shape[ax], device=p.device).reshape(shape)
    onehot = (label.long().unsqueeze(ax) == classes).to(p.dtype)
    g = p - onehot
    if use_ignore:
        keep = (label != ignore_label).to(p.dtype).unsqueeze(ax)
        g = g * keep
    norm = 1.0
    if normalization == "batch":
        norm = p.shape[0]
    elif normalization == "valid" and use_ignore:
        norm = (label != ignore_label).sum().to(p.dtype).clamp_min(1.0)
    elif normalization == "valid":
        norm = float(label.numel())
    return g * (grad_scale / norm)


class _SoftmaxOutput(torch.autograd.Function):
    """Forward: the softmax.  Backward: :func:`softmax_output_grad`,
    whatever the head gradient (the reference ignores it)."""

    @staticmethod
    def forward(ctx, data, label, cfg):
        p = torch.softmax(data, dim=1 if cfg["multi_output"] else -1)
        ctx.save_for_backward(p, label)
        ctx.cfg = cfg
        return p

    @staticmethod
    def backward(ctx, _head):
        p, label = ctx.saved_tensors
        return softmax_output_grad(p, label, **ctx.cfg), None, None


@register("SoftmaxOutput", input_names=("data", "label"),
          aliases=("Softmax",))
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0):
    """src/operator/softmax_output.cc: the softmax of ``data`` (over axis 1
    with ``multi_output``, else the last); its gradient is the fused
    softmax-cross-entropy one."""
    cfg = dict(grad_scale=float(grad_scale), ignore_label=float(ignore_label),
               use_ignore=_attr_bool(use_ignore),
               multi_output=_attr_bool(multi_output),
               normalization=str(normalization))
    return _SoftmaxOutput.apply(data, label, cfg)
