"""INT8 quantization operators.

Counterpart of ``mxnet_tpu/ops/quantization.py`` (reference:
``src/operator/quantization/``): quantize_v2, dequantize, requantize,
quantized_fully_connected, quantized_dense, quantized_conv,
quantized_pooling, quantized_act, quantized_flatten,
quantized_elemwise_add and quantized_concat.  Quantization is symmetric per
tensor (scale = max(|min|, |max|) / 127, zero point 0), and each quantized
op returns the reference's ``(quantized, min, max)`` triple, where min/max
carry the real range the extreme quantized value stands for.

The int8 × int8 → int32 contraction of the fully connected ops goes through
the kernel registry (:func:`_int8_dot`): the hand-written int8 matmul on a
CUDA tensor, its plain version on a CPU tensor.  The convolution is an f64
convolution (cuDNN on the card) cast to int32: PyTorch has no int8
convolution on CUDA, f32 holds the accumulator exactly only below 2^24 while
ResNet-50's 3×3×512 convolutions reach 127²·4608 ≈ 7.4e7, and f64 is exact
below 2^53.

Every division by a constant divides by a tensor on the data's device: a
CUDA division by a Python scalar multiplies by its reciprocal instead,
which may round differently from the reference's division.  Such
constants are made by a fill on the device, never copied from the host,
so a quantized graph's forward can be captured in a CUDA graph.
"""
from __future__ import annotations

import torch

from .kernels.int8_matmul import int8_matmul
from .nn import _attr_bool, _pooling, conv_nd
from .registry import register

__all__ = []

INT8_MAX = 127.0
INT32_MAX = 2147483647.0       # 2^31 once in f32, as in the reference


def _f32(v, device):
    """``v`` as an f32 tensor on ``device``; a Python number by a fill on
    the device (the same rounding as a copy), so that no op of the int8
    graph copies from the host and a forward can be captured in a CUDA
    graph."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _div(x, q):
    return x / _f32(q, x.device)


def _scale(mn, mx, qmax=INT8_MAX):
    return _div(torch.clamp_min(torch.maximum(mn.abs(), mx.abs()), 1e-10),
                qmax)


def _qmax(t):
    return INT8_MAX if t.dtype == torch.int8 else INT32_MAX


def _to_int8(x):
    """round-half-even, clip to ±127, int8."""
    return torch.clamp(torch.round(x), -INT8_MAX, INT8_MAX).to(torch.int8)


def _int8_dot(data, weight, scale_a=None, scale_b=None):
    """int8 [M, K] × int8 [N, K], contracted over K, through the kernel
    registry: without scales the int32 accumulator, with them the fused
    per-output-channel dequant to f32."""
    return int8_matmul(data, weight, scale_a, scale_b)


@register("_contrib_quantize_v2", aliases=("quantize_v2",), no_grad=True,
          num_outputs=3)
def _quantize_v2(data, min_calib_range=None, max_calib_range=None,
                 out_type="int8"):
    """fp32 → int8 (quantize_v2-inl.h); without calibrated ranges the range
    comes from the data."""
    if min_calib_range is None or max_calib_range is None:
        mn, mx = data.min(), data.max()
    else:
        mn = _f32(min_calib_range, data.device)
        mx = _f32(max_calib_range, data.device)
    s = _scale(mn, mx)
    r = s * INT8_MAX
    return _to_int8(data / s), -r, r


@register("_contrib_dequantize", aliases=("dequantize",), no_grad=True)
def _dequantize(data, min_range, max_range, out_type="float32"):
    """int8 (or an int32 accumulator) → fp32."""
    return data.to(torch.float32) * _scale(min_range, max_range,
                                           _qmax(data))


@register("_contrib_requantize", aliases=("requantize",), no_grad=True,
          num_outputs=3)
def _requantize(data, min_range, max_range, min_calib_range=None,
                max_calib_range=None, out_type="int8"):
    """int32 → int8 (requantize-inl.h): rescale the accumulator's range
    onto int8."""
    real = data.to(torch.float32) * _scale(min_range, max_range, INT32_MAX)
    if min_calib_range is not None:
        mn = _f32(min_calib_range, data.device)
        mx = _f32(max_calib_range, data.device)
    else:
        mn, mx = real.min(), real.max()
    s = _scale(mn, mx)
    r = s * INT8_MAX
    return _to_int8(real / s), -r, r


def _bias_to_acc(bias, min_bias, max_bias, out_scale):
    """An int8 bias with its own range, rescaled into the accumulator's
    scale (the reference shifts the bias likewise)."""
    sb = _scale(min_bias, max_bias)
    return torch.round(bias.to(torch.float32) * sb / out_scale) \
        .to(torch.int32)


@register("_contrib_quantized_fully_connected",
          aliases=("quantized_fully_connected",), no_grad=True,
          num_outputs=3,
          input_names=("data", "weight", "min_data", "max_data",
                       "min_weight", "max_weight", "bias", "min_bias",
                       "max_bias"))
def _quantized_fc(data, weight, min_data, max_data, min_weight,
                  max_weight, bias=None, min_bias=None, max_bias=None,
                  num_hidden=None, no_bias=False, flatten=True):
    """int8 × int8 → int32 (quantized_fully_connected.cc), through the int8
    matmul kernel."""
    if _attr_bool(flatten) and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    out = _int8_dot(data, weight)
    out_scale = _scale(min_data, max_data) * _scale(min_weight, max_weight)
    if not _attr_bool(no_bias) and bias is not None:
        out = out + _bias_to_acc(bias, min_bias, max_bias, out_scale)
    r = out_scale * INT32_MAX
    return out, -r, r


@register("_contrib_quantized_dense", aliases=("quantized_dense",),
          no_grad=True,
          input_names=("data", "weight", "min_data", "max_data",
                       "min_weight", "max_weight", "bias"))
def _quantized_dense(data, weight, min_data, max_data, min_weight,
                     max_weight, bias=None, num_hidden=None, no_bias=False,
                     flatten=True):
    """int8 × int8 with the dequant fused into the kernel's epilogue → f32.

    ``min_weight``/``max_weight`` may be per-output-channel [N]; ``bias``
    is f32, added after the dequant.  Oracle:
    ``dequantize(quantized_fully_connected(...))``."""
    if _attr_bool(flatten) and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    out = _int8_dot(data, weight, _scale(min_data, max_data),
                    _scale(min_weight, max_weight))
    if not _attr_bool(no_bias) and bias is not None:
        out = out + bias.to(torch.float32)
    return out


@register("_contrib_quantized_conv", aliases=("quantized_conv",),
          no_grad=True, num_outputs=3,
          input_names=("data", "weight", "min_data", "max_data",
                       "min_weight", "max_weight", "bias", "min_bias",
                       "max_bias"))
def _quantized_conv(data, weight, min_data, max_data, min_weight,
                    max_weight, bias=None, min_bias=None, max_bias=None,
                    kernel=(), stride=(), dilate=(), pad=(), num_filter=1,
                    num_group=1, no_bias=False, layout=None,
                    cudnn_tune=None, cudnn_off=False, workspace=1024):
    """int8 × int8 → int32 convolution, exact (an f64 convolution)."""
    if data.dtype != torch.int8 or weight.dtype != torch.int8:
        raise TypeError("quantized_conv: data and weight must be int8, got "
                        "%s and %s" % (data.dtype, weight.dtype))
    n = len(kernel)
    out = conv_nd(data.to(torch.float64), weight.to(torch.float64), kernel,
                  stride, dilate, pad, num_group).to(torch.int32)
    out_scale = _scale(min_data, max_data) * _scale(min_weight, max_weight)
    if not _attr_bool(no_bias) and bias is not None:
        b32 = _bias_to_acc(bias, min_bias, max_bias, out_scale)
        out = out + b32.reshape((1, -1) + (1,) * n)
    r = out_scale * INT32_MAX
    return out, -r, r


@register("_contrib_quantized_pooling", aliases=("quantized_pooling",),
          no_grad=True, num_outputs=3,
          input_names=("data", "min_data", "max_data"))
def _quantized_pooling(data, min_data, max_data, kernel=(), pool_type="max",
                       stride=(), pad=(), global_pool=False,
                       pooling_convention="valid", count_include_pad=True,
                       cudnn_off=False):
    """Pooling commutes with quantization (same scale in and out); avg
    pools in f32 and rounds back to int8."""
    out = _pooling(data.to(torch.float32), kernel=kernel,
                   pool_type=pool_type, stride=stride, pad=pad,
                   global_pool=global_pool,
                   pooling_convention=pooling_convention,
                   count_include_pad=count_include_pad)
    out = _to_int8(out) if pool_type == "avg" else out.to(torch.int8)
    return out, min_data, max_data


@register("_contrib_quantized_act", aliases=("quantized_act",),
          no_grad=True, num_outputs=3,
          input_names=("data", "min_data", "max_data"))
def _quantized_act(data, min_data, max_data, act_type="relu"):
    """ReLU in the quantized domain, the range kept as it was (so the scale,
    and with it every int value, is unchanged)."""
    if act_type != "relu":
        raise ValueError("quantized_act supports relu only")
    return torch.clamp_min(data, 0), min_data, max_data


@register("_contrib_quantized_flatten", aliases=("quantized_flatten",),
          no_grad=True, num_outputs=3,
          input_names=("data", "min_data", "max_data"))
def _quantized_flatten(data, min_data, max_data):
    return data.reshape(data.shape[0], -1), min_data, max_data


@register("_contrib_quantized_elemwise_add",
          aliases=("quantized_elemwise_add",), no_grad=True,
          num_outputs=3,
          input_names=("lhs", "rhs", "min_lhs", "max_lhs", "min_rhs",
                       "max_rhs"))
def _quantized_elemwise_add(lhs, rhs, min_lhs, max_lhs, min_rhs, max_rhs,
                            min_calib_range=None, max_calib_range=None,
                            with_relu=False):
    """int8 + int8 → int8 under per-input scales
    (quantized_elemwise_add.cc); either input may be an int32
    accumulator, scaled by its own dtype's quantized max."""
    qa, qb = _qmax(lhs), _qmax(rhs)
    sa = _scale(min_lhs, max_lhs, qa)
    sb = _scale(min_rhs, max_rhs, qb)
    if min_calib_range is not None and max_calib_range is not None:
        mag = torch.maximum(_f32(min_calib_range, lhs.device).abs(),
                            _f32(max_calib_range, lhs.device).abs())
    else:
        mag = qa * sa + qb * sb       # exact bound of |a·sa + b·sb|
    so = _div(torch.clamp_min(mag, 1e-10), INT8_MAX)
    acc = (lhs.to(torch.float32) * (sa / so)
           + rhs.to(torch.float32) * (sb / so))
    if _attr_bool(with_relu):
        acc = torch.clamp_min(acc, 0.0)
    return _to_int8(acc), -mag, mag


@register("_contrib_quantized_concat", aliases=("quantized_concat",),
          no_grad=True, num_outputs=3)
def _quantized_concat(*args, dim=1, num_args=None, min_calib_range=None,
                      max_calib_range=None):
    """Concat int8 (or int32 accumulator) branches with different scales
    (quantized_concat.cc).  Inputs: ``(data_0..data_{n-1}, min_0, max_0,
    min_1, max_1, ...)``.  Each branch is re-binned onto the common range
    (the calibrated one, else the widest branch's) and concatenated."""
    n = int(num_args) if num_args else len(args) // 3
    data, mins, maxs = args[:n], args[n::2], args[n + 1::2]
    if min_calib_range is not None and max_calib_range is not None:
        common = torch.maximum(_f32(min_calib_range, data[0].device).abs(),
                               _f32(max_calib_range, data[0].device).abs())
    else:
        common = torch.maximum(mins[0].abs(), maxs[0].abs())
        for mn, mx in zip(mins[1:], maxs[1:]):
            common = torch.maximum(common, torch.maximum(mn.abs(), mx.abs()))
    out_scale = _div(torch.clamp_min(common, 1e-10), INT8_MAX)
    rebinned = [_to_int8(d.to(torch.float32)
                         * (_scale(mn, mx, _qmax(d)) / out_scale))
                for d, mn, mx in zip(data, mins, maxs)]
    return torch.cat(rebinned, dim=int(dim)), -common, common
