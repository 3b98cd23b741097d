"""Tensor operators: elementwise, broadcast and scalar arithmetic,
reductions (with ``exclude``), shape ops (``split`` / ``stack`` and
``expand_dims`` / ``squeeze`` among them), ``pick``, ``dot``, ``cast`` and
``zeros_like`` / ``ones_like``.
Counterpart of those ops in ``mxnet_tpu/ops/tensor.py``, under the
reference's names: the ones the symbolic ResNet path emits
(``broadcast_add``, which ``Symbol.__add__`` composes, with the aliases
``elemwise_add``, ``_plus`` and ``_add``; ``_plus_scalar``; ``Flatten``),
the ones NDArray's operators and methods, the Gluon layers, losses and
``gluon.utils`` and ``gluon.rnn`` call, the scalar forms ``Symbol``'s
other operators compose (``_minus_scalar`` ... ``_rpower_scalar``) and
``clip`` (MobileNet's relu6).

A scalar operand takes the dtype of the array first (``_scalar_*``), as the
reference's ``jnp.asarray(scalar, x.dtype)`` does; comparisons return the
array's dtype (float32 for bool inputs).
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


def scalar_in(x, scalar):
    """``scalar`` rounded to ``x``'s dtype, as a Python number (exact in
    the f32 arithmetic torch does for f16/bf16 tensors)."""
    if x.dtype in (torch.float32, torch.float64):
        return float(scalar)
    return torch.tensor(scalar, dtype=x.dtype).item()


# ---------------------------------------------------------------------------
# unary elementwise
# ---------------------------------------------------------------------------
_UNARY = {
    "abs": torch.abs, "negative": torch.neg, "exp": torch.exp,
    "log": torch.log, "sqrt": torch.sqrt, "square": torch.square,
    "sigmoid": torch.sigmoid, "relu": torch.relu, "tanh": torch.tanh,
}
for _name, _f in _UNARY.items():
    register(_name)(lambda x, _f=_f: _f(x))

register("copy", aliases=("identity", "_copy"))(lambda x: x.clone())


@register("cast", aliases=("Cast",))
def _cast(x, dtype="float32"):
    return x.to(torch_dtype(dtype))


# ---------------------------------------------------------------------------
# binary broadcast and scalar forms
# ---------------------------------------------------------------------------
def _cast_bool(f):
    def g(a, b):
        r = f(a, b)
        if r.dtype == torch.bool:
            r = r.to(a.dtype if a.dtype != torch.bool else torch.float32)
        return r
    return g


_BINARY = {
    "broadcast_add": torch.add, "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul, "broadcast_div": torch.div,
    "broadcast_mod": torch.remainder, "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum, "broadcast_minimum": torch.minimum,
    "broadcast_equal": torch.eq, "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt, "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt, "broadcast_lesser_equal": torch.le,
}
_ELEMWISE_ALIAS = {
    "broadcast_add": ("elemwise_add", "_plus", "_add"),
    "broadcast_sub": ("elemwise_sub", "_minus", "_sub"),
    "broadcast_mul": ("elemwise_mul", "_mul"),
    "broadcast_div": ("elemwise_div", "_div"),
    "broadcast_power": ("_power",),
    "broadcast_maximum": ("_maximum", "maximum"),
    "broadcast_minimum": ("_minimum", "minimum"),
}

# torch.maximum / minimum take no Python number
_TENSOR_ONLY = ("broadcast_maximum", "broadcast_minimum")

for _name, _f in _BINARY.items():
    _g = _cast_bool(_f)
    register(_name, aliases=_ELEMWISE_ALIAS.get(_name, ()))(
        lambda a, b, _g=_g: _g(a, b))
    register("_scalar_" + _name)(
        lambda x, _g=_g, _full=_name in _TENSOR_ONLY, scalar=0.0,
        reverse=False:
        _g(torch.full_like(x, scalar_in(x, scalar)), x) if reverse
        else _g(x, torch.full_like(x, scalar_in(x, scalar)) if _full
                else scalar_in(x, scalar)))


def _as_x(x, scalar):
    """``scalar`` as a 0-d tensor of ``x``'s dtype on its device."""
    return torch.tensor(scalar, dtype=x.dtype, device=x.device)


@register("_plus_scalar")
def _plus_scalar(x, scalar=0.0):
    """``x + scalar``, the scalar cast to ``x``'s dtype first."""
    return x + _as_x(x, scalar)


# the scalar forms ``Symbol``'s operators compose, each scalar cast to the
# array's dtype first
register("_minus_scalar")(lambda x, scalar=0.0: x - _as_x(x, scalar))
register("_rminus_scalar")(lambda x, scalar=0.0: _as_x(x, scalar) - x)
register("_mul_scalar")(lambda x, scalar=1.0: x * _as_x(x, scalar))
register("_div_scalar")(lambda x, scalar=1.0: x / _as_x(x, scalar))
register("_rdiv_scalar")(lambda x, scalar=1.0: _as_x(x, scalar) / x)
register("_power_scalar")(lambda x, scalar=1.0: x ** _as_x(x, scalar))
register("_rpower_scalar")(lambda x, scalar=1.0: _as_x(x, scalar) ** x)


@register("clip")
def _clip(x, a_min=None, a_max=None):
    """``x`` limited to ``[a_min, a_max]`` (either bound may be None)."""
    if a_min is None and a_max is None:
        return x.clone()
    return torch.clamp(x, a_min, a_max)


@register("add_n", aliases=("ElementWiseSum",))
def _add_n(*xs, num_args=None):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _axes(x, axis, exclude):
    """The reduced axes as a tuple (``None``: all), complemented under
    ``exclude``."""
    if axis is None or axis == ():
        return None
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (int(axis),)
    ax = tuple(a % x.dim() for a in ax)
    if exclude:
        ax = tuple(a for a in range(x.dim()) if a not in ax)
    return ax


def _reduce(f):
    def g(x, axis=None, keepdims=False, exclude=False):
        ax = _axes(x, axis, exclude)
        if ax is None:
            out = f(x, dim=tuple(range(x.dim())))
            return out.reshape((1,) * x.dim()) if keepdims else out
        if not ax:
            return x
        return f(x, dim=ax, keepdim=bool(keepdims))
    return g


register("sum", aliases=("sum_axis",))(_reduce(torch.sum))
register("mean")(_reduce(torch.mean))



@register("norm")
def _norm(x, ord=2, axis=None, keepdims=False):
    ax = _axes(x, axis, False)
    dim = ax if ax is not None else tuple(range(x.dim()))
    if ord == 1:
        return x.abs().sum(dim=dim, keepdim=bool(keepdims))
    return x.square().sum(dim=dim, keepdim=bool(keepdims)).sqrt()


@register("argmax", no_grad=True)
def _argmax(x, axis=None, keepdims=False):
    """Indices of the largest entries, as float32 (the reference's
    dtype)."""
    if axis is None:
        return x.argmax().to(torch.float32)
    return x.argmax(dim=int(axis), keepdim=bool(keepdims)).to(torch.float32)


# ---------------------------------------------------------------------------
# shape
# ---------------------------------------------------------------------------
@register("reshape", aliases=("Reshape",))
def _reshape(x, shape=None, reverse=False):
    """The reference's special codes (src/operator/tensor/matrix_op.cc): 0
    keep a dim, -1 infer, -2 copy the rest, -3 merge the next two, -4 split
    one into the next two spec values (one may be -1)."""
    spec, in_shape = list(shape), list(x.shape)
    out, i, j = [], 0, 0
    while j < len(spec):
        s = spec[j]
        if s == 0:
            out.append(in_shape[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(in_shape[i:])
            i = len(in_shape)
        elif s == -3:
            out.append(in_shape[i] * in_shape[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = spec[j + 1], spec[j + 2]
            if d1 == -1:
                d1 = in_shape[i] // d2
            if d2 == -1:
                d2 = in_shape[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(s)
            i += 1
        j += 1
    return x.reshape(tuple(out))


@register("Flatten", aliases=("flatten",))
def _flatten(x):
    return x.reshape(x.shape[0], -1)


@register("transpose")
def _transpose(x, axes=None):
    return x.permute(tuple(axes) if axes else
                     tuple(reversed(range(x.dim()))))


@register("expand_dims")
def _expand_dims(x, axis=0):
    return x.unsqueeze(int(axis))


@register("squeeze")
def _squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    return x.squeeze(tuple(axis) if isinstance(axis, (list, tuple))
                     else int(axis))


@register("swapaxes", aliases=("SwapAxis",))
def _swapaxes(x, dim1=0, dim2=0):
    return x.transpose(int(dim1), int(dim2))


@register("slice_axis")
def _slice_axis(x, axis=0, begin=0, end=None):
    idx = [slice(None)] * x.dim()
    idx[int(axis)] = slice(begin, end)
    return x[tuple(idx)]


@register("pad", aliases=("Pad",))
def _pad(x, mode="constant", pad_width=None, constant_value=0.0):
    """``pad_width`` as the reference gives it: (before, after) per axis,
    first axis first."""
    pw = []
    for i in reversed(range(len(pad_width) // 2)):
        pw += [int(pad_width[2 * i]), int(pad_width[2 * i + 1])]
    if mode == "constant":
        return torch.nn.functional.pad(x, pw, value=constant_value)
    # F.pad pads only the trailing (spatial) axes in these modes
    while len(pw) > 2 and pw[-1] == 0 and pw[-2] == 0:
        pw = pw[:-2]
    return torch.nn.functional.pad(
        x, pw, mode={"edge": "replicate", "reflect": "reflect"}[mode])


@register("Concat", aliases=("concat",))
def _concat(*xs, dim=1, num_args=None):
    return torch.cat(xs, dim=int(dim))


@register("stack")
def _stack(*xs, axis=0, num_args=None):
    return torch.stack(xs, dim=int(axis))


@register("split", aliases=("SliceChannel",),
          visible_out=lambda attrs: list(range(int(
              attrs.get("num_outputs", 1)))))
def _split(x, num_outputs=1, axis=1, squeeze_axis=False):
    """``num_outputs`` equal pieces along ``axis`` (each without it under
    ``squeeze_axis``): a tuple, or the one piece."""
    num_outputs, axis = int(num_outputs), int(axis)
    if x.shape[axis] % num_outputs:
        raise ValueError("split: axis %d of size %d does not divide into "
                         "%d" % (axis, x.shape[axis], num_outputs))
    parts = x.chunk(num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


# ---------------------------------------------------------------------------
# indexing and products
# ---------------------------------------------------------------------------
@register("pick")
def _pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data``'s entries at ``index`` along ``axis`` (indices clipped to
    the axis, the reference's default mode)."""
    ax = int(axis) % data.dim()
    idx = index.long().clamp(0, data.shape[ax] - 1).unsqueeze(ax)
    out = torch.gather(data, ax, idx)
    return out if keepdims else out.squeeze(ax)


@register("dot")
def _dot(a, b, transpose_a=False, transpose_b=False):
    """src/operator/tensor/dot-inl.h: contracts ``a``'s last axis with
    ``b``'s first (MXNet's semantics, not numpy's matmul)."""
    if transpose_a:
        a = a.permute(tuple(reversed(range(a.dim()))))
    if transpose_b:
        b = b.permute(tuple(reversed(range(b.dim()))))
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("where")
def _where(cond, x, y):
    return torch.where(cond != 0, x, y)


# ---------------------------------------------------------------------------
# init-like
# ---------------------------------------------------------------------------
register("zeros_like")(torch.zeros_like)
register("ones_like")(torch.ones_like)
