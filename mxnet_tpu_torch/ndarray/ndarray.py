"""NDArray: the imperative tensor type, over :class:`torch.Tensor`.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``.  An NDArray is a mutable
handle on one tensor (``_set_data`` swaps it) and the Context of that
tensor's device.  PyTorch's CUDA calls return before the device finishes:
``asnumpy`` (and everything built on it) and ``wait_to_read`` are the
points that wait, as ``asnumpy`` and ``wait_to_read`` are in the reference.

``a[key] = value`` writes into ``a``'s tensor in place, converting
``value`` (an NDArray, a tensor, an array or a scalar) to ``a``'s dtype and
device, as the reference's ``__setitem__`` does; ``CustomOp.assign``, the
initializers and the metrics rely on it.  Arithmetic, comparisons, the
shape and reduction methods and ``astype`` go through the op registry
(``broadcast_*``, ``_scalar_broadcast_*``, ``reshape``, ``sum``, ...), so
inside ``autograd.record()`` they are recorded and outside it they build
no graph.  ``attach_grad`` makes the array a gradient leaf
(``autograd.mark_variables``); ``backward`` and ``grad`` are the
reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import dtype_name, np_dtype, numpy_dtype, torch_dtype
from ..context import Context, current_context

__all__ = ["NDArray", "array", "zeros", "ones", "zeros_like", "ones_like",
           "concat"]


def _invoke(name, inputs, params=None):
    from ..ops.registry import invoke

    return invoke(name, inputs, params or {})


class NDArray:
    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray wraps a torch.Tensor, not %s"
                            % type(data).__name__)
        self._data = data
        self._grad = None
        self._grad_req = None

    # -- core -----------------------------------------------------------
    @property
    def data(self):
        """The backing :class:`torch.Tensor`."""
        return self._data

    def _set_data(self, value):
        """In-place mutation: the backing tensor becomes ``value`` (an
        NDArray's tensor, a tensor or an array) on this array's device.  A
        mutated array is a fresh leaf of the autograd graph (a gradient
        leaf again if it has a gradient buffer)."""
        if isinstance(value, NDArray):
            value = value.data
        if value is self._data:
            return
        value = torch.as_tensor(value, device=self._data.device)
        if self._grad_req is not None and self._grad_req != "null":
            from ..autograd import _as_leaf

            value = _as_leaf(value, self._grad_req)
        elif value.requires_grad:
            value = value.detach()
        self._data = value

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return Context.of(self._data.device)

    ctx = context

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    # -- sync / host transfer ------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    def asnumpy(self):
        """A numpy copy (never a view: the port updates tensors in place);
        waits for the device.  bfloat16 comes back as ``ml_dtypes``'
        bfloat16 where that is installed, else as float32 (exact)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            dt = numpy_dtype(t.dtype)
            if isinstance(dt, str):
                t = t.float()
            else:
                return t.view(torch.int16).cpu().numpy().copy().view(dt)
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    # -- autograd -------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Give the array a zero gradient buffer and make it a gradient
        leaf."""
        from .. import autograd

        autograd.mark_variables([self], [NDArray(torch.zeros_like(
            self._data, requires_grad=False))], grad_req)

    @property
    def grad(self):
        return self._grad

    def detach(self):
        """The same values, cut from the graph."""
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd

        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    # -- conversion and movement ---------------------------------------
    def astype(self, dtype, copy=True):
        """A copy in ``dtype`` (recorded inside ``autograd.record()``)."""
        if not copy and torch_dtype(dtype) == self._data.dtype:
            return self
        return _invoke("cast", [self], {"dtype": dtype_name(dtype)})

    def as_in_context(self, ctx):
        if ctx == self.context:
            return self
        return NDArray(self._data.to(ctx.torch_device()))

    as_in_ctx = as_in_context

    def copyto(self, other):
        """Copy into ``other`` (an NDArray, returned) or onto a Context (a
        new NDArray)."""
        if isinstance(other, NDArray):
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True))
        raise TypeError("copyto expects an NDArray or a Context")

    def copy(self):
        """A copy on the same device."""
        return NDArray(self._data.detach().clone())

    def zeros_like(self):
        return NDArray(torch.zeros_like(self._data, requires_grad=False))

    def ones_like(self):
        return NDArray(torch.ones_like(self._data, requires_grad=False))

    # -- shape, reductions, elementwise (recorded ops) -----------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if "shape" in kwargs:
            shape = tuple(kwargs["shape"])
        return _invoke("reshape", [self], {"shape": shape})

    def transpose(self, axes=None):
        return _invoke("transpose", [self], {"axes": axes})

    @property
    def T(self):
        return self.transpose()

    def swapaxes(self, dim1, dim2):
        return _invoke("swapaxes", [self], {"dim1": dim1, "dim2": dim2})

    def expand_dims(self, axis):
        return _invoke("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return _invoke("squeeze", [self], {"axis": axis})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _invoke("split", [self], {"num_outputs": num_outputs,
                                         "axis": axis,
                                         "squeeze_axis": squeeze_axis})

    def slice_axis(self, axis, begin, end):
        return _invoke("slice_axis", [self], {"axis": axis, "begin": begin,
                                              "end": end})

    def sum(self, axis=None, keepdims=False, exclude=False):
        return _invoke("sum", [self], {"axis": axis, "keepdims": keepdims,
                                       "exclude": exclude})

    def mean(self, axis=None, keepdims=False, exclude=False):
        return _invoke("mean", [self], {"axis": axis, "keepdims": keepdims,
                                        "exclude": exclude})

    def argmax(self, axis=None, keepdims=False):
        """Indices of the largest entries, as float32 (the reference's
        dtype for ``argmax``'s output)."""
        return _invoke("argmax", [self], {"axis": axis,
                                          "keepdims": keepdims})

    def abs(self):
        return _invoke("abs", [self])

    def sqrt(self):
        return _invoke("sqrt", [self])

    def square(self):
        return _invoke("square", [self])

    # -- indexing --------------------------------------------------------
    def __getitem__(self, key):
        """Basic indexing (ints, slices): a view, as in the reference."""
        if isinstance(key, NDArray):
            key = key.data.long()
        from .. import autograd

        with autograd.grad_scope():
            return NDArray(self._data[key])

    def __setitem__(self, key, value):
        """Write ``value`` into ``self[key]`` in place, on this array's
        device and in its dtype, outside the autograd graph."""
        if self._data.is_inference():
            # an inference executor's output: a tensor autograd may not
            # write to outside inference mode, so take a copy first
            self._data = self._data.clone()
        if isinstance(value, NDArray):
            value = value.data
        if isinstance(value, torch.Tensor):
            value = value.detach().to(device=self._data.device,
                                      dtype=self._data.dtype)
        elif not isinstance(value, (int, float, bool)):
            value = torch.as_tensor(np.asarray(value),
                                    dtype=self._data.dtype,
                                    device=self._data.device)
        with torch.no_grad():
            self._data[key] = value

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- arithmetic ------------------------------------------------------
    def _binop(self, op, other, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return _invoke(op, [a, b])
        if not isinstance(other, (int, float, bool, np.number)):
            raise TypeError("NDArray arithmetic takes NDArrays and Python "
                            "scalars, not %s" % type(other).__name__)
        return _invoke("_scalar_" + op, [self],
                       {"scalar": other, "reverse": reverse})

    def __add__(self, other):
        return self._binop("broadcast_add", other)

    def __radd__(self, other):
        return self._binop("broadcast_add", other, True)

    def __sub__(self, other):
        return self._binop("broadcast_sub", other)

    def __rsub__(self, other):
        return self._binop("broadcast_sub", other, True)

    def __mul__(self, other):
        return self._binop("broadcast_mul", other)

    def __rmul__(self, other):
        return self._binop("broadcast_mul", other, True)

    def __truediv__(self, other):
        return self._binop("broadcast_div", other)

    def __rtruediv__(self, other):
        return self._binop("broadcast_div", other, True)

    def __mod__(self, other):
        return self._binop("broadcast_mod", other)

    def __pow__(self, other):
        return self._binop("broadcast_power", other)

    def __rpow__(self, other):
        return self._binop("broadcast_power", other, True)

    def __neg__(self):
        return _invoke("negative", [self])

    def __abs__(self):
        return _invoke("abs", [self])

    def __eq__(self, other):
        return self._binop("broadcast_equal", other)

    def __ne__(self, other):
        return self._binop("broadcast_not_equal", other)

    def __gt__(self, other):
        return self._binop("broadcast_greater", other)

    def __ge__(self, other):
        return self._binop("broadcast_greater_equal", other)

    def __lt__(self, other):
        return self._binop("broadcast_lesser", other)

    def __le__(self, other):
        return self._binop("broadcast_lesser_equal", other)

    def __hash__(self):
        return id(self)

    def __iadd__(self, other):
        self._set_data(self.__add__(other).data)
        return self

    def __isub__(self, other):
        self._set_data(self.__sub__(other).data)
        return self

    def __imul__(self, other):
        self._set_data(self.__mul__(other).data)
        return self

    def __itruediv__(self, other):
        self._set_data(self.__truediv__(other).data)
        return self

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(str(s) for s in self.shape),
            self.context)


# ---------------------------------------------------------------------------
# creation functions
# ---------------------------------------------------------------------------
def from_numpy(a, device):
    """A tensor on ``device`` holding a copy of numpy ``a`` in its own
    dtype (``ml_dtypes``' bfloat16 included)."""
    a = np.ascontiguousarray(a)
    if dtype_name(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a.copy()).to(device)


def array(source_array, ctx=None, dtype=None):
    """An NDArray on ``ctx`` (default :func:`current_context`) holding a
    copy of ``source_array``.  As in the reference, the dtype comes from a
    numpy source and is float32 otherwise; float64 becomes float32.  A
    ``dtype`` of bfloat16 rounds an f32 copy."""
    if isinstance(source_array, NDArray):
        source_array = source_array.asnumpy()
    elif isinstance(source_array, torch.Tensor):
        source_array = source_array.detach().cpu().numpy()
    device = (ctx or current_context()).torch_device()
    if dtype is not None and dtype_name(dtype) == "bfloat16":
        return NDArray(array(source_array, ctx, np.float32).data.to(
            torch.bfloat16))
    if dtype is None and not isinstance(source_array, np.ndarray):
        dtype = np.float32
    if isinstance(source_array, np.ndarray) and dtype is None \
            and dtype_name(source_array.dtype) == "bfloat16":
        return NDArray(from_numpy(source_array, device))
    a = np.array(source_array, dtype=np_dtype(dtype) if dtype else None,
                 order="C")
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return NDArray(torch.from_numpy(a).to(device))


def _filled(fill, shape, ctx, dtype):
    if isinstance(shape, int):
        shape = (shape,)
    device = (ctx or current_context()).torch_device()
    return NDArray(torch.full(tuple(shape), fill, dtype=torch_dtype(dtype),
                              device=device))


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return _filled(0, shape, ctx, dtype)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return _filled(1, shape, ctx, dtype)


def zeros_like(a):
    """Zeros of ``a``'s shape, dtype and device."""
    return a.zeros_like()


def ones_like(a):
    """Ones of ``a``'s shape, dtype and device."""
    return a.ones_like()


def concat(*arrays, dim=1):
    """``arrays`` joined along ``dim`` (all on one device)."""
    return _invoke("Concat", list(arrays), {"dim": dim})
