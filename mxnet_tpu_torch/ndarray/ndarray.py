"""NDArray: the imperative tensor type, over :class:`torch.Tensor`.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``.  An NDArray is a mutable
handle on one tensor (``_set_data`` swaps it) and the Context of that
tensor's device.  PyTorch's CUDA calls return before the device finishes:
``asnumpy`` (and everything built on it) and ``wait_to_read`` are the
points that wait, as ``asnumpy`` and ``wait_to_read`` are in the reference.

``a[key] = value`` writes into ``a``'s tensor in place, converting
``value`` (an NDArray, a tensor, an array or a scalar) to ``a``'s dtype and
device, as the reference's ``__setitem__`` does; ``CustomOp.assign``, the
initializers and the metrics rely on it.  ``+ - * /`` take NDArrays (same
device) and Python scalars and return new NDArrays.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import np_dtype, numpy_dtype, torch_dtype
from ..context import Context, current_context

__all__ = ["NDArray", "array", "zeros", "ones", "zeros_like", "ones_like",
           "concat"]


class NDArray:
    __slots__ = ("_data",)

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray wraps a torch.Tensor, not %s"
                            % type(data).__name__)
        self._data = data

    # -- core -----------------------------------------------------------
    @property
    def data(self):
        """The backing :class:`torch.Tensor`."""
        return self._data

    def _set_data(self, value):
        """In-place mutation: the backing tensor becomes ``value`` (an
        NDArray's tensor, a tensor or an array) on this array's device."""
        if isinstance(value, NDArray):
            value = value.data
        self._data = torch.as_tensor(value, device=self._data.device)

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def context(self):
        return Context.of(self._data.device)

    ctx = context

    # -- sync / host transfer ------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    def asnumpy(self):
        """A numpy copy (never a view: the port updates tensors in place);
        waits for the device."""
        t = self._data.detach()
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()

    # -- conversion and movement ---------------------------------------
    def astype(self, dtype, copy=True):
        dt = torch_dtype(dtype)
        if not copy and dt == self._data.dtype:
            return self
        return NDArray(self._data.to(dt, copy=True))

    def as_in_context(self, ctx):
        if ctx == self.context:
            return self
        return NDArray(self._data.to(ctx.torch_device()))

    def copy(self):
        """A copy on the same device."""
        return NDArray(self._data.clone())

    def zeros_like(self):
        return NDArray(torch.zeros_like(self._data))

    def ones_like(self):
        return NDArray(torch.ones_like(self._data))

    def argmax(self, axis=None, keepdims=False):
        """Indices of the largest entries, as float32 (the reference's
        dtype for ``argmax``'s output)."""
        if axis is None:
            return NDArray(self._data.argmax().to(torch.float32))
        return NDArray(self._data.argmax(dim=axis, keepdim=keepdims)
                       .to(torch.float32))

    # -- indexing --------------------------------------------------------
    def __getitem__(self, key):
        """Basic indexing (ints, slices): a view, as in the reference."""
        if isinstance(key, NDArray):
            key = key.data.long()
        return NDArray(self._data[key])

    def __setitem__(self, key, value):
        """Write ``value`` into ``self[key]`` in place, on this array's
        device and in its dtype."""
        if self._data.is_inference():
            # an inference executor's output: a tensor autograd may not
            # write to outside inference mode, so take a copy first
            self._data = self._data.clone()
        if isinstance(value, NDArray):
            value = value.data
        if isinstance(value, torch.Tensor):
            value = value.to(device=self._data.device,
                             dtype=self._data.dtype)
        elif not isinstance(value, (int, float, bool)):
            value = torch.as_tensor(np.asarray(value),
                                    dtype=self._data.dtype,
                                    device=self._data.device)
        with torch.no_grad():
            self._data[key] = value

    # -- arithmetic ------------------------------------------------------
    def _binop(self, fn, other, reverse=False):
        if isinstance(other, NDArray):
            other = other.data
        elif not isinstance(other, (int, float, bool)):
            raise TypeError("NDArray arithmetic takes NDArrays and Python "
                            "scalars, not %s" % type(other).__name__)
        return NDArray(fn(other, self._data) if reverse
                       else fn(self._data, other))

    def __add__(self, other):
        return self._binop(torch.add, other)

    def __radd__(self, other):
        return self._binop(torch.add, other, True)

    def __sub__(self, other):
        return self._binop(torch.sub, other)

    def __rsub__(self, other):
        return self._binop(lambda a, b: torch.full_like(b, a) - b, other,
                           True)

    def __mul__(self, other):
        return self._binop(torch.mul, other)

    def __rmul__(self, other):
        return self._binop(torch.mul, other, True)

    def __truediv__(self, other):
        return self._binop(torch.div, other)

    def __rtruediv__(self, other):
        return self._binop(lambda a, b: torch.full_like(b, a) / b, other,
                           True)

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(str(s) for s in self.shape),
            self.context)


# ---------------------------------------------------------------------------
# creation functions
# ---------------------------------------------------------------------------
def array(source_array, ctx=None, dtype=None):
    """An NDArray on ``ctx`` (default :func:`current_context`) holding a
    copy of ``source_array``.  As in the reference, the dtype comes from a
    numpy source and is float32 otherwise; float64 becomes float32."""
    if isinstance(source_array, NDArray):
        source_array = source_array.asnumpy()
    elif isinstance(source_array, torch.Tensor):
        source_array = source_array.detach().cpu().numpy()
    if dtype is None and not isinstance(source_array, np.ndarray):
        dtype = np.float32
    a = np.array(source_array, dtype=np_dtype(dtype) if dtype else None,
                 order="C")
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    device = (ctx or current_context()).torch_device()
    return NDArray(torch.from_numpy(a).to(device))


def _filled(fill, shape, ctx, dtype):
    if isinstance(shape, int):
        shape = (shape,)
    device = (ctx or current_context()).torch_device()
    return NDArray(torch.full(tuple(shape), fill, dtype=torch_dtype(dtype),
                              device=device))


def zeros(shape, ctx=None, dtype=None):
    return _filled(0, shape, ctx, dtype)


def ones(shape, ctx=None, dtype=None):
    return _filled(1, shape, ctx, dtype)


def zeros_like(a):
    """Zeros of ``a``'s shape, dtype and device."""
    return a.zeros_like()


def ones_like(a):
    """Ones of ``a``'s shape, dtype and device."""
    return a.ones_like()


def concat(*arrays, dim=1):
    """``arrays`` joined along ``dim`` (all on one device)."""
    return NDArray(torch.cat([a.data for a in arrays], dim=dim))
