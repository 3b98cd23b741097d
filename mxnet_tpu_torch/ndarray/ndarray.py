"""NDArray: the imperative tensor type, over :class:`torch.Tensor`.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``.  An NDArray is a mutable
handle on one tensor (``_set_data`` swaps it) and the Context of that
tensor's device.  PyTorch's CUDA calls return before the device finishes:
``asnumpy`` (and everything built on it) and ``wait_to_read`` are the
points that wait, as ``asnumpy`` and ``wait_to_read`` are in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import np_dtype, numpy_dtype, torch_dtype
from ..context import Context, current_context

__all__ = ["NDArray", "array", "zeros"]


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
        """A numpy copy; waits for the device."""
        return self._data.detach().cpu().numpy()

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


def zeros(shape, ctx=None, dtype=None):
    if isinstance(shape, int):
        shape = (shape,)
    device = (ctx or current_context()).torch_device()
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                               device=device))
