"""Device contexts.

Counterpart of ``mxnet_tpu/context.py``: a ``(device_type, device_id)`` pair
with a thread-local default and a ``with`` scope.  A Context maps to a
:class:`torch.device`: ``gpu(i)`` is ``cuda:i`` and ``cpu()`` is the host.

The default context is ``gpu(0)``.  Unlike the JAX package, which falls back
to the host when it sees no accelerator, a ``gpu`` context without a CUDA
device raises as soon as it is resolved to a device: the port runs on the
CPU only when the caller asks for it (``ctx=mx.cpu()`` or ``with
mx.cpu():``).
"""
from __future__ import annotations

import threading

import torch

__all__ = ["Context", "cpu", "gpu", "current_context"]


class Context:
    """A device context, usable as a ``with`` scope to set the default."""

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if device_type not in ("cpu", "gpu"):
            raise ValueError("unknown device type %r (mxnet_tpu_torch runs "
                             "on 'gpu' or 'cpu')" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)

    def torch_device(self):
        """The :class:`torch.device` of this context.  A ``gpu`` context
        raises :class:`RuntimeError` when no CUDA device is visible."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        from . import resolve_device

        return resolve_device(torch.device("cuda", self.device_id))

    @classmethod
    def of(cls, device):
        """The Context of a :class:`torch.device`."""
        device = torch.device(device)
        if device.type == "cuda":
            return cls("gpu", device.index or 0)
        if device.type == "cpu":
            return cls("cpu", 0)
        raise ValueError("no Context for device %s" % device)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def __enter__(self):
        if not hasattr(Context._default_ctx, "stack"):
            Context._default_ctx.stack = []
        Context._default_ctx.stack.append(self)
        return self

    def __exit__(self, *args):
        Context._default_ctx.stack.pop()

    @classmethod
    def default_ctx(cls):
        stack = getattr(cls._default_ctx, "stack", None)
        return stack[-1] if stack else Context("gpu", 0)


def cpu(device_id=0):
    """The host."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """CUDA device ``device_id``."""
    return Context("gpu", device_id)


def current_context():
    """The innermost ``with`` context, else ``gpu(0)``."""
    return Context.default_ctx()
