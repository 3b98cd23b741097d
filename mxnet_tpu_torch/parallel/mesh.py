"""Device mesh: the port of ``mxnet_tpu/parallel/mesh.py``.

A mesh names the axes of a grid of ranks, as a ``jax.sharding.Mesh``
names a grid of devices.  Here it is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group (one rank drives one device, :mod:`mxnet_tpu_torch._dist`),
with ``mesh_dim_names`` in :data:`AXIS_ORDER`; each axis carries the
process group that the collectives of :mod:`.collectives` run over.
``devices=`` lists ranks where the JAX package lists devices.

The rules are the JAX package's: axes not given have size 1 and are left
out of the mesh; when ``dp`` is not given, ranks left over go into it;
:func:`mesh_slices` cuts the ranks into disjoint meshes of one shape and
leaves the rest unused.  Every rank must build the same meshes in the same
order (their process groups are made collectively).
"""
from __future__ import annotations

import math
import threading

import numpy as np

__all__ = ["DeviceMesh", "make_mesh", "current_mesh", "get_mesh",
           "local_mesh", "mesh_slices", "AXIS_ORDER"]

_state = threading.local()

# canonical axis order: the rightmost axes vary fastest over the ranks
AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


class DeviceMesh:
    """A named mesh of ranks; a context manager that makes it the current
    mesh of this thread (the stack is thread-local, as in JAX)."""

    def __init__(self, mesh):
        self.mesh = mesh                    # torch DeviceMesh

    @property
    def axis_names(self):
        return tuple(self.mesh.mesh_dim_names)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.mesh.mesh.shape))

    @property
    def device_type(self):
        return self.mesh.device_type

    def size(self, axis=None):
        if axis is None:
            return math.prod(self.shape.values())
        return self.shape.get(axis, 1)

    def index(self, axis):
        """This rank's coordinate on ``axis`` (0 for an absent axis)."""
        if axis not in self.axis_names:
            return 0
        return int(self.mesh.get_local_rank(axis))

    def group(self, axis):
        """The process group of this rank's line along ``axis``."""
        return self.mesh.get_group(axis)

    def __enter__(self):
        stack = getattr(_state, "stack", None)
        if stack is None:
            stack = _state.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _state.stack.pop()

    def __repr__(self):
        return "DeviceMesh(%s)" % (", ".join(
            "%s=%d" % (k, v) for k, v in self.shape.items()))


def _sizes(axis_sizes):
    sizes = {k: int(v) for k, v in axis_sizes.items() if v is not None}
    for k in sizes:
        if k not in AXIS_ORDER:
            raise ValueError("unknown mesh axis %r (known: %s)"
                             % (k, AXIS_ORDER))
    return sizes


def _build(ranks, sizes, device_type):
    from torch.distributed.device_mesh import DeviceMesh as _TorchMesh

    names = [a for a in AXIS_ORDER if a in sizes]
    if not names:                       # a mesh of one rank and no axis
        names, sizes = ["dp"], {"dp": 1}
    shape = [sizes[a] for a in names]
    grid = np.asarray(ranks, dtype=np.int64).reshape(shape)
    return DeviceMesh(_TorchMesh(device_type, grid,
                                 mesh_dim_names=tuple(names)))


def _world(devices, device):
    from .. import _dist

    dev = _dist.ensure_initialized(device)
    ranks = list(range(_dist.world_size())) if devices is None \
        else [int(r) for r in devices]
    return ranks, dev.type


def make_mesh(devices=None, device=None, **axis_sizes) -> DeviceMesh:
    """Build a mesh: ``make_mesh(dp=2, tp=4)``.

    ``devices`` lists ranks (default: every rank of the world).  Without a
    process group this process joins one of its own rank (``device=None``
    is the card, which raises without one; ``device="cpu"`` takes gloo).
    Axes not given have size 1 and are left out; if the given sizes use
    fewer ranks than there are and ``dp`` was not given, ``dp`` takes the
    rest."""
    ranks, device_type = _world(devices, device)
    n = len(ranks)
    sizes = _sizes(axis_sizes)
    given = math.prod(sizes.values()) if sizes else 1
    if n % given:
        raise ValueError("axis sizes %r do not divide device count %d"
                         % (sizes, n))
    if given < n and "dp" not in sizes:
        sizes["dp"] = n // given
        given = n
    if given != n:
        raise ValueError("axis sizes %r use %d of %d devices"
                         % (sizes, given, n))
    return _build(ranks, sizes, device_type)


def local_mesh(device=None, **axis_sizes) -> DeviceMesh:
    """The mesh over this process's devices: one rank drives one device, so
    this rank alone (axis sizes multiplying to 1).  Every rank builds every
    rank's (their groups are made collectively) and keeps its own."""
    from .. import _dist

    if math.prod(_sizes(axis_sizes).values()) != 1:
        raise ValueError("local_mesh(%r): a rank drives one device"
                         % (axis_sizes,))
    slices = mesh_slices(device=device, **axis_sizes)
    return slices[_dist.rank()]


def mesh_slices(devices=None, device=None, **axis_sizes) -> "list[DeviceMesh]":
    """Cut the ranks into disjoint meshes of the given shape, in
    consecutive groups: ``mesh_slices(tp=2)`` over 8 ranks gives four tp=2
    meshes.  Unlike :func:`make_mesh`, ranks past the last full slice are
    left unused, not put into ``dp``."""
    ranks, _ = _world(devices, device)
    sizes = _sizes(axis_sizes)
    per = math.prod(sizes.values()) if sizes else 1
    if per < 1:
        raise ValueError("axis sizes %r give an empty slice" % (sizes,))
    if per > len(ranks):
        raise ValueError("slice needs %d device(s), only %d available"
                         % (per, len(ranks)))
    return [make_mesh(devices=ranks[i:i + per], device=device, **sizes)
            for i in range(0, len(ranks) - per + 1, per)]


def current_mesh() -> "DeviceMesh | None":
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


def get_mesh() -> DeviceMesh:
    m = current_mesh()
    if m is None:
        raise RuntimeError("no active DeviceMesh — use `with make_mesh(...):`")
    return m
