"""Named-axis collectives: the port of ``mxnet_tpu/parallel/collectives.py``.

In the JAX package these are ``lax`` collectives inside ``shard_map``.  In
the port the counterpart of a ``shard_map`` body is plain per-rank code on
local shards, and a collective over a mesh axis runs over that axis's
process group (:meth:`.mesh.DeviceMesh.group`) of the current mesh.  An
axis the mesh lacks has size 1 and its collectives are the identity; an
axis of size 1 in the mesh runs them over a group of one rank.  A tuple of
axes reduces over each in turn; gathers and scatters over a tuple take the
first axis as the major one, as JAX's do.

Each collective that a gradient flows through is a
:class:`torch.autograd.Function` whose backward is the transpose JAX's AD
uses: ``allreduce`` (sum) ↔ itself, ``allgather`` ↔ ``reduce_scatter``,
``ppermute_shift`` ↔ the reverse rotation, ``all_to_all`` ↔ the swapped
all-to-all, and ``broadcast`` is JAX's ``psum`` of the masked operand.  The
backward of ``psum`` is ``psum`` (JAX's rule under
``shard_map(check_vma=False)``): per-rank autograd then differentiates the
SUM over ranks of the scalars each rank backpropagates.
:func:`region_in` and :func:`region_out` give the two transposes that the
``shard_map`` boundary adds: the gradient of an operand replicated over
some axes is summed over them, and the cotangent of a result replicated
over some axes is divided by their size.  With both, ``autograd.grad`` of
a replicated loss gives every rank the gradient of the loss itself, as
``jax.grad`` of a ``shard_map``-ed function does.  A backward collective
meets the other ranks only if every rank of the axis records the same
collectives on operands that need a gradient: per-rank code keeps every
rank's graph the same shape (as ``broadcast`` does, masking rather than
dropping the operand).

Backends: NCCL takes CUDA tensors, gloo takes CPU tensors, and gloo takes
CUDA tensors for the ops in :data:`GLOO_CUDA_NATIVE` only.  For the others
a gloo op on a CUDA tensor is copied through host memory explicitly, and
each such op bumps ``parallel.host_staged.<op>`` and adds its bytes (both
directions) to ``parallel.host_staged.<op>.bytes``
(:func:`host_staged_counts`).  The compute stays on the card.
"""
from __future__ import annotations

import collections
import contextlib
import math
import threading

import torch

from .mesh import current_mesh

__all__ = ["allreduce", "allgather", "reduce_scatter", "ppermute_shift",
           "all_to_all", "axis_index", "axis_size", "pmean", "broadcast",
           "region_in", "region_out", "world_sum", "host_staged_counts",
           "reset_host_staged", "GLOO_CUDA_NATIVE"]

# the gloo collectives that take CUDA tensors themselves (on the H100 with
# torch 2.11, chip_smoke.py's multirank phase holds each to its exact
# result); gloo's send / recv fail on a CUDA tensor ("Bad address"), so
# the ring's and the pipeline's ppermute are copied through host memory,
# counted
GLOO_CUDA_NATIVE = frozenset({"all_reduce", "all_gather", "broadcast",
                              "all_to_all", "reduce_scatter"})

_STAGED = collections.Counter()
_STAGED_LOCK = threading.Lock()


def host_staged_counts():
    """``{"parallel.host_staged.<op>": n, "...<op>.bytes": b}`` since the
    last reset."""
    with _STAGED_LOCK:
        return dict(_STAGED)


def reset_host_staged():
    with _STAGED_LOCK:
        _STAGED.clear()


def _axes(axis_name):
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)


def _line(axis):
    """(group, size, index) of this rank's line along ``axis``; None when
    the mesh lacks the axis (or there is no mesh).  An axis of size 1 runs
    its collectives for real, over a group of one."""
    mesh = current_mesh()
    if mesh is None or axis not in mesh.axis_names:
        return None
    return mesh.group(axis), mesh.size(axis), mesh.index(axis)


def _staged(op, tensors, group):
    """Whether ``op`` on ``tensors`` over ``group`` goes through host
    memory (gloo with a CUDA tensor, for an op it does not take)."""
    import torch.distributed as dist

    if tensors[0].device.type != "cuda":
        return False
    if dist.get_backend(group) != "gloo" or op in GLOO_CUDA_NATIVE:
        return False
    with _STAGED_LOCK:
        _STAGED["parallel.host_staged.%s" % op] += 1
        _STAGED["parallel.host_staged.%s.bytes" % op] += 2 * sum(
            t.numel() * t.element_size() for t in tensors)
    return True


# -- one axis, no autograd ----------------------------------------------------

def _all_reduce(x, axis, op="sum"):
    line = _line(axis)
    if line is None:
        return x.clone()
    return _reduce_on(x, line[0], op)


def _reduce_on(x, group, op="sum"):
    import torch.distributed as dist

    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    if _staged("all_reduce", [x], group):
        out = x.detach().cpu()
        dist.all_reduce(out, red, group=group)
        return out.to(x.device)
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, red, group=group)
    return out


def world_sum(x):
    """The sum of ``x`` over every rank of the default process group (no
    mesh needed; no gradient): the kvstore's cross-process reduce."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return x.clone()
    return _reduce_on(x, dist.group.WORLD)


def _all_gather(x, axis, dim):
    import torch.distributed as dist

    line = _line(axis)
    if line is None:
        return x.clone()
    group, n, _ = line
    src = x.detach().contiguous()
    if _staged("all_gather", [src], group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _reduce_scatter(x, axis, dim):
    import torch.distributed as dist

    line = _line(axis)
    if line is None:
        return x.clone()
    group, n, me = line
    if x.shape[dim] % n:
        raise ValueError("reduce_scatter: dim %d of size %d over %d ranks"
                         % (dim, x.shape[dim], n))
    chunks = [c.contiguous() for c in x.detach().chunk(n, dim)]
    staged = _staged("reduce_scatter", chunks, group)
    if staged:
        chunks = [c.cpu() for c in chunks]
    out = torch.empty_like(chunks[me])
    dist.reduce_scatter(out, chunks, group=group)
    return out.to(x.device) if staged else out


def _ppermute(x, axis, shift):
    import torch.distributed as dist

    line = _line(axis)
    if line is None or shift % line[1] == 0:
        return x.clone()
    group, n, me = line
    ranks = dist.get_process_group_ranks(group)
    src = x.detach().contiguous()
    staged = _staged("ppermute", [src], group)
    if staged:
        src = src.cpu()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(me + shift) % n], group=group),
           dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device) if staged else out


def _all_to_all(x, axis, split_axis, concat_axis):
    import torch.distributed as dist

    line = _line(axis)
    if line is None:
        return x.clone()
    group, n, _ = line
    if x.shape[split_axis] % n:
        raise ValueError("all_to_all: dim %d of size %d over %d ranks"
                         % (split_axis, x.shape[split_axis], n))
    # chunk j of the split axis goes to rank j; what rank j sends lands as
    # chunk j of the concat axis
    src = torch.stack(x.detach().chunk(n, split_axis)).contiguous()
    staged = _staged("all_to_all", [src], group)
    if staged:
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return torch.cat(out.to(x.device).unbind(0), dim=concat_axis)


# -- several axes ------------------------------------------------------------

def _psum(x, axes):
    for a in axes:
        x = _all_reduce(x, a)
    return x


def _gather(x, axes, dim):
    for a in reversed(axes):            # the minor axis first
        x = _all_gather(x, a, dim)
    return x


def _scatter(x, axes, dim):
    for a in axes:                      # the major axis first
        x = _reduce_scatter(x, a, dim)
    return x


def _size(axes):
    mesh = current_mesh()
    return 1 if mesh is None else math.prod(mesh.size(a) for a in axes)


# -- differentiable ----------------------------------------------------------
#
# Autograd may run a backward on another thread (CUDA tensors: the device's
# thread), where this thread's mesh stack is not: each Function keeps the
# mesh of its forward and enters it in its backward.

def _mesh_of(ctx):
    ctx.mesh = current_mesh()


def _entered(ctx):
    return ctx.mesh if ctx.mesh is not None else contextlib.nullcontext()


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        _mesh_of(ctx)
        return _psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        with _entered(ctx):
            return _psum(g, ctx.axes), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        _mesh_of(ctx)
        return _gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        with _entered(ctx):
            return _scatter(g, ctx.axes, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        _mesh_of(ctx)
        return _scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        with _entered(ctx):
            return _gather(g, ctx.axes, ctx.dim), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        _mesh_of(ctx)
        return _ppermute(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        with _entered(ctx):
            return _ppermute(g, ctx.axis, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis):
        ctx.args = axis, split_axis, concat_axis
        _mesh_of(ctx)
        return _all_to_all(x, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        axis, split_axis, concat_axis = ctx.args
        with _entered(ctx):
            return (_all_to_all(g, axis, concat_axis, split_axis), None, None,
                    None)


class _RegionIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        _mesh_of(ctx)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with _entered(ctx):
            return _psum(g, ctx.axes), None


class _RegionOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.n = _size(axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.n if ctx.n != 1 else g), None


def allreduce(x, axis_name, op="sum"):
    """psum / pmean / pmax / pmin over a mesh axis (or a tuple of axes).
    ``max`` and ``min`` carry no gradient, as in JAX."""
    axes = _axes(axis_name)
    if op == "sum":
        return _Psum.apply(x, axes)
    if op == "mean":
        return pmean(x, axis_name)
    if op in ("max", "min"):
        for a in axes:
            x = _all_reduce(x, a, op)
        return x
    raise ValueError("unknown reduce op %r" % op)


def pmean(x, axis_name):
    axes = _axes(axis_name)
    return _Psum.apply(x, axes) / _size(axes)


def allgather(x, axis_name, axis=0, tiled=True):
    """The shards of every rank on the axis, concatenated along ``axis``
    (``tiled=False`` stacks them on a new leading ``axis``)."""
    axes = _axes(axis_name)
    if not tiled:
        x = x.unsqueeze(axis)
    return _AllGather.apply(x, axes, axis)


def reduce_scatter(x, axis_name, axis=0):
    """psum, of which each rank keeps its chunk along ``axis`` (tiled)."""
    return _ReduceScatter.apply(x, _axes(axis_name), axis)


def ppermute_shift(x, axis_name, shift=1):
    """Rotate shards around the axis's ring: rank i sends to i + shift."""
    return _PPermute.apply(x, axis_name, int(shift))


def all_to_all(x, axis_name, split_axis, concat_axis, tiled=True):
    if not tiled:
        raise NotImplementedError("all_to_all: tiled=False is not ported")
    return _AllToAll.apply(x, axis_name, split_axis, concat_axis)


def axis_index(axis_name):
    """This rank's coordinate on the axis (a Python int)."""
    mesh = current_mesh()
    return 0 if mesh is None else mesh.index(axis_name)


def axis_size(axis_name):
    return _size(_axes(axis_name))


def broadcast(x, axis_name, src=0):
    """Every rank gets rank ``src``'s value: JAX's psum of the operand
    masked to ``src`` (so the gradient is JAX's too)."""
    keep = axis_index(axis_name) == src
    return allreduce(torch.where(torch.tensor(keep, device=x.device), x,
                                 torch.zeros_like(x)), axis_name)


def region_in(x, axis_name):
    """Identity whose backward sums the gradient over ``axis_name``: the
    transpose ``shard_map`` gives an operand replicated over those axes."""
    return _RegionIn.apply(x, _axes(axis_name))


def region_out(x, axis_name):
    """Identity whose backward divides the cotangent by the axes' size:
    the transpose ``shard_map(check_vma=False)`` gives a result replicated
    over those axes."""
    return _RegionOut.apply(x, _axes(axis_name))
