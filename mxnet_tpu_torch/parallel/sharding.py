"""Sharding rules: the port of ``mxnet_tpu/parallel/sharding.py``.

A ``PartitionSpec`` per array, chosen by regex rules over the parameter
name, says how the array is cut over the mesh's axes.  The placement
currency is ``torch.distributed.tensor.DTensor``: a spec maps to one
``Shard(dim)`` or ``Replicate()`` placement per mesh axis
(:meth:`NamedSharding.placements`), :func:`shard_array` builds the DTensor
from this rank's slice of the full array (every rank holds the same full
array, so no collective is needed), and ``to_local()`` is the counterpart
of a JAX array's ``addressable_shards``.  Compute reads the local tensors;
a gather (:func:`gather`) is an ``allgather`` over the spec's axes.

``constraint`` is the identity: in per-rank code an activation is already
the local shard its rank computes, and a JAX sharding constraint never
changes values.
"""
from __future__ import annotations

import re

from .mesh import get_mesh

__all__ = ["ShardingRules", "param_sharding", "shard_array", "auto_shard",
           "constraint", "PartitionSpec", "match_partition_rules",
           "make_shard_and_gather_fns", "NamedSharding", "local_shard",
           "gather", "spec_of", "local_tensor", "zeros_like"]


class PartitionSpec(tuple):
    """One entry per array dimension: None (not cut), a mesh axis name, or
    a tuple of names (the first the major one)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


P = PartitionSpec


class ShardingRules:
    """Ordered (regex, PartitionSpec) rules; first full match wins."""

    def __init__(self, rules):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_for(self, name) -> PartitionSpec:
        for pat, spec in self.rules:
            if pat.fullmatch(name):
                return spec
        return PartitionSpec()


def _entry_axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _filter_spec(spec, mesh, shape=None):
    """Drop axes absent from the mesh (so one rule set serves many meshes)
    and, when ``shape`` is known, axes that do not evenly divide the dim
    (replicate instead of failing — e.g. a vocab of 97 with tp=2)."""
    sizes = mesh.shape

    def keep(i, entry):
        kept = []
        for e in _entry_axes(entry):
            if e not in sizes:
                continue
            if shape is not None:
                factor = sizes[e]
                for prev in kept:
                    factor *= sizes[prev]
                if shape[i] % factor:
                    continue
            kept.append(e)
        if not kept:
            return None
        return tuple(kept) if len(kept) > 1 else kept[0]

    return PartitionSpec(*(keep(i, e) for i, e in enumerate(spec)))


class NamedSharding:
    """A mesh and a (filtered) spec: the counterpart of
    ``jax.sharding.NamedSharding``."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec

    def placements(self):
        """DTensor placements, one per mesh axis.  Two axes on one dim must
        come in mesh order (DTensor's nesting)."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in self.mesh.axis_names:
            dims = [d for d, e in enumerate(self.spec)
                    if name in _entry_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        order = {a: i for i, a in enumerate(self.mesh.axis_names)}
        for e in self.spec:
            ax = _entry_axes(e)
            if [order[a] for a in ax] != sorted(order[a] for a in ax):
                raise ValueError("spec entry %r is not in mesh order %s"
                                 % (e, self.mesh.axis_names))
        return out

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


def param_sharding(spec, mesh=None, shape=None) -> NamedSharding:
    mesh = mesh or get_mesh()
    return NamedSharding(mesh, _filter_spec(spec, mesh, shape))


def local_shard(x, spec, mesh=None):
    """This rank's slice of the full array ``x`` under the (filtered)
    ``spec``: a view of ``x``."""
    mesh = mesh or get_mesh()
    spec = _filter_spec(spec, mesh, tuple(x.shape))
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:                  # the first axis is the major one
            n, idx = n * mesh.size(a), idx * mesh.size(a) + mesh.index(a)
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x


def gather(x, spec, mesh=None, full_shape=None):
    """The full array from this rank's shard ``x``: an ``allgather`` over
    each cut dim's axes (differentiable: its backward is the reduce-scatter).
    ``spec`` must be filtered already, or ``full_shape`` given."""
    from .collectives import allgather

    mesh = mesh or get_mesh()
    if full_shape is not None:
        spec = _filter_spec(spec, mesh, tuple(full_shape))
    for dim, entry in enumerate(spec):
        axes = [a for a in _entry_axes(entry) if a in mesh.shape]
        if axes:
            x = allgather(x, tuple(axes), axis=dim)
    return x


def _as_tensor(x, device):
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(device)
    from ..models.transformer import params_from_numpy

    return params_from_numpy({"x": x}, device)["x"]


def shard_array(x, spec, mesh=None):
    """Place the full array ``x`` (numpy or tensor, the same on every rank)
    with ``spec``: a DTensor holding this rank's slice, on this rank's
    device."""
    import torch
    from torch.distributed.tensor import DTensor

    from .. import _dist

    mesh = mesh or get_mesh()
    full = _as_tensor(x, _dist.device())
    sharding = param_sharding(spec, mesh, shape=tuple(full.shape))
    local = local_shard(full, sharding.spec, mesh).contiguous()
    return DTensor.from_local(local, mesh.mesh, sharding.placements(),
                              run_check=False, shape=full.shape,
                              stride=torch.empty(full.shape,
                                                 device="meta").stride())


def auto_shard(named_arrays, rules: ShardingRules, mesh=None):
    """Shard a {name: array} dict by rules; returns a new dict of
    DTensors."""
    mesh = mesh or get_mesh()
    return {k: shard_array(v, rules.spec_for(k), mesh)
            for k, v in named_arrays.items()}


def spec_of(x):
    """The PartitionSpec of a DTensor's placements; a plain tensor is
    replicated: ``P()``."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return PartitionSpec()
    names = x.device_mesh.mesh_dim_names
    entries = [[] for _ in range(x.ndim)]
    for name, pl in zip(names, x.placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(name)
    return PartitionSpec(*(None if not e else (e[0] if len(e) == 1
                                               else tuple(e))
                           for e in entries))


def zeros_like(x):
    """Zeros in ``x``'s layout: a DTensor of the same placements (made
    locally) or a plain tensor."""
    import torch
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return torch.zeros_like(x)
    return DTensor.from_local(torch.zeros_like(x.to_local()), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def local_tensor(x):
    """A DTensor's local tensor (sharing its storage), or ``x``."""
    return x.to_local() if hasattr(x, "to_local") else x


def match_partition_rules(rules, named_arrays):
    """Resolve a PartitionSpec per named array: ``rules`` is a
    :class:`ShardingRules` or a list of ``(regex, PartitionSpec)`` pairs;
    scalars and size-1 arrays always replicate, and names no rule matches
    replicate too.  Returns ``{name: spec}``."""
    if not isinstance(rules, ShardingRules):
        rules = ShardingRules(list(rules or []))
    specs = {}
    for name, arr in named_arrays.items():
        shape = tuple(getattr(arr, "shape", ()))
        if len(shape) == 0 or all(d <= 1 for d in shape):
            specs[name] = PartitionSpec()
        else:
            specs[name] = rules.spec_for(name)
    return specs


def make_shard_and_gather_fns(partition_specs, mesh=None):
    """Per-name shard / gather callables over a spec dict.
    ``shard_fns[name](x)`` places the full array ``x`` with the spec
    (:func:`shard_array`; axes the mesh lacks or that do not divide the
    dim replicate); ``gather_fns[name](x)`` gives the full array back as
    numpy (an allgather of the local shard: every rank of the mesh must
    call it).  Returns ``(shard_fns, gather_fns)``."""
    import torch

    mesh = mesh or get_mesh()
    shard_fns, gather_fns = {}, {}
    for name, spec in partition_specs.items():
        def _shard(x, _spec=spec):
            return shard_array(x, _spec, mesh)

        def _gather(x, _spec=spec):
            full = gather(local_tensor(x).detach(), spec_of(x), mesh)
            if full.dtype == torch.bfloat16:
                try:                    # JAX's bf16 numpy type, if there
                    import ml_dtypes
                except ImportError:
                    return full.float().cpu().numpy()
                return full.cpu().view(torch.int16).numpy().view(
                    ml_dtypes.bfloat16)
            return full.cpu().numpy()

        shard_fns[name] = _shard
        gather_fns[name] = _gather
    return shard_fns, gather_fns


def constraint(x, *spec_entries, mesh=None):
    """The identity: per-rank code already holds each activation's local
    shard (see the module docstring)."""
    del spec_entries, mesh
    return x
