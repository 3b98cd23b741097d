"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py``.  An op is one plain function
``fn(*tensors, **params)`` over :class:`torch.Tensor` inputs, returning a
tensor or a tuple of tensors; the symbol layer, the executor and the
generated ``nd.*`` functions all reach it through :func:`get_op`.

What the declaration keeps from the reference:

* ``input_names`` — the op's tensor inputs, in order; the symbol layer
  creates ``{name}_{input}`` Variables for the ones a caller leaves out;
* ``num_outputs`` and ``visible_out`` — how many outputs the function
  returns, and which of them a symbol shows (BatchNorm returns five and
  shows one);
* ``mutate`` — ``{output: input}`` slots the reference writes back in
  place; the symbol layer reads it to tell auxiliary states (BatchNorm's
  moving statistics) from arguments.  The inference executor never writes
  them back: in inference they do not change.
"""
from __future__ import annotations

__all__ = ["OpDef", "register", "get_op", "list_ops", "invoke", "OPS"]

OPS: dict = {}


class OpDef:
    """A registered operator."""

    __slots__ = ("name", "fn", "num_outputs", "no_grad", "aliases",
                 "input_names", "mutate", "visible_out")

    def __init__(self, name, fn, num_outputs=1, no_grad=False, aliases=(),
                 input_names=(), mutate=None, visible_out=None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.no_grad = no_grad
        self.aliases = tuple(aliases)
        self.input_names = tuple(input_names)
        self.mutate = dict(mutate or {})
        self.visible_out = visible_out

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name, **opts):
    """Decorator: register ``fn`` as op ``name`` (and its aliases)."""

    def deco(fn):
        op = OpDef(name, fn, **opts)
        OPS[name] = op
        for a in op.aliases:
            OPS[a] = op
        return fn

    return deco


def get_op(name):
    if name not in OPS:
        raise KeyError("operator %r is not registered" % name)
    return OPS[name]


def list_ops(distinct=True):
    """Sorted op names: canonical names by default, every registered name
    (aliases included) with ``distinct=False``."""
    if distinct:
        return sorted({op.name for op in OPS.values()})
    return sorted(OPS)


def invoke(op, ndarray_inputs, params=None):
    """Run op ``op`` (a name or an :class:`OpDef`) on NDArrays; returns one
    NDArray or a list of them (the reference's convention)."""
    from ..ndarray.ndarray import NDArray

    opdef = get_op(op) if isinstance(op, str) else op
    datas = [x.data if isinstance(x, NDArray) else x
             for x in ndarray_inputs]
    res = opdef.fn(*datas, **(params or {}))
    if not isinstance(res, (tuple, list)):
        return NDArray(res)
    return [NDArray(r) for r in res]
