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
  shows one); ``visible_out`` is a function of the node's attributes;
* ``mutate`` — ``{output: input}`` slots the reference writes back in
  place (FMutateInputs): BatchNorm's moving statistics, an optimizer's
  weight and state.  It is a dict, or, for ops whose arity is known only
  per call (``Custom``, ``multi_sgd_*``), a function ``mutate(params,
  n_inputs)`` giving the dict.  The symbol layer reads it to tell
  auxiliary states from arguments; :func:`invoke` and the training
  executor write the mutated outputs back into their inputs;
* ``train_aware`` — the function takes ``_train`` (True in a training
  forward): BatchNorm's batch statistics, ``Custom``'s ``is_train``;
* ``no_grad`` — the op is an update, not part of a differentiated graph.

:class:`invoke_tap` lets a scope see every imperative call's op,
parameters and tensors (after the reference's ``invoke_tap``).
"""
from __future__ import annotations

import threading

__all__ = ["OpDef", "register", "get_op", "list_ops", "invoke", "call",
           "invoke_tap", "OPS"]

OPS: dict = {}
_TAPS = threading.local()


class OpDef:
    """A registered operator."""

    __slots__ = ("name", "fn", "num_outputs", "no_grad", "aliases",
                 "input_names", "mutate", "mutate_fn", "visible_out",
                 "train_aware")

    def __init__(self, name, fn, num_outputs=1, no_grad=False, aliases=(),
                 input_names=(), mutate=None, visible_out=None,
                 train_aware=False):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.no_grad = no_grad
        self.aliases = tuple(aliases)
        self.input_names = tuple(input_names)
        if callable(mutate):
            self.mutate_fn, self.mutate = mutate, {}
        else:
            self.mutate_fn, self.mutate = None, dict(mutate or {})
        self.visible_out = visible_out
        self.train_aware = train_aware

    def mutate_map(self, params, n_inputs):
        """``{output: input}`` write-backs of one call with ``params``."""
        if self.mutate_fn is not None:
            return self.mutate_fn(params, n_inputs)
        return self.mutate

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


def call(opdef, tensors, params, train=False):
    """``opdef``'s function on ``tensors``; ``_train`` goes to ops that
    take it.  Always a tuple of outputs."""
    if opdef.train_aware:
        params = dict(params, _train=train)
    res = opdef.fn(*tensors, **params)
    return tuple(res) if isinstance(res, (tuple, list)) else (res,)


class invoke_tap:  # pylint: disable=invalid-name
    """Scope: ``fn(opdef, params, inputs, outputs)`` sees every
    :func:`invoke` on this thread after the op ran, with its input and
    output tensors (``FusedTrainStep`` reads the optimizer's per-step
    scalars, and counts a step's FLOPs and bytes from the shapes, this
    way)."""

    def __init__(self, fn):
        self._fn = fn

    def __enter__(self):
        if not hasattr(_TAPS, "fns"):
            _TAPS.fns = []
        _TAPS.fns.append(self._fn)
        return self

    def __exit__(self, *a):
        _TAPS.fns.remove(self._fn)


def invoke(op, ndarray_inputs, params=None):
    """Run op ``op`` (a name or an :class:`OpDef`) on NDArrays; returns one
    NDArray or a list of them (the reference's convention).

    Outputs in the op's ``mutate`` map are written back into their input
    NDArrays, which come back in their place; an op with a dynamic map
    and ``visible_out`` (``Custom``, ``multi_sgd_*``) returns only its
    visible outputs.  As in the reference, ``_train`` is
    ``autograd.is_training()``, and the op builds an autograd graph only
    while ``autograd.is_recording()``."""
    from .. import autograd
    from ..ndarray.ndarray import NDArray

    opdef = get_op(op) if isinstance(op, str) else op
    params = dict(params or {})
    inputs = list(ndarray_inputs)
    tensors = [x.data if isinstance(x, NDArray) else x for x in inputs]
    with autograd.grad_scope():
        res = call(opdef, tensors, params, autograd.is_training())
    for fn in getattr(_TAPS, "fns", ()):
        fn(opdef, params, tensors, res)
    mut = opdef.mutate_map(params, len(inputs))
    outputs = []
    for i, r in enumerate(res):
        if i in mut and isinstance(inputs[mut[i]], NDArray):
            inputs[mut[i]]._set_data(r)
            outputs.append(inputs[mut[i]])
        else:
            outputs.append(NDArray(r))
    if opdef.mutate_fn is not None and opdef.visible_out is not None:
        outputs = [outputs[j] for j in opdef.visible_out(params)]
    return outputs[0] if len(outputs) == 1 else outputs
