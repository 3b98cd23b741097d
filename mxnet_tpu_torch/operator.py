"""User-defined operators: ``CustomOp`` / ``CustomOpProp`` / ``register``.

Counterpart of ``mxnet_tpu/operator.py`` (reference
``python/mxnet/operator.py``: CustomOp, CustomOpProp, register, over
``src/operator/custom/custom-inl.h``): a user's Python op, with its own
shape and type inference, used imperatively (``mx.nd.Custom``) and inside
Symbol graphs trained by ``Module`` (``mx.sym.Custom``).

Where the JAX package runs the user's ``forward`` and ``backward`` as host
callbacks inside the compiled program, the port calls them directly: the
``Custom`` op's body is a :class:`torch.autograd.Function` whose forward
calls the user's ``forward`` on NDArrays that live on the executor's device
— so, as in MXNet, a custom op may launch device kernels on them (through
``mx.rtc``) — and whose backward calls the user's ``backward``.  Both run
inside the op's Context (``with ctx:``), so the NDArrays the user's code
creates land on that device; ``create_operator`` receives that Context.
Shapes and dtypes come from ``infer_shape`` / ``infer_type``, which is
also how ``symbol/infer.py`` sizes a graph holding a ``Custom`` node.

Auxiliary states (``list_auxiliary_states``) are trailing inputs; their
values after the user's ``forward`` are extra outputs that the registry's
dynamic ``mutate`` map writes back into them, as BatchNorm's moving
statistics are (``_custom_mutate`` in the JAX package).
"""
from __future__ import annotations

import numpy as np
import torch

from .base import np_dtype, torch_dtype
from .context import Context
from .ndarray.ndarray import NDArray
from .ops.registry import register as _register_op

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered"]


class CustomOp:
    """Base class of a user operator (reference operator.py:426)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError()

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as the request ``req`` says."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise ValueError("unknown req %r" % (req,))


class CustomOpProp:
    """A user operator's properties: arguments, outputs, auxiliary states,
    shapes, types and the operator factory (reference operator.py:472)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), \
            [in_shape[0]] * len(self.list_auxiliary_states())

    def infer_type(self, in_type):
        t = in_type[0] if in_type else np.float32
        return in_type, [t] * len(self.list_outputs()), \
            [t] * len(self.list_auxiliary_states())

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


_PROPS: dict = {}


def register(reg_name):
    """Decorator: register a :class:`CustomOpProp` subclass as
    ``op_type=reg_name`` (reference operator.py:692)."""

    def deco(prop_cls):
        if not (isinstance(prop_cls, type)
                and issubclass(prop_cls, CustomOpProp)):
            raise TypeError("register must be applied to a CustomOpProp "
                            "subclass, got %r" % (prop_cls,))
        _PROPS[reg_name] = prop_cls
        return prop_cls

    return deco


def get_all_registered():
    return dict(_PROPS)


def _prop(params):
    """The user's CustomOpProp for a ``Custom`` call's parameters.  As in
    the reference, every hyper-parameter reaches it as a string."""
    op_type = params.get("op_type")
    if op_type not in _PROPS:
        raise KeyError("Custom op type %r is not registered; use "
                       "@mx.operator.register(%r) on a CustomOpProp subclass"
                       % (op_type, op_type))
    return _PROPS[op_type](**{k: str(v) for k, v in params.items()
                              if k not in ("op_type", "_train")})


def _arity(params):
    prop = _prop(params)
    return (len(prop.list_arguments()), len(prop.list_outputs()),
            len(prop.list_auxiliary_states()))


def _custom_mutate(params, n_inputs):
    n_args, n_out, n_aux = _arity(params)
    return {n_out + j: n_args + j for j in range(n_aux)}


def _custom_visible(attrs):
    return list(range(_arity(attrs)[1]))


def custom_arg_shapes(params, in_shapes):
    """``{input position: shape}`` for a ``Custom`` node's inputs, from the
    user's ``infer_shape`` on the known ones (an unknown one is ``()``, as
    the reference passes it): how ``symbol/infer.py`` sizes a label or an
    auxiliary state nobody declared."""
    prop = _prop(params)
    n_args = len(prop.list_arguments())
    known = [tuple(s) if s is not None else () for s in in_shapes]
    arg_shapes, _, aux_shapes = prop.infer_shape(known[:n_args])
    return dict(enumerate(tuple(s) for s in
                          list(arg_shapes) + list(aux_shapes)))


class _CustomFunction(torch.autograd.Function):
    """The user's ``forward`` / ``backward`` as one autograd node.  Inputs:
    the arguments, then the auxiliary states; outputs: the user's outputs,
    then the auxiliary states after ``forward`` (not differentiable)."""

    @staticmethod
    def forward(ctx, plan, *tensors):
        op, mx_ctx, n_args, out_specs, is_train = plan
        in_nd = [NDArray(t.detach()) for t in tensors[:n_args]]
        # the user's forward may write its aux states in place: give it
        # copies, returned as the new values
        aux_nd = [NDArray(t.detach().clone()) for t in tensors[n_args:]]
        device = tensors[0].device
        out_nd = [NDArray(torch.zeros(s, dtype=dt, device=device))
                  for s, dt in out_specs]
        with mx_ctx:
            op.forward(is_train=is_train, req=["write"] * len(out_nd),
                       in_data=in_nd, out_data=out_nd, aux=aux_nd)
        outs = [o.data for o in out_nd]
        auxs = [a.data for a in aux_nd]
        ctx.mark_non_differentiable(*auxs)
        ctx.save_for_backward(*tensors[:n_args], *outs, *auxs)
        ctx.plan = plan
        ctx.n_out = len(outs)
        return tuple(outs + auxs)

    @staticmethod
    def backward(ctx, *grads):
        op, mx_ctx, n_args, _, _ = ctx.plan
        saved = ctx.saved_tensors
        in_data = [NDArray(t) for t in saved[:n_args]]
        out_data = [NDArray(t) for t in saved[n_args:n_args + ctx.n_out]]
        aux = [NDArray(t) for t in saved[n_args + ctx.n_out:]]
        out_grad = [NDArray(g if g is not None else torch.zeros_like(o.data))
                    for g, o in zip(grads[:ctx.n_out], out_data)]
        in_grad = [NDArray(torch.zeros_like(t)) for t in saved[:n_args]]
        with mx_ctx:
            op.backward(req=["write"] * n_args, out_grad=out_grad,
                        in_data=in_data, out_data=out_data, in_grad=in_grad,
                        aux=aux)
        n_aux = len(saved) - n_args - ctx.n_out
        return (None,) + tuple(g.data for g in in_grad) + (None,) * n_aux


@_register_op("Custom", train_aware=True, mutate=_custom_mutate,
              visible_out=_custom_visible)
def _custom(*tensors, op_type=None, _train=False, **user_kwargs):
    """Run the user operator ``op_type``: its outputs, then its auxiliary
    states after ``forward``.  On ``meta`` tensors (shape inference) the
    outputs are empty tensors of the shapes and dtypes the user's
    ``infer_shape`` / ``infer_type`` give."""
    prop = _prop(dict(user_kwargs, op_type=op_type))
    n_args = len(prop.list_arguments())
    n_aux = len(prop.list_auxiliary_states())
    if len(tensors) != n_args + n_aux:
        raise ValueError("Custom op %r takes %d inputs (%d arguments and %d "
                         "auxiliary states), got %d"
                         % (op_type, n_args + n_aux, n_args, n_aux,
                            len(tensors)))
    in_shapes = [tuple(t.shape) for t in tensors[:n_args]]
    in_types = [np_dtype(t.dtype) for t in tensors[:n_args]]
    arg_shapes, out_shapes, aux_shapes = prop.infer_shape(in_shapes)
    _, out_types, _ = prop.infer_type(in_types)
    out_specs = [(tuple(int(x) for x in s), torch_dtype(np.dtype(t)))
                 for s, t in zip(out_shapes, out_types)]
    device = tensors[0].device
    if device.type == "meta":
        return tuple(torch.empty(s, dtype=dt, device="meta")
                     for s, dt in out_specs) + tuple(tensors[n_args:])
    mx_ctx = Context.of(device)
    op = prop.create_operator(mx_ctx, [tuple(s) for s in arg_shapes],
                              in_types)
    return _CustomFunction.apply((op, mx_ctx, n_args, out_specs,
                                  bool(_train)), *tensors)
