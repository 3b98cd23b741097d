"""Executor: a bound symbolic graph, inference only.

Counterpart of ``mxnet_tpu/executor.py``.  Where the JAX package lowers the
whole graph to one XLA module, this executor walks the graph node by node
in topological order on the bound context's device, calling each op's
function under ``torch.inference_mode``, and drops each intermediate as
soon as its last consumer has run, so peak memory follows the live
activations rather than the whole graph.

Auxiliary states (BatchNorm's moving statistics) are inputs like the
arguments; in inference the ops leave them unchanged, so nothing is
written back.  ``forward(is_train=True)`` and ``backward`` are not ported:
they raise :class:`NotImplementedError`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ndarray as nd
from .context import current_context
from .ndarray import NDArray

__all__ = ["Executor"]


class Executor:
    """``grad_req`` is accepted for the reference's signature; inference
    allocates no gradients."""

    def __init__(self, symbol, ctx=None, grad_req="write", arg_shapes=None,
                 args=None, aux_states=None, type_dict=None):
        self._symbol = symbol
        self._ctx = ctx or current_context()
        device = self._ctx.torch_device()      # raises without a card
        if device.type == "cuda":
            # f32 stays f32, as JAX's "highest" precision keeps it
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()

        if args is not None:
            self.arg_arrays = self._align(args, self.arg_names, "args")
        else:
            inferred, _, _ = symbol.infer_shape(**dict(arg_shapes or {}))
            self.arg_arrays = []
            for name, shp in zip(self.arg_names, inferred):
                if shp is None:
                    raise ValueError(
                        "cannot infer shape of argument %r — pass its shape "
                        "to simple_bind" % name)
                dt = (type_dict or {}).get(name, np.float32)
                self.arg_arrays.append(nd.zeros(shp, ctx=self._ctx,
                                                dtype=dt))
        if aux_states is not None:
            self.aux_arrays = self._align(aux_states, self.aux_names, "aux")
        else:
            shapes = {n: a.shape for n, a in zip(self.arg_names,
                                                 self.arg_arrays)}
            _, _, aux_inferred = symbol.infer_shape(**shapes)
            self.aux_arrays = []
            for name, shp in zip(self.aux_names, aux_inferred):
                if shp is None:
                    raise ValueError("cannot infer aux shape %r" % name)
                self.aux_arrays.append(nd.zeros(shp, ctx=self._ctx))
        self.arg_dict = dict(zip(self.arg_names, self.arg_arrays))
        self.aux_dict = dict(zip(self.aux_names, self.aux_arrays))
        self.outputs = []

    def _as_bound(self, v):
        """``v`` as an NDArray on this executor's context."""
        if not isinstance(v, NDArray):
            v = nd.array(v, ctx=self._ctx)
        return v.as_in_context(self._ctx)

    def _align(self, values, names, what):
        if isinstance(values, dict):
            missing = [n for n in names if n not in values]
            if missing:
                raise ValueError("missing %s entry %r" % (what, missing[0]))
            return [self._as_bound(values[n]) for n in names]
        values = list(values)
        if len(values) != len(names):
            raise ValueError("%s length %d != expected %d"
                             % (what, len(values), len(names)))
        return [self._as_bound(v) for v in values]

    def _stage(self, feed):
        """Write a ``{name: array}`` feed into the bound arguments."""
        for k, v in feed.items():
            if k not in self.arg_dict:
                raise ValueError("unknown argument %r" % k)
            self.arg_dict[k]._set_data(v if isinstance(v, NDArray)
                                       else np.asarray(v))

    def forward(self, is_train=False, **kwargs):
        """Run the graph on the bound arrays (after writing ``kwargs`` into
        the named arguments); returns and keeps the outputs."""
        if is_train:
            raise NotImplementedError(
                "mxnet_tpu_torch: the executor runs inference only "
                "(forward(is_train=False)); training is not ported yet")
        self._stage(kwargs)
        sym = self._symbol
        topo = sym._topo()
        values = {n: a.data for n, a in zip(self.arg_names, self.arg_arrays)}
        values.update((n, a.data) for n, a in zip(self.aux_names,
                                                  self.aux_arrays))
        # consumers left per node; graph outputs are never dropped
        pending = {}
        for node in topo:
            for src, _ in node.inputs:
                pending[id(src)] = pending.get(id(src), 0) + 1
        for node, _ in sym._outputs:
            pending[id(node)] = pending.get(id(node), 0) + 1
        env = {}
        with torch.inference_mode():
            for node in topo:
                if node.is_var:
                    env[id(node)] = (values[node.name],)
                    continue
                res = node.op.fn(*[env[id(src)][oi]
                                   for src, oi in node.inputs],
                                 **node.attrs)
                env[id(node)] = tuple(res) if isinstance(
                    res, (tuple, list)) else (res,)
                for src, _ in node.inputs:
                    pending[id(src)] -= 1
                    if pending[id(src)] == 0:
                        del env[id(src)]
            self.outputs = [NDArray(env[id(n)][oi]) for n, oi in sym._outputs]
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        raise NotImplementedError(
            "mxnet_tpu_torch: Executor.backward is not ported yet")

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy ``arg_params`` / ``aux_params`` (NDArrays or arrays) into
        the bound arrays, onto this executor's device."""
        for params, bound, what in ((arg_params, self.arg_dict, "arg"),
                                    (aux_params or {}, self.aux_dict,
                                     "aux")):
            for name, arr in params.items():
                if name in bound:
                    bound[name]._set_data(arr if isinstance(arr, NDArray)
                                          else np.asarray(arr))
                elif not allow_extra_params:
                    raise ValueError("unknown %s %r" % (what, name))
