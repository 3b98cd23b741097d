"""Executor: a bound symbolic graph, for inference and training.

Counterpart of ``mxnet_tpu/executor.py``.  Where the JAX package lowers the
whole graph to one XLA module (and its backward to ``jax.vjp`` of it), this
executor walks the graph node by node in topological order on the bound
context's device, calling each op's function, and drops each intermediate
as soon as its last consumer has run, so peak memory follows the live
activations (in training: what autograd saved for the backward).

* ``forward(is_train=False)`` runs under ``torch.inference_mode``, and the
  auxiliary states (BatchNorm's moving statistics) do not change.
* ``forward(is_train=True)`` runs the ops in training mode with autograd
  recording from the arguments whose ``grad_req`` is not ``null``, and
  writes each op's new auxiliary states (its ``mutate`` outputs) back into
  the aux arrays, once.
* ``set_monitor_callback(cb)`` taps every op node's outputs
  (``monitor.Monitor.install``).
* ``backward(out_grads)`` takes ``torch.autograd.grad`` of the last
  training forward's outputs with respect to those arguments, the head
  gradients being ``out_grads`` (ones where none is given), and writes the
  gradients into ``grad_arrays`` (``write``) or adds them (``add``).  When
  no training forward ran since the last backward, or when it is given new
  inputs by name, it runs one first, from the auxiliary states that forward
  started from: each forward-backward pair applies the moving-statistics
  update exactly once, as the JAX package's fused step does.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ndarray as nd
from .context import current_context
from .ndarray import NDArray
from .ops.registry import call

__all__ = ["Executor"]

_GRAD_REQS = ("write", "add", "null")


class Executor:
    """A symbol bound to arrays on one context.  ``grad_req`` is a string
    for every argument, a list aligned with ``list_arguments()``, or a dict
    (arguments it leaves out get ``null``)."""

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
        if isinstance(grad_req, str):
            self._grad_req = dict.fromkeys(self.arg_names, grad_req)
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(self.arg_names, grad_req))
        else:
            self._grad_req = {n: grad_req.get(n, "null")
                              for n in self.arg_names}
        bad = {r for r in self._grad_req.values() if r not in _GRAD_REQS}
        if bad:
            raise ValueError("grad_req must be one of %s, not %s"
                             % (_GRAD_REQS, sorted(bad)))

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
        self.grad_arrays = [
            nd.zeros(a.shape, ctx=self._ctx, dtype=a.dtype)
            if self._grad_req[n] != "null" else None
            for n, a in zip(self.arg_names, self.arg_arrays)]
        self._index()
        self.outputs = []
        self._pending = None      # the last training forward, until backward
        self._monitor_cb = None

    def set_monitor_callback(self, callback, monitor_all=False):
        """Install a per-node output tap (reference
        ``MXExecutorSetMonitorCallbackEX``): every forward then calls
        ``callback(node name, outputs)`` after each op node, the outputs
        being that node's tensors.  ``None`` removes it."""
        self._monitor_cb = callback

    def _index(self):
        self.arg_dict = dict(zip(self.arg_names, self.arg_arrays))
        self.aux_dict = dict(zip(self.aux_names, self.aux_arrays))
        self.grad_dict = dict(zip(self.arg_names, self.grad_arrays))

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

    # -- running the graph ----------------------------------------------
    def _run(self, train):
        """Walk the graph once.  In training, returns the outputs and the
        ``(position, leaf)`` pairs of the differentiated arguments, and
        writes the new auxiliary states back."""
        sym = self._symbol
        topo = sym._topo()
        values, leaves = {}, []
        for i, (n, a) in enumerate(zip(self.arg_names, self.arg_arrays)):
            t = a.data
            if train and self._grad_req[n] != "null":
                if t.is_inference():
                    t = t.clone()
                t = t.detach().requires_grad_(True)
                leaves.append((i, t))
            values[n] = t
        aux_pos = {n: i for i, n in enumerate(self.aux_names)}
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
        for node in topo:
            if node.is_var:
                env[id(node)] = (values[node.name],)
                continue
            res = call(node.op, [env[id(src)][oi] for src, oi in node.inputs],
                       node.attrs, train)
            env[id(node)] = res
            if self._monitor_cb is not None:
                self._monitor_cb(node.name, res)
            if train:
                mut = node.op.mutate_map(node.attrs, len(node.inputs))
                for out_i, in_i in mut.items():
                    src = node.inputs[in_i][0] if in_i < len(node.inputs) \
                        else None
                    if src is not None and src.is_var \
                            and src.name in aux_pos:
                        self.aux_arrays[aux_pos[src.name]]._set_data(
                            res[out_i].detach())
            for src, _ in node.inputs:
                pending[id(src)] -= 1
                if pending[id(src)] == 0:
                    del env[id(src)]
        return [env[id(n)][oi] for n, oi in sym._outputs], leaves

    def forward(self, is_train=False, **kwargs):
        """Run the graph on the bound arrays (after writing ``kwargs`` into
        the named arguments); returns and keeps the outputs."""
        self._stage(kwargs)
        if not is_train:
            with torch.inference_mode():
                outs, _ = self._run(False)
            self._pending = None
        else:
            aux_in = [a.data for a in self.aux_arrays]
            outs, leaves = self._run(True)
            self._pending = (outs, leaves, aux_in)
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def backward(self, out_grads=None, is_train=True, **kwargs):
        """Gradients of the outputs with respect to the arguments whose
        ``grad_req`` is not ``null``, with ``out_grads`` (an NDArray, or
        one per output, ``None`` meaning ones) as head gradients."""
        if kwargs:
            if self._pending is not None:
                # the forward pending here read other inputs: rerun it from
                # the auxiliary states it started from
                for arr, val in zip(self.aux_arrays, self._pending[2]):
                    arr._set_data(val)
                self._pending = None
            self._stage(kwargs)
        if self._pending is None:
            self.forward(is_train=True)
        outs, leaves, _ = self._pending
        self._pending = None
        if isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        heads = list(out_grads or [])
        heads += [None] * (len(outs) - len(heads))
        ys, gys = [], []
        for o, g in zip(outs, heads):
            if not o.requires_grad:
                continue
            ys.append(o)
            gys.append(torch.ones_like(o) if g is None else
                       (g.data if isinstance(g, NDArray)
                        else torch.as_tensor(np.asarray(g)))
                       .to(device=o.device, dtype=o.dtype))
        grads = [None] * len(leaves)
        if ys and leaves:
            grads = torch.autograd.grad(ys, [t for _, t in leaves], gys,
                                        allow_unused=True)
        for (pos, leaf), g in zip(leaves, grads):
            tgt = self.grad_arrays[pos]
            if tgt is None:
                continue
            if g is None:
                g = torch.zeros_like(leaf)
            if self._grad_req[self.arg_names[pos]] == "add":
                tgt.data.add_(g)
            else:
                tgt._set_data(g)
        return self.outputs

    # -- parameters -------------------------------------------------------
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

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """An executor for other input shapes (``data=(N, C, H, W)``,
        ...): arrays whose shape does not change — the parameters, their
        gradients, the auxiliary states — are the same NDArrays as this
        executor's; the others are new zeros."""
        shapes = {n: a.shape for n, a in self.arg_dict.items()}
        shapes.update(kwargs)
        new = Executor(self._symbol, ctx=self._ctx, grad_req=self._grad_req,
                       arg_shapes=shapes)
        for mine, theirs in ((self.arg_arrays, new.arg_arrays),
                             (self.aux_arrays, new.aux_arrays),
                             (self.grad_arrays, new.grad_arrays)):
            for i, (a, b) in enumerate(zip(mine, theirs)):
                if a is not None and b is not None and a.shape == b.shape:
                    theirs[i] = a
        new._index()
        return new
