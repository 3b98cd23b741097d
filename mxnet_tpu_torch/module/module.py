"""Module: a Symbol, its Executor and an Optimizer — a trainable model.

Counterpart of ``mxnet_tpu/module/module.py`` (reference
``python/mxnet/module/module.py``): ``bind`` (one executor on one
context, with ``grad_req`` ``null`` for the data and labels),
``init_params`` / ``set_params`` / ``get_params``, ``init_optimizer``
(``rescale_grad = 1/batch`` unless given), ``forward``, ``backward``,
``forward_backward``, ``update`` (one list-valued ``Updater`` call, so SGD
runs in aggregated groups), ``update_metric`` and ``get_outputs``.
``kvstore`` is accepted and ignored.  Checkpoints, monitors and
``BucketingModule`` are not ported.
"""
from __future__ import annotations

import logging

from .. import initializer as _init
from .. import optimizer as opt
from ..context import current_context
from .base_module import BaseModule

__all__ = ["Module"]


def _desc(d):
    """``(name, shape)`` of a DataDesc or a pair."""
    return (d.name, tuple(d.shape)) if hasattr(d, "name") \
        else (d[0], tuple(d[1]))


class Module(BaseModule):
    """``context``: one Context (default ``gpu(0)``; pass ``mx.cpu()`` for
    the host)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None):
        super().__init__(logger=logger)
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise NotImplementedError("mxnet_tpu_torch: Module runs on "
                                          "one context")
            context = context[0]
        self._context = context or current_context()
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        inputs = self._data_names + self._label_names
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._optimizer = None
        self._updater = None

    def _check(self, *flags):
        if not all(getattr(self, f) for f in flags):
            raise RuntimeError("Module: call %s first" % " / ".join(
                {"binded": "bind", "params_initialized": "init_params",
                 "optimizer_initialized": "init_optimizer"}[f]
                for f in flags if not getattr(self, f)))

    # -- bind ----------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             force_rebind=False, grad_req="write"):
        """One executor for these input shapes; the data and labels get no
        gradient, the parameters ``grad_req`` when ``for_training``."""
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self._data_shapes = list(data_shapes)
        self._label_shapes = list(label_shapes or [])
        shapes = dict(_desc(d) for d in self._data_shapes
                      + self._label_shapes)
        req = {n: grad_req if for_training else "null"
               for n in self._param_names}
        self._exec = self._symbol.simple_bind(ctx=self._context,
                                              grad_req=req, **shapes)
        self.binded = True

    # -- parameters ----------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        """Parameters from ``arg_params`` / ``aux_params`` (NDArrays or
        arrays, e.g. ``model.params_from_numpy``'s output) where given,
        else from ``initializer`` (default ``Uniform(0.01)``), by name."""
        if self.params_initialized and not force_init:
            return
        self._check("binded")
        if initializer is None and arg_params is None:
            initializer = _init.Uniform(0.01)
        attrs = self._symbol.attr_dict()
        for names, given, bound in (
                (self._param_names, arg_params, self._exec.arg_dict),
                (self._aux_names, aux_params, self._exec.aux_dict)):
            for name in names:
                if given is not None and name in given:
                    bound[name][:] = given[name]
                elif given is not None and not allow_missing:
                    raise RuntimeError("%s is not presented" % name)
                elif initializer is not None:
                    initializer(_init.InitDesc(name, attrs.get(name)),
                                bound[name])
        self.params_initialized = True

    def get_params(self):
        """``(arg_params, aux_params)``: copies, on the module's device."""
        self._check("binded", "params_initialized")
        return ({n: self._exec.arg_dict[n].copy() for n in self._param_names},
                {n: self._exec.aux_dict[n].copy() for n in self._aux_names})

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    # -- optimizer -----------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """An optimizer by name, made as the reference makes it (with
        ``rescale_grad = 1/batch`` unless ``optimizer_params`` sets it, and
        the parameter names and the symbol, so that only ``*_weight``
        parameters decay), or an Optimizer as it is; and its Updater."""
        self._check("binded", "params_initialized")
        if self.optimizer_initialized and not force_init:
            return
        idx2name = dict(enumerate(self._param_names))
        if isinstance(optimizer, str):
            kwargs = dict(optimizer_params)
            if "rescale_grad" not in kwargs and self._data_shapes:
                batch = _desc(self._data_shapes[0])[1][0]
                kwargs["rescale_grad"] = 1.0 / max(1, batch)
            kwargs.setdefault("param_idx2name", idx2name)
            kwargs.setdefault("sym", self._symbol)
            optimizer = opt.create(optimizer, **kwargs)
        else:
            optimizer.idx2name = idx2name
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True

    # -- compute -------------------------------------------------------------
    def _feed(self, data_batch):
        """``{name: NDArray}`` of a batch; rebinds the executor (sharing
        the parameters) when a shape differs from the bound one."""
        feed = dict(zip(self._data_names, data_batch.data))
        if data_batch.label is not None:
            feed.update((n, a) for n, a in zip(self._label_names,
                                              data_batch.label)
                        if n in self._exec.arg_dict)
        if any(tuple(a.shape) != self._exec.arg_dict[n].shape
               for n, a in feed.items()):
            self._exec = self._exec.reshape(
                **{n: tuple(a.shape) for n, a in feed.items()})
        return feed

    def forward(self, data_batch, is_train=None):
        self._check("binded", "params_initialized")
        if is_train is None:
            is_train = self.for_training
        self._exec.forward(is_train=is_train, **self._feed(data_batch))

    def forward_backward(self, data_batch):
        """One training forward and its backward: the executor's
        ``backward`` runs the forward on the staged batch."""
        self._check("binded", "params_initialized")
        self._exec.backward(**self._feed(data_batch))

    def backward(self, out_grads=None):
        self._check("binded", "params_initialized")
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """One list-valued updater call over every parameter with a
        gradient."""
        self._check("binded", "params_initialized", "optimizer_initialized")
        idxs, grads, weights = [], [], []
        for i, name in enumerate(self._param_names):
            grad = self._exec.grad_dict.get(name)
            if grad is None:
                continue
            idxs.append(i)
            grads.append(grad)
            weights.append(self._exec.arg_dict[name])
        if idxs:
            self._updater(idxs, grads, weights)

    def get_outputs(self, merge_multi_context=True):
        self._check("binded", "params_initialized")
        return self._exec.outputs

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update_dict(
            dict(zip(self._label_names, labels or [])),
            dict(zip(self._symbol.list_outputs(), self._exec.outputs)))

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()
