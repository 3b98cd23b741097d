"""Optimizers: ``Optimizer``, ``SGD``, ``Adam``, the ``Updater``.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py`` (reference
``python/mxnet/optimizer/optimizer.py``).  Each update invokes a registered
update op of ``ops/optimizer_ops.py``, which updates the weight and its
state in place.

* ``num_update`` counts per parameter index; the learning-rate schedule
  reads the largest count, so within one aggregated group every
  parameter's lr comes from the count after the group's bump.
* lr and wd multipliers come from the symbol's ``__lr_mult__`` /
  ``__wd_mult__`` attributes and ``set_lr_mult`` / ``set_wd_mult``; every
  parameter whose name does not end in ``_weight`` gets no weight decay.
* ``SGD.aggregate_num`` (``MXNET_OPTIMIZER_AGGREGATION_SIZE``, default 4)
  lets the ``Updater`` hand SGD groups of up to that many same-dtype
  parameters, which it updates with one ``multi_sgd_(mom_)update``.

The mixed-precision (f32 master weight) paths of the JAX package are not
ported.
"""
from __future__ import annotations

import logging
import math
import os

from ..ndarray import zeros
from ..ops.registry import invoke

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
           "register"]


class Optimizer:
    """Base optimizer: update counts, lr / wd and their multipliers."""

    opt_registry: dict = {}
    aggregate_num = 0

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False):
        if multi_precision:
            raise NotImplementedError("mxnet_tpu_torch: the multi-precision "
                                      "optimizer paths are not ported")
        self.rescale_grad, self.wd = rescale_grad, wd
        self.lr, self.lr_scheduler = learning_rate, lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self.clip_gradient = clip_gradient
        self.num_update = self.begin_num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = ((sym.attr_dict(), sym.list_arguments())
                         if sym is not None else ())
        self.set_lr_mult({})
        self.set_wd_mult({})

    @staticmethod
    def register(klass):
        name = klass.__name__.lower()
        if name in Optimizer.opt_registry:
            logging.warning("New optimizer %s is overriding existing "
                            "optimizer %s", klass.__name__, name)
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def _mults_from_sym(self, attr_key):
        if not self.sym_info:
            return {}
        attrs, arg_names = self.sym_info
        return {n: float(attrs[n][attr_key]) for n in arg_names
                if attr_key in attrs.get(n, ())}

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {**self._mults_from_sym("__lr_mult__"),
                        **args_lr_mult}

    def set_wd_mult(self, args_wd_mult):
        # biases, BatchNorm's gamma and beta, ...: no weight decay
        no_decay = {n: 0.0 for n in self.idx2name.values()
                    if not n.endswith("_weight")}
        self.wd_mult = {**no_decay, **self._mults_from_sym("__wd_mult__"),
                        **args_wd_mult}

    def _update_count(self, index):
        for idx in index if isinstance(index, (list, tuple)) else (index,):
            count = self._index_update_count.get(
                idx, self.begin_num_update) + 1
            self._index_update_count[idx] = count
            self.num_update = max(self.num_update, count)

    def _mult_of(self, index, table):
        if index in table:
            return table[index]
        name = self.idx2name.get(index)
        return table.get(name, 1.0) if name is not None else 1.0

    def _get_lr(self, index):
        base = (self.lr_scheduler(self.num_update)
                if self.lr_scheduler is not None else self.lr)
        return base * self._mult_of(index, self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult_of(index, self.wd_mult)

    def _common_kwargs(self, index):
        kwargs = {"lr": self._get_lr(index), "wd": self._get_wd(index),
                  "rescale_grad": self.rescale_grad}
        if self.clip_gradient:
            kwargs["clip_gradient"] = self.clip_gradient
        return kwargs


register = Optimizer.register  # pylint: disable=invalid-name
create = Optimizer.create_optimizer  # pylint: disable=invalid-name


def _state_buf(weight):
    return zeros(weight.shape, weight.context, dtype=weight.dtype)


@register
class SGD(Optimizer):
    """SGD with momentum (``sgd_update`` / ``sgd_mom_update``; a group of
    several parameters goes to ``multi_sgd_(mom_)update``)."""

    aggregate_num = int(os.environ.get("MXNET_OPTIMIZER_AGGREGATION_SIZE",
                                       "4"))

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lazy_update = momentum, lazy_update

    def create_state(self, index, weight):
        return _state_buf(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        if not isinstance(index, (list, tuple)):
            index, weight, grad, state = [index], [weight], [grad], [state]
        self._update_count(index)
        if len(index) > 1:
            self._update_group(index, weight, grad, state)
            return
        kwargs = self._common_kwargs(index[0])
        if state[0] is not None:
            invoke("sgd_mom_update", [weight[0], grad[0], state[0]],
                   dict(momentum=self.momentum, **kwargs))
        else:
            invoke("sgd_update", [weight[0], grad[0]], kwargs)

    def _update_group(self, indices, weights, grads, states):
        params = dict(num_weights=len(indices),
                      lrs=tuple(self._get_lr(i) for i in indices),
                      wds=tuple(self._get_wd(i) for i in indices),
                      rescale_grad=self.rescale_grad)
        if self.clip_gradient:
            params["clip_gradient"] = self.clip_gradient
        inputs = []
        if self.momentum > 0:
            params["momentum"] = self.momentum
            for w, g, s in zip(weights, grads, states):
                inputs += [w, g, s]
            invoke("multi_sgd_mom_update", inputs, params)
        else:
            for w, g in zip(weights, grads):
                inputs += [w, g]
            invoke("multi_sgd_update", inputs, params)


@register
class Adam(Optimizer):
    """Adam (``adam_update``), the bias correction folded into the lr as
    the reference does."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_state_buf(weight), _state_buf(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kwargs = self._common_kwargs(index)
        t = self._index_update_count[index]
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        kwargs["lr"] = kwargs["lr"] * math.sqrt(coef2) / coef1
        mean, var = state
        invoke("adam_update", [weight, grad, mean, var],
               dict(beta1=self.beta1, beta2=self.beta2,
                    epsilon=self.epsilon, **kwargs))


class Updater:
    """Applies an optimizer to ``(index, grad, weight)``, owning the
    states.  A list-valued call to an optimizer with ``aggregate_num > 0``
    goes in chunks (:meth:`_aggregate_chunks`): runs of same-dtype
    parameters, at most ``aggregate_num`` long, each one optimizer call."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def _state_of(self, index, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        return self.states[index]

    def _aggregate_chunks(self, indices, grads, weights):
        """``(indices, grads, weights)`` chunks, in order."""
        cap = max(int(self.optimizer.aggregate_num), 1)
        run = []
        for i, g, w in zip(indices, grads, weights):
            if run and (len(run) >= cap or run[-1][2].dtype != w.dtype):
                yield tuple(zip(*run))
                run = []
            run.append((i, g, w))
        if run:
            yield tuple(zip(*run))

    def __call__(self, index, grad, weight):
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        if self.optimizer.aggregate_num > 0 and len(index) > 1:
            for idxs, gs, ws in self._aggregate_chunks(index, grad, weight):
                states = [self._state_of(i, w) for i, w in zip(idxs, ws)]
                self.optimizer.update(list(idxs), list(ws), list(gs),
                                      states)
            return
        for i, g, w in zip(index, grad, weight):
            self.optimizer.update(i, w, g, self._state_of(i, w))


def get_updater(optimizer):
    """An :class:`Updater` over ``optimizer``."""
    return Updater(optimizer)
