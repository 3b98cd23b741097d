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

* ``multi_precision=True``: a float16 / bfloat16 weight gets an f32
  master copy in its state (``(state, weight32)``, the reference's
  convention, made by ``create_state_multi_precision``), updated by
  ``mp_sgd_(mom_)update`` or, in groups, ``multi_mp_sgd_(mom_)update``;
  the weight becomes the master rounded to its dtype.
* ``param_dict`` (``{index: Parameter}``, set by ``gluon.Trainer``): a
  Parameter's ``lr_mult`` / ``wd_mult`` win over the tables.
"""
from __future__ import annotations

import logging
import math
import os
import pickle

import numpy as np

from ..base import dtype_name
from ..ndarray import NDArray, zeros
from ..ops.registry import invoke

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
           "register"]


class Optimizer:
    """Base optimizer: update counts, lr / wd and their multipliers."""

    opt_registry: dict = {}
    aggregate_num = 0

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad, self.wd = rescale_grad, wd
        self.multi_precision = multi_precision
        self.param_dict = dict(param_dict) if param_dict else {}
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

    def _wants_master_copy(self, weight):
        low = _is_low_precision(weight.dtype)
        if low and not self.multi_precision:
            logging.warning("Accumulating with float16 in optimizer can lead "
                            "to poor accuracy or slow convergence. Consider "
                            "using multi_precision=True option.")
        return low and self.multi_precision

    def create_state_multi_precision(self, index, weight):
        """The state, with an f32 master copy of a float16 / bfloat16
        weight under ``multi_precision``: ``(state, weight32)``."""
        if not self._wants_master_copy(weight):
            return self.create_state(index, weight)
        master = weight.astype(np.float32)
        return (self.create_state(index, master), master)

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update`, on the f32 master copy when there is one; the
        weight then becomes the master in its own dtype."""
        if not (self.multi_precision and _is_low_precision(weight.dtype)):
            self.update(index, weight, grad, state)
            return
        inner_state, master = state
        self.update(index, master, grad.astype(np.float32), inner_state)
        weight._set_data(master.data.to(weight.data.dtype))

    def set_learning_rate(self, lr):
        """Set the base learning rate (refused under an lr scheduler, as in
        the reference)."""
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined. Note that set_learning_rate can mutate "
                              "the value of the learning rate of the optimizer "
                              "only when the LRScheduler of the optimizer is "
                              "undefined.")
        self.lr = lr

    def __getstate__(self):
        # param_dict holds live Parameters: never pickled (the Trainer
        # re-attaches it on load_states)
        return {k: v for k, v in self.__dict__.items() if k != "param_dict"}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.param_dict = {}

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

    def _mult_of(self, index, table, attr):
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr)
        if index in table:
            return table[index]
        name = self.idx2name.get(index)
        return table.get(name, 1.0) if name is not None else 1.0

    def _get_lr(self, index):
        base = (self.lr_scheduler(self.num_update)
                if self.lr_scheduler is not None else self.lr)
        return base * self._mult_of(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._mult_of(index, self.wd_mult, "wd_mult")

    def _common_kwargs(self, index):
        kwargs = {"lr": self._get_lr(index), "wd": self._get_wd(index),
                  "rescale_grad": self.rescale_grad}
        if self.clip_gradient:
            kwargs["clip_gradient"] = self.clip_gradient
        return kwargs


register = Optimizer.register  # pylint: disable=invalid-name
create = Optimizer.create_optimizer  # pylint: disable=invalid-name


def _is_low_precision(dtype):
    """float16 and bfloat16 want an f32 master copy."""
    return dtype_name(dtype) in ("float16", "bfloat16")


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
        self._update_impl(index, weight, grad, state, False)

    def update_multi_precision(self, index, weight, grad, state):
        w0 = weight[0] if isinstance(weight, (list, tuple)) else weight
        self._update_impl(index, weight, grad, state,
                          self.multi_precision
                          and _is_low_precision(w0.dtype))

    def _update_impl(self, index, weight, grad, state, multi_precision):
        if not isinstance(index, (list, tuple)):
            index, weight, grad, state = [index], [weight], [grad], [state]
        self._update_count(index)
        if len(index) > 1:
            self._update_group(index, weight, grad, state, multi_precision)
            return
        kwargs = self._common_kwargs(index[0])
        if multi_precision:
            mom, weight32 = state[0]
            if mom is not None:
                invoke("mp_sgd_mom_update",
                       [weight[0], grad[0], mom, weight32],
                       dict(momentum=self.momentum, **kwargs))
            else:
                invoke("mp_sgd_update", [weight[0], grad[0], weight32],
                       kwargs)
        elif state[0] is not None:
            invoke("sgd_mom_update", [weight[0], grad[0], state[0]],
                   dict(momentum=self.momentum, **kwargs))
        else:
            invoke("sgd_update", [weight[0], grad[0]], kwargs)

    def _update_group(self, indices, weights, grads, states,
                      multi_precision=False):
        params = dict(num_weights=len(indices),
                      lrs=tuple(self._get_lr(i) for i in indices),
                      wds=tuple(self._get_wd(i) for i in indices),
                      rescale_grad=self.rescale_grad)
        if self.clip_gradient:
            params["clip_gradient"] = self.clip_gradient
        use_mom = self.momentum > 0
        if use_mom:
            params["momentum"] = self.momentum
        inputs = []
        for w, g, s in zip(weights, grads, states):
            if multi_precision:
                mom, w32 = s
                inputs += [w, g, mom, w32] if use_mom else [w, g, w32]
            else:
                inputs += [w, g, s] if use_mom else [w, g]
        op = "multi_%ssgd_%supdate" % ("mp_" if multi_precision else "",
                                       "mom_" if use_mom else "")
        invoke(op, inputs, params)


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
        self.states_synced = {}

    def _state_of(self, index, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            self.states[index] = self.sync_state_context(
                self.states[index], weight.context)
            self.states_synced[index] = True
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
                self.optimizer.update_multi_precision(
                    list(idxs), list(ws), list(gs), states)
            return
        for i, g, w in zip(index, grad, weight):
            self.optimizer.update_multi_precision(i, w, g,
                                                  self._state_of(i, w))

    def sync_state_context(self, state, context):
        """``state`` (an NDArray, a numpy array or nested tuples of them)
        on ``context``."""
        if isinstance(state, NDArray):
            return state.as_in_context(context)
        if isinstance(state, np.ndarray):
            from ..ndarray import array
            return array(state, ctx=context, dtype=state.dtype)
        if isinstance(state, (tuple, list)):
            return type(state)(self.sync_state_context(i, context)
                               for i in state)
        return state

    def set_states(self, states):
        """Load :meth:`get_states`' bytes; the states move to their
        weights' devices at their next update."""
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        """The states (as numpy) and, with ``dump_optimizer``, the
        optimizer, pickled."""
        def to_np(s):
            if isinstance(s, NDArray):
                return s.asnumpy()
            if isinstance(s, (tuple, list)):
                return type(s)(to_np(i) for i in s)
            return s
        states = {k: to_np(v) for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)


def get_updater(optimizer):
    """An :class:`Updater` over ``optimizer``."""
    return Updater(optimizer)
