"""Gluon Trainer: applies an Optimizer to a set of Parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference ``python/mxnet/
gluon/trainer.py``: Trainer:27, step:302, _allreduce_grads:353) on one
device: every Parameter lives on one context, so ``allreduce_grads`` has
nothing to reduce, and ``step`` rescales by ``1 / batch_size`` and runs
the optimizer through its ``Updater`` — for SGD, ``multi_(mp_)sgd_*``
updates over groups of parameters, in place.  KVStores, several contexts
per Parameter and the numerical-health guard (``numeric_guard``,
``attach_sentinel``) are not ported and raise.
"""
from __future__ import annotations

from .. import optimizer as opt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    """Applies an optimizer over a set of parameters
    (reference: gluon/trainer.py:27)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, donate=None, numeric_guard=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                "got %s." % (type(params),))
        if isinstance(kvstore, str) and kvstore.startswith("dist") \
                or update_on_kvstore or numeric_guard:
            raise NotImplementedError(
                "mxnet_tpu_torch: distributed kvstores, update_on_kvstore and "
                "the numerical-health guard are not ported")
        self._params = []
        self._param2idx = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    "got list of %s." % (type(param),))
            self._param2idx[param.name] = i
            self._params.append(param)
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._donate = donate            # accepted: updates run in place
        self._init_optimizer(optimizer, optimizer_params)

    @property
    def _optimizer(self):
        return self._updaters[0].optimizer

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            assert not optimizer_params, \
                "optimizer_params must be None if optimizer is an Optimizer " \
                "instance"
            optimizer.param_dict = param_dict
        else:
            optimizer = opt.create(optimizer, param_dict=param_dict,
                                   **optimizer_params)
        self._updaters = [opt.get_updater(optimizer)]

    @property
    def learning_rate(self):
        return self._optimizer.lr if self._optimizer.lr_scheduler is None \
            else self._optimizer.lr_scheduler(self._optimizer.num_update)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One update: gradients rescaled by ``1 / batch_size`` (times the
        ``rescale_grad`` given at construction), then the optimizer
        (reference: trainer.py:302)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        self._allreduce_grads()

    def _allreduce_grads(self):
        for param in self._params:
            if param._replicas is not None and len(param.list_ctx()) > 1:
                raise NotImplementedError(
                    "mxnet_tpu_torch: Parameter '%s' lives on %d contexts; "
                    "the Trainer reduces nothing across contexts yet"
                    % (param.name, len(param.list_ctx())))

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer step alone (after :meth:`allreduce_grads`)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        # one list-valued updater call, so SGD updates whole groups of
        # parameters with one multi-tensor op each
        idxs, grads, arrs = [], [], []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            idxs.append(i)
            grads.append(param.list_grad()[0])
            arrs.append(param.list_data()[0])
        if idxs:
            self._updaters[0](idxs, grads, arrs)

    def save_states(self, fname):
        """Save the optimizer and its states (reference:
        trainer.save_states)."""
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        with open(fname, "rb") as f:
            states = f.read()
        self._updaters[0].set_states(states)
        self._updaters[0].optimizer.param_dict = {
            i: param for i, param in enumerate(self._params)}
