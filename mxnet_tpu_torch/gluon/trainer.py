"""Gluon Trainer: applies an Optimizer to a set of Parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference ``python/mxnet/
gluon/trainer.py``: Trainer:27, step:302, _allreduce_grads:353) on one
device: every Parameter lives on one context, so ``allreduce_grads`` has
nothing to reduce, and ``step`` rescales by ``1 / batch_size`` and runs
the optimizer through its ``Updater`` — for SGD, ``multi_(mp_)sgd_*``
updates over groups of parameters, in place.  KVStores and several
contexts per Parameter are not ported and raise.

With a numerical-health guard (``numeric_guard=`` / ``MXNET_NUMERIC_GUARD``
/ :meth:`Trainer.attach_sentinel`), ``step`` runs the chaos hooks
``flip_param_bit`` and ``poison_grad`` (under an active plan), counts each
gradient's non-finite elements (:func:`~mxnet_tpu_torch.sentinel.
nonfinite_counts`, one device-to-host copy) and feeds the sentinel; the
update runs only on a finite step (or in ``warn`` mode), as in the JAX
package.  Every ``step`` feeds a ``telemetry.StepAccountant("train.eager")``
(``train.eager.steps_per_sec`` / ``items_per_sec``).
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
                or update_on_kvstore:
            raise NotImplementedError(
                "mxnet_tpu_torch: distributed kvstores and "
                "update_on_kvstore are not ported")
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
        # numerical-health guard (None defers to the MXNET_NUMERIC_GUARD
        # knob, resolved at the first step)
        self._numeric_guard = numeric_guard
        self._sentinel = None
        self._sentinel_ready = False
        self._step_count = 0
        self._accountant = None

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

    def attach_sentinel(self, sentinel):
        """Attach a configured :class:`~mxnet_tpu_torch.sentinel.
        HealthSentinel`; every :meth:`step` then checks the gradients'
        finiteness before the update.  ``None`` detaches (and falls back to
        the MXNET_NUMERIC_GUARD knob)."""
        self._sentinel = sentinel
        self._sentinel_ready = sentinel is not None
        return self

    def _sentinel_for_step(self):
        if not self._sentinel_ready:
            self._sentinel_ready = True
            from .. import sentinel as _sentinel_mod

            mode = _sentinel_mod.guard_mode(self._numeric_guard)
            if mode:
                self._sentinel = _sentinel_mod.HealthSentinel(
                    trainer=self, mode=mode)
        return self._sentinel

    def step(self, batch_size, ignore_stale_grad=False):
        """One update: gradients rescaled by ``1 / batch_size`` (times the
        ``rescale_grad`` given at construction), then the optimizer
        (reference: trainer.py:302).  Under a numerical-health guard a
        non-finite step skips the update (see the module docstring)."""
        if self._accountant is None:
            from .. import telemetry as _telemetry

            self._accountant = _telemetry.StepAccountant("train.eager")
        self._accountant.on_step(batch_size)
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        sentinel = self._sentinel_for_step()
        if sentinel is None:
            self._update(ignore_stale_grad)
            return
        from .. import chaos as _chaos
        from .. import sentinel as _sentinel_mod

        step_idx = self._step_count
        self._step_count = step_idx + 1
        gparams = [p for p in self._params if p.grad_req != "null"]
        if _chaos.active() is not None:
            _chaos.flip_param_bit(step_idx, self._params)
            _chaos.poison_grad(step_idx, gparams)
        grads = [g for p in gparams for g in p.list_grad()]
        counts = _sentinel_mod.nonfinite_counts(grads)
        # one slot per gradient copy: fold them back per Parameter
        per_param, k = [], 0
        for p in gparams:
            n = len(p.list_grad())
            per_param.append(int(counts[k:k + n].sum()))
            k += n
        names = [p.name for p in gparams]
        if any(per_param):
            action = sentinel.observe(step_idx, 0, per_param, names)
            if action == "warn":
                self._update(ignore_stale_grad)
            return  # any other action: update skipped, params unchanged
        self._update(ignore_stale_grad)
        # good-step bookkeeping AFTER the update, so ring snapshots hold
        # the post-step state (as on the fused path)
        sentinel.observe(step_idx, 0, per_param, names)

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
