"""FusedTrainStep: forward, loss, backward and the optimizer update in one
call.

Counterpart of ``mxnet_tpu/gluon/contrib/fused.py`` (FusedTrainStep:98).
The JAX package compiles the whole step into one XLA module with donated
buffers.  The port runs it eagerly on the card, with the same semantics:

* the forward and the loss run in training mode (BatchNorm's batch
  statistics; its running statistics are updated once);
* the gradients are those of the loss summed over the batch, taken by
  ``torch.autograd.grad`` with respect to every trainable Parameter (the
  Parameters' ``grad`` buffers are not touched), and ``rescale_grad`` is
  ``1 / batch``, as ``Trainer.step(batch)`` after ``loss.backward()``;
* the trainer's optimizer then updates every Parameter and its state in
  place through the trainer's ``Updater`` (SGD: ``multi_(mp_)sgd_*``
  groups); the host-side scalars the update ops receive — lr after the
  schedule, ``rescale_grad``, wd, for each Parameter in the trainer's
  order — are the reference's ``_host_scalars`` (fused.py:392), kept after
  each step as ``last_scalars`` in its layout ``[rows, loss scale, (lr,
  rescale_grad, wd) per Parameter]``;
* the call returns the per-sample loss NDArray.

**Numerical health** (:mod:`~mxnet_tpu_torch.sentinel`).  With a guard
(``numeric_guard=`` or the ``MXNET_NUMERIC_GUARD`` knob, or a
``sentinel=``) the differentiated loss is multiplied by the sentinel's
loss scale and ``1 / scale`` is folded into ``rescale_grad``; the step
forms the health vector ``[loss nonfinite, per-Parameter gradient
nonfinite]`` on the device from one f32 ``|g|`` sum per gradient and one
``isfinite`` over the stacked scalars, and copies it to the host without
waiting; :meth:`check_health` reads it one step late, at the top of the
next call, so no step waits on the host.  In ``skip`` / ``escalate``
modes a bad step is contained on the device: the update ops write
``where(ok, new, old)`` into the weights, f32 masters and momenta
(``ops.optimizer_ops.update_guard``) and BatchNorm's running statistics
are selected the same way, so every buffer stays bitwise unchanged, and a
finite step is bitwise the unguarded step.  The chaos hooks
``flip_param_bit`` and ``corrupt_loss_scale`` (``nan_grad``) fire at the
step boundary, as in the JAX package.

**Step accounting.**  The first call arms a
``telemetry.StepAccountant("train.fused")`` and every call feeds it, so
``train.fused.{steps_per_sec, items_per_sec}`` and — with the step's cost
(``MXNET_TELEMETRY_COST``) — ``mfu``, ``hbm_gbs`` and ``hbm_util`` are
published with no device sync.  The cost is counted from the shapes the
first call's own ops see (:func:`_step_cost`), never by running the step
again.

``donate`` is accepted (the update already runs in place).  ``devices``,
``bucket``, ``watchdog`` and ``preemption`` need ports of the mesh and of
the rest of ``elastic`` and raise ``NotImplementedError`` when set.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import autograd
from ... import chaos as _chaos
from ...ndarray.ndarray import NDArray, array
from ...ops.optimizer_ops import select_where, update_guard
from ...ops.registry import invoke_tap

__all__ = ["FusedTrainStep"]

# the arguments not ported yet, each with the ROADMAP Queue 1 item that
# ports it
_UNPORTED = {"devices": "9.3 (several devices a step)",
             "bucket": "8 (the rest of elastic)",
             "watchdog": "8 (the rest of elastic)",
             "preemption": "8 (the rest of elastic)"}


class _CostCounter:
    """Op observer of one training forward: FLOPs of every convolution and
    product (forward, and backward for the inputs that need gradients) and
    the bytes of every op's outputs."""

    def __init__(self):
        self.flops = 0.0
        self.act_bytes = 0.0

    def __call__(self, opdef, params, inputs, outputs):
        for o in outputs:
            if isinstance(o, torch.Tensor):
                self.act_bytes += o.numel() * o.element_size()
        if opdef.name not in ("Convolution", "FullyConnected"):
            return
        data, weight, out = inputs[0], inputs[1], outputs[0]
        # one multiply-add per output element and weight element of its
        # filter (a conv's Cin/groups x kernel, a product's K)
        per_out = weight.numel() // weight.shape[0]
        fwd = 2.0 * out.numel() * per_out
        self.flops += fwd
        if getattr(weight, "requires_grad", False):
            self.flops += fwd                           # weight gradient
        if getattr(data, "requires_grad", False):
            self.flops += fwd                           # data gradient


def _nbytes(t):
    return t.numel() * t.element_size()


def _step_cost(counter, weights, states):
    """``{"flops", "bytes_accessed"}`` of one step: the counter's FLOPs;
    bytes for each op output written in the forward and read in the
    backward, with its gradient written and read there (4x), each weight
    read in the forward and the backward and written by the update, with
    its gradient written and read (5x), and each optimizer-state buffer
    read and written (2x)."""
    wbytes = sum(_nbytes(w) for w in weights)
    sbytes = sum(_nbytes(s) for s in states)
    return {"flops": counter.flops,
            "bytes_accessed": 4.0 * counter.act_bytes + 5.0 * wbytes
            + 2.0 * sbytes}


def _abs_sums(tensors):
    """Each tensor's f32 ``|t|`` sum, in order, one multi-tensor reduction
    per dtype (a mixed-dtype list would take the per-tensor route)."""
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    sums = [None] * len(tensors)
    for idx in by_dtype.values():
        for i, v in zip(idx, torch._foreach_norm([tensors[i] for i in idx],
                                                 1, dtype=torch.float32)):
            sums[i] = v
    return sums


def _state_tensors(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _state_tensors(s)]
    return [state.data]


class FusedTrainStep:
    """``step(x, y)``: one training step of ``net`` under ``loss_fn`` with
    ``trainer``'s optimizer (see the module docstring)."""

    def __init__(self, net, loss_fn, trainer, devices=None, donate=None,
                 bucket=None, watchdog=None, preemption=None,
                 numeric_guard=None, sentinel=None):
        given = dict(devices=devices, bucket=bucket, watchdog=watchdog,
                     preemption=preemption)
        for name, item in _UNPORTED.items():
            if given[name] not in (None, False):
                raise NotImplementedError(
                    "mxnet_tpu_torch: FusedTrainStep(%s=...) is not ported "
                    "(ROADMAP Queue 1 item %s)" % (name, item))
        for p in trainer._params:
            if p._replicas is not None and len(p.list_data()) > 1:
                raise ValueError("FusedTrainStep supports single-context "
                                 "parameters")
        self._net = net
        self._loss_fn = loss_fn
        self._trainer = trainer
        self._donate = donate
        self._updater = trainer._updaters[0]
        self._optimizer = self._updater.optimizer
        # the optimizer's indices are the trainer's positions (param_dict,
        # lr_mult and the Updater's states are keyed on them)
        self._pidx = [i for i, p in enumerate(trainer._params)
                      if p.grad_req != "null"]
        self._params = [trainer._params[i] for i in self._pidx]
        self._auxs = [p for p in trainer._params if p.grad_req == "null"]
        self._ready = False
        self.last_scalars = None
        from ... import sentinel as _sentinel_mod

        if sentinel is not None:
            self._sentinel = sentinel
            self._guard_mode = (sentinel.mode if numeric_guard is None
                                else _sentinel_mod.guard_mode(numeric_guard))
        else:
            mode = _sentinel_mod.guard_mode(numeric_guard)
            self._guard_mode = mode
            self._sentinel = (_sentinel_mod.HealthSentinel(
                trainer=trainer, mode=mode) if mode else None)
        self._step_idx = 0
        self._pending_health = None
        self._accountant = None   # telemetry.StepAccountant, armed at call 1

    def _tap(self, scalars):
        def tap(_opdef, params, _inputs, _outputs):
            if "lrs" in params:
                for lr, wd in zip(params["lrs"], params["wds"]):
                    scalars.extend((lr, params["rescale_grad"], wd))
            elif "lr" in params:
                scalars.extend((params["lr"], params["rescale_grad"],
                                params["wd"]))
        return tap

    def __call__(self, x, y):
        """Run one training step; returns the per-sample loss NDArray."""
        # the PREVIOUS step's verdict first, before anything of this step
        # (chaos hooks, loss-scale read, rescale_grad): sentinel actions
        # land at the step boundary a synchronous check would hit
        self.check_health()
        if not isinstance(x, NDArray):
            x = array(np.asarray(x), ctx=self._params[0].list_ctx()[0])
        if not isinstance(y, NDArray):
            y = array(np.asarray(y), ctx=x.context)
        batch = x.shape[0]
        if not self._ready:
            # finish any deferred parameter initialization first
            with autograd.pause(train_mode=False):
                self._net(x)
            self._ready = True
        step_idx = self._step_idx
        _chaos.flip_param_bit(step_idx, self._trainer._params)
        guard = self._guard_mode
        scale = self._sentinel.loss_scale if self._sentinel is not None \
            else 1.0
        scale = _chaos.corrupt_loss_scale(step_idx, scale)
        self._optimizer.rescale_grad = 1.0 / (batch * scale)
        weights = [p.list_data()[0] for p in self._params]
        contain = guard in ("skip", "escalate")
        old_aux = [a.list_data()[0].data for a in self._auxs] \
            if contain else None
        counter = _CostCounter() if self._accountant is None else None
        if counter is not None:
            with invoke_tap(counter), autograd.record(train_mode=True):
                loss = self._loss_fn(self._net(x), y)
        else:
            with autograd.record(train_mode=True):
                loss = self._loss_fn(self._net(x), y)
        lsum = loss.data.sum()
        if guard:
            # scale the DIFFERENTIATED loss only (the returned loss stays
            # user-scale); 1/scale is in rescale_grad
            lsum = lsum * scale
        grads = torch.autograd.grad(lsum, [w.data for w in weights],
                                    allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(w.data)
                 for g, w in zip(grads, weights)]
        ok = None
        if guard:
            # |g|.sum() in f32 is non-finite iff g has a non-finite
            # element: one sum per gradient, one isfinite over the stack
            probes = torch.stack([lsum.detach().float().reshape(())]
                                 + _abs_sums(grads))
            health = (~torch.isfinite(probes)).to(torch.int32)
            ok = health.sum() == 0
            if contain:
                # the forward's new running statistics become where(ok,
                # new, old), written into the new tensors
                news = [a.list_data()[0].data for a in self._auxs]
                if news:
                    select_where(news, old_aux, ~ok)
        grads = [NDArray(g) for g in grads]
        scalars = [float(batch), float(scale)]
        with invoke_tap(self._tap(scalars)):
            if contain:
                with update_guard(ok):
                    self._updater(self._pidx, grads, weights)
            else:
                self._updater(self._pidx, grads, weights)
        self.last_scalars = np.asarray(scalars, dtype=np.float32)
        if guard and self._sentinel is not None:
            self._pending_health = (step_idx,) + self._stage_health(health)
        self._step_idx = step_idx + 1
        if counter is not None:
            self._arm_accountant(counter, weights)
        self._accountant.on_step(batch)
        return NDArray(loss.data.detach())

    @staticmethod
    def _stage_health(health):
        """Start the health vector's copy to the host without waiting; on
        the card into a pinned buffer, with an event to wait on later."""
        if not health.is_cuda:
            return health, None
        host = torch.empty(health.shape, dtype=health.dtype,
                           pin_memory=True)
        host.copy_(health, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event



    def _arm_accountant(self, counter, weights):
        """The ``train.fused`` step accountant, with the cost counted from
        the first call's shapes (``MXNET_TELEMETRY_COST``)."""
        from ... import telemetry as _telemetry
        from ...config import config as _config

        self._accountant = _telemetry.StepAccountant("train.fused")
        if _config.telemetry_cost:
            states = [t for i in self._pidx
                      for t in _state_tensors(self._updater.states.get(i))]
            self._accountant.set_cost(_step_cost(
                counter, [w.data for w in weights], states))

    def check_health(self):
        """Observe the most recent step's health vector now (a no-op when
        none is pending).  The per-step check is deferred by one step so
        the host never blocks mid-loop; call this after the last step to
        flush the tail.  May run the escalation ladder, including
        ``sys.exit(NUMERIC_EXIT_CODE)``."""
        if self._pending_health is None:
            return
        step_i, host, event = self._pending_health
        self._pending_health = None
        if event is not None:
            event.synchronize()
        h = host.numpy().copy()
        self._sentinel.observe(step_i, int(h[0]), h[1:],
                               [p.name for p in self._params])
