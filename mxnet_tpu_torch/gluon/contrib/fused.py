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

``donate`` is accepted (the update already runs in place).  ``devices``,
``bucket``, ``watchdog``, ``preemption``, ``numeric_guard`` and
``sentinel`` need ports of ``elastic``, ``sentinel`` and ``chaos`` and
raise ``NotImplementedError`` when set.  Capturing the step as a CUDA
graph is later work.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import autograd
from ...ndarray.ndarray import NDArray, array
from ...ops.registry import invoke_tap

__all__ = ["FusedTrainStep"]

_UNPORTED = ("devices", "bucket", "watchdog", "preemption", "numeric_guard",
             "sentinel")


class FusedTrainStep:
    """``step(x, y)``: one training step of ``net`` under ``loss_fn`` with
    ``trainer``'s optimizer (see the module docstring)."""

    def __init__(self, net, loss_fn, trainer, devices=None, donate=None,
                 bucket=None, watchdog=None, preemption=None,
                 numeric_guard=None, sentinel=None):
        given = dict(devices=devices, bucket=bucket, watchdog=watchdog,
                     preemption=preemption, numeric_guard=numeric_guard,
                     sentinel=sentinel)
        for name in _UNPORTED:
            if given[name] not in (None, False):
                raise NotImplementedError(
                    "mxnet_tpu_torch: FusedTrainStep(%s=...) needs elastic / "
                    "sentinel / chaos, which are not ported" % name)
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
        self._ready = False
        self.last_scalars = None

    def _tap(self, scalars):
        def tap(_opdef, params):
            if "lrs" in params:
                for lr, wd in zip(params["lrs"], params["wds"]):
                    scalars.extend((lr, params["rescale_grad"], wd))
            elif "lr" in params:
                scalars.extend((params["lr"], params["rescale_grad"],
                                params["wd"]))
        return tap

    def __call__(self, x, y):
        """Run one training step; returns the per-sample loss NDArray."""
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
        self._optimizer.rescale_grad = 1.0 / batch
        weights = [p.list_data()[0] for p in self._params]
        with autograd.record(train_mode=True):
            loss = self._loss_fn(self._net(x), y)
        grads = torch.autograd.grad(loss.data.sum(),
                                    [w.data for w in weights],
                                    allow_unused=True)
        grads = [NDArray(g if g is not None else torch.zeros_like(w.data))
                 for g, w in zip(grads, weights)]
        scalars = [float(batch), 1.0]
        with invoke_tap(self._tap(scalars)):
            self._updater(self._pidx, grads, weights)
        self.last_scalars = np.asarray(scalars, dtype=np.float32)
        return NDArray(loss.data.detach())
