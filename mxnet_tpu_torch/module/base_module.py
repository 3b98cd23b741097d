"""BaseModule: the high-level train / evaluate interface.

Counterpart of ``mxnet_tpu/module/base_module.py`` (reference
``python/mxnet/module/base_module.py``): ``fit`` is the symbolic training
loop — per batch ``forward_backward``, ``update``, ``update_metric`` and
the batch-end callbacks — and ``score`` / ``predict`` evaluate.
"""
from __future__ import annotations

import logging
import time

import numpy as np

from .. import metric as _metric
from .. import ndarray as nd
from ..io.io import DataBatch

__all__ = ["BaseModule", "BatchEndParam"]


class BatchEndParam:
    """What a batch-end callback receives."""

    def __init__(self, epoch, nbatch, eval_metric, locals):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    def forward_backward(self, data_batch):
        """A forward and a backward on one batch."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Evaluate ``eval_metric`` over a DataIter; its name-value
        pairs."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("score needs a bound, initialized module")
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                for cb in _as_list(batch_end_callback):
                    cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                     eval_metric=eval_metric, locals=None))
            actual_num_batch += 1
        if score_end_callback:
            for cb in _as_list(score_end_callback):
                cb(BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                 eval_metric=eval_metric, locals=None))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs of forwards over a DataIter (the padding of the last
        batch dropped), or of one forward on an array."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("predict needs a bound, initialized module")
        if isinstance(eval_data, (nd.NDArray, np.ndarray)):
            if isinstance(eval_data, np.ndarray):
                eval_data = nd.array(eval_data, ctx=self._context)
            self.forward(DataBatch([eval_data]), is_train=False)
            return self.get_outputs()[0]
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            output_list.append([out[0:out.shape[0] - pad]
                                for out in self.get_outputs()])
        if not output_list:
            return output_list
        if merge_batches:
            merged = [nd.concat(*[o[i] for o in output_list], dim=0)
                      for i in range(len(output_list[0]))]
            if len(merged) == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None):
        """The training loop (reference base_module.py:409).  The default
        initializer is ``Uniform(0.01)``; ``kvstore`` is accepted and
        ignored (one device)."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        from ..initializer import Uniform

        initializer = initializer or Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            end_of_batch = False
            data_iter = iter(train_data)
            next_data_batch = next(data_iter)
            while not end_of_batch:
                data_batch = next_data_batch
                self.forward_backward(data_batch)
                self.update()
                try:
                    next_data_batch = next(data_iter)
                except StopIteration:
                    end_of_batch = True
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    for cb in _as_list(batch_end_callback):
                        cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                         eval_metric=eval_metric,
                                         locals=locals()))
                nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                arg_params, aux_params = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_params, aux_params)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()
