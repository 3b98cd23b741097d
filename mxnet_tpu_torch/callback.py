"""Training callbacks: ``Speedometer``, ``log_train_metric``,
``do_checkpoint`` and ``module_checkpoint``.

Counterpart of those in ``mxnet_tpu/callback.py`` (reference
``python/mxnet/callback.py``); the log lines keep the reference's shapes
(``Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec``), which log parsers key
on.  The checkpoint callbacks number epochs from 1 in their file names,
as the reference does.
"""
from __future__ import annotations

import logging
import time

from .model import save_checkpoint

__all__ = ["Speedometer", "log_train_metric", "do_checkpoint",
           "module_checkpoint"]


def _every(period, fn):
    """Epoch-end callback calling ``fn(epoch number from 1, *rest)`` every
    ``period`` epochs."""
    period = max(1, int(period))

    def _callback(iter_no, *rest):
        epoch = iter_no + 1
        if epoch % period == 0:
            fn(epoch, *rest)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback: ``save_checkpoint(prefix, ...)`` every
    ``period`` epochs."""
    return _every(period,
                  lambda epoch, sym, arg, aux:
                      save_checkpoint(prefix, epoch, sym, arg, aux))


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback: ``mod.save_checkpoint`` (with the optimizer's
    states, if asked) every ``period`` epochs."""
    return _every(period,
                  lambda epoch, *rest:
                      mod.save_checkpoint(prefix, epoch,
                                          save_optimizer_states))


def log_train_metric(period, auto_reset=False):
    """Batch-end callback: log the training metric every ``period``
    batches (and reset it, with ``auto_reset``)."""

    def _callback(param):
        if param.nbatch % period or param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset:
            param.eval_metric.reset()
    return _callback


class Speedometer:
    """Batch-end callback: log samples per second (and the metric) every
    ``frequent`` batches.  The speed is measured from the clock and batch
    count of the last report, so it stays right at any call cadence; a
    batch count that goes back (a new epoch) re-arms it.  Each report reads
    the metric, which waits for the device."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._mark = None          # (clock, nbatch) at the last report

    def __call__(self, param):
        count = param.nbatch
        if self._mark is None or count < self._mark[1]:
            self._mark = (time.monotonic(), count)
            return
        if count - self._mark[1] < self.frequent:
            return
        metric = param.eval_metric
        readings = [] if metric is None else metric.get_name_value()
        now = time.monotonic()
        elapsed = now - self._mark[0]
        samples = (count - self._mark[1]) * self.batch_size
        speed = samples / elapsed if elapsed > 0 else float("inf")
        if readings and self.auto_reset:
            metric.reset()
        logging.info(
            "%s[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
            "Epoch" if metric is not None else "Iter", param.epoch, count,
            speed, "".join("\t%s=%f" % nv for nv in readings))
        self._mark = (now, count)
