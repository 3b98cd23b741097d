"""Training callbacks: ``Speedometer`` and ``log_train_metric``.

Counterpart of those in ``mxnet_tpu/callback.py`` (reference
``python/mxnet/callback.py``); the log lines keep the reference's shapes
(``Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec``), which log parsers key
on.  ``do_checkpoint`` waits for ``.params`` serialization.
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "log_train_metric"]


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
