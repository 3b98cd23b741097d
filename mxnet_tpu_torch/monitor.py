"""Monitor: per-op output statistics during training (reference:
``python/mxnet/monitor.py:33`` — taps every executor-internal tensor via
``monitor_callback`` and prints a stat per matching tensor).

Counterpart of ``mxnet_tpu/monitor.py``.  The port's Executor already runs
the graph node by node, so ``install`` only sets its monitor callback:
each node's outputs reach :meth:`Monitor._tap` as tensors, copied to the
host (a device sync per tapped node while the monitor is active).
"""
from __future__ import annotations

import logging
import re

import numpy as np
import torch

__all__ = ["Monitor", "notify_nonfinite"]

# monitors that asked to receive sentinel events (Monitor.install adds)
_installed = []


def _host(o):
    """A tapped output as numpy (bfloat16 widened to float32, exact)."""
    if isinstance(o, torch.Tensor):
        t = o.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(o)


def notify_nonfinite(step, names, monitor=None):
    """Sentinel → monitor bridge: report ONE deduplicated event per bad
    step (not one per array — the sentinel already aggregated the
    per-parameter non-finite counts) carrying the step index and the
    offending parameter names.  Delivered to ``monitor`` if given, else
    to every installed :class:`Monitor`; always logged."""
    targets = [monitor] if monitor is not None else list(_installed)
    for m in targets:
        m.notify_nonfinite(step, names)
    if not targets:
        logging.getLogger(__name__).warning(
            "non-finite step %d (%s)", step, ", ".join(names) or "?")


class Monitor:
    """Collect statistics of internal tensors every ``interval`` batches.

    Parameters (reference parity): ``interval``, ``stat_func`` (numpy
    array -> scalar/array stat; default mean absolute value), ``pattern``
    (regex over tensor names), ``sort`` (sort results by name).
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def stat_func(x):
                return np.abs(x).mean()
        self.interval = interval
        self.stat_func = stat_func
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.queue = []
        self.step = 0
        self.activated = False
        self._exes = []
        self.nonfinite_events = []   # [(step, names)] — deduped, bounded
        self._nonfinite_steps_seen = set()
        if self not in _installed:
            _installed.append(self)

    # -- executor hookup -------------------------------------------------
    def install(self, exe):
        """Attach to an executor (reference: Monitor.install)."""
        exe.set_monitor_callback(self._tap)
        self._exes.append(exe)

    def _tap(self, name, outputs):
        if not self.activated:
            return
        for i, o in enumerate(outputs):
            full = name if len(outputs) == 1 else "%s_output%d" % (name, i)
            if self.re_pattern.match(full):
                host = _host(o)
                self.queue.append((self.step, full, self.stat_func(host)))
                # nonfinite taps are deduped against the sentinel: the
                # sentinel reports the whole step once via
                # notify_nonfinite, so _tap never re-reports arrays from
                # a step that already has an event
                if (self.step not in self._nonfinite_steps_seen
                        and host.dtype.kind == "f"
                        and not np.isfinite(host).all()):
                    self.notify_nonfinite(self.step, [full])

    # -- sentinel events --------------------------------------------------
    def notify_nonfinite(self, step, names):
        """One event per bad step, whoever reports first (sentinel wins
        on the fused path — it runs before any eager tap); duplicates
        for an already-seen step are dropped."""
        step = int(step)
        if step in self._nonfinite_steps_seen:
            return
        self._nonfinite_steps_seen.add(step)
        self.nonfinite_events.append((step, tuple(names)))
        del self.nonfinite_events[:-256]
        logging.getLogger(__name__).warning(
            "Batch: %7d non-finite values in: %s",
            step, ", ".join(names) or "?")

    # -- batch lifecycle (reference tic/toc/toc_print) -------------------
    def tic(self):
        """Start collecting for this batch if the interval hits."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Stop collecting; return [(step, name, stat)] (reference :97)."""
        if not self.activated:
            return []
        self.activated = False
        res = list(self.queue)
        self.queue = []
        if self.sort:
            res.sort(key=lambda x: x[1])
        return res

    def toc_print(self):
        for step, name, stat in self.toc():
            logging.getLogger(__name__).info(
                "Batch: %7d %30s %s", step, name, stat)
