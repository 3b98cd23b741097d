"""Learning-rate schedules.

The port's copy of ``mxnet_tpu/lr_scheduler.py``'s ``LRScheduler``,
``FactorScheduler`` and ``MultiFactorScheduler`` (reference
``python/mxnet/lr_scheduler.py``), with linear / constant warmup.

As in the JAX package, every schedule is a closed-form map ``num_update
-> lr`` rather than the reference's step-walking cursors: the optimizer
evaluates it afresh at every update, so probing the lr at any step changes
nothing, and each call reads the current ``base_lr``, which ``Optimizer``
sets to its ``learning_rate`` after construction.
"""
from __future__ import annotations

import bisect

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler"]


class LRScheduler:
    """Base class: warmup handling + the ``__call__(num_update) -> lr``
    contract.  Subclasses implement ``_decayed_lr(num_update)`` for the
    post-warmup regime."""

    _WARMUP_MODES = ("linear", "constant")

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        if warmup_steps < 0:
            raise ValueError("warmup_steps must be >= 0")
        if warmup_mode not in self._WARMUP_MODES:
            raise ValueError("warmup_mode must be one of %s"
                             % (self._WARMUP_MODES,))
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_mode = warmup_mode

    @property
    def warmup_final_lr(self):
        # tracks base_lr so Optimizer's post-construction
        # ``scheduler.base_lr = learning_rate`` also re-anchors the warmup
        # target — the ramp always lands exactly on the post-warmup lr
        # (the reference froze this at init, leaving a jump at warmup end)
        return self.base_lr

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        # validated at call time, against the CURRENT anchor — Optimizer
        # re-assigns base_lr after construction, so an init-time check
        # would test a value that may never be used
        if self.warmup_begin_lr > self.warmup_final_lr:
            raise ValueError("warmup must ramp UP: warmup_begin_lr (%s) "
                             "exceeds base_lr (%s)"
                             % (self.warmup_begin_lr, self.warmup_final_lr))
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        span = self.warmup_final_lr - self.warmup_begin_lr
        return self.warmup_begin_lr + span * (num_update
                                              / float(self.warmup_steps))

    def _decayed_lr(self, num_update):
        raise NotImplementedError(
            "%s must implement _decayed_lr" % type(self).__name__)

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self._decayed_lr(int(num_update))


class FactorScheduler(LRScheduler):
    """``lr = base_lr * factor ** k`` where ``k`` grows by one each
    ``step`` updates, floored at ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError("step must be >= 1")
        if factor > 1.0:
            raise ValueError("factor > 1 would grow the lr")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def _decayed_lr(self, num_update):
        # the k-th decay lands after update k*step (strictly greater, the
        # reference's boundary), so k = floor((t-1)/step) for t >= 1
        k = max(num_update - 1, 0) // self.step
        return max(self.base_lr * self.factor ** k, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """``lr *= factor`` once per milestone passed; milestones are a sorted
    list of update counts."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of milestones")
        if any(s < 1 for s in step):
            raise ValueError("milestones must be >= 1")
        if sorted(set(step)) != step:
            raise ValueError("milestones must be strictly increasing")
        if factor > 1.0:
            raise ValueError("factor > 1 would grow the lr")
        self.step = step
        self.factor = factor

    def _decayed_lr(self, num_update):
        # milestone m has fired once num_update > m; bisect counts them
        fired = bisect.bisect_left(self.step, num_update)
        return self.base_lr * self.factor ** fired
