"""Dynamic loss scaling (the reference's ``contrib.amp`` LossScaler:
``python/mxnet/amp/loss_scaler.py`` grow/backoff automaton); counterpart
of ``mxnet_tpu/optimizer/loss_scaler.py``.

The scale multiplies the loss inside the fused train step and its
reciprocal is folded into ``rescale_grad`` on the host — the applied
update is mathematically identical to unscaled training whenever the
gradients stay finite, while small bf16/fp16 gradients are lifted out of
the flush-to-zero band.

The automaton is the standard one: a non-finite step multiplies the
scale by ``backoff_factor`` (the step itself is skipped by the sentinel);
``growth_interval`` consecutive finite steps multiply it by
``growth_factor``.
"""
from __future__ import annotations

__all__ = ["DynamicLossScaler"]


class DynamicLossScaler:
    """Grow/backoff loss-scale automaton.

    Parameters mirror the reference AMP defaults: ``init_scale`` 2**16,
    halve on overflow, double every ``growth_interval`` clean steps,
    clamped to [``min_scale``, ``max_scale``].  ``init_scale=1.0`` makes
    the scaler a no-op until the first overflow (the mode the sentinel
    uses when the user did not opt into mixed-precision scaling).
    """

    def __init__(self, init_scale=2.0 ** 16, growth_factor=2.0,
                 backoff_factor=0.5, growth_interval=2000,
                 min_scale=1.0, max_scale=2.0 ** 24):
        if not (0.0 < backoff_factor < 1.0):
            raise ValueError("backoff_factor must be in (0, 1)")
        if growth_factor <= 1.0:
            raise ValueError("growth_factor must be > 1")
        self.loss_scale = float(init_scale)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)
        self._unskipped = 0

    def update(self, found_inf):
        """Advance the automaton one step; returns the scale to use for
        the NEXT step.  ``found_inf`` is this step's sentinel verdict."""
        if found_inf:
            return self.backoff()
        self._unskipped += 1
        if self._unskipped >= self.growth_interval:
            self._unskipped = 0
            self.loss_scale = min(self.max_scale,
                                  self.loss_scale * self.growth_factor)
        return self.loss_scale

    def backoff(self):
        """Overflow response: shrink the scale, restart the growth
        clock.  Idempotent at ``min_scale`` (returns False from
        :meth:`can_backoff` there so the escalation ladder advances)."""
        self._unskipped = 0
        self.loss_scale = max(self.min_scale,
                              self.loss_scale * self.backoff_factor)
        return self.loss_scale

    def can_backoff(self):
        return self.loss_scale > self.min_scale

    # -- checkpointing ----------------------------------------------------
    def state_dict(self):
        return {"loss_scale": self.loss_scale,
                "unskipped": self._unskipped}

    def load_state_dict(self, state):
        self.loss_scale = float(state["loss_scale"])
        self._unskipped = int(state["unskipped"])

    def __repr__(self):
        return ("DynamicLossScaler(scale=%g, unskipped=%d)"
                % (self.loss_scale, self._unskipped))
