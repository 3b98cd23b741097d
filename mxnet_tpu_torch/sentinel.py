"""Numerical-health sentinel: detect, contain, and escalate bad steps.

Counterpart of ``mxnet_tpu/sentinel.py``:

* **Detection** — a finiteness reduction over the loss and every gradient
  on the device.  Inside :class:`~mxnet_tpu_torch.gluon.contrib.
  FusedTrainStep` it is one f32 ``|g|`` sum per gradient and one
  ``isfinite`` over the stacked scalars (the health vector, read one step
  late); for the eager ``Trainer.step`` path :func:`nonfinite_counts`
  counts each gradient's non-finite elements.  Per-parameter flags give
  attribution (which gradient went bad), not just a verdict.
* **Containment** — in ``skip`` mode a bad fused step leaves every
  parameter, BatchNorm statistic and optimizer-state buffer bitwise
  unchanged: the update ops select ``where(ok, new, old)`` on the device
  (``ops.optimizer_ops.update_guard``), so no step waits on the host.
* **Escalation** (``escalate`` mode) — a ladder driven by the
  consecutive-bad-step streak: skip-step → rescale
  (:class:`~mxnet_tpu_torch.optimizer.DynamicLossScaler` backoff) →
  rollback-k (:class:`RollbackRing`) → exit with the retryable
  :data:`~mxnet_tpu_torch.elastic.NUMERIC_EXIT_CODE`.
* **Divergence detection** — :class:`DivergenceDetector` checksums the
  parameters and compares the digest across replicas through a
  store-if-absent ``transport`` (:class:`LocalTransport` in one process).

Events land in ``profiler.dispatch_stats()`` (``nonfinite_steps``,
``rollbacks``, ``divergence_checks``), in the ``sentinel.loss_scale`` and
``sentinel.bad_streak`` telemetry gauges, and — one event per bad step —
in any active :class:`~mxnet_tpu_torch.monitor.Monitor`.

Enable with ``MXNET_NUMERIC_GUARD=warn|skip|escalate`` (or the
``numeric_guard=`` argument of FusedTrainStep / Trainer); the rollback
depth comes from ``MXNET_ROLLBACK_STEPS``.  Not ported: the async-KV
digest exchange (:class:`KVDivergenceTransport`, ROADMAP Queue 1 item 9)
and the checkpoint-restore rung (``checkpoint_manager=``, item 8), which
raise.
"""
from __future__ import annotations

import logging
import sys
import warnings
import zlib

import numpy as np
import torch

__all__ = ["HealthSentinel", "EscalationPolicy", "RollbackRing",
           "DivergenceDetector", "DivergenceError", "LocalTransport",
           "KVDivergenceTransport", "guard_mode", "nonfinite_counts",
           "params_digest", "replica_digests"]

_log = logging.getLogger(__name__)

GUARD_MODES = ("", "warn", "skip", "escalate")


def guard_mode(value=None):
    """Resolve + validate a guard mode: explicit argument wins, else the
    ``MXNET_NUMERIC_GUARD`` knob; ``False`` forces off."""
    if value is False:
        return ""
    if value is None:
        from .config import config

        value = config.numeric_guard
    value = str(value or "").strip().lower()
    if value == "off":
        value = ""
    if value not in GUARD_MODES:
        raise ValueError("MXNET_NUMERIC_GUARD=%r: expected one of "
                         "'', 'warn', 'skip', 'escalate'" % (value,))
    return value


def _tensor(a):
    return a.data if hasattr(a, "data") else a


_COUNTS_TRACKER = None


def nonfinite_counts(arrays):
    """Per-array count of non-finite elements as one int32 host vector
    (one device-to-host copy).  The first call at each (shapes, dtypes)
    signature counts as a ``recompile``, as the JAX package's jit does."""
    global _COUNTS_TRACKER
    from . import dispatch as _dispatch

    ts = [_tensor(a).detach() for a in arrays]
    if _COUNTS_TRACKER is None:
        _COUNTS_TRACKER = _dispatch.ShapeTracker("sentinel")
    _COUNTS_TRACKER.note(*ts)
    if not ts:
        return np.zeros(0, np.int32)
    with torch.no_grad():
        counts = torch.stack([(~torch.isfinite(t)).sum().to(torch.int32)
                              for t in ts])
    return counts.cpu().numpy()


# ---------------------------------------------------------------------------
# rollback ring
# ---------------------------------------------------------------------------
def _tree_snapshot(node):
    if node is None:
        return None
    if isinstance(node, (tuple, list)):
        return tuple(_tree_snapshot(x) for x in node)
    if isinstance(node, dict):
        return {k: _tree_snapshot(v) for k, v in node.items()}
    return _tensor(node).detach().to("cpu", copy=True)


def _tree_restore(node, snap):
    if node is None:
        return
    if isinstance(node, (tuple, list)):
        for x, s in zip(node, snap):
            _tree_restore(x, s)
        return
    if isinstance(node, dict):
        for k in node:
            _tree_restore(node[k], snap[k])
        return
    # written back into the SAME tensor: every handle on it stays valid
    with torch.no_grad():
        _tensor(node).copy_(snap)


class RollbackRing:
    """Bounded ring of the last-k training-state snapshots (host RAM).

    A snapshot is a device→host copy of every parameter (trainable and
    aux) plus the optimizer state tree; memory cost is ``k * (params +
    optimizer state)`` host bytes (``MXNET_ROLLBACK_STEPS``).
    ``restore()`` writes the newest snapshot back into the same tensors,
    then pops it — repeated restores walk further into the past."""

    def __init__(self, k, params=(), updaters=()):
        self.k = int(k)
        self._params = list(params)
        self._updaters = list(updaters)
        self._ring = []          # [(step, param_snaps, state_snaps)]

    def __len__(self):
        return len(self._ring)

    def steps(self):
        return [s for s, _, _ in self._ring]

    def snapshot(self, step):
        """Capture the current state; evicts the oldest past depth k."""
        if self.k <= 0:
            return
        psnap = [tuple(_tree_snapshot(a) for a in p.list_data())
                 for p in self._params]
        ssnap = [_tree_snapshot(u.states) for u in self._updaters]
        self._ring.append((int(step), psnap, ssnap))
        if len(self._ring) > self.k:
            self._ring.pop(0)

    def restore(self):
        """Write the newest snapshot back; returns its step.  Raises
        IndexError on an empty ring (the escalation ladder checks)."""
        step, psnap, ssnap = self._ring.pop()
        for p, snaps in zip(self._params, psnap):
            for arr, s in zip(p.list_data(), snaps):
                _tree_restore(arr, s)
        for u, s in zip(self._updaters, ssnap):
            _tree_restore(u.states, s)
        return step


# ---------------------------------------------------------------------------
# cross-replica divergence detection
# ---------------------------------------------------------------------------
class DivergenceError(RuntimeError):
    """Replicas disagree on the parameter checksum — one of them took a
    different update (SDC, lost message, non-determinism)."""


def _raw_bytes(arr):
    """The tensor's bytes as they lie in memory (bfloat16 as its 2-byte
    words, the bytes of the JAX package's ``ml_dtypes`` arrays)."""
    t = _tensor(arr).detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy().tobytes()


def params_digest(params):
    """Order-stable CRC32 digest over every parameter's bytes (slot 0)."""
    crc = 0
    for p in params:
        arr = p.list_data()[0] if hasattr(p, "list_data") else p
        crc = zlib.crc32(_raw_bytes(arr), crc)
    return crc & 0xFFFFFFFF


def replica_digests(nd):
    """CRC32 of each copy of a replicated array: one device, one copy."""
    return [zlib.crc32(_raw_bytes(nd)) & 0xFFFFFFFF]


class LocalTransport:
    """In-process store-if-absent digest board (tests, single host)."""

    def __init__(self):
        self._board = {}

    def publish(self, key, digest):
        return self._board.setdefault(key, int(digest))


class KVDivergenceTransport:
    """Digest exchange over the async-KV store: not ported."""

    def __init__(self, client):
        raise NotImplementedError(
            "mxnet_tpu_torch: KVDivergenceTransport needs the async-KV "
            "store, which is not ported (ROADMAP Queue 1 item 9)")


class DivergenceDetector:
    """Periodic param-checksum comparison across replicas.

    ``check(step, params)`` bumps ``divergence_checks`` and compares the
    local digest to the one agreed through ``transport`` (when given).
    Returns True on agreement; on mismatch warns and returns False
    (``raise_on_divergence=True`` raises :class:`DivergenceError`
    instead)."""

    def __init__(self, interval=100, transport=None, prefix="mxtpu:div",
                 raise_on_divergence=False):
        self.interval = max(1, int(interval))
        self.transport = transport
        self.prefix = prefix
        self.raise_on_divergence = raise_on_divergence

    def due(self, step):
        return step > 0 and step % self.interval == 0

    def check(self, step, params):
        from . import profiler as _prof

        _prof.dispatch_count("divergence_checks")
        for p in params:
            digests = replica_digests(p.list_data()[0]
                                      if hasattr(p, "list_data") else p)
            if len(set(digests)) > 1:
                return self._diverged(
                    step, "param %r copies disagree: %s"
                    % (getattr(p, "name", "?"),
                       ["%08x" % d for d in digests]))
        if self.transport is not None:
            mine = params_digest(params)
            agreed = self.transport.publish(
                "%s:%d" % (self.prefix, step), mine)
            if agreed != mine:
                return self._diverged(
                    step, "local digest %08x != agreed %08x"
                    % (mine, agreed))
        return True

    def _diverged(self, step, detail):
        msg = "replica divergence at step %d: %s" % (step, detail)
        if self.raise_on_divergence:
            raise DivergenceError(msg)
        _log.error(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
        return False


# ---------------------------------------------------------------------------
# escalation policy + sentinel
# ---------------------------------------------------------------------------
class EscalationPolicy:
    """How long each rung of the ladder holds, in consecutive bad steps:
    the first ``skip_steps`` bad steps are skipped, the next
    ``rescale_steps`` also back the loss scale off, then up to
    ``rollbacks`` ring restores, then ``sys.exit(NUMERIC_EXIT_CODE)``.
    Rungs whose mechanism is absent (no scaler / empty ring) are skipped.
    ``restore_checkpoint`` is kept for the JAX signature; with no
    checkpoint manager in the port that rung never fires."""

    def __init__(self, skip_steps=2, rescale_steps=2, rollbacks=1,
                 restore_checkpoint=True):
        self.skip_steps = int(skip_steps)
        self.rescale_steps = int(rescale_steps)
        self.rollbacks = int(rollbacks)
        self.restore_checkpoint = bool(restore_checkpoint)


class HealthSentinel:
    """Host side of the guard: consumes each step's health verdict, maintains
    the bad-step streak, and runs the escalation ladder.

    ``FusedTrainStep(..., numeric_guard=...)`` and ``Trainer(...,
    numeric_guard=...)`` build one from the knobs; construct one
    explicitly to attach a scaler, a divergence detector or a policy."""

    def __init__(self, trainer=None, mode=None, scaler=None,
                 rollback_steps=None, snapshot_interval=10,
                 policy=None, divergence=None, checkpoint_manager=None,
                 monitor=None):
        if checkpoint_manager is not None:
            raise NotImplementedError(
                "mxnet_tpu_torch: the sentinel's checkpoint-restore rung "
                "(checkpoint_manager=) needs elastic.CheckpointManager, "
                "which is not ported (ROADMAP Queue 1 item 8)")
        self.mode = guard_mode(mode)
        self.trainer = trainer
        self.scaler = scaler
        self.policy = policy or EscalationPolicy()
        self.divergence = divergence
        self.checkpoint_manager = None
        self.monitor = monitor
        self.snapshot_interval = max(1, int(snapshot_interval))
        if rollback_steps is None:
            from .config import config

            rollback_steps = config.rollback_steps
        params = list(trainer._params) if trainer is not None else []
        updaters = list(trainer._updaters) if trainer is not None else []
        self.ring = RollbackRing(rollback_steps, params, updaters)
        self._params = params
        self.bad_streak = 0
        self._rescales = 0
        self._rollbacks = 0
        self.last_action = "ok"
        self.events = []          # [(step, action, names)] bounded log
        self._max_events = 64

    @property
    def loss_scale(self):
        return self.scaler.loss_scale if self.scaler is not None else 1.0

    # -- verdict intake ---------------------------------------------------
    def observe(self, step, loss_nonfinite, grad_counts, param_names):
        """Digest one step's health vector.  Returns the action taken:
        'ok', 'warn', 'skip', 'rescale' or 'rollback' ('exit' never
        returns — it raises SystemExit)."""
        bad = bool(loss_nonfinite) or bool(np.any(np.asarray(grad_counts)))
        if not bad:
            self._good_step(step)
            self._publish_gauges()
            return "ok"
        names = [n for n, c in zip(param_names, grad_counts) if c]
        if loss_nonfinite:
            names = ["<loss>"] + names
        action = self._bad_step(step, names)
        self._publish_gauges()
        return action

    def _publish_gauges(self):
        """The current loss scale and bad-step streak as telemetry gauges
        (the counters flow through the ``dispatch.`` counters)."""
        from . import telemetry as _telemetry

        g = _telemetry.registry().gauge
        g("sentinel.loss_scale").set(self.loss_scale)
        g("sentinel.bad_streak").set(self.bad_streak)

    def _good_step(self, step):
        self.bad_streak = 0
        self._rescales = 0
        self._rollbacks = 0
        self.last_action = "ok"
        if self.scaler is not None:
            self.scaler.update(found_inf=False)
        if self.ring.k > 0 and step % self.snapshot_interval == 0:
            self.ring.snapshot(step)
        if self.divergence is not None and self.divergence.due(step):
            if not self.divergence.check(step, self._params):
                # a diverged replica is a bad step with unknown blast
                # radius: run the ladder from the rollback rung
                self.bad_streak = (self.policy.skip_steps
                                   + self.policy.rescale_steps)
                self._bad_step(step, ["<divergence>"])

    def _bad_step(self, step, names):
        from . import monitor as _monitor
        from . import profiler as _prof

        _prof.dispatch_count("nonfinite_steps")
        self.bad_streak += 1
        _monitor.notify_nonfinite(step, names, monitor=self.monitor)
        action = self._pick_action()
        self._apply_action(action, step, names)
        self.last_action = action
        self.events.append((int(step), action, tuple(names)))
        del self.events[:-self._max_events]
        return action

    def _pick_action(self):
        if self.mode == "warn":
            return "warn"
        if self.mode == "skip":
            return "skip"
        p = self.policy
        if self.bad_streak <= p.skip_steps:
            return "skip"
        if (self.scaler is not None and self._rescales < p.rescale_steps
                and self.scaler.can_backoff()):
            return "rescale"
        if len(self.ring) and self._rollbacks < p.rollbacks:
            return "rollback"
        return "exit"

    def _apply_action(self, action, step, names):
        from . import profiler as _prof
        from .elastic import NUMERIC_EXIT_CODE

        what = "step %d non-finite (%s)" % (step, ", ".join(names) or "?")
        if action == "warn":
            warnings.warn(
                what + " — update APPLIED (MXNET_NUMERIC_GUARD=warn)",
                RuntimeWarning, stacklevel=4)
        elif action == "skip":
            _log.warning("%s — update skipped on device (streak %d)",
                         what, self.bad_streak)
        elif action == "rescale":
            self._rescales += 1
            self.scaler.backoff()
            _log.warning("%s — skipped + loss scale backed off to %g",
                         what, self.scaler.loss_scale)
        elif action == "rollback":
            self._rollbacks += 1
            restored = self.ring.restore()
            _prof.dispatch_count("rollbacks")
            _log.error("%s — rolled back to the step-%d snapshot",
                       what, restored)
        else:
            _log.critical("%s — escalation exhausted; exiting rc=%d "
                          "(retryable)", what, NUMERIC_EXIT_CODE)
            self._debug_bundle("sentinel_rc77", what, step)
            sys.exit(NUMERIC_EXIT_CODE)

    def _debug_bundle(self, reason, what, step):
        """Postmortem capture before the ladder's terminal rung; never
        blocks the exit path on its own failure."""
        from . import debug

        debug.write_bundle(reason, extra={
            "what": what, "step": step, "bad_streak": self.bad_streak,
            "rescales": self._rescales, "rollbacks": self._rollbacks,
            "events": list(self.events)})
