"""Environment-variable configuration tier: the knobs of
``mxnet_tpu/config.py`` that the port reads through ``config``
(telemetry's peak rates and step costs, debug bundles, memory accounting,
the numerical-health guard and its rollback ring).

Each knob is declared once with a type, default and doc.  Names are the
JAX package's, so one launch script sets both packages.  The peak rates
the telemetry gauges divide by default to one NVIDIA H100 SXM's published
dense figures (989 TFLOP/s bf16, 3.35 TB/s HBM3), not to a TPU's.
"""
from __future__ import annotations

import os

__all__ = ["config", "Knob"]


class Knob:
    def __init__(self, name, typ, default, doc):
        self.name = name
        self.typ = typ
        self.default = default
        self.doc = doc

    @property
    def value(self):
        raw = os.environ.get(self.name)
        if raw is None:
            return self.default
        if self.typ is bool:
            return raw.strip().lower() not in ("0", "false", "no", "off",
                                               "f", "")
        return self.typ(raw)


class _Config:
    """Typed view over the MXNET_* / MXTPU_* env tier."""

    _KNOBS = [
        Knob("MXNET_NUMERIC_GUARD", str, "",
             "Numerical-health sentinel over the training hot path: a "
             "finiteness reduction over loss+gradients on the device "
             "rides FusedTrainStep / Trainer.step. 'warn' counts+warns "
             "but still applies the update; 'skip' keeps params, "
             "BatchNorm statistics and optimizer state bitwise unchanged "
             "across a non-finite step (selected on the device, no host "
             "round-trip); 'escalate' runs the ladder skip -> rescale -> "
             "rollback-k -> exit(77, retryable). '' disables."),
        Knob("MXNET_ROLLBACK_STEPS", int, 0,
             "Depth k of the bad-step rollback ring (host-RAM snapshots "
             "of params + optimizer state kept by the sentinel; a restore "
             "writes into the same tensors). 0 disables snapshotting; the "
             "escalation ladder then skips the rollback rung."),
        Knob("MXNET_TELEMETRY_COST", bool, True,
             "Count each training step's FLOPs and bytes from the shapes "
             "its first call sees (convolutions and products forward and "
             "backward; parameters, optimizer state and activations), so "
             "the live train.fused.mfu / hbm_gbs / hbm_util gauges are "
             "published with zero device syncs; set 0 to skip."),
        Knob("MXNET_TELEMETRY_PEAK_FLOPS", float, 989e12,
             "Accelerator peak FLOP/s the MFU gauges divide by. Default: "
             "one NVIDIA H100 SXM, dense bf16 (989 TFLOP/s, published "
             "figure at the 700 W limit)."),
        Knob("MXNET_TELEMETRY_PEAK_HBM_GBS", float, 3350.0,
             "Accelerator peak HBM bandwidth (GB/s) the hbm_util gauge "
             "divides by. Default: one NVIDIA H100 SXM, HBM3 "
             "(3.35 TB/s)."),
        Knob("MXTPU_DEBUG_BUNDLE_DIR", str, "",
             "Directory for postmortem debug bundles (registry snapshot, "
             "recent profiler events, recompile ring, dispatch stats, "
             "memory view, chaos plan). '' disables."),
        Knob("MXTPU_DEBUG_BUNDLE_KEEP", int, 20,
             "Newest-N bundles kept in MXTPU_DEBUG_BUNDLE_DIR."),
        Knob("MXTPU_DEBUG_BUNDLE_EVENTS", int, 500,
             "How many of the newest profiler ring events each bundle "
             "embeds."),
        Knob("MXTPU_MEM_ACCOUNTING", bool, True,
             "Tagged device-memory accounting (mxnet_tpu_torch.memory): "
             "per-device live/peak gauges from the CUDA caching "
             "allocator, per-subsystem tag providers. Set 0 to make "
             "update() a no-op."),
    ]

    def __init__(self):
        self._by_name = {k.name: k for k in self._KNOBS}

    def __getattr__(self, item):
        for prefix in ("MXNET_", "MXTPU_"):
            key = prefix + item.upper()
            if key in self._by_name:
                return self._by_name[key].value
        raise AttributeError(item)


config = _Config()
