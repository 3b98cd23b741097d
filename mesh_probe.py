#!/usr/bin/env python3
"""The device mesh over NCCL on four cards, one rank a card.

Four rank processes (``mxnet_tpu_torch.tools.launch``, NCCL, ``cuda:r``)
run chip_smoke.py's multi-rank legs at four ranks (:data:`LEGS`): the
collectives check; dp=4, tp=4, fsdp=4 (with the ZeRO bytes check) and
dp=2 × tp=2 on the flagship; ep=4 with MoE (8 experts); sp=4 and tp=4 on
the long-context configuration; the flagship's 4 blocks as a 4-stage
pipeline; and the kernel ring at [1, 8192, 16, 64] split four ways.  Each
leg is held to the single-rank step on the same weights (run on every
card, and timed: its second step is ``ref_ms`` beside the leg's ``ms``),
and every rank must launch the kernels its leg reaches with no plain
version.  One JSON line a leg, then the cards' name and power limit and
``{"ok": true, ...}``.  Run from the repository's root::

    python3 mesh_probe.py

Needs four CUDA cards; exits non-zero otherwise.
"""
import sys
import tempfile
import time

import chip_smoke as cs

LEGS = (
    ("dp4_flagship", cs.FLAGSHIP_TRAIN, 8, 1024, {"dp": 4}, False,
     cs._DENSE_KERNELS),
    ("tp4_flagship", cs.FLAGSHIP_TRAIN, 8, 1024, {"tp": 4}, False,
     cs._DENSE_KERNELS),
    ("fsdp4_flagship", cs.FLAGSHIP_TRAIN, 8, 1024, {"fsdp": 4}, True,
     cs._DENSE_KERNELS),
    ("dp2_tp2_flagship", cs.FLAGSHIP_TRAIN, 8, 1024, {"dp": 2, "tp": 2},
     False, cs._DENSE_KERNELS),
    ("ep4_flagship_moe", dict(cs.FLAGSHIP_TRAIN, use_moe=True, n_experts=8),
     8, 1024, {"ep": 4}, False, cs._DENSE_KERNELS),
    ("sp4_longctx", cs.LONGCTX, 1, 8192, {"sp": 4}, False,
     cs._DENSE_KERNELS),
    ("tp4_longctx", cs.LONGCTX, 1, 8192, {"tp": 4}, False,
     cs._DENSE_KERNELS + cs._FLASH_KERNELS),
)
RANKS = 4
TIMEOUT_S = 600


def worker(out_dir):
    """One rank (one card) of the probe."""
    cs.mesh_legs(out_dir, LEGS, RANKS)


def main():
    import torch

    from mxnet_tpu_torch.tools.launch import launch_local

    t0 = time.perf_counter()
    dev = cs.phase_device()
    cs._check(torch.cuda.device_count() >= RANKS,
              "mesh_probe needs %d cards, found %d"
              % (RANKS, torch.cuda.device_count()))
    cs.phase_build()
    out_dir = tempfile.mkdtemp(prefix="mesh_probe_")
    codes = launch_local(RANKS, [
        sys.executable, "-c",
        "import sys, mesh_probe; mesh_probe.worker(sys.argv[1])", out_dir],
        timeout=TIMEOUT_S)
    cs._check(codes == [0] * RANKS, "mesh_probe: the ranks exited %s"
              % codes)
    cs.read_mesh_legs(out_dir, RANKS, LEGS, dev)
    cs._emit({"phase": "total", "wall_s": time.perf_counter() - t0})
    print(dev["smi"])
    cs._emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
