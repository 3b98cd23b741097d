#!/usr/bin/env python3
"""The ring plan of the wgmma_xwide flash backward, timed on one card.

``mxnet_tpu_torch/ops/kernels/csrc/flash_attention_bwd_wgmma_xwide.cu``
streams tiles of BT rows through STAGES ring slots, per padded head_dim
and kernel (its ``Plan``): one slot of 32 rows at 448 and 512, two slots
of 32 at 384 and for dQ at 320, one slot of 64 for dK/dV at 320.  This
script builds a copy whose plan gives every width two slots (of 16 rows
at 448 and 512) and a copy whose producer
copies only the first STAGES streamed tiles (the later tiles reuse them:
wrong results, the time of everything but those copies) in a temporary
directory (the port's own build is untouched), holds the built and the
two-slot kernels against the plain backward, and times the three in
turns (built, two slots, no copies, no copies, two slots, built) at the
bf16 shapes of chip_smoke.py's wgmma_xwide cases.  One JSON line per
shape and kernel, then the card's name and power limit.  Run from the
root of a checkout, with one card::

    python3 xwide_plan_probe.py

It exits non-zero without a CUDA device.
"""
import functools
import importlib
import json
import os
import statistics
import subprocess
import tempfile

SHAPES = (  # (B, T, H, D, causal)
    (1, 4096, 16, 512, True),
    (2, 8192, 2, 512, True),
    (1, 4096, 16, 448, True),
    (1, 4096, 16, 384, True),
    (1, 4096, 16, 320, True),
    (2, 1000, 4, 320, False),
)
SOURCE = "flash_attention_bwd_wgmma_xwide"


# the plan's lines, and the two-slot plan in their place
PLAN = ("  static constexpr int BT = D == 320 && KV ? 64 : 32;\n"
        "  static constexpr int STAGES = D == 384 || (D == 320 && !KV) ? 2 : 1;\n")
TWO_SLOTS = ("  static constexpr int BT = D >= 448 ? 16 : 32;\n"
             "  static constexpr int STAGES = 2;\n")
# the producer's per-tile expect; the no-copy copy skips every tile's
# copies after the first STAGES (the consumers still wait on the barrier)
EXPECT = "    mbar_expect_tx(full, bytes);\n"
NO_COPIES = ("    if (j >= STAGES) {\n      mbar_arrive(full);\n"
             "      continue;\n    }\n" + EXPECT)


def _library(fa, build, tmp, tag, edit):
    """The source as ``edit`` returns it, built into ``tmp`` and
    loaded."""
    import ctypes

    csrc = os.path.join(os.path.dirname(fa.__file__), "csrc")
    src = edit(open(os.path.join(csrc, SOURCE + ".cu")).read())
    path = os.path.join(tmp, "%s_%s.cu" % (SOURCE, tag))
    open(path, "w").write(src)
    so = path[:-3] + ".so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", so,
                    path], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    fa._configure_bwd_tc("mxt_flash_bwd_wgmma_xwide", lib)
    return lib


def _replaced(src, old, new):
    if src.count(old) != 1:
        raise SystemExit("xwide_plan_probe: the source's lines moved: %r"
                         % old)
    return src.replace(old, new)


def _run(torch, fa, build, smoke, tmp):
    built = build.load(SOURCE, functools.partial(
        fa._configure_bwd_tc, "mxt_flash_bwd_wgmma_xwide"))
    libs = {"built": built,
            "two_slots": _library(fa, build, tmp, "two_slots", lambda src:
                                  _replaced(src, PLAN, TWO_SLOTS)),
            "no_copies": _library(fa, build, tmp, "no_copies", lambda src:
                                  _replaced(src, EXPECT, NO_COPIES))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, T, H, D, causal in SHAPES:
        q, k, v, do = (torch.randn(B, T, H, D, generator=gen,
                                   device="cuda").bfloat16()
                       for _ in range(4))
        o, lse = fa._flash_cuda(q, k, v, causal)
        delta = fa._delta(o, do, None)
        want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, None,
                                                causal)
        scale = D ** -0.5
        launch = {"dq": fa._flash_dq_wgmma_xwide_cuda,
                  "dkv": fa._flash_dkv_wgmma_xwide_cuda}
        errs = {}
        for plan in ("built", "two_slots"):
            lib = libs[plan]
            build._LIBS[SOURCE] = lib
            dq = launch["dq"](q, k, v, do, lse, delta, causal, scale)
            dk, dv = launch["dkv"](q, k, v, do, lse, delta, causal, scale)
            torch.cuda.synchronize()
            e_dk, e_dv = (smoke._err(g, w, 1e-3, 2 ** -7)
                          for g, w in zip((dk, dv), want[1:]))
            errs[plan] = {
                "dq": smoke._err(dq, want[0], 1e-3, 2 ** -7),
                "dkv": (max(e_dk[0], e_dv[0]), e_dk[1] and e_dv[1])}
        del want
        args = smoke._copies((q, k, v, do, lse, delta))
        for kind, fn in launch.items():
            turns = {}
            for plan in ("built", "two_slots", "no_copies", "no_copies",
                         "two_slots", "built"):
                build._LIBS[SOURCE] = libs[plan]
                turns.setdefault(plan, []).append(smoke._time_ms(
                    lambda q, k, v, do, lse, delta, fn=fn: fn(
                        q, k, v, do, lse, delta, causal, scale), args))
            ms = {p: statistics.mean(t) for p, t in turns.items()}
            print(json.dumps({
                "kernel": kind, "shape": [B, T, H, D], "causal": causal,
                "dtype": "bfloat16", "ms_turns": turns, "ms": ms,
                "two_slots_over_built": ms["two_slots"] / ms["built"],
                "share_of_the_streamed_copies":
                    1 - ms["no_copies"] / ms["built"],
                "max_abs_err": {p: e[kind][0] for p, e in errs.items()},
                "ok": {p: e[kind][1] for p, e in errs.items()}}),
                  flush=True)
            if not all(e[kind][1] for e in errs.values()):
                raise SystemExit("xwide_plan_probe: a plan disagrees with "
                                 "the plain backward")
        build._LIBS[SOURCE] = built


def main():
    import torch

    from mxnet_tpu_torch.ops.kernels import _build
    fa = importlib.import_module(
        "mxnet_tpu_torch.ops.kernels.flash_attention")
    smoke = importlib.import_module("chip_smoke")

    if not torch.cuda.is_available():
        raise SystemExit("xwide_plan_probe: no CUDA device is available")
    with tempfile.TemporaryDirectory(prefix="xwide_plan_probe_") as tmp:
        _run(torch, fa, _build, smoke, tmp)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
