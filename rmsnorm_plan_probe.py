#!/usr/bin/env python3
"""Time the RMSNorm kernel's plans on one NVIDIA card.

At each of the main paths' bf16 shapes (``chip_smoke.RMSNORM_SHAPES``) and
the two f32 ones, this script times the plan ``plan_rmsnorm`` takes, the
``warp`` variant under other persistent grids (1 to 4 CTAs per SM, and
one CTA per group of rows with no persistence), the ``block`` variant,
and a copy of x (the same bytes through the same timing: the rate the card
reaches for them), all in turns in one process: each plan twice, in the
order p1, p2, ..., pn, pn, ..., p1.  Each plan's output is held to the
plain version first.  Timing as ``chip_smoke.py`` times kernels: a CUDA
graph of calls on inputs cycled past the 50 MB L2.

It prints one JSON line per shape, then the card's name and power limit.
Run from the root of a checkout, with one card::

    python3 rmsnorm_plan_probe.py

It exits non-zero without a CUDA device.
"""
import json
import statistics
import subprocess
import sys


def _plans(layers, n, E, dtype, sms):
    """``{label: plan}``: the planned one, warp under other grids, and
    block."""
    chunks = E * layers._ITEMSIZE[dtype] // 16
    planned = layers.plan_rmsnorm(n, E, dtype, E, 16, sms)
    out = {"planned (%s)" % planned.variant: planned}
    warp = layers._warp_plan(n, chunks, sms)
    if warp is not None:
        for per_sm in (1, 2, 3, 4):
            grid = min(-(-n // warp.rows_per_cta), per_sm * sms)
            out["warp %d/SM" % per_sm] = warp._replace(grid=grid)
        out["warp no persistence"] = warp._replace(
            grid=-(-n // warp.rows_per_cta))
    block = layers._block_plan(n, chunks)
    if block is not None:
        out["block"] = block
    return out


def main():
    import torch

    import chip_smoke as cs
    from mxnet_tpu_torch.ops.kernels import common, layers

    if not torch.cuda.is_available():
        raise SystemExit("rmsnorm_plan_probe: no CUDA device is available")
    sms = common.sm_count(torch.device("cuda", 0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = ([(s, torch.bfloat16) for s in cs.RMSNORM_SHAPES]
             + [(s, torch.float32) for s in cs.RMSNORM_F32_SHAPES])
    for (n, E), dt in cases:
        x = torch.randn((n, E), generator=gen, device="cuda").to(dt)
        scale = (1 + 0.1 * torch.randn(E, generator=gen,
                                       device="cuda")).to(dt)
        ref = layers.fused_rmsnorm_reference(x, scale)
        plans = _plans(layers, n, E, dt, sms)

        def run(x, s, plan):
            x2, s2, out = layers._rmsnorm_operands(x, s)
            return layers._rmsnorm_launch(x2, s2, out, 1e-6, plan)

        tol = (1e-5, 1e-5) if dt == torch.float32 else (1e-6, 2 ** -6)
        for label, plan in plans.items():
            _, ok = cs._err(run(x, scale, plan), ref, *tol)
            cs._check(ok, "%s at %s disagrees with the plain version"
                      % (label, (n, E)))
        args = cs._copies((x, scale))
        fns = {label: (lambda x, s, plan=plan: run(x, s, plan))
               for label, plan in plans.items()}
        fns["copy"] = lambda x, s: torch.empty_like(x).copy_(x)
        order = list(fns)
        turns = {}
        for label in order + order[::-1]:
            turns.setdefault(label, []).append(cs._time_ms(fns[label], args))
        bound, _ = cs._bound(4.0 * n * E, (2 * n * E + E) * x.element_size(),
                             str(dt).split(".")[1])
        print(json.dumps({
            "shape": [n, E], "dtype": str(dt).split(".")[1],
            "bound_ms": bound,
            "plans": {k: list(p) for k, p in plans.items()},
            "ms": {k: statistics.mean(t) for k, t in turns.items()},
            "ms_turns": turns}), flush=True)
        del x, scale, ref, args
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
