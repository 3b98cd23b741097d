#!/usr/bin/env python3
"""Time the int8 matmul's wgmma kernel under several plans on one NVIDIA card.

``plan_int8_matmul`` (mxnet_tpu_torch/ops/kernels/int8_matmul.py) picks a
column tile and a split of K for the classifier heads' small M.  This
script asks what the choice costs: at VGG16's fc6 (M 128, K 25088, N 4096)
and ResNet-50's classifier (M 128, K 2048, N 1000) it times the int32 form
under each (column tile, splits) pair listed below, through the same
helpers as ``chip_smoke.py`` (a CUDA graph of calls on inputs cycled past
the L2), checks each result bit for bit against the plain version, and
splits the planned call's device time between its two kernels (the
product and the split-K sum) with ``torch.profiler``.

It prints one JSON line per plan and per profiled call.  Run from the root
of a checkout, with one card::

    python3 int8_plan_probe.py

It exits non-zero without a CUDA device.
"""
import importlib
import re

SHAPES = {
    # (M, K, N): [(column tile, splits), ...]
    (128, 25088, 4096): [(256, 8), (256, 4), (256, 16), (128, 8), (128, 4),
                         (64, 4), (64, 2)],
    (128, 2048, 1000): [(256, 8), (128, 8), (128, 4), (64, 8), (64, 4)],
}


def _profile(km, a, b):
    """Device microseconds per call of each kernel of the planned call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    km._int8_matmul_cuda(a, b)
    torch.cuda.synchronize()
    calls = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            km._int8_matmul_cuda(a, b)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            m = re.search(r"\w+_kernel<[^>]*>", e.key)
            name = m.group(0) if m else e.key[:60]
            out[name] = out.get(name, 0.0) + e.device_time_total / calls
    return out


def main():
    import torch
    import chip_smoke as cs

    km = importlib.import_module("mxnet_tpu_torch.ops.kernels.int8_matmul")
    dev = cs.phase_device()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (M, K, N), plans in SHAPES.items():
        a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        ref = km.int8_matmul_reference(a, b)
        args = cs._copies((a, b))
        k_tiles = -(-K // 128)
        for block_n, splits in plans:
            per = -(-k_tiles // splits)
            plan = km.Int8Plan("wgmma", 128, block_n, -(-k_tiles // per),
                               per)

            def run(a, b, plan=plan):
                return km._launch("wgmma", *km._operands(a, b, None, None),
                                  plan)

            cs._emit({"M": M, "K": K, "N": N, "plan": plan._asdict(),
                      "planned": plan == km.plan_int8_matmul(M, N, K, sms),
                      "bit_exact": bool(torch.equal(run(a, b), ref)),
                      "ms": cs._time_ms(run, args)})
        cs._emit({"M": M, "K": K, "N": N, "profile_us_per_call":
                  _profile(km, a, b)})
    print(dev["smi"])


if __name__ == "__main__":
    main()
