#!/usr/bin/env python3
"""Probe chip_smoke.py's module_train gate on one NVIDIA card.

The gate takes one ``forward_backward`` and ``update`` of ResNet-50 at
batch ``MODULE_CHECK_BATCH`` on the card and on the CPU, at the parameters
that the phase's 8-step ``Module.fit`` leaves, in float64 and in f32
(``chip_smoke._module_gate``).  This script asks what that comparison
measures, at several such states: it runs the phase ``--fits`` times (the
fit on the card is not bitwise repeatable, so each leaves another state),
recording a failed gate instead of raising, and takes the gate's
comparison once more at the seeded initialization that the fit starts
from.  At each state it adds the card's f32 step with cuDNN turned off
(PyTorch's own CUDA convolutions) against the CPU's float64 step: is the
card's f32 error cuDNN's?

It prints one JSON line per state, with the gate's report.  Run from the
root of a checkout, with one card::

    python3 module_gate_probe.py [--fits N]

It exits non-zero without a CUDA device.
"""
import json
import sys


def _cudnn_off_error(cs, mx, net, args, auxs, images, labels):
    """The card's f32 gradients with cuDNN off against the CPU's float64
    ones: ``[joint, (worst tensor, error)]``."""
    import torch

    x = images[:cs.MODULE_CHECK_BATCH]
    y = labels[:cs.MODULE_CHECK_BATCH]
    with torch.backends.cudnn.flags(enabled=False):
        got = cs._module_step(mx, net, mx.gpu(0), args, auxs, x, y)[0]
    want = cs._module_step(mx, net, mx.cpu(), args, auxs, x, y, "float64")[0]
    _, rep = cs._compare_tensors(got, want, cs.MODULE_CHECK_REL)
    return [rep["joint_rel_l2"], rep["worst"]]


def main(argv):
    import torch

    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models.resnet_symbol import get_symbol

    if not torch.cuda.is_available():
        raise SystemExit("module_gate_probe: no CUDA device is available")
    fits = int(argv[argv.index("--fits") + 1]) if "--fits" in argv else 3
    dev = {"name": torch.cuda.get_device_name(0), "smi": ""}
    net = get_symbol(**cs.INT8_NET)
    gate = cs._module_gate
    seen = {}

    def recording_gate(mx_, net_, args, auxs, images, labels):
        seen.update(args=args, auxs=auxs, images=images, labels=labels)
        return gate(mx_, net_, args, auxs, images, labels)

    cs._module_gate, cs._check = recording_gate, lambda cond, msg: None
    for fit in range(fits):
        cs.phase_module_train(dev)
        ok, report = gate(mx, net, seen["args"], seen["auxs"],
                          seen["images"], seen["labels"])
        print(json.dumps({
            "state": "fit %d" % fit, "device": dev["name"], "ok": ok,
            "report": report, "card_f32_cudnn_off_vs_float64":
                _cudnn_off_error(cs, mx, net, seen["args"], seen["auxs"],
                                 seen["images"], seen["labels"])}),
              flush=True)
    # the seeded initialization the phase's fit starts from
    mx.random.seed(0)
    shape = tuple(int(v) for v in cs.INT8_NET["image_shape"].split(","))
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (cs.MODULE_BATCH,) + shape)],
             label_shapes=[("softmax_label", (cs.MODULE_BATCH,))])
    mod.init_params(initializer=mx.init.Uniform(0.01))
    a0, b0 = mod.get_params()
    a0 = {n: v.asnumpy() for n, v in a0.items()}
    b0 = {n: v.asnumpy() for n, v in b0.items()}
    ok, report = gate(mx, net, a0, b0, seen["images"], seen["labels"])
    print(json.dumps({
        "state": "initial", "device": dev["name"], "ok": ok,
        "report": report, "card_f32_cudnn_off_vs_float64": _cudnn_off_error(
            cs, mx, net, a0, b0, seen["images"], seen["labels"])}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
