#!/usr/bin/env python3
"""The ring plans of the wgmma_xwide flash kernels, timed on one card.

The backward,
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
bf16 shapes of chip_smoke.py's wgmma_xwide cases.

The forward, ``mxnet_tpu_torch/ops/kernels/csrc/
flash_attention_wgmma_xwide.cu``, streams key tiles of BK keys through ST
ring slots (its ``Plan``: two slots of 32 keys at 448 and 512, one slot of
64 at 320 and 384).  Its part builds a copy with the other plan at each
width (one slot of 64 keys at 448 and 512, three slots of 32 at 320 and
384), a copy whose warpgroups skip the exchange of their partial scores
(each softmax runs on its own half of S: wrong results, the time of
everything but the exchange) and a copy whose producer copies only the
first ST key tiles, holds the built and the other plan's copies against
the plain forward, and times the four in turns (built, other plan, no
exchange, no copies, no copies, no exchange, other plan, built) at the
bf16 shapes of chip_smoke.py's forward cases and at [1, 4096, 16, 448]
and [1, 4096, 16, 320].

The wgmma_xxwide forward (the same source's kernel in 2-CTA clusters that
split D, at 640-1024) is timed the same way against copies that skip its
exchanges: one whose warps skip meeting the peer CTA (each CTA's softmax
on its own half of the scores: wrong results, the time of everything but
the pair's exchange), one whose warpgroups skip their exchange inside a
CTA, and one whose producer copies only the first ST key tiles, in turns
(built, no peer, no exchange, no copies, and back) at chip_smoke.py's
[2, 1000, 4, 576] (run at 640) and [1, 4096, 16, 576], and at [1, 4096,
16, 1024]; it also prints the ptxas registers and spills of the
forward's eight instantiations.

The wgmma_xxwide backward (the backward source's dQ and dK/dV in 2-CTA
clusters that split D, at 640-1024) is timed the same way against a copy
whose warps skip meeting the peer CTA (each CTA's p and ds from its own
half of the scores: wrong results, the time of everything but the pair's
exchange) and one whose producer copies only the first STAGES streamed
tiles, in turns (built, no peer, no copies, and back) at chip_smoke.py's
[2, 1000, 4, 576] and [1, 4096, 16, 576] (run at 640) and the
head_dim-1024 leg's [4, 8192, 1, 1024], after holding the built kernels
against the plain backward; it also prints the ptxas registers and
spills of the backward's sixteen instantiations.

One JSON line per shape and kernel, then the card's name and power
limit.  Run from the root of a checkout, with one card::

    python3 xwide_plan_probe.py            # every part below, in order
    python3 xwide_plan_probe.py fwd        # wgmma_xwide's forward only
    python3 xwide_plan_probe.py xxwide     # wgmma_xxwide's forward only
    python3 xwide_plan_probe.py bwd        # wgmma_xwide's backward only
    python3 xwide_plan_probe.py xxbwd      # wgmma_xxwide's backward only

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
XXBWD_SHAPES = (  # (B, T, H, D, causal)
    (2, 1000, 4, 576, False),
    (1, 4096, 16, 576, True),
    (4, 8192, 1, 1024, True),
)


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


FWD_SHAPES = (  # (B, T, H, D, causal)
    (2, 8192, 2, 512, True),
    (1, 4096, 16, 512, True),
    (1, 4096, 16, 448, True),
    (1, 4096, 16, 384, True),
    (1, 4096, 16, 320, True),
    (2, 1000, 4, 320, False),
)
FWD_SOURCE = "flash_attention_wgmma_xwide"
FWD_PLAN = ("  static constexpr int BK = D >= 448 ? 32 : 64;\n"
            "  static constexpr int ST = D >= 448 ? 2 : 1;\n")
FWD_OTHER = ("  static constexpr int BK = D >= 448 ? 64 : 32;\n"
             "  static constexpr int ST = D >= 448 ? 1 : 3;\n")
# the exchange's first line; the no-exchange copy returns before it
EXCHANGE = "  if (wait_read) consumers_sync(2);\n"
NO_EXCHANGE = "  return;\n" + EXCHANGE
# the first line of the meeting with the peer CTA (wgmma_xxwide); the
# no-peer copy returns before it
PEER = "  const uint32_t peer = cluster_ctarank() ^ 1u;\n"
NO_PEER = "  return;\n" + PEER
XXWIDE_SHAPES = (  # (B, T, H, D, causal)
    (2, 1000, 4, 576, False),
    (1, 4096, 16, 576, True),
    (1, 4096, 16, 1024, True),
)
# the producer's K and V copies of a tile; the no-copy copy skips them
# after the first ST tiles (the consumers still wait on the barriers)
FWD_EXPECT_K = "    mbar_expect_tx(L::full_k(bars, s), L::kTileBytes);\n"
FWD_EXPECT_V = "    mbar_expect_tx(L::full_v(bars, s), L::kTileBytes);\n"


def _fwd_no_copies(src):
    for which, tile in (("k", "kt"), ("v", "vt")):
        expect = FWD_EXPECT_K if which == "k" else FWD_EXPECT_V
        src = _replaced(src, expect, "    if (j >= ST) mbar_arrive(L::full_%s("
                        "bars, s)); else\n  " % which + expect)
        loop = ("    for (int p = 0; p < D / PANEL; ++p)\n"
                "      tma_load(%s + " % tile)
        src = _replaced(src, loop, loop.replace(
            "p < D / PANEL", "p < (j >= ST ? 0 : D / PANEL)"))
    return src


def _library(fa, build, tmp, tag, edit, source=SOURCE,
             prefix="mxt_flash_bwd_wgmma_xwide", configure=None):
    """The source as ``edit`` returns it, built into ``tmp`` and loaded
    (the backward source's entry points declared for both its variants
    unless ``configure`` says otherwise)."""
    import ctypes

    csrc = os.path.join(os.path.dirname(fa.__file__), "csrc")
    src = edit(open(os.path.join(csrc, source + ".cu")).read())
    path = os.path.join(tmp, "%s_%s.cu" % (source, tag))
    open(path, "w").write(src)
    so = path[:-3] + ".so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", so,
                    path], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    if configure is None:
        fa._configure_bwd_source(source, lib)
    else:
        configure(prefix, lib)
    return lib


def _replaced(src, old, new):
    if src.count(old) != 1:
        raise SystemExit("xwide_plan_probe: the source's lines moved: %r"
                         % old)
    return src.replace(old, new)


def _run(torch, fa, build, smoke, tmp):
    built = build.load(SOURCE, functools.partial(fa._configure_bwd_source,
                                                 SOURCE))
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


# each forward variant's shapes, its edited copies (name -> edit) and the
# copies held against the plain forward beside the built kernel
FWD_PARTS = {
    "wgmma_xwide": (FWD_SHAPES, {
        "other_plan": lambda src: _replaced(src, FWD_PLAN, FWD_OTHER),
        "no_exchange": lambda src: _replaced(src, EXCHANGE, NO_EXCHANGE),
        "no_copies": _fwd_no_copies}, ("other_plan",)),
    "wgmma_xxwide": (XXWIDE_SHAPES, {
        "no_peer": lambda src: _replaced(src, PEER, NO_PEER),
        "no_exchange": lambda src: _replaced(src, EXCHANGE, NO_EXCHANGE),
        "no_copies": _fwd_no_copies}, ()),
}
SHARE = {"no_peer": "share_of_the_peer_exchange",
         "no_exchange": "share_of_the_exchange",
         "no_copies": "share_of_the_streamed_copies"}


def _run_fwd(torch, fa, build, smoke, tmp, variant):
    shapes, edits, checked = FWD_PARTS[variant]
    configure = functools.partial(fa._configure_fwd_source, FWD_SOURCE)
    built = build.load(FWD_SOURCE, configure)
    if variant == "wgmma_xxwide":      # its instantiations and xwide's
        log = build.build([FWD_SOURCE])[FWD_SOURCE]["log"]
        for kernel, line in smoke._ptxas_summary(log):
            print(json.dumps({"ptxas": line}), flush=True)
    libs = {"built": built}
    for tag, edit in edits.items():
        libs[tag] = _library(fa, build, tmp, tag, edit, FWD_SOURCE,
                             "mxt_flash_" + variant,
                             lambda prefix, lib: configure(lib))
    gen = torch.Generator(device="cuda").manual_seed(0)
    fn = getattr(fa, "_flash_%s_cuda" % variant)
    for B, T, H, D, causal in shapes:
        W = fa._kernel_width(variant, D)
        scale = D ** -0.5
        q, k, v = (torch.randn(B, T, H, D, generator=gen,
                               device="cuda").bfloat16() for _ in range(3))
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal,
                                                      return_lse=True)
        q, k, v = (fa._pad_d(t, W) for t in (q, k, v))
        errs = {}
        for plan in ("built",) + checked:
            build._LIBS[FWD_SOURCE] = libs[plan]
            o, lse = fn(q, k, v, causal, scale)
            torch.cuda.synchronize()
            e_o, e_l = (smoke._err(o[..., :D], o_ref, 1e-4, 2 ** -7),
                        smoke._err(lse, lse_ref, 1e-4, 1e-5))
            errs[plan] = (max(e_o[0], e_l[0]), e_o[1] and e_l[1])
        del o_ref, lse_ref, o, lse
        args = smoke._copies((q, k, v))
        order = tuple(libs)
        turns = {}
        for plan in order + order[::-1]:
            build._LIBS[FWD_SOURCE] = libs[plan]
            turns.setdefault(plan, []).append(smoke._time_ms(
                lambda q, k, v: fn(q, k, v, causal, scale), args))
        ms = {p: statistics.mean(t) for p, t in turns.items()}
        rec = {"kernel": "forward %s" % variant, "shape": [B, T, H, D],
               "padded_head_dim": W, "causal": causal, "dtype": "bfloat16",
               "ms_turns": turns, "ms": ms,
               "max_abs_err": {p: e[0] for p, e in errs.items()},
               "ok": {p: e[1] for p, e in errs.items()}}
        for plan in edits:
            if plan in SHARE:
                rec[SHARE[plan]] = 1 - ms[plan] / ms["built"]
            else:
                rec["%s_over_built" % plan] = ms[plan] / ms["built"]
        print(json.dumps(rec), flush=True)
        if not all(e[1] for e in errs.values()):
            raise SystemExit("xwide_plan_probe: a %s plan disagrees with "
                             "the plain forward" % variant)
    build._LIBS[FWD_SOURCE] = built


def _run_xxbwd(torch, fa, build, smoke, tmp):
    """The wgmma_xxwide backward: its instantiations' registers and
    spills, then per shape the built kernels held against the plain
    backward and timed in turns with the no-peer and no-copies copies."""
    built = build.load(SOURCE, functools.partial(fa._configure_bwd_source,
                                                 SOURCE))
    for kernel, line in smoke._ptxas_summary(
            build.build([SOURCE])[SOURCE]["log"]):
        print(json.dumps({"ptxas": line}), flush=True)
    libs = {"built": built,
            "no_peer": _library(fa, build, tmp, "no_peer", lambda src:
                                _replaced(src, PEER, NO_PEER)),
            "no_copies": _library(fa, build, tmp, "xx_no_copies", lambda src:
                                  _replaced(src, EXPECT, NO_COPIES))}
    launch = {"dq": fa._flash_dq_wgmma_xxwide_cuda,
              "dkv": fa._flash_dkv_wgmma_xxwide_cuda}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, T, H, D, causal in XXBWD_SHAPES:
        W = fa._kernel_width("wgmma_xxwide", D)
        scale = D ** -0.5
        q, k, v, do = (torch.randn(B, T, H, D, generator=gen,
                                   device="cuda").bfloat16()
                       for _ in range(4))
        o, lse = fa._flash_cuda(q, k, v, causal)
        delta = fa._delta(o, do, None)
        want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, None,
                                                causal)
        q, k, v, do = (fa._pad_d(t, W) for t in (q, k, v, do))
        build._LIBS[SOURCE] = built
        dq = launch["dq"](q, k, v, do, lse, delta, causal, scale)
        dk, dv = launch["dkv"](q, k, v, do, lse, delta, causal, scale)
        torch.cuda.synchronize()
        errs = {"dq": smoke._err(dq[..., :D], want[0], 1e-3, 2 ** -7)}
        e_dk, e_dv = (smoke._err(g[..., :D], w, 1e-3, 2 ** -7)
                      for g, w in zip((dk, dv), want[1:]))
        errs["dkv"] = (max(e_dk[0], e_dv[0]), e_dk[1] and e_dv[1])
        del want, dq, dk, dv, o
        args = smoke._copies((q, k, v, do, lse, delta))
        for kind, fn in launch.items():
            turns = {}
            for plan in ("built", "no_peer", "no_copies", "no_copies",
                         "no_peer", "built"):
                build._LIBS[SOURCE] = libs[plan]
                turns.setdefault(plan, []).append(smoke._time_ms(
                    lambda q, k, v, do, lse, delta, fn=fn: fn(
                        q, k, v, do, lse, delta, causal, scale), args))
            ms = {p: statistics.mean(t) for p, t in turns.items()}
            print(json.dumps({
                "kernel": "%s wgmma_xxwide" % kind, "shape": [B, T, H, D],
                "padded_head_dim": W, "causal": causal, "dtype": "bfloat16",
                "ms_turns": turns, "ms": ms,
                "share_of_the_peer_exchange":
                    1 - ms["no_peer"] / ms["built"],
                "share_of_the_streamed_copies":
                    1 - ms["no_copies"] / ms["built"],
                "max_abs_err": errs[kind][0], "ok": errs[kind][1]}),
                  flush=True)
            if not errs[kind][1]:
                raise SystemExit("xwide_plan_probe: the wgmma_xxwide %s "
                                 "disagrees with the plain backward" % kind)
        build._LIBS[SOURCE] = built


def main():
    import sys

    import torch

    from mxnet_tpu_torch.ops.kernels import _build
    fa = importlib.import_module(
        "mxnet_tpu_torch.ops.kernels.flash_attention")
    smoke = importlib.import_module("chip_smoke")

    if not torch.cuda.is_available():
        raise SystemExit("xwide_plan_probe: no CUDA device is available")
    parts = sys.argv[1:] or ["fwd", "xxwide", "bwd", "xxbwd"]
    with tempfile.TemporaryDirectory(prefix="xwide_plan_probe_") as tmp:
        if "fwd" in parts:
            _run_fwd(torch, fa, _build, smoke, tmp, "wgmma_xwide")
        if "xxwide" in parts:
            _run_fwd(torch, fa, _build, smoke, tmp, "wgmma_xxwide")
        if "bwd" in parts:
            _run(torch, fa, _build, smoke, tmp)
        if "xxbwd" in parts:
            _run_xxbwd(torch, fa, _build, smoke, tmp)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
