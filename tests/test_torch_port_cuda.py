"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test here is marked ``cuda`` and skips without a card.

This file imports neither ``jax`` nor ``mxnet_tpu`` (the card's machine has
no JAX), so it runs there without the repository's conftest::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py

Tolerances: f32 within 2e-5 (the same f32 arithmetic in another summation
order; ``rsqrtf`` and ``expf`` within 2 ulp).  bf16 outputs may round to
the neighbouring bf16 value (2^-8 relative): 2^-7 relative after one
rounding, 2^-6 after RMSNorm's two.  ``lse`` is f32 in both.  The flash
gradients sum over every key (dQ) or query (dK, dV) in f32, in another
order than the dense plain version: f32 within 1e-4 relative and 1e-4
absolute; bf16 after their one rounding, 2^-7 relative and 1e-3 absolute.
The tensor-core (wgmma) backward is also held against autograd through the
dense forward, an independent formula, within 2^-6 of each gradient's
largest entry (in bf16 that formula takes delta from the unrounded O).
The int8 matmul, both forms and both variants (wgmma with its split-K, and
mma), is bit-exact against its plain version (an exact int32 sum in any
order; one rounding to f32 and one f32 product in the dequant).  Each
RMSNorm variant (warp, block, simt), planned and forced, is held to its
plain version at those tolerances at the main paths' shapes and at the
edges (odd E, offset views, strided rows, 1-8 rows, 128 KB rows), two
calls bit-identical, with 0 ptxas spills in every instantiation.  Head dims
above 512 take the flash kernels' wide variant in f32, above 1024 in
bf16, held to the plain versions at the padded cases' tolerances.  bf16 at
head_dim 129-256 takes the tensor-core ``wgmma_wide`` kernels, forward and
backward, held as the wgmma ones are (plain version, dense autograd for
the backward, kv_len, fused-qkv views, a strided dO, misaligned inputs,
two calls bit-identical), and a TransformerLM with head_dim 256 prefills
through them as through the plain versions.  bf16 at head_dim 257-512
takes the tensor-core ``wgmma_xwide`` kernels, forward and backward, held
the same way (the backward against dense autograd within 6.5e-3 of each
gradient's largest entry).  The f32 backward at
head_dim 129-256 takes the tensor-core ``tf32x3`` dQ and dK/dV
(split-TF32 products), held at the f32 gradient tolerances to the plain
backward and within 1e-4 of each gradient's largest entry to dense
autograd, with the same views, refusals and repeat checks; at head_dim
257-512 the f32 backward takes the tensor-core ``tf32x3_xwide`` dQ and
dK/dV (the tf32x3 kernels in 2-CTA clusters that split D), held the same
way; at head_dim 33-128 (run at 64 or 128) the f32 backward takes
tf32x3's narrow dQ and dK/dV (each warp 16 rows over all of D), held the
same way, with ``kv_len`` (the backward over the first kv_len keys), keys
no query sees, fused-qkv views, a strided dO, refusals, the autograd
counters at head_dim 64, float64 autograd and the ptxas report of every
tf32x3 backward instantiation, and the f32 forward there takes tf32x3's
narrow forward, held to the plain version at the f32 forward gates at
head_dim 40, 64, 96 and 128, causal and not, with ``kv_len`` below Tk,
two calls bit for bit; and so does the
f32 forward there (``tf32x3_xwide``: the tf32x3
forward in 2-CTA clusters), held as the tf32x3 forward is; the bf16
forward at head_dim 513-1024 takes ``wgmma_xxwide`` (the wgmma_xwide
forward in 2-CTA clusters), held as the wgmma_xwide forward is, and so
does the bf16 backward there (the wgmma_xwide dQ and dK/dV in 2-CTA
clusters), held as the wgmma_xwide backward is, at head_dim 576-1024,
with one head among the cases.  The f32
forward at head_dim 33-256 takes the tensor-core ``tf32x3`` forward (split-TF32
products for S and P·V), held to the plain version at the f32 forward
gates (o within 1e-5 + 1e-4·|o|, lse within 1e-4 + 1e-5·|lse|: the
kernels' gates on the card), with ``kv_len``, fused-qkv views,
refusals, two calls bit-identical, and forward and backward through
``flash_attention`` against dense autograd in float64.

``mx.rtc``: tests/test_rtc.py's kernels written in CUDA and the
reference's templated ``axpy`` (compiled with ``--fmad=false``) equal the
torch expressions exactly; the user op ``rtc_softmax`` (chip_smoke.py's
user code) against the example's ``numpy_softmax``, forward and backward,
within 1e-5 relative and 1e-7 absolute (``expf`` and numpy's ``exp`` within
2 ulp, the row sum in another order).  One ResNet-20 Module step on the
card against the CPU: every gradient, moving statistic and update within
1e-3 relative L2, as chip_smoke.py's ResNet-50 gate holds them.

Gluon: one step (record, backward, Trainer.step) of resnet18_v1
thumbnail at batch 4, hybridized against imperative on the card (f32,
within 1e-5 relative L2) and in float64 on the card against the CPU
(within 1e-8), as chip_smoke.py's gluon_step_card_vs_cpu gate holds them;
FusedTrainStep against record / backward / Trainer.step on the card, f32
and bf16 with multi_precision; the Gluon entry points on ``gpu(0)`` by
default.  Without a card they refuse to start unless given ``ctx=cpu()``
(``test_torch_port_isolation.py``).

Inference, serving and numerical health: ``benchmark.compiled_loop``'s
CUDA graph of chained forwards equals the eager chain bit for bit (f32
and bf16), a draw is one replay and the probe leaves the input alone; a
finite ``FusedTrainStep(numeric_guard="skip")`` step equals the unguarded
one bit for bit and a ``nan_grad`` step leaves every parameter, BatchNorm
statistic and optimizer-state buffer unchanged (cuDNN deterministic);
``serving.ModelServer`` answers the bare Predictor's bits.

The fused RNN op: cuDNN (``ops.rnn.rnn_cudnn``) against the plain time
loop (``rnn_reference``) for lstm, gru, rnn_tanh and rnn_relu at 1 layer
and at 2 bidirectional ones, f32 (TF32 off) and float64, outputs and the
gradients of the data, the packed parameters and the states; dropout
between layers only, one cuDNN call a layer; no plain path for bf16 on
the card; word_lm.py's graph at a small width, one float64 ``Module`` step
on the card against the CPU within 1e-8, with cuDNN's RNN node in its
backward.

Export and checkpoints: a narrow VGG11 exported, quantized
(``quantize_model``) and imported as an int8 ``SymbolBlock`` on the card
gives the plain versions' outputs bit for bit, launching the int8 matmul
once per fully connected layer with no plain version; ``clip`` on the
card gives the CPU's values bit for bit.

Greedy NMS (``csrc/nms.cu``): the kernel's keep mask equals its plain
loop's bit for bit at N 1, 33, 6000 and 8732, for each IoU formula
(``_pair_iou`` / ``_iou_corner``), comparison (>= / >) and class mode,
one launch a call; views, refusals and empty inputs; MultiBoxDetection,
Proposal and box_nms on the card launch it once each, never select the
plain version, and give the CPU's results (ids and keep decisions
exact).

The kernel library's front door: ``select_impl("flash_attention")`` and
``select_impl("int8_matmul")`` resolve to ``'cuda'`` and, through a
``kernel_unit``, launch the forward, dQ and dK/dV kernels and the fused
dequant kernel on their tensor-core variants; ``MXTPU_PALLAS=interpret``
and ``off`` raise on a CUDA tensor (no plain version on the card because
of the knob), and ``off`` runs the plain version on a CPU tensor, counted
as ``kernels.select.<name>.reference``.
"""
import importlib
import pathlib
import sys
import threading
import uuid

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx

from mxnet_tpu_torch.ops.kernels import common, int8_matmul
from mxnet_tpu_torch.ops.kernels.int8_matmul import (
    _int8_matmul_cuda, _int8_mm_mma_cuda, _int8_mm_wgmma_cuda,
    int8_matmul_reference, plan_int8_matmul)
from mxnet_tpu_torch.ops.kernels.flash_attention import (
    _delta, _flash_bwd_cuda, _flash_cuda, _flash_dkv_wgmma_cuda,
    _flash_dq_wgmma_cuda, _flash_simt_cuda, _flash_tf32x3_cuda,
    _flash_tf32x3_xwide_cuda, _flash_wgmma_cuda, _flash_wgmma_wide_cuda,
    _flash_wgmma_xwide_cuda, _flash_wgmma_xxwide_cuda, flash_attention,
    flash_attention_bwd_reference,
    flash_attention_lse, flash_attention_reference)
from mxnet_tpu_torch.ops.kernels.layers import (
    _rmsnorm_block_cuda, _rmsnorm_cuda, _rmsnorm_simt_cuda,
    _rmsnorm_warp_cuda, _xent_bwd_cuda, _xent_fwd_cuda, fused_rmsnorm,
    fused_rmsnorm_reference, fused_softmax_xent, plan_rmsnorm,
    softmax_xent_bwd_reference, softmax_xent_reference)
from mxnet_tpu_torch.ops.kernels import _build

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_ONE_ROUNDING = dict(rtol=2.0 ** -7, atol=1e-5)
BF16_TWO_ROUNDINGS = dict(rtol=2.0 ** -6, atol=1e-6)
F32_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_GRAD_TOL = dict(rtol=2.0 ** -7, atol=1e-3)

pytestmark = pytest.mark.cuda

FLASH_CASES = [
    # (B, Tq, Tk, H, D, causal)
    (2, 16, 16, 2, 16, True),        # one ragged q tile
    (1, 37, 37, 2, 32, True),
    (1, 37, 37, 2, 32, False),
    (1, 24, 40, 2, 16, False),       # Tq != Tk
    (1, 20, 33, 3, 64, True),        # causal, Tq < Tk (top-left aligned)
    (1, 130, 70, 2, 64, True),       # causal, Tq > Tk
    (1, 300, 300, 4, 128, True),     # several tiles, skipped causal tiles
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks on "
                    "the card")
    return torch.device("cuda", 0)


def _np(a):
    return a.float().cpu().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(513, 2048), (3, 5, 8192), (1, 96)])
def test_rmsnorm_kernel_matches_plain(dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    scale = torch.randn(shape[-1], generator=g, device=dev).to(dtype)
    got = _rmsnorm_cuda(x, scale)
    ref = fused_rmsnorm_reference(x, scale)
    assert got.shape == x.shape and got.dtype == dtype
    tol = F32_TOL if dtype == torch.float32 else BF16_TWO_ROUNDINGS
    np.testing.assert_allclose(_np(got), _np(ref), **tol)


def test_rmsnorm_routes_to_kernel_and_counts_launches(dev):
    common.reset_counts()
    x = torch.randn(4, 64, device=dev)
    fused_rmsnorm(x, torch.ones(64, device=dev))
    assert common.selection_counts() == {
        "kernels.select.fused_rmsnorm.cuda": 1}
    # few rows: one CTA a row
    assert common.launch_counts() == {"kernels.launch.fused_rmsnorm": 1,
                                      "kernels.launch.fused_rmsnorm.block": 1}
    # more rows than SMs: rows to warps; an offset view: the scalar kernel
    common.reset_counts()
    fused_rmsnorm(torch.randn(4096, 64, device=dev),
                  torch.ones(64, device=dev))
    fused_rmsnorm(torch.randn(8, 65, device=dev)[:, 1:],
                  torch.ones(64, device=dev))
    assert common.launch_counts() == {"kernels.launch.fused_rmsnorm": 2,
                                      "kernels.launch.fused_rmsnorm.warp": 1,
                                      "kernels.launch.fused_rmsnorm.simt": 1}
    assert common.selection_counts() == {
        "kernels.select.fused_rmsnorm.cuda": 2}


# (N, E): the main paths' shapes (decode, the 4000-token prompt's prefill,
# a 4096-row prefill, the flagship step, the long-context step)
RMSNORM_MAIN = [(8, 2048), (4000, 2048), (4096, 2048), (8192, 2048),
                (8192, 1024)]
RMSNORM_VARIANTS = {"warp": _rmsnorm_warp_cuda, "block": _rmsnorm_block_cuda,
                    "simt": _rmsnorm_simt_cuda, "planned": _rmsnorm_cuda}


def _rmsnorm_inputs(dev, shape, dtype, seed=0, scale_shift=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    scale = (1 + 0.1 * torch.randn(shape[-1] + scale_shift, generator=g,
                                   device=dev)).to(dtype)
    return x, scale[scale_shift:]


def _rmsnorm_check(fn, x, scale):
    """``fn`` against the plain version at the stated tolerances, and two
    calls bit-identical."""
    got = fn(x, scale)
    again = fn(x, scale)
    ref = fused_rmsnorm_reference(x, scale)
    assert got.shape == x.shape and got.dtype == x.dtype
    tol = F32_TOL if x.dtype == torch.float32 else BF16_TWO_ROUNDINGS
    np.testing.assert_allclose(_np(got), _np(ref), **tol)
    assert torch.equal(got.view(torch.int16 if x.dtype == torch.bfloat16
                                else torch.int32),
                       again.view(torch.int16 if x.dtype == torch.bfloat16
                                  else torch.int32))


@pytest.mark.parametrize("variant", list(RMSNORM_VARIANTS))
@pytest.mark.parametrize("shape", RMSNORM_MAIN)
def test_rmsnorm_variants_at_main_path_shapes(dev, shape, variant):
    x, scale = _rmsnorm_inputs(dev, shape, torch.bfloat16)
    _rmsnorm_check(RMSNORM_VARIANTS[variant], x, scale)


@pytest.mark.parametrize("variant", list(RMSNORM_VARIANTS))
@pytest.mark.parametrize("shape", [(4096, 2048), (8, 2048), (1000, 1000)])
def test_rmsnorm_variants_f32(dev, shape, variant):
    x, scale = _rmsnorm_inputs(dev, shape, torch.float32)
    _rmsnorm_check(RMSNORM_VARIANTS[variant], x, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (1, 2048), (2, 2048), (3, 2048), (5, 2048), (7, 2048),  # N = 1 ... 8
    (8, 8), (133, 8), (300, 1000), (4000, 1000),   # short rows, masked lanes
    (200, 4096), (200, 8192), (3, 16384), (140, 16384),  # row groups, block
    (2, 65536), (9, 65536),                        # 128 / 256 KB rows
    (6, 7), (300, 7), (300, 2047), (1, 1),         # odd E: simt only
    (0, 2048),                                     # no rows
])
def test_rmsnorm_variants_at_edges(dev, shape, dtype):
    """Each variant, forced, where it takes the layout (and raises where it
    cannot), and the planned one."""
    x, scale = _rmsnorm_inputs(dev, shape, dtype)
    n, E = shape
    plan = plan_rmsnorm(n, E, dtype, E, 16, common.sm_count(dev))
    chunks = E * x.element_size() / 16
    for variant, fn in RMSNORM_VARIANTS.items():
        takes = {"warp": chunks == int(chunks) and chunks <= 1024,
                 "block": chunks == int(chunks) and chunks <= 8192,
                 "simt": True, "planned": True}[variant]
        if not takes:
            with pytest.raises(ValueError, match=variant):
                fn(x, scale)
            continue
        common.reset_counts()
        _rmsnorm_check(fn, x, scale)
        if variant == "planned" and n:
            assert common.launch_counts()[
                "kernels.launch.fused_rmsnorm.%s" % plan.variant] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_offset_views_and_strided_rows(dev, dtype):
    """Strided rows of whole vectors take the vector variants; an offset
    view (a base off 16 bytes) or a row stride off whole vectors takes the
    scalar kernel, which the vector ones refuse."""
    g = torch.Generator(device=dev).manual_seed(1)
    big = torch.randn(300, 2048 + 64, generator=g, device=dev).to(dtype)
    scale = (1 + 0.1 * torch.randn(2048, generator=g, device=dev)).to(dtype)
    strided = big[:, :2048]                       # row stride 2112
    offset = big[:, 1:2049]                       # base 2 or 4 bytes off
    odd_stride = torch.randn(300, 2049, generator=g, device=dev).to(
        dtype)[:, :2048]
    for x, vector in ((strided, True), (big[:8, 32:2080], True),
                      (offset, False), (odd_stride, False),
                      (big[:7, 1:2049], False)):
        for variant, fn in RMSNORM_VARIANTS.items():
            if not vector and variant in ("warp", "block"):
                with pytest.raises(ValueError, match="16-byte"):
                    fn(x, scale)
                continue
            common.reset_counts()
            _rmsnorm_check(fn, x, scale)
            if variant == "planned":
                launched = common.launch_counts()
                assert ("kernels.launch.fused_rmsnorm.simt" in launched) \
                    == (not vector)
    # a scale off 16 bytes: the scalar kernel too
    x, s = _rmsnorm_inputs(dev, (4096, 2048), dtype, scale_shift=1)
    common.reset_counts()
    _rmsnorm_check(_rmsnorm_cuda, x, s)
    assert common.launch_counts()["kernels.launch.fused_rmsnorm.simt"] == 2


def test_rmsnorm_kernels_do_not_spill(dev):
    """ptxas: every RMSNorm kernel instantiation, 0 bytes of spills."""
    log = _build.build(["rmsnorm"])["rmsnorm"]["log"]
    lines = [ln for ln in log.splitlines() if "spill stores" in ln]
    # simt 2, warp 6 x 2, block 4 x 2 instantiations
    assert len(lines) == 22, log
    assert all(" 0 bytes spill stores, 0 bytes spill loads" in ln
               for ln in lines), log


def test_rmsnorm_refuses_other_dtypes(dev):
    x = torch.randn(4, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        _rmsnorm_cuda(x, torch.ones(64, device=dev, dtype=torch.float16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(dev, case, dtype):
    B, Tq, Tk, H, D, causal = case
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((B, T, H, D), generator=g, device=dev).to(dtype)
               for T in (Tq, Tk, Tk))
    o, lse = _flash_cuda(q, k, v, causal)
    ro, rlse = flash_attention_reference(q, k, v, causal, return_lse=True)
    assert o.dtype == dtype and lse.dtype == torch.float32
    tol = F32_TOL if dtype == torch.float32 else BF16_ONE_ROUNDING
    np.testing.assert_allclose(_np(o), _np(ro), **tol)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-5, atol=1e-4)


def test_flash_reads_strided_qkv_slices(dev):
    B, T, H, D = 1, 77, 2, 64
    qkv = torch.randn(B, T, 3 * H * D, device=dev, dtype=torch.bfloat16)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, -1))
    assert not q.is_contiguous()
    common.reset_counts()
    o, lse = flash_attention_lse(q, k, v)
    o2, lse2 = _flash_cuda(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 2,
        "kernels.launch.flash_attention.wgmma": 2}
    assert common.selection_counts() == {
        "kernels.select.flash_attention.cuda": 1}


def test_flash_refuses_bad_inputs(dev):
    q = torch.randn(1, 8, 2, 0, device=dev)
    with pytest.raises(ValueError, match="head_dim 0"):
        _flash_cuda(q, q, q)
    q = torch.randn(1, 8, 2, 64, device=dev)
    with pytest.raises(TypeError):
        _flash_cuda(q, q.half(), q)


# ---------------------------------------------------------------------------
# flash forward: the tensor-core (wgmma) variant, bf16 with D 64 or 128
# ---------------------------------------------------------------------------
WGMMA_CASES = [
    # (B, Tq, Tk, H, D, causal); tiles are 128 queries x 128 keys
    (1, 1, 1, 2, 64, True),
    (1, 1, 1, 2, 128, False),
    (2, 63, 63, 2, 64, True),
    (1, 65, 65, 2, 128, True),
    (1, 127, 127, 3, 64, False),
    (1, 129, 129, 2, 128, True),
    (1, 129, 129, 2, 64, True),
    (1, 1000, 3000, 2, 128, False),
    (1, 1000, 3000, 2, 64, False),
    (1, 4000, 4000, 2, 128, True),
    (1, 4000, 4000, 2, 64, True),
    (1, 20, 300, 2, 64, True),       # causal, Tq < Tk (top-left aligned)
    (1, 65, 200, 2, 128, True),
    (1, 300, 70, 2, 128, True),      # causal, Tq > Tk
    (1, 1, 129, 2, 64, False),
]


def _qkv(dev, B, Tq, Tk, H, D, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn((B, T, H, D), generator=g, device=dev).to(dtype)
                 for T in (Tq, Tk, Tk))


@pytest.mark.parametrize("case", WGMMA_CASES)
def test_flash_wgmma_matches_plain(dev, case):
    B, Tq, Tk, H, D, causal = case
    q, k, v = _qkv(dev, B, Tq, Tk, H, D)
    common.reset_counts()
    o, lse = _flash_cuda(q, k, v, causal)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.wgmma": 1}
    ro, rlse = flash_attention_reference(q, k, v, causal, return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(o), _np(ro), **BF16_ONE_ROUNDING)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_wgmma_reads_fused_qkv_views(dev, D):
    """q/k/v as [B, T, H, D] views of one [B, T, 3·H·D] product, as the
    model makes them: no copy, the same bits as contiguous copies."""
    B, T, H = 2, 333, 3
    g = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, -1))
    assert not q.is_contiguous()
    o, lse = _flash_wgmma_cuda(q, k, v)
    o2, lse2 = _flash_wgmma_cuda(q.contiguous(), k.contiguous(),
                                 v.contiguous())
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = flash_attention_reference(q, k, v, return_lse=True)
    np.testing.assert_allclose(_np(o), _np(ro), **BF16_ONE_ROUNDING)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("launch", [_flash_wgmma_cuda, _flash_simt_cuda,
                                    _flash_wgmma_wide_cuda,
                                    _flash_wgmma_xwide_cuda])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kv_len_and_rows_without_keys(dev, launch, causal):
    """``kv_len`` (``_fwd``'s argument) masks keys at and past it: the same
    as attending over the first kv_len keys; with kv_len 0 every row has l
    = 0 and gets o = 0 and the finite lse -1e30, in every variant (the
    wgmma_wide one at head_dim 256, the wgmma_xwide one at 512)."""
    D = {_flash_wgmma_wide_cuda: 256,
         _flash_wgmma_xwide_cuda: 512}.get(launch, 128)
    q, k, v = _qkv(dev, 1, 200, 300, 2, D, seed=4)
    o, lse = launch(q, k, v, causal, kv_len=0)
    assert not o.any()
    assert torch.isfinite(lse).all() and bool((lse == -1e30).all())
    o, lse = launch(q, k, v, causal, kv_len=150)
    ro, rlse = flash_attention_reference(q, k[:, :150], v[:, :150], causal,
                                         return_lse=True)
    np.testing.assert_allclose(_np(o), _np(ro), **BF16_ONE_ROUNDING)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype,D,variant", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 32, "simt"), (torch.bfloat16, 16, "simt"),
    (torch.float32, 64, "tf32x3"), (torch.float32, 128, "tf32x3"),
    (torch.bfloat16, 256, "wgmma_wide"), (torch.bfloat16, 192, "wgmma_wide"),
    (torch.bfloat16, 320, "wgmma_xwide"), (torch.float32, 256, "tf32x3"),
    (torch.float32, 192, "tf32x3"), (torch.float32, 160, "tf32x3"),
    (torch.float32, 320, "tf32x3_xwide"), (torch.bfloat16, 512,
                                            "wgmma_xwide"),
    (torch.bfloat16, 576, "wgmma_xxwide"), (torch.float32, 576, "wide"),
    (torch.bfloat16, 1088, "wide")])
def test_flash_forward_variant_counters(dev, dtype, D, variant):
    q, k, v = _qkv(dev, 1, 70, 70, 2, D, dtype)
    common.reset_counts()
    flash_attention(q, k, v)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.%s" % variant: 1}


def test_flash_wgmma_refuses_misaligned_inputs(dev):
    """The wgmma variant raises on inputs its TMA copies cannot read; it
    never hands them to the other variant."""
    B, T, H, D = 1, 64, 2, 64
    flat = torch.randn(B * T * H * D + 1, device=dev, dtype=torch.bfloat16)
    q = flat[1:].view(B, T, H, D)                     # base 2 bytes off
    k = torch.randn(B, T, H, D, device=dev, dtype=torch.bfloat16)
    common.reset_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, k, k)
    wide = torch.randn(B, T, H * D + 4, device=dev, dtype=torch.bfloat16)
    k2 = wide[..., :H * D].view(B, T, H, D)           # T stride 132
    with pytest.raises(ValueError, match="T stride 132"):
        _flash_cuda(k, k2, k)
    assert common.launch_counts() == {}
    with pytest.raises(ValueError, match="wgmma variant"):
        _flash_wgmma_cuda(*_qkv(dev, 1, 8, 8, 2, 64, torch.float32))


# ---------------------------------------------------------------------------
# flash backward: dQ and dK/dV
# ---------------------------------------------------------------------------
FLASH_BWD_CASES = FLASH_CASES + [
    (1, 8, 200, 2, 32, True),        # causal Tq < Tk: keys 8.. get dK=dV=0
]


def _flash_bwd_inputs(dev, B, Tq, Tk, H, D, causal, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, T, H, D), generator=g, device=dev).to(dtype)
               for T in (Tq, Tk, Tk))
    o, lse = _flash_cuda(q, k, v, causal)
    do = torch.randn((B, Tq, H, D), generator=g, device=dev).to(dtype)
    dlse = torch.randn((B, H, Tq), generator=g, device=dev)
    return q, k, v, o, lse, do, dlse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_bwd_kernels_match_plain(dev, case, dtype):
    B, Tq, Tk, H, D, causal = case
    q, k, v, o, lse, do, dlse = _flash_bwd_inputs(dev, *case, dtype)
    # free NaN blocks of dQ's and dK/dV's sizes, so that the outputs'
    # torch.empty likely reuse them: every row must be written
    for t in (q, k, v):
        torch.full_like(t, float("nan"))
    got = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, dlse, causal)
    tol = F32_GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL
    for gt, wt, name in zip(got, want, ("dq", "dk", "dv")):
        assert gt.dtype == dtype and gt.shape == wt.shape
        assert torch.isfinite(gt).all(), name
        np.testing.assert_allclose(_np(gt), _np(wt), err_msg=name, **tol)
    if causal and Tq < Tk:
        assert not got[1][:, Tq:].any() and not got[2][:, Tq:].any()


def test_flash_bwd_reads_strided_slices_and_dout(dev):
    """q/k/v as slices of one fused qkv tensor and a non-contiguous dO
    give the same gradients as contiguous copies."""
    B, T, H, D = 1, 77, 2, 64
    g = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, -1))
    o, lse = _flash_cuda(q, k, v)
    do = torch.randn(B, H, T, D, generator=g, device=dev,
                     dtype=torch.bfloat16).transpose(1, 2)
    assert not q.is_contiguous() and not do.is_contiguous()
    a = _flash_bwd_cuda(q, k, v, o, lse, do)
    b = _flash_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(), o,
                        lse, do.contiguous())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_autograd_launches_backward_kernels(dev):
    """Autograd of ``flash_attention`` at f32 head_dim 64: the forward, dQ
    and dK/dV on tf32x3 (its narrow plans), one launch each."""
    B, T, H, D = 1, 130, 2, 64
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(B, T, H, D, generator=g, device=dev,
                           requires_grad=True) for _ in range(3))
    common.reset_counts()
    o, lse = flash_attention_lse(q, k, v)
    (o.square().sum() + lse.tanh().sum()).backward()
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.tf32x3": 1,
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.tf32x3": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.tf32x3": 1}
    assert common.selection_counts() == {
        "kernels.select.flash_attention.cuda": 1,
        "kernels.select.flash_attention_bwd.cuda": 1}
    qr, kr, vr = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o2, lse2 = flash_attention_reference(qr, kr, vr, return_lse=True)
    (o2.square().sum() + lse2.tanh().sum()).backward()
    for t, r in ((q, qr), (k, kr), (v, vr)):
        np.testing.assert_allclose(_np(t.grad), _np(r.grad), **F32_GRAD_TOL)


def test_flash_bwd_refuses_bad_inputs(dev):
    q = torch.randn(1, 8, 2, 0, device=dev)
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError, match="head_dim 0"):
        _flash_bwd_cuda(q, q, q, q, lse, q)
    q = torch.randn(1, 8, 2, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        _flash_bwd_cuda(q, q, q, q, lse, q)
    q = torch.randn(1, 8, 2, 64, device=dev)
    with pytest.raises(ValueError, match="lse"):
        _flash_bwd_cuda(q, q, q, q, lse[:, :, :4], q)
    with pytest.raises(TypeError):
        flash_attention(q.double(), q.double(), q.double())


# ---------------------------------------------------------------------------
# flash backward: the tensor-core (wgmma) variant, bf16 with D 64 or 128
# ---------------------------------------------------------------------------
WGMMA_BWD_CASES = [
    # (B, Tq, Tk, H, D, causal); CTAs own 128 rows, tiles stream 64
    (1, 1, 1, 2, 64, True),
    (1, 1, 1, 2, 128, False),
    (2, 63, 63, 2, 64, True),
    (1, 65, 65, 2, 128, True),
    (1, 127, 127, 3, 64, False),
    (1, 129, 129, 2, 128, True),
    (1, 129, 129, 2, 64, True),
    (1, 1000, 3000, 2, 128, False),
    (1, 1000, 3000, 2, 64, False),
    (1, 20, 300, 2, 64, True),       # causal, Tq < Tk: keys 20.. dK=dV=0
    (1, 65, 200, 2, 128, True),
    (1, 300, 70, 2, 128, True),      # causal, Tq > Tk
    (1, 300, 70, 2, 64, True),
    (1, 1, 129, 2, 64, False),
]


def _dense_autograd_grads(q, k, v, do, dlse, causal):
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    o, lse = flash_attention_reference(qr, kr, vr, causal, return_lse=True)
    return torch.autograd.grad((o, lse), (qr, kr, vr), (do, dlse))


def _rel_to_max(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("case", WGMMA_BWD_CASES)
def test_flash_bwd_wgmma_matches_plain(dev, case):
    B, Tq, Tk, H, D, causal = case
    q, k, v, o, lse, do, dlse = _flash_bwd_inputs(dev, *case, torch.bfloat16)
    for t in (q, k, v):                    # see test_flash_bwd_kernels_...
        torch.full_like(t, float("nan"))
    common.reset_counts()
    got = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.wgmma": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.wgmma": 1}
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, dlse, causal)
    auto = _dense_autograd_grads(q, k, v, do, dlse, causal)
    for gt, wt, at, name in zip(got, want, auto, ("dq", "dk", "dv")):
        assert gt.dtype == torch.bfloat16 and gt.shape == wt.shape
        assert gt.is_contiguous() and torch.isfinite(gt).all(), name
        np.testing.assert_allclose(_np(gt), _np(wt), err_msg=name,
                                   **BF16_GRAD_TOL)
        assert _rel_to_max(gt, at) <= 2.0 ** -6, name
    if causal and Tq < Tk:
        assert not got[1][:, Tq:].any() and not got[2][:, Tq:].any()
    again = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    for a, b in zip(got, again):           # no atomics: the same bits
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_bwd_wgmma_reads_fused_qkv_views_and_strided_dout(dev, D):
    """q/k/v as views of one fused qkv product and a transposed dO give
    the same bits as contiguous copies."""
    B, T, H = 2, 333, 3
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, -1))
    o, lse = _flash_cuda(q, k, v)
    do = torch.randn(B, H, T, D, generator=g, device=dev,
                     dtype=torch.bfloat16).transpose(1, 2)
    assert not q.is_contiguous() and not do.is_contiguous()
    a = _flash_bwd_cuda(q, k, v, o, lse, do)
    b = _flash_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(), o,
                        lse, do.contiguous())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_bwd_wgmma_refuses_misaligned_inputs(dev):
    """Misaligned q/k/v raise before any launch; a misaligned dO (an
    internal cotangent) is copied by the backward, and refused by the
    launchers themselves."""
    B, T, H, D = 1, 64, 2, 64
    q, k, v, o, lse, do, _ = _flash_bwd_inputs(dev, B, T, T, H, D, True,
                                               torch.bfloat16)
    flat = torch.randn(B * T * H * D + 1, device=dev, dtype=torch.bfloat16)
    bad = flat[1:].view(B, T, H, D)                   # base 2 bytes off
    bad.copy_(q)
    delta = _delta(o, do, None)
    common.reset_counts()
    with pytest.raises(ValueError, match="q's base address"):
        _flash_bwd_cuda(bad, k, v, o, lse, do)
    for launch in (_flash_dq_wgmma_cuda, _flash_dkv_wgmma_cuda):
        with pytest.raises(ValueError, match="k's base address"):
            launch(q, bad, v, do, lse, delta)
        with pytest.raises(ValueError, match="dO's base address"):
            launch(q, k, v, bad, lse, delta)
    assert common.launch_counts() == {}
    bad.copy_(do)
    got = _flash_bwd_cuda(q, k, v, o, lse, bad)
    want = _flash_bwd_cuda(q, k, v, o, lse, do)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_flash_autograd_bf16_launches_wgmma_kernels(dev):
    B, T, H, D = 1, 130, 2, 64
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(B, T, H, D, generator=g, device=dev,
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    common.reset_counts()
    o, lse = flash_attention_lse(q, k, v)
    (o.float().square().sum() + lse.tanh().sum()).backward()
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.wgmma": 1,
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.wgmma": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.wgmma": 1}


# ---------------------------------------------------------------------------
# flash forward: the tensor-core wgmma_wide variant, bf16 at D 192 or 256
# ---------------------------------------------------------------------------
WGMMA_WIDE_FWD_CASES = [
    # (B, Tq, Tk, H, D, causal); tiles are 128 queries x 64 keys; D 160
    # pads to 192
    (1, 1, 1, 2, 256, True),
    (1, 1, 1, 2, 192, False),
    (2, 63, 63, 2, 256, True),
    (1, 65, 65, 2, 192, True),
    (1, 127, 127, 3, 160, False),
    (1, 129, 129, 2, 256, True),
    (1, 129, 129, 2, 160, True),
    (1, 1000, 3000, 2, 256, False),
    (1, 1000, 3000, 2, 192, False),
    (1, 4000, 4000, 2, 256, True),
    (1, 4000, 4000, 2, 192, True),
    (1, 20, 300, 2, 256, True),      # causal, Tq < Tk (top-left aligned)
    (1, 65, 200, 2, 160, True),
    (1, 300, 70, 2, 256, True),      # causal, Tq > Tk
    (1, 300, 70, 2, 192, True),
    (1, 1, 129, 2, 256, False),
]


@pytest.mark.parametrize("case", WGMMA_WIDE_FWD_CASES)
def test_flash_wgmma_wide_matches_plain(dev, case):
    """The wgmma_wide forward against the plain version at the wgmma
    variant's bf16 tolerances, one launch of it, and two calls
    bit-identical."""
    B, Tq, Tk, H, D, causal = case
    q, k, v = _qkv(dev, B, Tq, Tk, H, D)
    common.reset_counts()
    o, lse = _flash_cuda(q, k, v, causal)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.wgmma_wide": 1}
    ro, rlse = flash_attention_reference(q, k, v, causal, return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(o), _np(ro), **BF16_ONE_ROUNDING)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-5, atol=1e-4)
    o2, lse2 = _flash_cuda(q, k, v, causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("D", [192, 256])
def test_flash_wgmma_wide_reads_fused_qkv_views(dev, D):
    """q/k/v as [B, T, H, D] views of one [B, T, 3·H·D] product: no copy,
    the same bits as contiguous copies."""
    B, T, H = 2, 333, 3
    g = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, -1))
    assert not q.is_contiguous()
    o, lse = _flash_wgmma_wide_cuda(q, k, v)
    o2, lse2 = _flash_wgmma_wide_cuda(q.contiguous(), k.contiguous(),
                                      v.contiguous())
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = flash_attention_reference(q, k, v, return_lse=True)
    np.testing.assert_allclose(_np(o), _np(ro), **BF16_ONE_ROUNDING)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-5, atol=1e-4)


def test_flash_wgmma_wide_refuses_misaligned_inputs(dev):
    """The wgmma_wide forward raises on inputs its TMA copies cannot read,
    before any launch; it never hands them to the wide variant."""
    B, T, H, D = 1, 64, 2, 256
    flat = torch.randn(B * T * H * D + 1, device=dev, dtype=torch.bfloat16)
    q = flat[1:].view(B, T, H, D)                     # base 2 bytes off
    k = torch.randn(B, T, H, D, device=dev, dtype=torch.bfloat16)
    common.reset_counts()
    with pytest.raises(ValueError, match="wgmma_wide variant.*16-byte"):
        flash_attention(q, k, k)
    wide = torch.randn(B, T, H * D + 4, device=dev, dtype=torch.bfloat16)
    k2 = wide[..., :H * D].view(B, T, H, D)           # T stride 516
    with pytest.raises(ValueError, match="wgmma_wide variant.*T stride 516"):
        _flash_cuda(k, k, k2)
    assert common.launch_counts() == {}
    with pytest.raises(ValueError, match="wgmma_wide variant"):
        _flash_wgmma_wide_cuda(*_qkv(dev, 1, 8, 8, 2, 256, torch.float32))


# ---------------------------------------------------------------------------
# flash backward: the tensor-core wgmma_wide variant, bf16 at D 192 or 256
# ---------------------------------------------------------------------------
WGMMA_WIDE_BWD_CASES = [
    # (B, Tq, Tk, H, D, causal); CTAs own 64 rows, tiles stream 64, each
    # warpgroup scores 32 of them; D 160 pads to 192
    (1, 1, 1, 2, 256, True),
    (1, 1, 1, 2, 192, False),
    (2, 63, 63, 2, 256, True),
    (1, 65, 65, 2, 192, True),
    (1, 127, 127, 3, 160, False),
    (1, 129, 129, 2, 256, True),
    (1, 129, 129, 2, 160, True),
    (1, 1000, 3000, 2, 256, False),
    (1, 1000, 3000, 2, 192, False),
    (1, 20, 300, 2, 256, True),      # causal, Tq < Tk: keys 20.. dK=dV=0
    (1, 65, 200, 2, 160, True),
    (1, 300, 70, 2, 256, True),      # causal, Tq > Tk
    (1, 300, 70, 2, 192, True),
    (1, 1, 129, 2, 256, False),
]


@pytest.mark.parametrize("case", WGMMA_WIDE_BWD_CASES)
def test_flash_bwd_wgmma_wide_matches_plain(dev, case):
    """dQ and dK/dV of the wgmma_wide variant against the plain backward
    (with an lse cotangent) at the wgmma variant's bf16 tolerances, against
    dense autograd within 2^-6 of each gradient's largest entry, keys no
    query sees at zero, and two calls bit-identical."""
    B, Tq, Tk, H, D, causal = case
    q, k, v, o, lse, do, dlse = _flash_bwd_inputs(dev, *case, torch.bfloat16)
    for t in (q, k, v):                    # see test_flash_bwd_kernels_...
        torch.full_like(t, float("nan"))
    common.reset_counts()
    got = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.wgmma_wide": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.wgmma_wide": 1}
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, dlse, causal)
    auto = _dense_autograd_grads(q, k, v, do, dlse, causal)
    for gt, wt, at, name in zip(got, want, auto, ("dq", "dk", "dv")):
        assert gt.dtype == torch.bfloat16 and gt.shape == wt.shape
        assert gt.is_contiguous() and torch.isfinite(gt).all(), name
        np.testing.assert_allclose(_np(gt), _np(wt), err_msg=name,
                                   **BF16_GRAD_TOL)
        assert _rel_to_max(gt, at) <= 2.0 ** -6, name
    if causal and Tq < Tk:
        assert not got[1][:, Tq:].any() and not got[2][:, Tq:].any()
    again = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    for a, b in zip(got, again):           # no atomics: the same bits
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [192, 256])
def test_flash_bwd_wgmma_wide_reads_fused_qkv_views_and_strided_dout(dev, D):
    """q/k/v as views of one fused qkv product and a transposed dO give
    the same bits as contiguous copies."""
    B, T, H = 2, 333, 3
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, -1))
    o, lse = _flash_cuda(q, k, v)
    do = torch.randn(B, H, T, D, generator=g, device=dev,
                     dtype=torch.bfloat16).transpose(1, 2)
    assert not q.is_contiguous() and not do.is_contiguous()
    common.reset_counts()
    a = _flash_bwd_cuda(q, k, v, o, lse, do)
    assert common.launch_counts()[
        "kernels.launch.flash_attention_dq.wgmma_wide"] == 1
    b = _flash_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(), o,
                        lse, do.contiguous())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_bwd_wgmma_wide_refuses_misaligned_inputs(dev):
    """Misaligned q/k/v raise before any launch; a misaligned dO (an
    internal cotangent) is copied by the backward, and refused by the
    launchers themselves."""
    from mxnet_tpu_torch.ops.kernels.flash_attention import (
        _flash_dkv_wgmma_wide_cuda, _flash_dq_wgmma_wide_cuda)
    B, T, H, D = 1, 64, 2, 256
    q, k, v, o, lse, do, _ = _flash_bwd_inputs(dev, B, T, T, H, D, True,
                                               torch.bfloat16)
    flat = torch.randn(B * T * H * D + 1, device=dev, dtype=torch.bfloat16)
    bad = flat[1:].view(B, T, H, D)                   # base 2 bytes off
    bad.copy_(q)
    delta = _delta(o, do, None)
    common.reset_counts()
    with pytest.raises(ValueError, match="wgmma_wide variant.*q's base"):
        _flash_bwd_cuda(bad, k, v, o, lse, do)
    for launch in (_flash_dq_wgmma_wide_cuda, _flash_dkv_wgmma_wide_cuda):
        with pytest.raises(ValueError, match="k's base address"):
            launch(q, bad, v, do, lse, delta)
        with pytest.raises(ValueError, match="dO's base address"):
            launch(q, k, v, bad, lse, delta)
    assert common.launch_counts() == {}
    bad.copy_(do)
    got = _flash_bwd_cuda(q, k, v, o, lse, bad)
    want = _flash_bwd_cuda(q, k, v, o, lse, do)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_flash_autograd_bf16_head_dim_256_launches_wgmma_wide(dev):
    """Autograd of ``flash_attention`` at bf16 head_dim 256: the forward,
    dQ and dK/dV on wgmma_wide, one each, and nothing on wide."""
    B, T, H, D = 1, 130, 2, 256
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(B, T, H, D, generator=g, device=dev,
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    common.reset_counts()
    o, lse = flash_attention_lse(q, k, v)
    (o.float().square().sum() + lse.tanh().sum()).backward()
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.wgmma_wide": 1,
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.wgmma_wide": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.wgmma_wide": 1}
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


# ---------------------------------------------------------------------------
# flash forward: the tensor-core wgmma_xwide variant, bf16 at D 320-512
# ---------------------------------------------------------------------------
WGMMA_XWIDE_FWD_CASES = [
    # (B, Tq, Tk, H, D, causal); CTAs own 64 query rows, key tiles of 64
    # (32 at 448 and 512), the two warpgroups split D's panels 3 + 2 (320),
    # 3 + 3, 4 + 3, 4 + 4; D 257 pads to 320, 400 to 448
    (1, 1, 1, 2, 512, True),
    (1, 1, 1, 2, 320, False),
    (2, 63, 63, 2, 512, True),
    (1, 65, 65, 2, 384, True),
    (1, 127, 127, 3, 257, False),
    (1, 129, 129, 2, 448, True),
    (1, 129, 129, 2, 400, True),
    (1, 1000, 3000, 2, 512, False),
    (1, 1000, 3000, 2, 320, False),
    (1, 2000, 2000, 2, 512, True),
    (1, 2000, 2000, 2, 384, True),
    (1, 20, 300, 2, 512, True),      # causal, Tq < Tk (top-left aligned)
    (1, 65, 200, 2, 400, True),
    (1, 300, 70, 2, 512, True),      # causal, Tq > Tk
    (1, 300, 70, 2, 448, True),
    (1, 1, 129, 2, 384, False),
    (2, 333, 333, 2, 320, True),
    (1, 777, 777, 4, 257, True),
]


@pytest.mark.parametrize("case", WGMMA_XWIDE_FWD_CASES)
def test_flash_wgmma_xwide_matches_plain(dev, case):
    """The wgmma_xwide forward against the plain version: o within one
    bf16 rounding, lse within 1e-4 + 1e-5·|lse|, one launch of it, and
    two calls bit-identical."""
    B, Tq, Tk, H, D, causal = case
    q, k, v = _qkv(dev, B, Tq, Tk, H, D)
    common.reset_counts()
    o, lse = _flash_cuda(q, k, v, causal)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.wgmma_xwide": 1}
    ro, rlse = flash_attention_reference(q, k, v, causal, return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert o.shape == q.shape and o.is_contiguous()
    np.testing.assert_allclose(_np(o), _np(ro), **BF16_ONE_ROUNDING)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-5, atol=1e-4)
    o2, lse2 = _flash_cuda(q, k, v, causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_flash_wgmma_xwide_forward_does_not_spill(dev):
    """ptxas: the wgmma_xwide forward at each of its 4 widths, alone and in
    2-CTA clusters (wgmma_xxwide), 0 bytes of spills."""
    src = "flash_attention_wgmma_xwide"
    log = _build.build([src])[src]["log"]
    lines = [ln for ln in log.splitlines() if "spill stores" in ln]
    assert len(lines) == 8, log
    assert all(" 0 bytes spill stores, 0 bytes spill loads" in ln
               for ln in lines), log


@pytest.mark.parametrize("D", [320, 448, 512])
def test_flash_wgmma_xwide_reads_fused_qkv_views(dev, D):
    """q/k/v as [B, T, H, D] views of one [B, T, 3·H·D] product: no copy,
    the same bits as contiguous copies."""
    B, T, H = 2, 333, 3
    g = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, -1))
    assert not q.is_contiguous()
    o, lse = _flash_wgmma_xwide_cuda(q, k, v)
    o2, lse2 = _flash_wgmma_xwide_cuda(q.contiguous(), k.contiguous(),
                                       v.contiguous())
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = flash_attention_reference(q, k, v, return_lse=True)
    np.testing.assert_allclose(_np(o), _np(ro), **BF16_ONE_ROUNDING)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-5, atol=1e-4)


def test_flash_wgmma_xwide_refuses_misaligned_inputs(dev):
    """The wgmma_xwide forward raises on inputs its TMA copies cannot read,
    before any launch; it never hands them to the wide variant."""
    B, T, H, D = 1, 64, 2, 512
    flat = torch.randn(B * T * H * D + 1, device=dev, dtype=torch.bfloat16)
    q = flat[1:].view(B, T, H, D)                     # base 2 bytes off
    k = torch.randn(B, T, H, D, device=dev, dtype=torch.bfloat16)
    common.reset_counts()
    with pytest.raises(ValueError, match="wgmma_xwide variant.*16-byte"):
        flash_attention(q, k, k)
    wide = torch.randn(B, T, H * D + 4, device=dev, dtype=torch.bfloat16)
    k2 = wide[..., :H * D].view(B, T, H, D)           # T stride 1028
    with pytest.raises(ValueError, match="wgmma_xwide variant.*T stride 1028"):
        _flash_cuda(k, k, k2)
    assert common.launch_counts() == {}
    with pytest.raises(ValueError, match="wgmma_xwide variant"):
        _flash_wgmma_xwide_cuda(*_qkv(dev, 1, 8, 8, 2, 512, torch.float32))


# ---------------------------------------------------------------------------
# flash backward: the tensor-core wgmma_xwide variant, bf16 at D 320-512
# ---------------------------------------------------------------------------
XWIDE_AUTOGRAD_REL = 6.5e-3
WGMMA_XWIDE_BWD_CASES = [
    # (B, Tq, Tk, H, D, causal); CTAs own 64 rows, tiles stream 64 rows at
    # D 320 and 32 above; dK/dV CTAs hold one of two column windows; D 257
    # pads to 320, 400 to 448
    (1, 1, 1, 2, 512, True),
    (1, 1, 1, 2, 320, False),
    (2, 63, 63, 2, 512, True),
    (1, 65, 65, 2, 384, True),
    (1, 127, 127, 3, 257, False),
    (1, 129, 129, 2, 448, True),
    (1, 129, 129, 2, 400, True),
    (1, 1000, 3000, 2, 512, False),
    (1, 1000, 3000, 2, 320, False),
    (1, 20, 300, 2, 512, True),      # causal, Tq < Tk: keys 20.. dK=dV=0
    (1, 65, 200, 2, 400, True),
    (1, 300, 70, 2, 512, True),      # causal, Tq > Tk
    (1, 300, 70, 2, 384, True),
    (1, 1, 129, 2, 448, False),
    (2, 333, 333, 2, 320, True),
    (1, 777, 777, 4, 257, True),
]


@pytest.mark.parametrize("case", WGMMA_XWIDE_BWD_CASES)
def test_flash_bwd_wgmma_xwide_matches_plain(dev, case):
    """dQ and dK/dV of the wgmma_xwide variant against the plain backward
    (with an lse cotangent) within one bf16 ulp (2^-7 relative, 1e-3
    absolute for cancelling entries), against dense autograd within 6.5e-3
    of each gradient's largest entry, keys no query sees at zero, and two
    calls bit-identical."""
    B, Tq, Tk, H, D, causal = case
    q, k, v, o, lse, do, dlse = _flash_bwd_inputs(dev, *case, torch.bfloat16)
    for t in (q, k, v):                    # see test_flash_bwd_kernels_...
        torch.full_like(t, float("nan"))
    common.reset_counts()
    got = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.wgmma_xwide": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.wgmma_xwide": 1}
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, dlse, causal)
    auto = _dense_autograd_grads(q, k, v, do, dlse, causal)
    for gt, wt, at, name in zip(got, want, auto, ("dq", "dk", "dv")):
        assert gt.dtype == torch.bfloat16 and gt.shape == wt.shape
        assert gt.is_contiguous() and torch.isfinite(gt).all(), name
        np.testing.assert_allclose(_np(gt), _np(wt), err_msg=name,
                                   **BF16_GRAD_TOL)
        assert _rel_to_max(gt, at) <= XWIDE_AUTOGRAD_REL, name
    if causal and Tq < Tk:
        assert not got[1][:, Tq:].any() and not got[2][:, Tq:].any()
    again = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    for a, b in zip(got, again):           # no atomics: the same bits
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [320, 448, 512])
def test_flash_bwd_wgmma_xwide_reads_fused_qkv_views_and_strided_dout(dev,
                                                                      D):
    """q/k/v as views of one fused qkv product and a transposed dO give
    the same bits as contiguous copies."""
    B, T, H = 2, 333, 3
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, -1))
    o, lse = _flash_cuda(q, k, v)
    do = torch.randn(B, H, T, D, generator=g, device=dev,
                     dtype=torch.bfloat16).transpose(1, 2)
    assert not q.is_contiguous() and not do.is_contiguous()
    common.reset_counts()
    a = _flash_bwd_cuda(q, k, v, o, lse, do)
    assert common.launch_counts()[
        "kernels.launch.flash_attention_dq.wgmma_xwide"] == 1
    b = _flash_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(), o,
                        lse, do.contiguous())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_bwd_wgmma_xwide_refuses_misaligned_inputs(dev):
    """Misaligned q/k/v raise before any launch; a misaligned dO (an
    internal cotangent) is copied by the backward, and refused by the
    launchers themselves."""
    from mxnet_tpu_torch.ops.kernels.flash_attention import (
        _flash_dkv_wgmma_xwide_cuda, _flash_dq_wgmma_xwide_cuda)
    B, T, H, D = 1, 64, 2, 512
    q, k, v, o, lse, do, _ = _flash_bwd_inputs(dev, B, T, T, H, D, True,
                                               torch.bfloat16)
    flat = torch.randn(B * T * H * D + 1, device=dev, dtype=torch.bfloat16)
    bad = flat[1:].view(B, T, H, D)                   # base 2 bytes off
    bad.copy_(q)
    delta = _delta(o, do, None)
    common.reset_counts()
    with pytest.raises(ValueError, match="wgmma_xwide variant.*q's base"):
        _flash_bwd_cuda(bad, k, v, o, lse, do)
    for launch in (_flash_dq_wgmma_xwide_cuda, _flash_dkv_wgmma_xwide_cuda):
        with pytest.raises(ValueError, match="k's base address"):
            launch(q, bad, v, do, lse, delta)
        with pytest.raises(ValueError, match="dO's base address"):
            launch(q, k, v, bad, lse, delta)
        with pytest.raises(ValueError, match="takes bf16 with head_dim"):
            launch(q.float(), k.float(), v.float(), do.float(), lse, delta)
    assert common.launch_counts() == {}
    bad.copy_(do)
    got = _flash_bwd_cuda(q, k, v, o, lse, bad)
    want = _flash_bwd_cuda(q, k, v, o, lse, do)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_flash_autograd_bf16_head_dim_512_launches_wgmma_xwide(dev):
    """Autograd of ``flash_attention`` at bf16 head_dim 512: the forward,
    dQ and dK/dV on wgmma_xwide, one each."""
    B, T, H, D = 1, 130, 2, 512
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(B, T, H, D, generator=g, device=dev,
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    common.reset_counts()
    o, lse = flash_attention_lse(q, k, v)
    (o.float().square().sum() + lse.tanh().sum()).backward()
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.wgmma_xwide": 1,
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.wgmma_xwide": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.wgmma_xwide": 1}
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_flash_bwd_wgmma_xwide_does_not_spill(dev):
    """ptxas: dQ and dK/dV at 320, 384, 448 and 512 columns a CTA, alone
    (wgmma_xwide) and in 2-CTA clusters (wgmma_xxwide), 0 bytes of
    spills."""
    src = "flash_attention_bwd_wgmma_xwide"
    log = _build.build([src])[src]["log"]
    lines = [ln for ln in log.splitlines() if "spill stores" in ln]
    assert len(lines) == 16, log
    assert all(" 0 bytes spill stores, 0 bytes spill loads" in ln
               for ln in lines), log


# ---------------------------------------------------------------------------
# flash backward: wgmma_xxwide, bf16 at D 640-1024 (the wgmma_xwide dQ and
# dK/dV in 2-CTA clusters that split D)
# ---------------------------------------------------------------------------
WGMMA_XXWIDE_BWD_CASES = [
    # (B, Tq, Tk, H, D, causal); a pair of CTAs owns 64 query rows (dQ) or
    # 64 keys and a column window (dK/dV), each the wgmma_xwide layout over
    # half of D; 576 pads to 640, 700 to 768, 1000 to 1024
    (1, 1, 1, 2, 1024, True),
    (1, 1, 1, 1, 640, False),
    (2, 63, 63, 2, 576, True),
    (1, 65, 65, 2, 768, True),
    (1, 127, 127, 3, 1000, False),
    (1, 129, 129, 2, 896, True),
    (1, 129, 129, 2, 700, True),
    (1, 1000, 3000, 2, 1024, False),
    (1, 1000, 3000, 1, 576, False),
    (1, 20, 300, 2, 576, True),      # causal, Tq < Tk: keys 20.. dK=dV=0
    (1, 65, 200, 2, 896, True),
    (1, 300, 70, 2, 1024, True),     # causal, Tq > Tk
    (1, 300, 70, 2, 640, True),
    (1, 1, 129, 2, 768, False),
    (2, 333, 333, 2, 640, True),
    (1, 777, 777, 1, 1024, True),
    (1, 2000, 2000, 1, 1000, True),
]


@pytest.mark.parametrize("case", WGMMA_XXWIDE_BWD_CASES)
def test_flash_bwd_wgmma_xxwide_matches_plain(dev, case):
    """dQ and dK/dV of the wgmma_xxwide variant against the plain backward
    (with an lse cotangent) within one bf16 ulp (2^-7 relative, 1e-3
    absolute for cancelling entries), against dense autograd within 6.5e-3
    of each gradient's largest entry, keys no query sees at zero, one
    launch of each and none of wide, and two calls bit-identical."""
    B, Tq, Tk, H, D, causal = case
    q, k, v, o, lse, do, dlse = _flash_bwd_inputs(dev, *case, torch.bfloat16)
    for t in (q, k, v):                    # see test_flash_bwd_kernels_...
        torch.full_like(t, float("nan"))
    common.reset_counts()
    got = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.wgmma_xxwide": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.wgmma_xxwide": 1}
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, dlse, causal)
    auto = _dense_autograd_grads(q, k, v, do, dlse, causal)
    for gt, wt, at, name in zip(got, want, auto, ("dq", "dk", "dv")):
        assert gt.dtype == torch.bfloat16 and gt.shape == wt.shape
        assert gt.is_contiguous() and torch.isfinite(gt).all(), name
        np.testing.assert_allclose(_np(gt), _np(wt), err_msg=name,
                                   **BF16_GRAD_TOL)
        assert _rel_to_max(gt, at) <= XWIDE_AUTOGRAD_REL, name
    if causal and Tq < Tk:
        assert not got[1][:, Tq:].any() and not got[2][:, Tq:].any()
    again = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    for a, b in zip(got, again):           # no atomics: the same bits
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [576, 1024])
def test_flash_bwd_wgmma_xxwide_reads_fused_qkv_views_and_strided_dout(
        dev, D):
    """q/k/v as views of one fused qkv product and a transposed dO give
    the same bits as contiguous copies."""
    B, T, H = 2, 333, 3
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, -1))
    o, lse = _flash_cuda(q, k, v)
    do = torch.randn(B, H, T, D, generator=g, device=dev,
                     dtype=torch.bfloat16).transpose(1, 2)
    assert not q.is_contiguous() and not do.is_contiguous()
    common.reset_counts()
    a = _flash_bwd_cuda(q, k, v, o, lse, do)
    assert common.launch_counts()[
        "kernels.launch.flash_attention_dkv.wgmma_xxwide"] == 1
    b = _flash_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(), o,
                        lse, do.contiguous())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_bwd_wgmma_xxwide_refuses_misaligned_inputs(dev):
    """Misaligned q/k/v raise before any launch; a misaligned dO (an
    internal cotangent) is copied by the backward, and refused by the
    launchers themselves, as are f32 and a width not theirs."""
    from mxnet_tpu_torch.ops.kernels.flash_attention import (
        _flash_dkv_wgmma_xxwide_cuda, _flash_dq_wgmma_xxwide_cuda)
    B, T, H, D = 1, 64, 2, 1024
    q, k, v, o, lse, do, _ = _flash_bwd_inputs(dev, B, T, T, H, D, True,
                                               torch.bfloat16)
    flat = torch.randn(B * T * H * D + 1, device=dev, dtype=torch.bfloat16)
    bad = flat[1:].view(B, T, H, D)                   # base 2 bytes off
    bad.copy_(q)
    delta = _delta(o, do, None)
    common.reset_counts()
    with pytest.raises(ValueError, match="wgmma_xxwide variant.*q's base"):
        _flash_bwd_cuda(bad, k, v, o, lse, do)
    for launch in (_flash_dq_wgmma_xxwide_cuda,
                   _flash_dkv_wgmma_xxwide_cuda):
        with pytest.raises(ValueError, match="k's base address"):
            launch(q, bad, v, do, lse, delta)
        with pytest.raises(ValueError, match="dO's base address"):
            launch(q, k, v, bad, lse, delta)
        with pytest.raises(ValueError, match="takes bf16 with head_dim"):
            launch(q.float(), k.float(), v.float(), do.float(), lse, delta)
        half = [t[..., :512].contiguous() for t in (q, k, v, do)]
        with pytest.raises(ValueError, match="takes bf16 with head_dim"):
            launch(*half, lse, delta)
    assert common.launch_counts() == {}
    bad.copy_(do)
    got = _flash_bwd_cuda(q, k, v, o, lse, bad)
    want = _flash_bwd_cuda(q, k, v, o, lse, do)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_flash_autograd_bf16_head_dim_1024_launches_wgmma_xxwide(dev):
    """Autograd of ``flash_attention`` at bf16 head_dim 1024 with one head
    (the head_dim-1024 leg's layout): the forward, dQ and dK/dV on
    wgmma_xxwide, one each, none on wide."""
    B, T, H, D = 2, 130, 1, 1024
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(B, T, H, D, generator=g, device=dev,
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    common.reset_counts()
    o, lse = flash_attention_lse(q, k, v)
    (o.float().square().sum() + lse.tanh().sum()).backward()
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.wgmma_xxwide": 1,
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.wgmma_xxwide": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.wgmma_xxwide": 1}
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


# ---------------------------------------------------------------------------
# flash forward: the tensor-core tf32x3 variant, f32 at D 192 or 256
# ---------------------------------------------------------------------------
F32_FWD_TOL = dict(rtol=1e-4, atol=1e-5)
F32_LSE_TOL = dict(rtol=1e-5, atol=1e-4)
TF32X3_FWD_CASES = [
    # (B, Tq, Tk, H, D, causal); CTAs own 64 queries, key tiles of 64; D
    # 160 pads to 192
    (1, 1, 1, 2, 256, True),
    (1, 1, 1, 2, 192, False),
    (2, 63, 63, 2, 256, True),
    (1, 65, 65, 2, 192, True),
    (1, 127, 127, 3, 160, False),
    (1, 129, 129, 2, 256, True),
    (1, 1000, 3000, 2, 256, False),
    (1, 1000, 3000, 16, 192, False),
    (1, 4096, 4096, 16, 192, True),
    (1, 8192, 8192, 4, 256, True),   # the f32 head_dim-256 leg's shape
    (1, 777, 777, 4, 160, True),
    (1, 20, 300, 2, 256, True),      # causal, Tq < Tk (top-left aligned)
    (1, 300, 70, 2, 256, True),      # causal, Tq > Tk
    (1, 1, 129, 2, 256, False),
]


@pytest.mark.parametrize("case", TF32X3_FWD_CASES)
def test_flash_tf32x3_matches_plain(dev, case):
    """The tf32x3 forward (split-TF32 products for S and P·V) against the
    plain version at the f32 forward gates, o and lse, one launch of it,
    and two calls bit-identical."""
    B, Tq, Tk, H, D, causal = case
    q, k, v = _qkv(dev, B, Tq, Tk, H, D, torch.float32)
    common.reset_counts()
    o, lse = _flash_cuda(q, k, v, causal)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.tf32x3": 1}
    ro, rlse = flash_attention_reference(q, k, v, causal, return_lse=True)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert o.shape == q.shape and o.is_contiguous()
    np.testing.assert_allclose(_np(o), _np(ro), **F32_FWD_TOL)
    np.testing.assert_allclose(_np(lse), _np(rlse), **F32_LSE_TOL)
    o2, lse2 = _flash_cuda(q, k, v, causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("D", [192, 256, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tf32x3_kv_len_and_rows_without_keys(dev, D, causal):
    """``kv_len`` masks keys at and past it, as attending over the first
    kv_len keys; with kv_len 0 every row gets o = 0 and lse = -1e30."""
    q, k, v = _qkv(dev, 1, 200, 300, 2, D, torch.float32, seed=4)
    o, lse = _flash_tf32x3_cuda(q, k, v, causal, kv_len=0)
    assert not o.any() and bool((lse == -1e30).all())
    for kv_len in (150, 300 - 17):
        o, lse = _flash_tf32x3_cuda(q, k, v, causal, kv_len=kv_len)
        ro, rlse = flash_attention_reference(q, k[:, :kv_len],
                                             v[:, :kv_len], causal,
                                             return_lse=True)
        np.testing.assert_allclose(_np(o), _np(ro), **F32_FWD_TOL)
        np.testing.assert_allclose(_np(lse), _np(rlse), **F32_LSE_TOL)


@pytest.mark.parametrize("D", [192, 256, 64, 128])
def test_flash_tf32x3_reads_fused_qkv_views(dev, D):
    """f32 q/k/v as [B, T, H, D] views of one [B, T, 3·H·D] product: no
    copy, the same bits as contiguous copies."""
    B, T, H = 2, 333, 3
    g = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device=dev)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, -1))
    assert not q.is_contiguous()
    o, lse = _flash_tf32x3_cuda(q, k, v)
    o2, lse2 = _flash_tf32x3_cuda(q.contiguous(), k.contiguous(),
                                  v.contiguous())
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = flash_attention_reference(q, k, v, return_lse=True)
    np.testing.assert_allclose(_np(o), _np(ro), **F32_FWD_TOL)
    np.testing.assert_allclose(_np(lse), _np(rlse), **F32_LSE_TOL)


def test_flash_tf32x3_refuses_misaligned_inputs(dev):
    """The tf32x3 forward raises on inputs its 16-byte copies cannot read,
    and on bf16 or another head_dim, before any launch; it never hands
    them to the wide variant."""
    B, T, H, D = 1, 64, 2, 256
    flat = torch.randn(B * T * H * D + 1, device=dev)
    q = flat[1:].view(B, T, H, D)                     # base 4 bytes off
    k = torch.randn(B, T, H, D, device=dev)
    common.reset_counts()
    with pytest.raises(ValueError, match="tf32x3 variant.*16-byte"):
        flash_attention(q, k, k)
    wide = torch.randn(B, T, H * D + 2, device=dev)
    k2 = wide[..., :H * D].view(B, T, H, D)           # T stride 514
    with pytest.raises(ValueError, match="tf32x3 variant.*T stride 514"):
        _flash_cuda(k, k, k2)
    for t in (k.to(torch.bfloat16), k[..., :96].contiguous()):
        with pytest.raises(ValueError, match="tf32x3 variant.*takes float32"):
            _flash_tf32x3_cuda(t, t, t)
    assert common.launch_counts() == {}



TF32X3_NARROW_FWD_CASES = [
    # (B, Tq, Tk, H, D, causal, kv_len); 40 pads to 64, 96 to 128
    (2, 1024, 1024, 8, 64, True, None),
    (1, 8192, 8192, 16, 64, True, None),     # the f32 long-context leg's
    (1, 4096, 4096, 16, 128, True, None),
    (1, 777, 777, 4, 40, True, None),
    (1, 777, 777, 4, 96, False, None),
    (1, 1000, 3000, 16, 64, False, None),
    (1, 1, 1, 2, 64, True, None),
    (2, 63, 63, 2, 128, True, None),
    (1, 65, 65, 2, 40, False, None),
    (1, 300, 70, 2, 96, True, None),         # causal, Tq > Tk
    (1, 20, 300, 2, 128, True, None),        # causal, Tq < Tk
    (1, 200, 300, 2, 64, True, 150),         # kv_len < Tk
    (1, 200, 300, 2, 128, False, 283),
    (1, 130, 300, 3, 40, False, 77),
    (1, 300, 200, 3, 96, True, 1),
]


@pytest.mark.parametrize("case", TF32X3_NARROW_FWD_CASES)
def test_flash_tf32x3_narrow_forward_matches_plain(dev, case):
    """The tf32x3 forward's narrow plan (f32 at head_dim 33-128, run at 64
    or 128) through ``_flash_cuda`` against the plain version over the
    first kv_len keys at the f32 forward gates, o and lse, one launch of it
    and none of simt, and two calls bit-identical."""
    B, Tq, Tk, H, D, causal, kv_len = case
    q, k, v = _qkv(dev, B, Tq, Tk, H, D, torch.float32, seed=D)
    common.reset_counts()
    o, lse = _flash_cuda(q, k, v, causal, None, kv_len)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.tf32x3": 1}
    n = Tk if kv_len is None else kv_len
    ro, rlse = flash_attention_reference(q, k[:, :n], v[:, :n], causal,
                                         return_lse=True)
    assert o.dtype == torch.float32 and o.shape == q.shape
    assert o.is_contiguous()
    np.testing.assert_allclose(_np(o), _np(ro), **F32_FWD_TOL)
    np.testing.assert_allclose(_np(lse), _np(rlse), **F32_LSE_TOL)
    o2, lse2 = _flash_cuda(q, k, v, causal, None, kv_len)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)

def _dense64(q, k, v, causal):
    """Dense attention in float64 (the exact reference): o and lse."""
    qd, kd, vd = (t.double() for t in (q, k, v))
    D, Tq, Tk = q.shape[-1], q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / D ** 0.5
    if causal:
        keep = (torch.arange(Tq, device=q.device)[:, None]
                >= torch.arange(Tk, device=q.device)[None, :])
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, -1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]), vd)
    return o, lse


@pytest.mark.parametrize("D", [192, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tf32x3_fwd_bwd_against_float64_autograd(dev, D, causal):
    """Forward and backward through ``flash_attention_lse`` (the tf32x3
    forward, dQ and dK/dV, one launch each) against autograd through
    dense attention in float64: o and lse at the f32 forward gates, each
    gradient within 1e-4 of its largest entry."""
    B, T, H = 1, 700, 2
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn(B, T, H, D, generator=g, device=dev,
                           requires_grad=True) for _ in range(3))
    do = torch.randn(B, T, H, D, generator=g, device=dev)
    dlse = torch.randn(B, H, T, generator=g, device=dev)
    common.reset_counts()
    o, lse = flash_attention_lse(q, k, v, causal)
    got = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.tf32x3": 1,
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.tf32x3": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.tf32x3": 1}
    leaves = tuple(t.detach().double().requires_grad_(True)
                   for t in (q, k, v))
    o64, lse64 = _dense64(*leaves, causal)
    want = torch.autograd.grad((o64, lse64), leaves,
                               (do.double(), dlse.double()))
    np.testing.assert_allclose(_np(o.detach()), o64.detach().cpu().numpy(),
                               **F32_FWD_TOL)
    np.testing.assert_allclose(_np(lse.detach()),
                               lse64.detach().cpu().numpy(), **F32_LSE_TOL)
    for gt, wt, name in zip(got, want, ("dq", "dk", "dv")):
        assert _rel_to_max(gt.double(), wt) <= 1e-4, name


# ---------------------------------------------------------------------------
# flash backward: the tensor-core tf32x3 variant, f32 at D 192 or 256
# ---------------------------------------------------------------------------
TF32X3_BWD_CASES = [
    # (B, Tq, Tk, H, D, causal); CTAs own 64 rows, tiles stream 32; D 160
    # pads to 192
    (1, 1, 1, 2, 256, True),
    (1, 1, 1, 2, 192, False),
    (2, 63, 63, 2, 256, True),
    (1, 65, 65, 2, 192, True),
    (1, 127, 127, 3, 160, False),
    (1, 129, 129, 2, 256, True),
    (1, 1000, 3000, 2, 256, False),
    (1, 1000, 3000, 2, 192, False),
    (1, 20, 300, 2, 256, True),      # causal, Tq < Tk: keys 20.. dK=dV=0
    (1, 65, 200, 2, 160, True),
    (1, 300, 70, 2, 256, True),      # causal, Tq > Tk
    (1, 1, 129, 2, 256, False),
]


@pytest.mark.parametrize("case", TF32X3_BWD_CASES)
def test_flash_bwd_tf32x3_matches_plain(dev, case):
    """dQ and dK/dV of the tf32x3 variant (split-TF32 products) against the
    plain backward (with an lse cotangent) at the f32 gradient tolerances,
    against dense autograd within 1e-4 of each gradient's largest entry,
    keys no query sees at zero, and two calls bit-identical."""
    B, Tq, Tk, H, D, causal = case
    q, k, v, o, lse, do, dlse = _flash_bwd_inputs(dev, *case, torch.float32)
    for t in (q, k, v):                    # see test_flash_bwd_kernels_...
        torch.full_like(t, float("nan"))
    common.reset_counts()
    got = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.tf32x3": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.tf32x3": 1}
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, dlse, causal)
    auto = _dense_autograd_grads(q, k, v, do, dlse, causal)
    for gt, wt, at, name in zip(got, want, auto, ("dq", "dk", "dv")):
        assert gt.dtype == torch.float32 and gt.shape == wt.shape
        assert gt.is_contiguous() and torch.isfinite(gt).all(), name
        np.testing.assert_allclose(_np(gt), _np(wt), err_msg=name,
                                   **F32_GRAD_TOL)
        assert _rel_to_max(gt, at) <= 1e-4, name
    if causal and Tq < Tk:
        assert not got[1][:, Tq:].any() and not got[2][:, Tq:].any()
    again = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    for a, b in zip(got, again):           # no atomics: the same bits
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [192, 256])
def test_flash_bwd_tf32x3_reads_fused_qkv_views_and_strided_dout(dev, D):
    """f32 q/k/v as views of one fused qkv product and a transposed dO give
    the same bits as contiguous copies."""
    B, T, H = 2, 333, 3
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device=dev)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, -1))
    o, lse = _flash_cuda(q, k, v)
    do = torch.randn(B, H, T, D, generator=g, device=dev).transpose(1, 2)
    assert not q.is_contiguous() and not do.is_contiguous()
    common.reset_counts()
    a = _flash_bwd_cuda(q, k, v, o, lse, do)
    assert common.launch_counts()[
        "kernels.launch.flash_attention_dq.tf32x3"] == 1
    b = _flash_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(), o,
                        lse, do.contiguous())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_bwd_tf32x3_refuses_misaligned_inputs(dev):
    """Misaligned f32 q/k/v raise before any launch; a misaligned dO (an
    internal cotangent) is copied by the backward, and refused by the
    launchers themselves; bf16 or another head_dim is refused too, never
    handed to the wide kernels."""
    from mxnet_tpu_torch.ops.kernels.flash_attention import (
        _flash_dkv_tf32x3_cuda, _flash_dq_tf32x3_cuda)
    B, T, H, D = 1, 64, 2, 256
    q, k, v, o, lse, do, _ = _flash_bwd_inputs(dev, B, T, T, H, D, True,
                                               torch.float32)
    flat = torch.randn(B * T * H * D + 1, device=dev)
    bad = flat[1:].view(B, T, H, D)                   # base 4 bytes off
    bad.copy_(q)
    delta = _delta(o, do, None)
    common.reset_counts()
    with pytest.raises(ValueError, match="tf32x3 variant.*q's base"):
        _flash_bwd_cuda(bad, k, v, o, lse, do)
    for launch in (_flash_dq_tf32x3_cuda, _flash_dkv_tf32x3_cuda):
        with pytest.raises(ValueError, match="k's base address"):
            launch(q, bad, v, do, lse, delta)
        with pytest.raises(ValueError, match="dO's base address"):
            launch(q, k, v, bad, lse, delta)
        with pytest.raises(ValueError, match="tf32x3 variant.*takes float32"):
            launch(*(t.to(torch.bfloat16) for t in (q, k, v, do)), lse,
                   delta)
    assert common.launch_counts() == {}
    bad.copy_(do)
    got = _flash_bwd_cuda(q, k, v, o, lse, bad)
    want = _flash_bwd_cuda(q, k, v, o, lse, do)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_flash_autograd_f32_head_dim_256_launches_tf32x3(dev):
    """Autograd of ``flash_attention`` at f32 head_dim 256: the forward,
    dQ and dK/dV on tf32x3, one each, and no wide kernel."""
    B, T, H, D = 1, 130, 2, 256
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(B, T, H, D, generator=g, device=dev,
                           requires_grad=True) for _ in range(3))
    common.reset_counts()
    o, lse = flash_attention_lse(q, k, v)
    (o.square().sum() + lse.tanh().sum()).backward()
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.tf32x3": 1,
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.tf32x3": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.tf32x3": 1}
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


# ---------------------------------------------------------------------------
# flash backward: the tensor-core tf32x3 variant's narrow plan, f32 at D
# 33-128 (run at 64 or 128; the forward stays simt there)
# ---------------------------------------------------------------------------
TF32X3_NARROW_BWD_CASES = [
    # (B, Tq, Tk, H, D, causal); CTAs own 64 rows at 64 and 128 at 128,
    # tiles stream 64 and 32 rows; 40 pads to 64, 96 and 100 to 128
    (1, 1, 1, 2, 64, True),          # a single row
    (1, 1, 1, 2, 128, False),
    (2, 63, 63, 2, 64, True),
    (1, 65, 65, 2, 128, True),
    (1, 127, 127, 3, 40, False),
    (1, 129, 129, 2, 96, True),
    (1, 257, 257, 2, 64, True),
    (1, 1000, 3000, 2, 64, False),
    (1, 1000, 3000, 2, 128, False),
    (1, 20, 300, 2, 64, True),       # causal, Tq < Tk: keys 20.. dK=dV=0
    (1, 65, 200, 2, 100, True),
    (1, 300, 70, 2, 128, True),      # causal, Tq > Tk
    (1, 300, 70, 2, 40, False),
]


@pytest.mark.parametrize("case", TF32X3_NARROW_BWD_CASES)
def test_flash_bwd_tf32x3_narrow_matches_plain(dev, case):
    """dQ and dK/dV of tf32x3 at 64 and 128 (split-TF32 products, each warp
    16 rows over all of D) against the plain backward (with an lse
    cotangent) at the f32 gradient tolerances, against dense autograd
    within 1e-4 of each gradient's largest entry, keys no query sees at
    zero, and two calls bit-identical."""
    B, Tq, Tk, H, D, causal = case
    q, k, v, o, lse, do, dlse = _flash_bwd_inputs(dev, *case, torch.float32)
    for t in (q, k, v):                    # see test_flash_bwd_kernels_...
        torch.full_like(t, float("nan"))
    common.reset_counts()
    got = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.tf32x3": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.tf32x3": 1}
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, dlse, causal)
    auto = _dense_autograd_grads(q, k, v, do, dlse, causal)
    for gt, wt, at, name in zip(got, want, auto, ("dq", "dk", "dv")):
        assert gt.dtype == torch.float32 and gt.shape == wt.shape
        assert gt.is_contiguous() and torch.isfinite(gt).all(), name
        np.testing.assert_allclose(_np(gt), _np(wt), err_msg=name,
                                   **F32_GRAD_TOL)
        assert _rel_to_max(gt, at) <= 1e-4, name
    if causal and Tq < Tk:
        assert not got[1][:, Tq:].any() and not got[2][:, Tq:].any()
    again = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    for a, b in zip(got, again):           # no atomics: the same bits
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_tf32x3_narrow_kv_len_and_keys_no_query_sees(dev, D,
                                                              causal):
    """The backward of attention over the first kv_len keys (the simt
    forward with ``kv_len`` on all 300 keys gives the o and lse of the
    first kv_len): the tf32x3 dQ and dK/dV on k[:, :kv_len] against the
    plain backward; with causal and 60 queries, the keys past 60 that no
    query sees get dK = dV = 0."""
    B, Tq, Tk, H = 1, 60, 300, 2
    g = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn(B, Tq, H, D, generator=g, device=dev)
    k, v = (torch.randn(B, Tk, H, D, generator=g, device=dev)
            for _ in range(2))
    do = torch.randn(B, Tq, H, D, generator=g, device=dev)
    for kv_len in (150, 300 - 17):
        o, lse = _flash_simt_cuda(q, k, v, causal, kv_len=kv_len)
        ks, vs = k[:, :kv_len], v[:, :kv_len]
        common.reset_counts()
        got = _flash_bwd_cuda(q, ks, vs, o, lse, do, None, causal)
        assert common.launch_counts()[
            "kernels.launch.flash_attention_dkv.tf32x3"] == 1
        want = flash_attention_bwd_reference(q, ks, vs, o, lse, do, None,
                                             causal)
        for gt, wt, name in zip(got, want, ("dq", "dk", "dv")):
            assert gt.shape == wt.shape, name
            np.testing.assert_allclose(_np(gt), _np(wt), err_msg=name,
                                       **F32_GRAD_TOL)
        if causal:
            assert not got[1][:, Tq:].any() and not got[2][:, Tq:].any()


@pytest.mark.parametrize("D", [64, 128])
def test_flash_bwd_tf32x3_narrow_reads_fused_qkv_views_and_strided_dout(
        dev, D):
    """f32 q/k/v as views of one fused qkv product and a transposed dO give
    the same bits as contiguous copies, at 64 and 128."""
    B, T, H = 2, 333, 3
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device=dev)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, -1))
    o, lse = _flash_cuda(q, k, v)
    do = torch.randn(B, H, T, D, generator=g, device=dev).transpose(1, 2)
    assert not q.is_contiguous() and not do.is_contiguous()
    common.reset_counts()
    a = _flash_bwd_cuda(q, k, v, o, lse, do)
    assert common.launch_counts()[
        "kernels.launch.flash_attention_dq.tf32x3"] == 1
    b = _flash_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(), o,
                        lse, do.contiguous())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_bwd_tf32x3_narrow_refuses_misaligned_inputs(dev):
    """At f32 head_dim 64: misaligned q/k/v raise before any launch; a
    misaligned dO is copied by the backward, and refused by the launchers
    themselves; bf16, and f32 at a width that is not 64, 128, 192 or 256,
    are refused too, never handed to the simt kernels."""
    from mxnet_tpu_torch.ops.kernels.flash_attention import (
        _flash_dkv_tf32x3_cuda, _flash_dq_tf32x3_cuda)
    B, T, H, D = 1, 64, 2, 64
    q, k, v, o, lse, do, _ = _flash_bwd_inputs(dev, B, T, T, H, D, True,
                                               torch.float32)
    flat = torch.randn(B * T * H * D + 1, device=dev)
    bad = flat[1:].view(B, T, H, D)                   # base 4 bytes off
    bad.copy_(q)
    delta = _delta(o, do, None)
    common.reset_counts()
    with pytest.raises(ValueError, match="tf32x3 variant.*q's base"):
        _flash_bwd_cuda(bad, k, v, o, lse, do)
    for launch in (_flash_dq_tf32x3_cuda, _flash_dkv_tf32x3_cuda):
        with pytest.raises(ValueError, match="k's base address"):
            launch(q, bad, v, do, lse, delta)
        with pytest.raises(ValueError, match="dO's base address"):
            launch(q, k, v, bad, lse, delta)
        with pytest.raises(ValueError, match="tf32x3 variant.*takes float32"):
            launch(*(t.to(torch.bfloat16) for t in (q, k, v, do)), lse,
                   delta)
        with pytest.raises(ValueError, match="tf32x3 variant.*head_dim 32"):
            launch(*(t[..., :32] for t in (q, k, v, do)), lse, delta)
    assert common.launch_counts() == {}
    bad.copy_(do)
    got = _flash_bwd_cuda(q, k, v, o, lse, bad)
    want = _flash_bwd_cuda(q, k, v, o, lse, do)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tf32x3_narrow_fwd_bwd_against_float64_autograd(dev, D,
                                                              causal):
    """Forward and backward through ``flash_attention_lse`` at f32 head_dim
    64 and 128 (the tf32x3 forward, dQ and dK/dV of the narrow plans, one
    launch each) against autograd through dense attention in float64: o
    and lse at the f32 forward gates, each gradient within 1e-4 of its
    largest entry."""
    B, T, H = 1, 700, 2
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn(B, T, H, D, generator=g, device=dev,
                           requires_grad=True) for _ in range(3))
    do = torch.randn(B, T, H, D, generator=g, device=dev)
    dlse = torch.randn(B, H, T, generator=g, device=dev)
    common.reset_counts()
    o, lse = flash_attention_lse(q, k, v, causal)
    got = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.tf32x3": 1,
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.tf32x3": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.tf32x3": 1}
    leaves = tuple(t.detach().double().requires_grad_(True)
                   for t in (q, k, v))
    o64, lse64 = _dense64(*leaves, causal)
    want = torch.autograd.grad((o64, lse64), leaves,
                               (do.double(), dlse.double()))
    np.testing.assert_allclose(_np(o.detach()), o64.detach().cpu().numpy(),
                               **F32_FWD_TOL)
    np.testing.assert_allclose(_np(lse.detach()),
                               lse64.detach().cpu().numpy(), **F32_LSE_TOL)
    for gt, wt, name in zip(got, want, ("dq", "dk", "dv")):
        assert _rel_to_max(gt.double(), wt) <= 1e-4, name


def test_flash_bwd_tf32x3_does_not_spill(dev):
    """ptxas: every dQ and dK/dV instantiation of tf32x3 (the narrow plan
    at 64 and 128; 192 and 256 alone and in 2-CTA clusters), 0 bytes of
    spills."""
    src = "flash_attention_bwd_tf32x3"
    log = _build.build([src])[src]["log"]
    lines = [ln for ln in log.splitlines() if "spill stores" in ln]
    assert len(lines) == 12, log
    assert all(" 0 bytes spill stores, 0 bytes spill loads" in ln
               for ln in lines), log


# ---------------------------------------------------------------------------
# flash backward: the tensor-core tf32x3_xwide variant, f32 at D 257-512
# (run at 384 or 512 by 2-CTA clusters that split D)
# ---------------------------------------------------------------------------
TF32X3_XWIDE_BWD_CASES = [
    # (B, Tq, Tk, H, D, causal); 257 and 320 pad to 384, 400 and 448 to 512
    (1, 1, 1, 2, 512, True),         # a single row
    (1, 1, 129, 2, 384, False),
    (2, 63, 63, 2, 512, True),
    (1, 65, 65, 2, 257, True),
    (1, 127, 127, 3, 320, False),
    (1, 129, 129, 2, 400, True),
    (1, 1000, 3000, 2, 320, False),
    (1, 1000, 3000, 2, 512, False),
    (1, 20, 300, 2, 384, True),      # causal, Tq < Tk: keys 20.. dK=dV=0
    (1, 65, 200, 2, 448, True),
    (1, 300, 70, 2, 512, True),      # causal, Tq > Tk
    (1, 300, 70, 2, 448, False),
]


@pytest.mark.parametrize("case", TF32X3_XWIDE_BWD_CASES)
def test_flash_bwd_tf32x3_xwide_matches_plain(dev, case):
    """dQ and dK/dV of the tf32x3_xwide variant (split-TF32 products, D
    split across a 2-CTA cluster) against the plain backward (with an lse
    cotangent) at the f32 gradient tolerances, against dense autograd
    within 1e-4 of each gradient's largest entry, keys no query sees at
    zero, and two calls bit-identical."""
    B, Tq, Tk, H, D, causal = case
    q, k, v, o, lse, do, dlse = _flash_bwd_inputs(dev, *case, torch.float32)
    for t in (q, k, v):                    # see test_flash_bwd_kernels_...
        torch.full_like(t, float("nan"))
    common.reset_counts()
    got = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.tf32x3_xwide": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.tf32x3_xwide": 1}
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, dlse, causal)
    auto = _dense_autograd_grads(q, k, v, do, dlse, causal)
    for gt, wt, at, name in zip(got, want, auto, ("dq", "dk", "dv")):
        assert gt.dtype == torch.float32 and gt.shape == wt.shape
        assert gt.is_contiguous() and torch.isfinite(gt).all(), name
        np.testing.assert_allclose(_np(gt), _np(wt), err_msg=name,
                                   **F32_GRAD_TOL)
        assert _rel_to_max(gt, at) <= 1e-4, name
    if causal and Tq < Tk:
        assert not got[1][:, Tq:].any() and not got[2][:, Tq:].any()
    again = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    for a, b in zip(got, again):           # no atomics: the same bits
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [320, 512])
def test_flash_bwd_tf32x3_xwide_reads_fused_qkv_views_and_strided_dout(dev,
                                                                       D):
    """f32 q/k/v as views of one fused qkv product and a transposed dO give
    the same bits as contiguous copies (at 512 the views go to the kernels
    uncopied; 320 is padded to 384 first)."""
    B, T, H = 2, 333, 3
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device=dev)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, -1))
    o, lse = _flash_cuda(q, k, v)
    do = torch.randn(B, H, T, D, generator=g, device=dev).transpose(1, 2)
    assert not q.is_contiguous() and not do.is_contiguous()
    common.reset_counts()
    a = _flash_bwd_cuda(q, k, v, o, lse, do)
    assert common.launch_counts()[
        "kernels.launch.flash_attention_dq.tf32x3_xwide"] == 1
    b = _flash_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(), o,
                        lse, do.contiguous())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_bwd_tf32x3_xwide_refuses_misaligned_inputs(dev):
    """Misaligned f32 q/k/v raise before any launch; a misaligned dO (an
    internal cotangent) is copied by the backward, and refused by the
    launchers themselves; bf16 or another head_dim is refused too, never
    handed to the wide kernels."""
    from mxnet_tpu_torch.ops.kernels.flash_attention import (
        _flash_dkv_tf32x3_xwide_cuda, _flash_dq_tf32x3_xwide_cuda)
    B, T, H, D = 1, 64, 2, 512
    q, k, v, o, lse, do, _ = _flash_bwd_inputs(dev, B, T, T, H, D, True,
                                               torch.float32)
    flat = torch.randn(B * T * H * D + 1, device=dev)
    bad = flat[1:].view(B, T, H, D)                   # base 4 bytes off
    bad.copy_(q)
    delta = _delta(o, do, None)
    common.reset_counts()
    with pytest.raises(ValueError, match="tf32x3_xwide variant.*q's base"):
        _flash_bwd_cuda(bad, k, v, o, lse, do)
    for launch in (_flash_dq_tf32x3_xwide_cuda, _flash_dkv_tf32x3_xwide_cuda):
        with pytest.raises(ValueError, match="k's base address"):
            launch(q, bad, v, do, lse, delta)
        with pytest.raises(ValueError, match="dO's base address"):
            launch(q, k, v, bad, lse, delta)
        with pytest.raises(ValueError,
                           match="tf32x3_xwide variant.*takes float32"):
            launch(*(t.to(torch.bfloat16) for t in (q, k, v, do)), lse,
                   delta)
        with pytest.raises(ValueError,
                           match="tf32x3_xwide variant.*head_dim 448"):
            launch(*(t[..., :448] for t in (q, k, v, do)), lse, delta)
    assert common.launch_counts() == {}
    bad.copy_(do)
    got = _flash_bwd_cuda(q, k, v, o, lse, bad)
    want = _flash_bwd_cuda(q, k, v, o, lse, do)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_flash_autograd_f32_head_dim_512_launches_tf32x3_xwide(dev):
    """Autograd of ``flash_attention`` at f32 head_dim 512: the forward,
    dQ and dK/dV on tf32x3_xwide, one each."""
    B, T, H, D = 1, 130, 2, 512
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(B, T, H, D, generator=g, device=dev,
                           requires_grad=True) for _ in range(3))
    common.reset_counts()
    o, lse = flash_attention_lse(q, k, v)
    (o.square().sum() + lse.tanh().sum()).backward()
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.tf32x3_xwide": 1,
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.tf32x3_xwide": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.tf32x3_xwide": 1}
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


# ---------------------------------------------------------------------------
# flash forward in 2-CTA clusters that split D: tf32x3_xwide (f32 at
# 257-512, run at 384 or 512) and wgmma_xxwide (bf16 at 513-1024, run at
# 640, 768, 896 or 1024)
# ---------------------------------------------------------------------------
TF32X3_XWIDE_FWD_CASES = [
    # (B, Tq, Tk, H, D, causal); a pair of CTAs owns 64 query rows, key
    # tiles of 64; 257 and 320 pad to 384, 400 and 448 to 512
    (1, 1, 1, 2, 512, True),         # a single row
    (1, 1, 129, 2, 384, False),
    (2, 63, 63, 2, 512, True),
    (1, 65, 65, 2, 257, True),
    (1, 127, 127, 3, 320, False),
    (1, 129, 129, 2, 400, True),
    (1, 1000, 3000, 2, 320, False),
    (1, 1000, 3000, 2, 512, False),
    (1, 2000, 2000, 2, 448, True),
    (1, 20, 300, 2, 384, True),      # causal, Tq < Tk (top-left aligned)
    (1, 300, 70, 2, 512, True),      # causal, Tq > Tk
    (2, 333, 333, 2, 512, True),
]


@pytest.mark.parametrize("case", TF32X3_XWIDE_FWD_CASES)
def test_flash_tf32x3_xwide_matches_plain(dev, case):
    """The tf32x3_xwide forward (split-TF32 products, D split across a
    2-CTA cluster) against the plain version at the f32 forward gates, o
    and lse, one launch of it and none of wide, and two calls
    bit-identical."""
    B, Tq, Tk, H, D, causal = case
    q, k, v = _qkv(dev, B, Tq, Tk, H, D, torch.float32)
    common.reset_counts()
    o, lse = _flash_cuda(q, k, v, causal)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.tf32x3_xwide": 1}
    ro, rlse = flash_attention_reference(q, k, v, causal, return_lse=True)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert o.shape == q.shape and o.is_contiguous()
    np.testing.assert_allclose(_np(o), _np(ro), **F32_FWD_TOL)
    np.testing.assert_allclose(_np(lse), _np(rlse), **F32_LSE_TOL)
    o2, lse2 = _flash_cuda(q, k, v, causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


WGMMA_XXWIDE_FWD_CASES = [
    # (B, Tq, Tk, H, D, causal); a pair of CTAs owns 64 query rows, each
    # the wgmma_xwide layout over half of D; 513 and 576 pad to 640, 700
    # to 768, 1000 to 1024
    (1, 1, 1, 2, 1024, True),
    (1, 1, 129, 2, 640, False),
    (2, 63, 63, 2, 576, True),
    (1, 65, 65, 2, 513, True),
    (1, 127, 127, 3, 768, False),
    (1, 129, 129, 2, 896, True),
    (1, 129, 129, 2, 700, True),
    (1, 1000, 3000, 2, 1024, False),
    (1, 1000, 3000, 2, 576, False),
    (1, 2000, 2000, 2, 1000, True),
    (1, 20, 300, 2, 576, True),      # causal, Tq < Tk (top-left aligned)
    (1, 300, 70, 2, 1024, True),     # causal, Tq > Tk
    (2, 333, 333, 2, 640, True),
]


@pytest.mark.parametrize("case", WGMMA_XXWIDE_FWD_CASES)
def test_flash_wgmma_xxwide_matches_plain(dev, case):
    """The wgmma_xxwide forward (D split across a 2-CTA cluster) against
    the plain version: o within one bf16 rounding, lse within 1e-4 +
    1e-5·|lse|, one launch of it and none of wide, and two calls
    bit-identical."""
    B, Tq, Tk, H, D, causal = case
    q, k, v = _qkv(dev, B, Tq, Tk, H, D)
    common.reset_counts()
    o, lse = _flash_cuda(q, k, v, causal)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.wgmma_xxwide": 1}
    ro, rlse = flash_attention_reference(q, k, v, causal, return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert o.shape == q.shape and o.is_contiguous()
    np.testing.assert_allclose(_np(o), _np(ro), **BF16_ONE_ROUNDING)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-5, atol=1e-4)
    o2, lse2 = _flash_cuda(q, k, v, causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


CLUSTER_FWD = {"tf32x3_xwide": (_flash_tf32x3_xwide_cuda, torch.float32,
                                (384, 512)),
               "wgmma_xxwide": (_flash_wgmma_xxwide_cuda, torch.bfloat16,
                                (640, 1024))}


def _cluster_fwd_tol(dtype):
    if dtype == torch.float32:
        return F32_FWD_TOL, F32_LSE_TOL
    return BF16_ONE_ROUNDING, dict(rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("variant", sorted(CLUSTER_FWD))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_cluster_forwards_kv_len_and_rows_without_keys(dev, variant,
                                                             causal):
    """``kv_len`` masks keys at and past it, as attending over the first
    kv_len keys (Tq != Tk); with kv_len 0 every row gets o = 0 and lse =
    -1e30, in both CTAs of each pair."""
    launch, dtype, widths = CLUSTER_FWD[variant]
    tol, lse_tol = _cluster_fwd_tol(dtype)
    for D in widths:
        q, k, v = _qkv(dev, 1, 200, 300, 2, D, dtype, seed=4)
        o, lse = launch(q, k, v, causal, kv_len=0)
        assert not o.any() and bool((lse == -1e30).all())
        for kv_len in (150, 300 - 17):
            o, lse = launch(q, k, v, causal, kv_len=kv_len)
            ro, rlse = flash_attention_reference(q, k[:, :kv_len],
                                                 v[:, :kv_len], causal,
                                                 return_lse=True)
            np.testing.assert_allclose(_np(o), _np(ro), **tol)
            np.testing.assert_allclose(_np(lse), _np(rlse), **lse_tol)


@pytest.mark.parametrize("variant", sorted(CLUSTER_FWD))
def test_flash_cluster_forwards_read_fused_qkv_views(dev, variant):
    """q/k/v as [B, T, H, D] views of one [B, T, 3·H·D] product: no copy,
    the same bits as contiguous copies, at both ends of the variant's
    widths."""
    launch, dtype, widths = CLUSTER_FWD[variant]
    tol, lse_tol = _cluster_fwd_tol(dtype)
    B, T, H = 2, 333, 3
    g = torch.Generator(device=dev).manual_seed(3)
    for D in widths:
        qkv = torch.randn(B, T, 3 * H * D, generator=g, device=dev).to(dtype)
        q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, -1))
        assert not q.is_contiguous()
        o, lse = launch(q, k, v)
        o2, lse2 = launch(q.contiguous(), k.contiguous(), v.contiguous())
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        ro, rlse = flash_attention_reference(q, k, v, return_lse=True)
        np.testing.assert_allclose(_np(o), _np(ro), **tol)
        np.testing.assert_allclose(_np(lse), _np(rlse), **lse_tol)


@pytest.mark.parametrize("dtype,D", [(torch.float32, 448),
                                     (torch.bfloat16, 576)])
def test_flash_cluster_forwards_lse_through_flash_attention_lse(dev, dtype,
                                                                D):
    """``flash_attention_lse`` at a width the cluster forwards take: the
    kernel's o and lse, the plain version's values."""
    q, k, v = _qkv(dev, 2, 300, 300, 2, D, dtype, seed=6)
    tol, lse_tol = _cluster_fwd_tol(dtype)
    common.reset_counts()
    o, lse = flash_attention_lse(q, k, v)
    variant = "tf32x3_xwide" if dtype == torch.float32 else "wgmma_xxwide"
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.%s" % variant: 1}
    ro, rlse = flash_attention_reference(q, k, v, True, return_lse=True)
    np.testing.assert_allclose(_np(o), _np(ro), **tol)
    np.testing.assert_allclose(_np(lse), _np(rlse), **lse_tol)


@pytest.mark.parametrize("variant", sorted(CLUSTER_FWD))
def test_flash_cluster_forwards_refuse_misaligned_inputs(dev, variant):
    """The cluster forwards raise on inputs their copies cannot read, and
    on the other dtype or a width not theirs, before any launch; they
    never hand them to the wide variant."""
    launch, dtype, widths = CLUSTER_FWD[variant]
    B, T, H, D = 1, 64, 2, widths[-1]
    per = 16 // torch.tensor([], dtype=dtype).element_size()
    flat = torch.randn(B * T * H * D + 1, device=dev).to(dtype)
    q = flat[1:].view(B, T, H, D)                     # base off 16 bytes
    k = torch.randn(B, T, H, D, device=dev).to(dtype)
    common.reset_counts()
    with pytest.raises(ValueError, match="%s variant.*16-byte" % variant):
        flash_attention(q, k, k)
    wide = torch.randn(B, T, H * D + per // 2, device=dev).to(dtype)
    k2 = wide[..., :H * D].view(B, T, H, D)           # T stride off 16 bytes
    with pytest.raises(ValueError, match="%s variant.*T stride %d"
                       % (variant, H * D + per // 2)):
        _flash_cuda(k, k, k2)
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    for t in (k.to(other), k[..., :256].contiguous()):
        with pytest.raises(ValueError, match="%s variant.*takes" % variant):
            launch(t, t, t)
    assert common.launch_counts() == {}


def test_flash_tf32x3_forward_does_not_spill(dev):
    """ptxas: the tf32x3 forward at 192 and 256 columns a CTA, alone and
    in 2-CTA clusters (tf32x3_xwide), and its narrow plan at 64 and 128, 0
    bytes of spills."""
    src = "flash_attention_tf32x3"
    log = _build.build([src])[src]["log"]
    lines = [ln for ln in log.splitlines() if "spill stores" in ln]
    assert len(lines) == 6, log
    assert all(" 0 bytes spill stores, 0 bytes spill loads" in ln
               for ln in lines), log


# ---------------------------------------------------------------------------
# head dims the kernels do not have: zero-padded along D on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [48, 80, 96, 160, 256, 320, 576])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_padded_head_dims_match_plain(dev, D, dtype, causal):
    """Forward and backward at head_dim 48, 80 and 96 (padded to 64, 128
    and 128) and above 128 (160 padded to 192, 256, 320, 576: the wide
    variant, but at 160 and 256, which take wgmma_wide in bf16 and tf32x3
    in f32, bf16 at 320, which takes wgmma_xwide both ways, f32 at 320,
    which takes tf32x3_xwide at 384 both ways, and bf16 at 576, which
    takes wgmma_xxwide at 640 both ways):
    no ValueError, the plain version's results, ``scale`` from the real
    head_dim, and the padded variant's launches."""
    B, Tq, Tk, H = 1, 150, 150, 2
    common.reset_counts()
    q, k, v, o, lse, do, dlse = _flash_bwd_inputs(dev, B, Tq, Tk, H, D,
                                                  causal, dtype)
    if 128 < D <= 256:
        variant = "wgmma_wide" if dtype == torch.bfloat16 else "tf32x3"
    elif 256 < D <= 512:
        variant = ("wgmma_xwide" if dtype == torch.bfloat16
                   else "tf32x3_xwide")
    elif D > 128:
        variant = "wide"
    else:
        variant = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    if dtype == torch.bfloat16 and 512 < D <= 1024:
        variant = "wgmma_xxwide"
    bwd_variant = variant
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.%s" % variant: 1}
    ro, rlse = flash_attention_reference(q, k, v, causal, return_lse=True)
    assert o.shape == (B, Tq, H, D) and o.is_contiguous()
    tol = F32_TOL if dtype == torch.float32 else BF16_ONE_ROUNDING
    np.testing.assert_allclose(_np(o), _np(ro), **tol)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-5, atol=1e-4)
    common.reset_counts()
    got = _flash_bwd_cuda(q, k, v, o, lse, do, dlse, causal)
    assert common.launch_counts() == {
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.%s" % bwd_variant: 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.%s" % bwd_variant: 1}
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, dlse, causal)
    gtol = F32_GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL
    for gt, wt, name in zip(got, want, ("dq", "dk", "dv")):
        assert gt.shape == wt.shape and gt.is_contiguous(), name
        np.testing.assert_allclose(_np(gt), _np(wt), err_msg=name, **gtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wide_kv_len_strided_views_and_repeat(dev, dtype):
    """The wide forward masks keys at and past kv_len and reads q/k/v slices
    of a fused qkv tensor through their strides; the backward at this
    head_dim (256: tf32x3 in f32, wgmma_wide in bf16) reads the same slices
    and gives the same bits twice (no atomics)."""
    B, T, H, D = 2, 90, 2, 256
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device=dev).to(dtype)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    assert not q.is_contiguous()
    from mxnet_tpu_torch.ops.kernels.flash_attention import _flash_wide_cuda
    o, lse = _flash_wide_cuda(q, k, v, False, None, 50)
    ro, rlse = flash_attention_reference(q[:, :, :, :], k[:, :50],
                                         v[:, :50], False, return_lse=True)
    tol = F32_TOL if dtype == torch.float32 else BF16_ONE_ROUNDING
    np.testing.assert_allclose(_np(o), _np(ro), **tol)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-5, atol=1e-4)
    o, lse = _flash_cuda(q, k, v, True)
    do = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    common.reset_counts()
    first = _flash_bwd_cuda(q, k, v, o, lse, do, None, True)
    variant = "tf32x3" if dtype == torch.float32 else "wgmma_wide"
    assert common.launch_counts() == {
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.%s" % variant: 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.%s" % variant: 1}
    again = _flash_bwd_cuda(q, k, v, o, lse, do, None, True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, None, True)
    gtol = F32_GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL
    for gt, wt, name in zip(first, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(gt), _np(wt), err_msg=name, **gtol)


def test_transformer_prefill_at_head_dim_256_matches_plain(dev):
    """A TransformerLM with head_dim 256 (d_model 512, 2 heads) prefills a
    prompt whose scores pass the dense gate through the wgmma_wide flash
    forward, and its logits match those through the plain versions."""
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)
    cfg = TransformerConfig(vocab_size=512, d_model=512, n_heads=2,
                            n_layers=2, d_ff=1024, max_len=1024,
                            dtype="bfloat16", dense_attn_max_score_mb=1)
    assert cfg.head_dim == 256
    model = TransformerLM(cfg, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
    T, ps = 600, 16                     # 2 * 600^2 * 4 bytes > 1 MB: flash
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, 512, (1, T), generator=g, device=dev)
    table = torch.arange(T // ps + 1, device=dev)
    runs = []
    for plain in (False, True):
        kp, vp = model.init_kv_pages(T // ps + 2, ps)
        saved = dict(common._REGISTRY)
        if plain:
            for name, entry in saved.items():
                common._REGISTRY[name] = {"cuda": entry["reference"],
                                          "reference": entry["reference"]}
        try:
            common.reset_counts()
            with torch.no_grad():
                logits = model.prefill(kp, vp, tokens, T, table)
            torch.cuda.synchronize()
            launches = common.launch_counts()
        finally:
            common._REGISTRY.clear()
            common._REGISTRY.update(saved)
        runs.append((logits, launches))
    (lk, launches), (lp, plain_launches) = runs
    assert launches.get("kernels.launch.flash_attention.wgmma_wide") == 2
    assert "kernels.launch.flash_attention" not in plain_launches
    assert torch.isfinite(lk).all() and lk.shape == (512,)
    # bf16 through two layers: the attention output's and RMSNorm's
    # roundings, then the GEMMs downstream of them (chip_smoke.py's
    # prefill bound, LOGITS_ATOL)
    np.testing.assert_allclose(_np(lk), _np(lp), rtol=0, atol=5e-2)


# ---------------------------------------------------------------------------
# softmax cross-entropy: forward and backward
# ---------------------------------------------------------------------------
XENT_CASES = [
    (37, 77),          # ragged N, V not a multiple of the block
    (64, 1000),
    (300, 32000),      # the model's vocabulary
    (5, 1),
]


def _xent_inputs(dev, N, V, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = (3 * torch.randn(N, V, generator=g, device=dev)).to(dtype)
    labels = torch.randint(0, V, (N,), generator=g, device=dev)
    labels[0], labels[-1] = V, -1           # outside [0, V): gold 0
    return logits, labels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", XENT_CASES)
def test_xent_kernels_match_plain(dev, case, dtype):
    N, V = case
    logits, labels = _xent_inputs(dev, N, V, dtype)
    loss, lse = _xent_fwd_cuda(logits, labels)
    rloss, rlse = softmax_xent_reference(logits, labels, return_lse=True)
    assert loss.dtype == lse.dtype == torch.float32 and loss.shape == (N,)
    np.testing.assert_allclose(_np(loss), _np(rloss), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-5, atol=1e-4)
    g = torch.randn(N, device=dev)
    d = _xent_bwd_cuda(logits, labels, lse, g)
    rd = softmax_xent_bwd_reference(logits, labels, lse, g)
    assert d.dtype == dtype and d.shape == logits.shape
    tol = F32_TOL if dtype == torch.float32 else BF16_ONE_ROUNDING
    np.testing.assert_allclose(_np(d), _np(rd), **tol)


def test_xent_reads_row_stride_and_stride0_g(dev):
    """A column slice of a wider buffer goes in through its row stride;
    the ``.mean()`` cotangent is an expanded, stride-0 ``g``."""
    wide, labels = _xent_inputs(dev, 33, 700, torch.float32)
    logits = wide[:, :500]
    labels = labels.clamp(0, 499)
    assert not logits.is_contiguous()
    loss, lse = _xent_fwd_cuda(logits, labels)
    loss2, lse2 = _xent_fwd_cuda(logits.contiguous(), labels)
    assert torch.equal(loss, loss2) and torch.equal(lse, lse2)
    g = torch.full((), 1 / 33, device=dev).expand(33)
    assert g.stride() == (0,)
    d = _xent_bwd_cuda(logits, labels, lse, g)
    rd = softmax_xent_bwd_reference(logits, labels, lse, g.contiguous())
    np.testing.assert_allclose(_np(d), _np(rd), **F32_TOL)


def test_xent_autograd_launches_both_kernels(dev):
    logits, labels = _xent_inputs(dev, 4 * 6, 50, torch.float32)
    logits = logits.view(4, 6, 50).requires_grad_(True)
    labels = labels.clamp(0, 49).view(4, 6)
    common.reset_counts()
    fused_softmax_xent(logits, labels).mean().backward()
    assert common.launch_counts() == {
        "kernels.launch.fused_softmax_xent": 1,
        "kernels.launch.fused_softmax_xent_bwd": 1}
    ref = logits.detach().clone().requires_grad_(True)
    torch.nn.functional.cross_entropy(ref.view(-1, 50),
                                      labels.view(-1)).backward()
    np.testing.assert_allclose(_np(logits.grad), _np(ref.grad), **F32_TOL)


def test_xent_refuses_bad_inputs(dev):
    logits = torch.randn(4, 10, device=dev, dtype=torch.float16)
    labels = torch.zeros(4, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        _xent_fwd_cuda(logits, labels)
    with pytest.raises(TypeError):
        _xent_fwd_cuda(logits.float(), labels.float())
    with pytest.raises(ValueError, match="shape"):
        _xent_fwd_cuda(logits.float(), labels[:3])


def test_rmsnorm_backward_on_card_matches_cpu(dev):
    """The RMSNorm gradient is plain torch math on both devices."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(6, 256, generator=g, device=dev, requires_grad=True)
    s = (1 + 0.1 * torch.randn(256, generator=g, device=dev)
         ).requires_grad_(True)
    fused_rmsnorm(x, s).square().sum().backward()
    xc, sc = (t.detach().cpu().requires_grad_(True) for t in (x, s))
    fused_rmsnorm(xc, sc).square().sum().backward()
    np.testing.assert_allclose(_np(x.grad), _np(xc.grad), **F32_GRAD_TOL)
    np.testing.assert_allclose(_np(s.grad), _np(sc.grad), **F32_GRAD_TOL)


# ---------------------------------------------------------------------------
# int8 matmul: int32 out and fused dequant
# ---------------------------------------------------------------------------
INT8_CASES = [
    # (M, K, N)
    (1, 1, 1),
    (16, 32, 8),                     # one mma tile
    (128, 2048, 1000),               # ResNet-50's classifier at batch 128
    (256, 512, 384),                 # aligned, 128x128 tiles on small cards
    (777, 301, 1001),                # ragged everywhere, K odd
    (64, 48, 130),                   # K % 16 == 0 but not a tile of K
    (300, 1000, 72),                 # K % 16 != 0, K % 8 == 0
    (2048, 2048, 2048),              # one wave of 128 x 256 wgmma tiles
    (128, 25088, 4096),              # VGG16's fc6 at batch 128: split-K
    (1, 2048, 1000),                 # M = 1, split-K
    (16, 2048, 1000),
    (127, 4096, 1000),
    (200, 1024, 1001),               # N not a multiple of any tile
    (128, 16, 1000),                 # K = 16: one zero-filled K tile
    (128, 2432, 1000),               # 19 K tiles: a shorter last split
]
def _int8_inputs(dev, M, K, N, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                      dtype=torch.int8)
    sa = torch.tensor([0.05], device=dev)
    sb = torch.rand(N, generator=g, device=dev) * 0.1 + 0.01
    return a, b, sa, sb


@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_matmul_kernels_bit_exact(dev, case):
    a, b, sa, sb = _int8_inputs(dev, *case)
    got = _int8_matmul_cuda(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got, int8_matmul_reference(a, b))
    for scales in ((sa, sb), (sa, None), (None, sb)):
        got = _int8_matmul_cuda(a, b, *scales)
        want = int8_matmul_reference(a, b, *scales)
        assert got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_int8_matmul_on_strided_and_offset_operands(dev):
    """Rows with a stride past K and a base not 16-byte aligned take the
    general path; the result is the same."""
    M, K, N = 70, 64, 40
    a, b, sa, sb = _int8_inputs(dev, M, K + 16, N)
    a2, b2 = a[:, 3:3 + K], b[:, 1:1 + K]
    assert a2.stride(0) == K + 16 and not a2.is_contiguous()
    for scales in ((None, None), (sa, sb)):
        assert torch.equal(_int8_matmul_cuda(a2, b2, *scales),
                           int8_matmul_reference(a2.contiguous(),
                                                 b2.contiguous(), *scales))


def test_int8_matmul_routes_cuda_tensors_to_the_kernels(dev):
    a, b, sa, sb = _int8_inputs(dev, 32, 64, 24)
    common.reset_counts()
    int8_matmul(a, b)
    int8_matmul(a, b, sa, sb)
    assert common.selection_counts() == {
        "kernels.select.int8_matmul.cuda": 2}
    assert common.launch_counts() == {
        "kernels.launch.int8_matmul": 1,
        "kernels.launch.int8_matmul.wgmma": 1,
        "kernels.launch.int8_matmul_dequant": 1,
        "kernels.launch.int8_matmul_dequant.wgmma": 1}


@pytest.mark.parametrize("M,K,N,offset,variant", [
    (128, 2048, 1000, 0, "wgmma"),   # fc1: split-K
    (2048, 2048, 2048, 0, "wgmma"),
    (777, 301, 1001, 0, "mma"),      # K odd
    (70, 64, 40, 3, "mma"),          # an offset view
])
def test_int8_matmul_variant_by_layout(dev, M, K, N, offset, variant):
    """The planner's variant is the one that launches, in both forms, and
    the other variant, launched directly, gives the same bits where it
    takes the input."""
    a, b, sa, sb = _int8_inputs(dev, M, K + offset, N)
    a = a[:, offset:offset + K]
    b = b[:, :K]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = plan_int8_matmul(M, N, K, sms, variant == "wgmma")
    assert plan.variant == variant
    for scales in ((None, None), (sa, sb)):
        common.reset_counts()
        got = _int8_matmul_cuda(a, b, *scales)
        name = "int8_matmul" if scales[0] is None else "int8_matmul_dequant"
        want_counts = {"kernels.launch.%s" % name: 1,
                       "kernels.launch.%s.%s" % (name, variant): 1}
        if plan.splits > 1:          # the kernel that adds the splits
            want_counts["kernels.launch.%s.reduce" % name] = 1
        assert common.launch_counts() == want_counts
        want = int8_matmul_reference(a.contiguous(), b.contiguous(), *scales)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        other = _int8_mm_mma_cuda(a, b, *scales)
        assert torch.equal(other.view(torch.int32), want.view(torch.int32))
        if variant == "mma":
            with pytest.raises(ValueError, match="wgmma variant"):
                _int8_mm_wgmma_cuda(a, b, *scales)


def test_int8_matmul_wgmma_split_k_wraps_past_2_31(dev):
    """Sums past +2^31 and -2^31 wrap in int32 as the plain version's do,
    through the split-K adds."""
    M, K, N = 4, 140032, 8
    a = torch.full((M, K), 127, dtype=torch.int8, device=dev)
    a[1] = -127
    b = torch.full((N, K), 127, dtype=torch.int8, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert plan_int8_matmul(M, N, K, sms).splits > 1
    got = _int8_mm_wgmma_cuda(a, b)
    want = int8_matmul_reference(a, b)
    exact = (127 * 127 * K + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert int(want[0, 0]) == exact and int(want[1, 0]) == -exact
    assert torch.equal(got, want)


def test_int8_matmul_refuses_bad_inputs(dev):
    a, b, _, _ = _int8_inputs(dev, 8, 16, 4)
    with pytest.raises(TypeError):
        _int8_matmul_cuda(a.float(), b)
    with pytest.raises(ValueError):
        _int8_matmul_cuda(a, b[:, :8])
    with pytest.raises(ValueError, match="scales"):
        _int8_matmul_cuda(a, b, None, torch.ones(5, device=dev))


# ---------------------------------------------------------------------------
# mx.rtc
# ---------------------------------------------------------------------------
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke(dev):
    """chip_smoke.py (its user kernels and helpers), with its user ops
    registered."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    mod = importlib.import_module("chip_smoke")
    mod.register_user_ops(mx)
    return mod


def _nd(t):
    return mx.nd.NDArray(t)


def test_rtc_test_rtc_kernels_in_cuda(dev, smoke):
    m = mx.rtc.CudaModule(smoke.RTC_TEST_SRC, options=["--fmad=false"])
    axpy = m.get_kernel("axpy", "const float *x, const float *y, float *o, "
                                "int n")
    scale = m.get_kernel("scale", "const float *x, float *o, int n")
    n = 8
    x = _nd(torch.arange(n, dtype=torch.float32, device=dev))
    y = _nd(torch.ones(n, device=dev))
    out = mx.nd.zeros((n,), ctx=mx.gpu(0))
    axpy.launch([x, y, out, n], mx.gpu(0), (1, 1, 1), (32, 1, 1))
    torch.testing.assert_close(out.data, 2.5 * x.data + y.data,
                               rtol=0, atol=0)
    scale.launch([x, out, n], mx.gpu(0), (1, 1, 1), (32, 1, 1))
    torch.testing.assert_close(out.data, x.data * 3.0, rtol=0, atol=0)


def test_rtc_templated_exports(dev, smoke):
    m = mx.rtc.CudaModule(smoke.RTC_AXPY_TEMPLATE_SRC,
                          options=["--fmad=false"],
                          exports=["axpy<float>", "axpy<double>"])
    for dt, ctype in ((torch.float32, "float"), (torch.float64, "double")):
        k = m.get_kernel("axpy<%s>" % ctype, "const %s *x, %s *y, %s alpha"
                         % (ctype, ctype, ctype))
        x = _nd(torch.ones(10, dtype=dt, device=dev))
        y = _nd(torch.zeros(10, dtype=dt, device=dev))
        k.launch([x, y, 3.0], mx.gpu(0), (1, 1, 1), (10, 1, 1))
        assert torch.equal(y.data, torch.full((10,), 3.0, dtype=dt,
                                              device=dev))


def test_rtc_compiles_once(dev, smoke):
    src = smoke.RTC_TEST_SRC + "\n// %s\n" % uuid.uuid4()
    before = mx.rtc.compile_count()
    m = mx.rtc.CudaModule(src)
    assert mx.rtc.compile_count() == before + 1 and m.compile_ms > 0
    again = mx.rtc.CudaModule(src)              # the cached cubin
    assert mx.rtc.compile_count() == before + 1 and again.compile_ms is None
    k = again.get_kernel("scale", "const float *x, float *o, int n")
    x = _nd(torch.ones(4, device=dev))
    out = mx.nd.zeros((4,), ctx=mx.gpu(0))
    for _ in range(2):
        k.launch([x, out, 4], mx.gpu(0), (1, 1, 1), (4, 1, 1))
    assert len(k._functions) == 1 and mx.rtc.compile_count() == before + 1
    assert torch.equal(out.data, torch.full((4,), 3.0, device=dev))


def test_rtc_errors(dev, smoke):
    m = mx.rtc.CudaModule(smoke.RTC_TEST_SRC)
    with pytest.raises(ValueError, match="not in the module"):
        m.get_kernel("nonexistent", "int n")
    with pytest.raises(RuntimeError, match="undeclared_fn"):
        mx.rtc.CudaModule('extern "C" __global__ void k(float *x) '
                          '{ x[0] = undeclared_fn(); }')
    k = m.get_kernel("scale", "const float *x, float *o, int n")
    x64 = _nd(torch.ones(4, dtype=torch.float64, device=dev))
    out = mx.nd.zeros((4,), ctx=mx.gpu(0))
    with pytest.raises(TypeError, match="float32"):
        k.launch([x64, out, 4], mx.gpu(0), (1, 1, 1), (4, 1, 1))
    with pytest.raises(ValueError, match="lies on cpu"):
        k.launch([mx.nd.zeros((4,), ctx=mx.cpu()), out, 4], mx.gpu(0),
                 (1, 1, 1), (4, 1, 1))


@pytest.mark.parametrize("shape", [(64, 4), (32, 1000)])
def test_rtc_softmax_matches_numpy_softmax(dev, smoke, shape):
    n, c = shape
    g = torch.Generator(device=dev).manual_seed(n)
    x = 3 * torch.randn(shape, generator=g, device=dev)
    y = torch.randint(0, c, (n,), generator=g, device=dev).float()
    res = {}
    for op_type in ("rtc_softmax", "numpy_softmax"):
        net = mx.sym.Custom(mx.sym.Variable("data"), mx.sym.Variable("label"),
                            op_type=op_type, name="sm")
        ex = net.simple_bind(ctx=mx.gpu(0), grad_req={"data": "write"},
                             data=shape, label=(n,))
        out = ex.forward(is_train=True, data=_nd(x), label=_nd(y))[0]
        ex.backward()
        res[op_type] = (out.data, ex.grad_dict["data"].data)
    tol = dict(rtol=smoke.RTC_FWD_RTOL, atol=smoke.RTC_FWD_ATOL)
    torch.testing.assert_close(res["rtc_softmax"][0], res["numpy_softmax"][0],
                               **tol)
    torch.testing.assert_close(res["rtc_softmax"][1], res["numpy_softmax"][1],
                               **tol)
    assert torch.allclose(res["rtc_softmax"][0].sum(1),
                          torch.ones(n, device=dev))


def test_resnet20_module_step_card_vs_cpu(dev, smoke):
    from mxnet_tpu_torch.models.resnet_symbol import get_symbol

    net = get_symbol(num_classes=10, num_layers=20, image_shape="3,28,28")
    rng = np.random.RandomState(0)
    arg_shapes, _, aux_shapes = net.infer_shape(data=(4, 3, 28, 28))
    args = {n: (rng.randn(*s) * 0.1).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    auxs = {n: np.ones(s, np.float32) if n.endswith("_var")
            else np.zeros(s, np.float32)
            for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    x = rng.rand(4, 3, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.float32)
    card = smoke._module_step(mx, net, mx.gpu(0), args, auxs, x, y)
    host = smoke._module_step(mx, net, mx.cpu(), args, auxs, x, y)
    for c, h in zip(card, host):
        ok, report = smoke._compare_tensors(c, h, smoke.MODULE_CHECK_REL)
        assert ok, report


# ---------------------------------------------------------------------------
# Gluon on the card
# ---------------------------------------------------------------------------
def _gluon_case(smoke, seed=1, batch=4):
    from mxnet_tpu_torch.gluon.model_zoo import vision

    weights = smoke._gluon_weights(mx, vision, "cudagate_", seed=seed)
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, batch).astype(np.float32)
    return weights, x, y


def test_gluon_hybridized_matches_imperative_on_card(dev, smoke):
    weights, x, y = _gluon_case(smoke)
    imp = smoke._gluon_step(mx, mx.gpu(0), weights, x, y, "float32", False,
                            "cudagate_")
    hyb = smoke._gluon_step(mx, mx.gpu(0), weights, x, y, "float32", True,
                            "cudagate_")
    for a, b in zip(hyb, imp):
        ok, report = smoke._compare_tensors(a, b, smoke.GLUON_HYBRID_REL)
        assert ok, report


def test_gluon_float64_step_card_vs_cpu(dev, smoke):
    weights, x, y = _gluon_case(smoke, seed=2)
    card = smoke._gluon_step(mx, mx.gpu(0), weights, x, y, "float64", False,
                             "cudagate_")
    host = smoke._gluon_step(mx, mx.cpu(), weights, x, y, "float64", False,
                             "cudagate_")
    for a, b in zip(card, host):
        ok, report = smoke._compare_tensors(a, b,
                                            smoke.MODULE_CHECK_REL_F64)
        assert ok, report


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gluon_fused_step_matches_trainer_step_on_card(dev, smoke, dtype):
    """FusedTrainStep and record / backward / Trainer.step on the card,
    three steps each from the same weights, with cuDNN's deterministic
    algorithms (its default weight-gradient kernels add in an order that
    changes between calls, and at lr 0.1 three steps amplify that to 1e-2
    in the losses): losses within 1e-5 (f32) or 2^-7 (bf16,
    multi_precision), the weights within 1e-4 relative L2 (f32) or 2^-6
    (bf16)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision

    weights, x, y = _gluon_case(smoke, seed=3, batch=8)
    opts = dict(smoke.CIFAR_SGD, multi_precision=dtype == "bfloat16")
    ctx = mx.gpu(0)
    out = []
    for fused in (True, False):
        net = vision.resnet18_v1(classes=10, thumbnail=True,
                                 prefix="cudagate_")
        net.load_dict(weights, ctx=ctx)
        net.cast(dtype)
        net.hybridize()
        tr = gluon.Trainer(net.collect_params(), "sgd", dict(opts))
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        xd = mx.nd.array(x, ctx=ctx).astype(dtype)
        yd = mx.nd.array(y, ctx=ctx)
        step = gluon.contrib.FusedTrainStep(net, loss_fn, tr)
        losses = []
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True):
            for _ in range(3):
                if fused:
                    loss = step(xd, yd)
                else:
                    with mx.autograd.record():
                        loss = loss_fn(net(xd), yd)
                    loss.backward()
                    tr.step(len(x))
                losses.append(loss.asnumpy().astype(np.float32))
        out.append((losses, {n: p.data().asnumpy().astype(np.float64)
                             for n, p in net.collect_params().items()}))
    (lf, wf), (lp, wp) = out
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(np.array(lf), np.array(lp), rtol=tol,
                               atol=tol)
    ok, report = smoke._compare_tensors(
        wf, wp, 1e-4 if dtype == "float32" else 2.0 ** -6)
    assert ok, report


def test_gluon_entry_points_default_to_the_card(dev):
    from mxnet_tpu_torch import gluon

    net = gluon.nn.Dense(3, in_units=2)
    net.initialize()
    assert net.weight.list_ctx() == [mx.gpu(0)]
    assert net.weight.data().data.is_cuda
    out = net(mx.nd.ones((4, 2)))
    assert out.context == mx.gpu(0) and out.shape == (4, 3)


# ---------------------------------------------------------------------------
# the serving plane's page movement on the card
# ---------------------------------------------------------------------------
SERVE_SMALL = dict(vocab_size=97, d_model=256, n_heads=2, n_layers=2,
                   d_ff=512, max_len=256, dtype="bfloat16")


def _serve_small(dev, n=2):
    gen = torch.Generator(device=dev).manual_seed(0)
    model = mx.TransformerLM(mx.TransformerConfig(**SERVE_SMALL),
                             device=dev, generator=gen)
    cfg = mx.GenerationConfig(page_size=16, max_pages=64, max_slots=4,
                              max_new_tokens=40, slot_buckets="4",
                              prefill_buckets="64,128")
    return [mx.GenerationServer(model, cfg, device=dev) for _ in range(n)]


def _slow_token(t):
    import time

    time.sleep(0.005)


def _park_mid_stream(srv, prompt, n_before=4):
    import time

    from mxnet_tpu_torch.serving import StreamMigrated

    fut = srv.submit_async(prompt, on_token=_slow_token)
    t0 = time.monotonic()
    while len(fut.stream_tokens) < n_before:
        assert time.monotonic() - t0 < 60, "stream never started"
        time.sleep(0.001)
    [h] = srv.park_streams(1)
    with pytest.raises(StreamMigrated):
        fut.result(timeout=30)
    return fut.stream_tokens, h


def test_kv_blob_bf16_roundtrip_of_card_pages(dev):
    """bf16 pages gathered from the card pack to the bytes of their raw
    words and scatter back bit for bit."""
    from mxnet_tpu_torch.generation import (_block_tensor, pack_kv_blob,
                                            unpack_kv_blob)

    [srv] = _serve_small(dev, 1)
    try:
        eng = srv.engine
        g = torch.Generator(device=dev).manual_seed(1)
        eng.k_pages.copy_(torch.randn(eng.k_pages.shape, generator=g,
                                      device=dev))
        eng.v_pages.copy_(torch.randn(eng.v_pages.shape, generator=g,
                                      device=dev))
        pages = [5, 2, 9]
        k, v = srv._run_on_scheduler(lambda: eng.gather_pages(pages))
        blob = pack_kv_blob({"n_pages": 3}, k, v)
        h, kb, vb = unpack_kv_blob(blob)
        assert h["kv_dtype"] == "bfloat16"
        kt = _block_tensor(kb, torch.bfloat16, dev)
        vt = _block_tensor(vb, torch.bfloat16, dev)
        assert torch.equal(kt.view(torch.int16),
                           eng.k_pages[:, pages].view(torch.int16))
        srv._run_on_scheduler(lambda: eng.scatter_pages([20, 21, 22],
                                                        kt, vt))
        assert torch.equal(eng.v_pages[:, [20, 21, 22]].view(torch.int16),
                           eng.v_pages[:, pages].view(torch.int16))
    finally:
        srv.drain(timeout=30)


def test_migrate_bitwise_on_card(dev):
    """One slot bucket on both servers: a migrated bf16 stream's greedy
    continuation is the unparked stream's, bit for bit, with no prefill on
    the receiver."""
    from mxnet_tpu_torch import profiler

    a, b = _serve_small(dev)
    try:
        p = np.random.default_rng(3).integers(0, 97, 100)
        ref = a.submit(p, timeout=120)
        delivered, h = _park_mid_stream(a, p)
        blob = a.export_stream(h)
        p0 = profiler.dispatch_value("gen_prefills")
        h2 = b.import_stream(blob)
        fut = b.submit_async(p, resume_from=delivered, migrate_handle=h2)
        cont = list(fut.tokens(timeout=120))
        assert profiler.dispatch_value("gen_prefills") == p0
        assert delivered + cont == ref
    finally:
        for s in (a, b):
            s.drain(timeout=30)
            assert s.engine.allocator.used == 0


def test_defrag_on_card_continues_bitwise(dev):
    [srv] = _serve_small(dev, 1)
    try:
        rng = np.random.default_rng(4)
        p_long, p_short = rng.integers(0, 97, 60), rng.integers(0, 97, 60)
        ref = srv.submit(p_long, timeout=120)
        fut_s = srv.submit_async(p_short, max_new_tokens=20)
        fut_l = srv.submit_async(p_long, on_token=_slow_token)
        fut_s.result(timeout=120)
        while len(fut_l.stream_tokens) < 24:
            assert not fut_l.done
            threading.Event().wait(0.001)
        moved = srv.defrag()
        assert fut_l.result(timeout=120) == ref
        assert moved == 1 and srv.stats["defrag_moved"] == 1
    finally:
        srv.drain(timeout=30)
        assert srv.engine.allocator.used == 0


# ---------------------------------------------------------------------------
# the throughput harness, the numerical-health guard and the serving front
# ---------------------------------------------------------------------------
def _small_resnet(dev, dtype="bfloat16", batch=4):
    from mxnet_tpu_torch.gluon.model_zoo import vision

    mx.random.seed(0)
    net = vision.resnet18_v1(classes=10, thumbnail=True)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.hybridize(static_alloc=True, static_shape=True)
    rng = np.random.RandomState(0)
    x32 = mx.nd.array(rng.rand(batch, 3, 32, 32).astype(np.float32),
                      ctx=mx.gpu(0))
    y = mx.nd.array(rng.randint(0, 10, (batch,)), ctx=mx.gpu(0))
    with mx.autograd.pause():
        net(x32)
    if dtype != "float32":
        net.cast(dtype)
    return net, x32.astype(dtype), y


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compiled_throughput_graph_equals_eager_chain(dev, dtype):
    """One CUDA graph of the chained forwards: each draw is one replay,
    the probe leaves the input unchanged, and the graph's last output is
    the eager chain's, bit for bit."""
    from mxnet_tpu_torch import autograd, benchmark

    net, x, _ = _small_resnet(dev, dtype)
    loop = benchmark.compiled_loop(net, x, 5)
    assert isinstance(loop.graph, torch.cuda.CUDAGraph)
    before = benchmark.graph_replays()
    assert loop.draw() > 0
    assert benchmark.graph_replays() == before + 1
    assert torch.equal(loop.carry, x.data)
    zero = torch.zeros((), dtype=x.data.dtype, device=dev)
    with autograd.pause():
        _, eager = benchmark.chained_forward(net, x.data, zero, 5)
    assert torch.equal(loop.out, eager)
    r = benchmark.compiled_throughput(net, x, steps=3, draws=2)
    assert r["draws"] == 2 and r["median"] > 0
    assert benchmark.graph_replays() == before + 1 + 1 + 2


def _state_digest(trainer):
    from mxnet_tpu_torch import sentinel

    states = []
    for i in sorted(trainer._updaters[0].states):
        s = trainer._updaters[0].states[i]
        states += [t for t in (s if isinstance(s, tuple) else (s,))
                   if t is not None]
    return (sentinel.params_digest(trainer._params),
            sentinel.params_digest(states))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_guarded_step_is_bitwise_and_contains_nan_on_card(dev, dtype):
    """From one state (cuDNN's deterministic algorithms), a finite guarded
    step equals the unguarded one bit for bit; a nan_grad step leaves every
    parameter, BatchNorm statistic and optimizer-state buffer unchanged."""
    from mxnet_tpu_torch import chaos, gluon, sentinel
    from mxnet_tpu_torch.gluon.contrib import FusedTrainStep

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        net, x, y = _small_resnet(dev, dtype)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.05, "momentum": 0.9,
                            "multi_precision": dtype != "float32"})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        base = FusedTrainStep(net, loss_fn, tr)
        guard = FusedTrainStep(net, loss_fn, tr, numeric_guard="skip")
        base(x, y)
        ring = sentinel.RollbackRing(1, tr._params, tr._updaters)
        digests = []
        for s in (base, base, guard):
            ring.snapshot(0)
            s(x, y).asnumpy()
            guard.check_health()
            digests.append(_state_digest(tr))
            ring.restore()
        assert digests[0] == digests[1] == digests[2]
        before = _state_digest(tr)
        k = guard._step_idx
        with chaos.inject("nan_grad@%d" % k):
            guard(x, y)
            guard.check_health()
        assert _state_digest(tr) == before
        assert guard._sentinel.events[-1][:2] == (k, "skip")
        assert np.isfinite(guard(x, y).asnumpy().astype(np.float32)).all()
    finally:
        torch.backends.cudnn.deterministic = det


def test_model_server_serves_bare_predictor_bits_on_card(dev):
    """The serving front on the card answers what the bare Predictor
    answers at the same batch shape, bit for bit."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.predict import Predictor

    ctx = mx.gpu(0)
    rng = np.random.RandomState(0)
    net = mx.sym.FullyConnected(
        mx.sym.Activation(mx.sym.FullyConnected(
            mx.sym.var("data"), num_hidden=32, name="fc1"),
            act_type="relu"), num_hidden=8, name="fc2")
    params = {"arg:fc1_weight": mx.nd.array(rng.rand(32, 16), ctx=ctx),
              "arg:fc1_bias": mx.nd.zeros((32,), ctx=ctx),
              "arg:fc2_weight": mx.nd.array(rng.rand(8, 32), ctx=ctx),
              "arg:fc2_bias": mx.nd.zeros((8,), ctx=ctx)}
    bare = Predictor(net, params, ctx=ctx, input_shapes={"data": (1, 16)})
    srv = serving.ModelServer(net, params, ctx=ctx,
                              input_shapes={"data": (1, 16)},
                              max_batch=8, max_wait_ms=0)
    try:
        for _ in range(8):
            xi = rng.rand(1, 16).astype(np.float32)
            want = bare.forward(data=xi)[0].asnumpy()
            assert np.array_equal(srv.submit({"data": xi})[0], want)
    finally:
        assert srv.drain(timeout=30)


# ---------------------------------------------------------------------------
# the kernel library's front door (MXTPU_PALLAS, the JAX-form select_impl,
# kernel_unit) on the card
# ---------------------------------------------------------------------------
def test_front_door_flash_fwd_bwd_launches_the_kernels(dev, monkeypatch):
    """bench.py's kernels-leg step through ``select_impl("flash_attention")``
    and a kernel unit: 'cuda', and the forward, dQ and dK/dV kernels each
    launched once through their tensor-core variants; the gradients are
    autograd's through the dense plain forward within 2^-6 of each
    gradient's largest entry (the tensor-core backward's tolerance against
    that independent formula)."""
    monkeypatch.delenv("MXTPU_PALLAS", raising=False)
    fn, impl = common.select_impl("flash_attention")
    assert impl == "cuda" and fn is flash_attention
    unit = common.kernel_unit(
        "test_card_flash_fwd_bwd",
        lambda q, k, v: (fn(q, k, v, causal=True).float() ** 2).sum())
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(1, 256, 4, 64, generator=g, device=dev,
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    common.reset_counts()
    got = torch.autograd.grad(unit(q, k, v), (q, k, v))
    torch.cuda.synchronize()
    assert common.selection_counts() == {
        "kernels.select.flash_attention.cuda": 1,
        "kernels.select.flash_attention_bwd.cuda": 1}
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.wgmma": 1,
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.wgmma": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.wgmma": 1}
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    o = flash_attention_reference(qr, kr, vr, True)
    want = torch.autograd.grad((o.float() ** 2).sum(), (qr, kr, vr))
    for gt, wt, name in zip(got, want, "qkv"):
        assert torch.isfinite(gt).all(), name
        assert _rel_to_max(gt, wt) <= 2.0 ** -6, name


def test_front_door_int8_dequant_launches_the_kernel(dev, monkeypatch):
    monkeypatch.delenv("MXTPU_PALLAS", raising=False)
    fn, impl = common.select_impl("int8_matmul")
    assert impl == "cuda" and fn is int8_matmul
    a, b, sa, sb = _int8_inputs(dev, 256, 512, 384)
    common.reset_counts()
    got = common.kernel_unit("test_card_int8", fn)(a, b, sa, sb)
    launches = common.launch_counts()
    # a plan with split-K adds the kernel that sums the splits
    assert launches.pop("kernels.launch.int8_matmul_dequant.reduce", 1) == 1
    assert launches == {
        "kernels.launch.int8_matmul_dequant": 1,
        "kernels.launch.int8_matmul_dequant.wgmma": 1}
    assert torch.equal(got, int8_matmul_reference(a, b, sa, sb))


def test_interpret_mode_raises_on_a_cuda_tensor(dev, monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "interpret")
    x = torch.randn(8, 64, device=dev)
    common.reset_counts()
    with pytest.raises(RuntimeError, match="interpret"):
        fused_rmsnorm(x, torch.ones(64, device=dev))
    assert common.launch_counts() == {}
    assert common.select_impl("flash_attention")[1] == "reference"


def test_off_mode_is_visible_in_the_reference_counters(dev, monkeypatch):
    """``off`` never hands the card the plain version: a CUDA tensor
    raises and launches nothing; a CPU tensor runs the plain version,
    counted as ``reference``."""
    monkeypatch.setenv("MXTPU_PALLAS", "off")
    x = torch.randn(8, 64, device=dev)
    common.reset_counts()
    with pytest.raises(RuntimeError, match="MXTPU_PALLAS=off"):
        fused_rmsnorm(x, torch.ones(64, device=dev))
    assert common.selection_counts() == {}
    assert common.launch_counts() == {}
    out = fused_rmsnorm(x.cpu(), torch.ones(64))
    assert out.device.type == "cpu"
    assert common.selection_counts() == {
        "kernels.select.fused_rmsnorm.reference": 1}
    assert common.launch_counts() == {}
    assert common.select_impl("int8_matmul")[1] == "reference"


# ---------------------------------------------------------------------------
# the device mesh at world size 1 (a real NCCL communicator over one rank)
# ---------------------------------------------------------------------------
def _qkv_bf16(dev, shape=(2, 1024, 8, 64), seed=21):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev,
                        dtype=torch.bfloat16).requires_grad_(True)
            for _ in range(3)]


def test_mesh_attention_at_world_size_one_is_the_flash_kernel(dev):
    """Under a mesh the model's attention is the flash kernel on the rank's
    batch and heads (``flash_self_attention`` is the kernel's own entry):
    a bf16 model past the dense gate under ``make_mesh(dp=1, tp=1)`` gives
    the meshless gradients bit for bit and its loss within 1e-6 relative
    (the mean taken as an all-reduced sum over the token count), the
    forward, dQ and dK/dV
    launched through their tensor-core variants once a layer, no plain
    version selected."""
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)
    from mxnet_tpu_torch.ops.kernels.flash_attention import (
        flash_self_attention)
    from mxnet_tpu_torch.parallel import make_mesh

    assert flash_self_attention is flash_attention
    cfg = TransformerConfig(vocab_size=512, d_model=128, n_heads=2,
                            n_layers=2, d_ff=256, dtype="bfloat16",
                            remat=False, dense_attn_max_score_mb=0)
    model = TransformerLM(cfg, device=dev)
    toks = torch.randint(0, 512, (2, 257), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(6))
    x, y = toks[:, :-1].contiguous(), toks[:, 1:].contiguous()
    params = {k: p.detach() for k, p in model.named_parameters()}
    ref_loss, ref_grads = model.value_and_grad(params, x, y)
    with make_mesh(dp=1, tp=1):
        common.reset_counts()
        loss, grads = model.value_and_grad(params, x, y)
        selects = common.selection_counts()
        launches = common.launch_counts()
    assert abs(float(loss) - float(ref_loss)) <= 1e-6 * abs(float(ref_loss))
    for k, want in ref_grads.items():
        assert torch.equal(grads[k], want), k
    assert not any(k.endswith(".reference") for k in selects), selects
    for name in ("flash_attention", "flash_attention_dq",
                 "flash_attention_dkv"):
        assert launches["kernels.launch.%s.wgmma" % name] == cfg.n_layers


def test_kernel_ring_on_one_rank_equals_the_flash_kernel(dev):
    """``ring_attention(use_pallas=True)`` over an sp axis of one rank is
    one flash block: output and gradients bit for bit the kernel's."""
    from mxnet_tpu_torch.parallel import make_mesh, ring_attention

    q, k, v = _qkv_bf16(dev, (1, 2048, 16, 64), seed=22)
    w = torch.randn(q.shape, device=dev)
    with make_mesh(sp=1):
        o = ring_attention(q, k, v, "sp", causal=True, use_pallas=True)
        got = torch.autograd.grad((o.float() * w).sum(), (q, k, v))
    o_ref = flash_attention(q, k, v, causal=True)
    want = torch.autograd.grad((o_ref.float() * w).sum(), (q, k, v))
    assert torch.equal(o, o_ref)
    for gt, wt in zip(got, want):
        assert torch.equal(gt, wt)


def test_sharded_step_at_world_size_one_matches_meshless(dev):
    """``make_train_step(rules=default_rules())`` under ``make_mesh(dp=1)``
    (NCCL over one rank: every collective runs) against the meshless step
    on the same bf16 parameters: the loss within 1e-5 relative (the mean
    taken as an all-reduced sum over the token count), each parameter
    within 2^-8 of its largest entry (a gradient an ulp apart can move a
    bf16 update by one ulp); the kernels launched, no plain version."""
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM,
                                                    default_rules,
                                                    make_train_step)
    from mxnet_tpu_torch.parallel import make_mesh

    cfg = TransformerConfig(vocab_size=512, d_model=128, n_heads=2,
                            n_layers=2, d_ff=256, dtype="bfloat16",
                            remat=False)
    model = TransformerLM(cfg, device=dev)
    toks = torch.randint(0, 512, (2, 129), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(5))
    x, y = toks[:, :-1].contiguous(), toks[:, 1:].contiguous()
    base = {k: p.detach().clone() for k, p in model.named_parameters()}
    ref_p = {k: v.clone() for k, v in base.items()}
    ref_v = {k: torch.zeros_like(v) for k, v in base.items()}
    _, _, ref_loss = make_train_step(model)(ref_p, ref_v, x, y)
    with make_mesh(dp=1):
        p = {k: v.clone() for k, v in base.items()}
        v = {k: torch.zeros_like(t) for k, t in base.items()}
        common.reset_counts()
        p, v, loss = make_train_step(model, rules=default_rules())(p, v, x, y)
        selects = common.selection_counts()
        launches = common.launch_counts()
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    for k, want in ref_p.items():
        got = p[k].to_local() if hasattr(p[k], "to_local") else p[k]
        assert _rel_to_max(got, want) <= 2.0 ** -8, k
    assert not any(k.endswith(".reference") for k in selects), selects
    for name in ("fused_rmsnorm", "fused_softmax_xent",
                 "fused_softmax_xent_bwd"):
        assert launches.get("kernels.launch." + name, 0) > 0, name


# ---------------------------------------------------------------------------
# the fused RNN op on cuDNN, and the LSTM language model's step
# ---------------------------------------------------------------------------
def _rel64(got, want):
    """max |got - want| over want's largest entry, in float64."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-300))


def _rnn_inputs(dev, dtype, mode, layers, bidir, T=7, N=3, I=5, H=8):
    from mxnet_tpu_torch.ops import rnn as trnn

    dirs = 2 if bidir else 1
    g = torch.Generator(device=dev).manual_seed(3)
    size = trnn.rnn_param_size(mode, I, H, layers, bidir)
    shapes = [(T, N, I), (size,), (layers * dirs, N, H),
              (layers * dirs, N, H)]
    return [(torch.randn(s, generator=g, device=dev, dtype=dtype)
             * (H ** -0.5 if len(s) == 1 else 1.0)).requires_grad_()
            for s in shapes], dict(mode=mode, state_size=H,
                                   num_layers=layers, bidirectional=bidir)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layers,bidir", [(1, False), (2, True)])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_cudnn_matches_plain_loop(dev, mode, layers, bidir, dtype):
    """cuDNN against rnn_reference: outputs and every gradient within 1e-4
    / 1e-3 of each tensor's largest entry in f32 (TF32 off: cuDNN's f32
    activations are not the correctly rounded ones torch's are, and at 2
    bidirectional rnn_tanh layers its output stood 1.7e-5 of the largest
    entry off on an H100), 1e-12 in float64, where the rounding is gone and
    only the function is compared; the output's autograd node is
    cuDNN's."""
    from mxnet_tpu_torch.ops import rnn as trnn

    inputs, kw = _rnn_inputs(dev, dtype, mode, layers, bidir)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = [o for o in trnn.rnn_cudnn(*inputs, **kw) if o is not None]
        ref = [o for o in trnn.rnn_reference(*inputs, **kw)
               if o is not None]
        g = torch.Generator(device=dev).manual_seed(4)
        cts = [torch.randn(o.shape, generator=g, device=dev, dtype=dtype)
               for o in got]
        leaves = inputs if mode == "lstm" else inputs[:3]
        g_got = torch.autograd.grad(got, leaves, cts)
        g_ref = torch.autograd.grad(ref, leaves, cts)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert type(got[0].grad_fn).__name__ == "CudnnRnnBackward0"
    fwd, grad = (1e-4, 1e-3) if dtype == torch.float32 else (1e-12, 1e-12)
    for a, b in zip(got, ref):
        assert _rel64(a.detach(), b.detach()) <= fwd
    for a, b in zip(g_got, g_ref):
        assert _rel64(a, b) <= grad


def test_rnn_cudnn_dropout_goes_between_layers(dev):
    """p > 0 in training: one cuDNN call a layer, the mask from mx.random
    between them and none after the last, as the plain loop does."""
    from mxnet_tpu_torch.ops import rnn as trnn

    inputs, kw = _rnn_inputs(dev, torch.float64, "lstm", 3, True)
    mx.random.seed(11)
    got = trnn.rnn_cudnn(*inputs, p=0.4, train=True, **kw)
    mx.random.seed(11)
    ref = trnn.rnn_reference(*inputs, p=0.4, train=True, **kw)
    for a, b in zip(got, ref):
        assert _rel64(a.detach(), b.detach()) <= 1e-12
    plain = trnn.rnn_cudnn(*inputs, **kw)
    assert not torch.allclose(got[0], plain[0])
    assert torch.equal(trnn.rnn_cudnn(*inputs, p=0.4, **kw)[0], plain[0])


def test_rnn_op_has_no_plain_path_on_the_card(dev):
    """A tensor cuDNN's RNN does not take (bf16) raises on the card."""
    from mxnet_tpu_torch.ops import rnn as trnn

    inputs, kw = _rnn_inputs(dev, torch.bfloat16, "lstm", 1, False)
    with pytest.raises(RuntimeError, match="cuDNN"):
        trnn._rnn(*inputs, **kw)


def test_word_lm_float64_module_step_card_vs_cpu(dev, smoke):
    """word_lm.py's graph at a small width: one float64 Module step on
    the card against the CPU within chip_smoke's 1e-8, and cuDNN in its
    training graph's backward."""
    sym = smoke._word_lm_symbol(mx, vocab=97, emsize=16, nhid=24, nlayers=2)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 97, (9, 4)).astype(np.float32)
    y = rng.randint(0, 97, (9, 4)).astype(np.float32)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mx.random.seed(0)
    mod.init_params(mx.init.Xavier())
    args = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    mod.forward(mx.io.DataBatch([mx.nd.array(x, ctx=mx.gpu(0))],
                                [mx.nd.array(y, ctx=mx.gpu(0))]),
                is_train=True)
    assert "CudnnRnnBackward0" in smoke._autograd_names(
        mod._exec._pending[0])
    ok, report = smoke._f64_card_vs_cpu(mx, sym, args, x, y, smoke.LM_SGD)
    assert ok, report


def test_int8_symbolblock_on_card_equals_plain(dev, smoke, tmp_path):
    """A narrow VGG11 through export, ``quantize_model`` and
    ``SymbolBlock.imports`` on the card: its int8 outputs through the
    kernels equal those through the plain versions bit for bit, and one
    forward launches the int8 matmul once per fully connected layer, by
    the planned variant, with no plain version."""
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    from mxnet_tpu_torch.gluon.model_zoo.vision.vgg import VGG

    ctx = mx.gpu(0)
    rng = np.random.RandomState(0)
    net = VGG([1, 1, 2, 2, 2], [8, 16, 16, 32, 32], classes=10)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.hybridize()
    x = mx.nd.array(rng.rand(32, 3, 32, 32).astype(np.float32), ctx=ctx)
    with mx.autograd.pause():
        net(x[0:1])
    prefix = str(tmp_path / "vgg")
    net.export(prefix, 0)
    sym, args, auxs = mx.model.load_checkpoint(prefix, 0)
    calib = mx.io.NDArrayIter(rng.rand(8, 3, 32, 32).astype(np.float32),
                              np.zeros(8), 4)
    qsym, qargs, qauxs = quantize_model(
        sym, args, auxs, ctx=ctx, calib_mode="naive", calib_data=calib,
        num_calib_examples=8, fold_bn=True, fuse_int8=True)
    mx.model.save_checkpoint(prefix + "_q", 0, qsym, qargs, qauxs)
    qnet = mx.gluon.SymbolBlock.imports(prefix + "_q-symbol.json", ["data"],
                                        prefix + "_q-0000.params", ctx=ctx)
    with mx.autograd.pause():
        qnet(x)
        torch.cuda.synchronize()
        common.reset_counts()
        got = qnet(x).asnumpy()
        launches = common.launch_counts()
        selects = common.selection_counts()
        with smoke._plain_versions():
            want = qnet(x).asnumpy()
    np.testing.assert_array_equal(got, want)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    expect = {}
    for K, N in ((32, 4096), (4096, 4096), (4096, 10)):
        plan = plan_int8_matmul(32, N, K, sms)
        keys = ["int8_matmul", "int8_matmul." + plan.variant]
        if plan.variant == "wgmma" and plan.splits > 1:
            keys.append("int8_matmul.reduce")
        for k in keys:
            expect["kernels.launch." + k] = expect.get(
                "kernels.launch." + k, 0) + 1
    assert launches == expect
    assert not any(k.endswith(".reference") for k in selects)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bounds", [(0, 6), (None, 0.5), (-1.5, None)])
def test_clip_on_card_equals_cpu(dev, dtype, bounds):
    """``nd.clip`` and ``sym.clip`` (MobileNet's relu6) on the card give
    the CPU's values, bit for bit."""
    x = torch.from_numpy(np.random.RandomState(4).uniform(
        -9, 9, (33, 65)).astype(np.float32)).to(getattr(torch, dtype))
    want = mx.nd.clip(mx.nd.NDArray(x), *bounds).data
    got = mx.nd.clip(mx.nd.NDArray(x.to(dev)), *bounds)
    assert got.context.device_type == "gpu"
    assert torch.equal(got.data.cpu(), want)
    s = mx.sym.clip(mx.sym.var("x"), *bounds)
    out = s.bind(mx.gpu(0), args={"x": mx.nd.NDArray(x.to(dev))},
                 grad_req="null").forward()[0]
    assert torch.equal(out.data.cpu(), want)


# ---------------------------------------------------------------------------
# greedy NMS (csrc/nms.cu) and the detection ops on the card
# ---------------------------------------------------------------------------
def _nms_case(B, N, seed, dev):
    """Score-sorted boxes in clusters (real suppression), 80% valid, three
    classes; a degenerate box, a repeated one and a zero-area one."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, 1, (B, max(N // 8, 1), 2))
    pick = rng.randint(0, centers.shape[1], (B, N))
    c = np.take_along_axis(centers, pick[..., None], 1) + \
        rng.normal(0, 0.02, (B, N, 2))
    wh = rng.uniform(0.02, 0.3, (B, N, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    if N > 3:
        boxes[:, 1] = boxes[:, 0]
        boxes[:, 2, 2] = boxes[:, 2, 0] - 0.05         # negative width
        boxes[:, 3, 2:] = boxes[:, 3, :2]               # zero area
    valid = rng.uniform(size=(B, N)) < 0.8
    ids = rng.randint(0, 3, (B, N)).astype(np.float32)
    return (torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev),
            torch.from_numpy(ids).to(dev))


@pytest.mark.parametrize("classes", [False, True])
@pytest.mark.parametrize("iou,cmp,thresh", [("pair", "ge", 0.45),
                                            ("pair", "gt", 0.7),
                                            ("corner", "gt", 0.5),
                                            ("corner", "ge", 0.3)])
@pytest.mark.parametrize("N", [1, 33, 6000, 8732])
def test_greedy_nms_kernel_matches_plain_bit_for_bit(dev, N, iou, cmp,
                                                     thresh, classes):
    from mxnet_tpu_torch.ops.kernels.nms import (_greedy_nms_cuda,
                                                 greedy_nms_reference)
    boxes, valid, ids = _nms_case(2, N, N, dev)
    ids = ids if classes else None
    common.reset_counts()
    got = _greedy_nms_cuda(boxes, valid, ids, thresh, iou, cmp)
    assert common.launch_counts() == {"kernels.launch.greedy_nms": 1}
    want = greedy_nms_reference(boxes, valid, ids, thresh, iou, cmp)
    assert got.dtype == torch.bool and got.shape == valid.shape
    assert torch.equal(got, want)
    assert not (got & ~valid).any()
    if N >= 33:
        assert (valid & ~got).any()                  # something suppressed
    assert torch.equal(_greedy_nms_cuda(boxes, valid, ids, thresh, iou, cmp),
                       got)


def test_greedy_nms_kernel_views_and_refusals(dev):
    from mxnet_tpu_torch.ops.kernels.nms import (MAX_BOXES, _greedy_nms_cuda,
                                                 greedy_nms_reference)
    boxes, valid, ids = _nms_case(3, 300, 5, dev)
    # a strided, offset view of the boxes: copied to an aligned buffer
    wide = torch.zeros(3, 300, 6, device=dev)
    wide[..., 1:5] = boxes
    view = wide[..., 1:5]
    assert torch.equal(_greedy_nms_cuda(view, valid, ids, 0.4),
                       greedy_nms_reference(boxes, valid, ids, 0.4))
    with pytest.raises(TypeError):
        _greedy_nms_cuda(boxes.double(), valid)
    with pytest.raises(ValueError):
        _greedy_nms_cuda(torch.zeros(1, MAX_BOXES + 1, 4, device=dev),
                         torch.ones(1, MAX_BOXES + 1, dtype=torch.bool,
                                    device=dev))
    empty = _greedy_nms_cuda(boxes[:, :0], valid[:, :0])
    assert empty.shape == (3, 0)


def test_detection_ops_launch_the_kernel_and_match_the_cpu(dev):
    """MultiBoxDetection, Proposal and box_nms on the card launch the NMS
    kernel once each and never select its plain version; each gives the
    CPU's result on the same inputs (ids and keep decisions exact)."""
    from mxnet_tpu_torch.ops import registry
    rng = np.random.RandomState(0)
    logits = rng.standard_normal((2, 6, 2000)).astype(np.float32)
    prob = torch.softmax(torch.from_numpy(logits), 1)
    loc = torch.from_numpy(rng.normal(0, 0.5, (2, 8000)).astype(np.float32))
    anchors = _nms_case(1, 2000, 1, "cpu")[0].clamp(0, 1)
    cls = torch.from_numpy(rng.uniform(0, 1, (1, 18, 20, 25))
                           .astype(np.float32))
    bbox = torch.from_numpy(rng.normal(0, 0.2, (1, 36, 20, 25))
                            .astype(np.float32))
    info = torch.tensor([[320.0, 400.0, 1.0]])
    data = torch.cat([torch.from_numpy(rng.randint(0, 3, (2, 500, 1))
                                       .astype(np.float32)),
                      torch.from_numpy(rng.uniform(0, 1, (2, 500, 1))
                                       .astype(np.float32)),
                      _nms_case(2, 500, 2, "cpu")[0]], -1)
    cases = [("_contrib_MultiBoxDetection", (prob, loc, anchors),
              dict(nms_threshold=0.45, nms_topk=400)),
             ("_contrib_Proposal", (cls, bbox, info),
              dict(rpn_pre_nms_top_n=1000, rpn_post_nms_top_n=100,
                   scales=(8, 16, 32))),
             ("_contrib_box_nms", (data,), dict(overlap_thresh=0.5,
                                                id_index=0))]
    for name, args, kw in cases:
        fn = registry.get_op(name).fn
        want = fn(*args, **kw)
        common.reset_counts()
        got = fn(*[a.to(dev) for a in args], **kw)
        assert common.launch_counts() == {"kernels.launch.greedy_nms": 1}, \
            name
        assert common.selection_counts() == {
            "kernels.select.greedy_nms.cuda": 1}, name
        got = got.cpu()
        if name == "_contrib_MultiBoxDetection":
            assert torch.equal(got[..., 0], want[..., 0])
        if name == "_contrib_box_nms":
            assert torch.equal(got[..., 1] >= 0, want[..., 1] >= 0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
