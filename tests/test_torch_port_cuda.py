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
above 128 take the flash kernels' wide variant, held to the plain versions
at the padded cases' tolerances, and a TransformerLM with head_dim 256
prefills through it as through the plain versions.

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
    _flash_dq_wgmma_cuda, _flash_simt_cuda, _flash_wgmma_cuda,
    flash_attention, flash_attention_bwd_reference, flash_attention_lse,
    flash_attention_reference)
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


@pytest.mark.parametrize("launch", [_flash_wgmma_cuda, _flash_simt_cuda])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kv_len_and_rows_without_keys(dev, launch, causal):
    """``kv_len`` (``_fwd``'s argument) masks keys at and past it: the same
    as attending over the first kv_len keys; with kv_len 0 every row has l
    = 0 and gets o = 0 and the finite lse -1e30, in both variants."""
    q, k, v = _qkv(dev, 1, 200, 300, 2, 128, seed=4)
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
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt")])
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
    B, T, H, D = 1, 130, 2, 64
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(B, T, H, D, generator=g, device=dev,
                           requires_grad=True) for _ in range(3))
    common.reset_counts()
    o, lse = flash_attention_lse(q, k, v)
    (o.square().sum() + lse.tanh().sum()).backward()
    assert common.launch_counts() == {
        "kernels.launch.flash_attention": 1,
        "kernels.launch.flash_attention.simt": 1,
        "kernels.launch.flash_attention_dq": 1,
        "kernels.launch.flash_attention_dq.simt": 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.simt": 1}
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
# head dims the kernels do not have: zero-padded along D on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [48, 80, 96, 160, 256, 320])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_padded_head_dims_match_plain(dev, D, dtype, causal):
    """Forward and backward at head_dim 48, 80 and 96 (padded to 64, 128
    and 128) and above 128 (160 padded to 192, 256, 320: the wide
    variant): no ValueError, the plain version's results, ``scale`` from
    the real head_dim, and the padded variant's launches."""
    B, Tq, Tk, H = 1, 150, 150, 2
    common.reset_counts()
    q, k, v, o, lse, do, dlse = _flash_bwd_inputs(dev, B, Tq, Tk, H, D,
                                                  causal, dtype)
    if D > 128:
        variant = "wide"
    else:
        variant = "wgmma" if dtype == torch.bfloat16 else "simt"
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
        "kernels.launch.flash_attention_dq.%s" % variant: 1,
        "kernels.launch.flash_attention_dkv": 1,
        "kernels.launch.flash_attention_dkv.%s" % variant: 1}
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, dlse, causal)
    gtol = F32_GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL
    for gt, wt, name in zip(got, want, ("dq", "dk", "dv")):
        assert gt.shape == wt.shape and gt.is_contiguous(), name
        np.testing.assert_allclose(_np(gt), _np(wt), err_msg=name, **gtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wide_kv_len_strided_views_and_repeat(dev, dtype):
    """The wide forward masks keys at and past kv_len, reads q/k/v slices
    of a fused qkv tensor through their strides, and its backward gives the
    same bits twice (no atomics)."""
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
    first = _flash_bwd_cuda(q, k, v, o, lse, do, None, True)
    again = _flash_bwd_cuda(q, k, v, o, lse, do, None, True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, None, True)
    gtol = F32_GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL
    for gt, wt, name in zip(first, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(gt), _np(wt), err_msg=name, **gtol)


def test_transformer_prefill_at_head_dim_256_matches_plain(dev):
    """A TransformerLM with head_dim 256 (d_model 512, 2 heads) prefills a
    prompt whose scores pass the dense gate through the wide flash kernels,
    and its logits match those through the plain versions."""
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
    assert launches.get("kernels.launch.flash_attention.wide") == 2
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
