"""The flash kernels' CUDA variants, from the Python side, on the CPU.

Which variant a dtype / head_dim selects, forward and backward
(``_variant``), how a head dim the kernels lack is padded to a kernel
width with the real head_dim's scale (``_padded_dim``, ``_kernel_width``), how the tensor-core variants' tensor maps see a tensor's strides,
and that their precondition check raises with a message (and never hands an
input to the other variant).  None of these needs a card: the checks run on
tensor metadata before any build or launch, and the dispatch tests replace
the launchers.  The kernels themselves are held against their plain
version on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""
import importlib

import pytest
import torch

fa = importlib.import_module("mxnet_tpu_torch.ops.kernels.flash_attention")

BF16 = torch.bfloat16


@pytest.mark.parametrize("dtype,D,variant", [
    (BF16, 64, "wgmma"), (BF16, 128, "wgmma"),
    (BF16, 16, "simt"), (BF16, 32, "simt"),
    (torch.float32, 16, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "tf32x3"), (torch.float32, 128, "tf32x3"),
    # head dims the kernels lack select by their padded width
    (BF16, 48, "wgmma"), (BF16, 80, "wgmma"), (BF16, 96, "wgmma"),
    (BF16, 33, "wgmma"), (BF16, 8, "simt"), (torch.float32, 48, "tf32x3"),
    (torch.float32, 96, "tf32x3"),
    # above 128: bf16 up to 1024 and f32 up to 512 on the tensor cores,
    # the rest wide
    (BF16, 129, "wgmma_wide"), (BF16, 256, "wgmma_wide"),
    pytest.param(torch.float32, 160, "tf32x3", id="dtype17-160-tf32x3"),
    (torch.float32, 320, "tf32x3_xwide"), (BF16, 576, "wgmma_xxwide"),
    (torch.float32, 576, "wide"), (BF16, 1025, "wide"),
    # f32 at head_dim 33-128: the narrow plans of tf32x3, both ways
    (torch.float32, 33, "tf32x3"), (torch.float32, 65, "tf32x3"),
    (torch.float32, 100, "tf32x3")])
def test_variant_by_dtype_and_head_dim(dtype, D, variant):
    """:func:`_variant` names the same variant forward and backward: f32
    at padded head_dim 64-256 runs on the tensor cores (``tf32x3``, at 64
    and 128 its narrow plans), and at 320-512 in 2-CTA clusters
    (``tf32x3_xwide``); bf16 at padded head_dim 576-1024 in 2-CTA clusters
    (``wgmma_xxwide``)."""
    assert fa._variant(dtype, D) == variant
    assert fa._variant(dtype, D, backward=True) == variant


@pytest.mark.parametrize("D,width", [(33, 64), (48, 64), (64, 64),
                                     (65, 128), (96, 128), (100, 128),
                                     (128, 128)])
def test_f32_backward_at_33_to_128_takes_tf32x3(D, width):
    """f32 at head_dim 33-128: dQ and dK/dV on the tensor cores
    (``tf32x3``'s narrow plan) at the padded width 64 or 128, and the
    forward too at the same width; 1-32 stays ``simt`` both ways."""
    assert fa._variant(torch.float32, D, backward=True) == "tf32x3"
    assert fa._kernel_width("tf32x3", D, backward=True) == width
    assert fa._variant(torch.float32, D) == "tf32x3"
    assert fa._kernel_width("tf32x3", D) == width
    for small in (1, 16, 17, 32):
        assert fa._variant(torch.float32, small, backward=True) == "simt"
        assert fa._variant(BF16, small, backward=True) == "simt"


@pytest.mark.parametrize("dtype,D,variant", [
    (BF16, 129, "wgmma_wide"), (BF16, 160, "wgmma_wide"),
    (BF16, 192, "wgmma_wide"), (BF16, 193, "wgmma_wide"),
    (BF16, 256, "wgmma_wide"), (BF16, 257, "wgmma_xwide"),
    (BF16, 320, "wgmma_xwide"),
    pytest.param(torch.float32, 192, "tf32x3", id="dtype7-192-tf32x3"),
    pytest.param(torch.float32, 256, "tf32x3", id="dtype8-256-tf32x3"),
    (BF16, 128, "wgmma")])
def test_backward_above_128_takes_wgmma_wide_for_bf16_up_to_256(dtype, D,
                                                                variant):
    """Above head_dim 128 the forward and the backward take the tensor-core
    wgmma_wide kernels for bf16 at the padded widths 192 and 256; f32 there
    takes the tensor-core tf32x3 kernels both ways.  Beyond 256 bf16 takes
    the tensor-core wgmma_xwide kernels, forward and backward: the same
    variant both ways."""
    assert fa._variant(dtype, D) == variant
    assert fa._variant(dtype, D, backward=True) == variant


@pytest.mark.parametrize("D,width", [(257, 320), (320, 320), (321, 384),
                                     (384, 384), (400, 448), (448, 448),
                                     (512, 512)])
def test_bf16_backward_at_257_to_512_takes_wgmma_xwide(D, width):
    """bf16 at head_dim 257-512 (padded to 320, 384, 448 or 512) takes the
    tensor-core wgmma_xwide kernels, the backward and the forward alike."""
    assert fa._padded_dim(D) == width
    assert width in fa._TC_WIDTHS["wgmma_xwide"]
    assert fa._variant(BF16, D) == "wgmma_xwide"
    assert fa._variant(BF16, D, backward=True) == "wgmma_xwide"
    assert fa._kernel_width("wgmma_xwide", D) == width


@pytest.mark.parametrize("dtype,D", [
    (BF16, 513), (BF16, 576), (BF16, 1024), (torch.float32, 257),
    (torch.float32, 320), (torch.float32, 512), (torch.float32, 576),
    (torch.float32, 513), (torch.float32, 1024), (BF16, 1000), (BF16, 1025),
    (BF16, 2048), (torch.float32, 448)])
def test_bf16_above_512_and_f32_above_256_stay_wide_both_ways(dtype, D):
    """What stays on the wide kernels above the one-CTA tensor-core
    widths: bf16 at 513-1024 takes the 2-CTA-cluster wgmma_xxwide kernels
    both ways, bf16 above 1024 wide both ways; f32 at 257-512 takes the
    2-CTA-cluster tf32x3_xwide kernels both ways, f32 above 512 wide both
    ways."""
    if dtype == BF16:
        want = "wgmma_xxwide" if D <= 1024 else "wide"
    else:
        want = "tf32x3_xwide" if D <= 512 else "wide"
    assert fa._variant(dtype, D) == want
    assert fa._variant(dtype, D, backward=True) == want


@pytest.mark.parametrize("D,width,bwd_width", [
    (257, 320, 384), (320, 320, 384), (384, 384, 384), (400, 448, 512),
    (448, 448, 512), (512, 512, 512)])
def test_f32_backward_at_257_to_512_takes_tf32x3_xwide(D, width, bwd_width):
    """f32 at head_dim 257-512: the forward and the backward on
    tf32x3_xwide at 384 (257-384) or 512 (385-512), the next of its own
    widths past the padded width: a pair of CTAs splits D evenly."""
    assert fa._padded_dim(D) == width
    assert fa._kernel_width("wide", D) == width
    for backward in (False, True):
        assert fa._variant(torch.float32, D, backward) == "tf32x3_xwide"
    assert fa._kernel_width("tf32x3_xwide", D) == bwd_width


@pytest.mark.parametrize("D,width,kernel_width", [
    (513, 576, 640), (576, 576, 640), (640, 640, 640), (641, 704, 768),
    (700, 704, 768), (768, 768, 768), (832, 832, 896), (896, 896, 896),
    (960, 960, 1024), (1000, 1024, 1024), (1024, 1024, 1024)])
def test_bf16_forward_at_513_to_1024_takes_wgmma_xxwide(D, width,
                                                        kernel_width):
    """bf16 at head_dim 513-1024: the forward on wgmma_xxwide at the next
    of 640, 768, 896 and 1024 (a pair of CTAs, each at a wgmma_xwide
    width), and the backward the same; wide would run the padded width."""
    assert fa._padded_dim(D) == width
    assert fa._variant(BF16, D) == "wgmma_xxwide"
    assert fa._kernel_width("wgmma_xxwide", D) == kernel_width
    assert kernel_width // 2 in fa._TC_WIDTHS["wgmma_xwide"]
    assert fa._variant(BF16, D, backward=True) == "wgmma_xxwide"
    assert fa._kernel_width("wide", D) == width


@pytest.mark.parametrize("D,variant,kernel_width", [
    (513, "wgmma_xxwide", 640), (576, "wgmma_xxwide", 640),
    (769, "wgmma_xxwide", 896), (1000, "wgmma_xxwide", 1024),
    (1024, "wgmma_xxwide", 1024), (1025, "wide", 1088)])
def test_bf16_backward_widths_above_512(D, variant, kernel_width):
    """The bf16 backward above 512: dQ and dK/dV on wgmma_xxwide (2-CTA
    clusters that split D) at 640, 768, 896 or 1024, the next of them past
    the padded width; above 1024 on wide at the padded width."""
    assert fa._variant(BF16, D, backward=True) == variant
    assert fa._kernel_width(variant, D) == kernel_width


@pytest.mark.parametrize("dtype,D", [(BF16, 1025), (BF16, 1088),
                                     (torch.float32, 513),
                                     (torch.float32, 1024)])
def test_past_the_cluster_widths_stays_wide(dtype, D):
    """bf16 above 1024 and f32 above 512 take the wide kernels both ways,
    at the padded width."""
    for backward in (False, True):
        assert fa._variant(dtype, D, backward) == "wide"
    assert fa._kernel_width("wide", D) == fa._padded_dim(D)


@pytest.mark.parametrize("dtype,D,variant", [
    (BF16, 64, "wgmma"), (BF16, 128, "wgmma"), (BF16, 32, "simt"),
    (torch.float32, 128, "tf32x3"), (BF16, 256, "wgmma_wide"),
    (torch.float32, 192, "tf32x3"), (BF16, 192, "wgmma_wide"),
    (BF16, 320, "wgmma_xwide"), (torch.float32, 160, "tf32x3"),
    (torch.float32, 256, "tf32x3"), (torch.float32, 320, "tf32x3_xwide"),
    (BF16, 512, "wgmma_xwide"), (BF16, 576, "wgmma_xxwide"),
    (torch.float32, 400, "tf32x3_xwide"), (torch.float32, 512, "tf32x3_xwide"),
    (BF16, 1024, "wgmma_xxwide"), (BF16, 1088, "wide"),
    (torch.float32, 576, "wide")])
def test_flash_cuda_dispatches_by_variant(monkeypatch, dtype, D, variant):
    """``_flash_cuda`` hands the inputs to the launcher its variant names,
    with the caller's arguments (160 padded to 192, 320 to 384, 400 to 512,
    576 to 640 in bf16: the variant's kernel width), and returns what it
    gives back, sliced to D."""
    calls = []

    def launcher(name):
        def launch(q, k, v, causal, scale, kv_len):
            calls.append((name, q.shape[-1], causal, scale, kv_len))
            return q, "lse"
        return launch

    for name in ("wgmma", "wgmma_wide", "wgmma_xwide", "wgmma_xxwide",
                 "tf32x3", "tf32x3_xwide", "simt", "wide"):
        monkeypatch.setattr(fa, "_flash_%s_cuda" % name, launcher(name))
    q = torch.zeros(1, 5, 2, D, dtype=dtype)
    o, lse = fa._flash_cuda(q, q, q, False, 0.5, 3)
    assert lse == "lse" and torch.equal(o, q)
    assert calls == [(variant, fa._kernel_width(variant, D), False, 0.5, 3)]


@pytest.mark.parametrize("D,width", [(1, 16), (16, 16), (17, 32), (32, 32),
                                     (33, 64), (48, 64), (64, 64),
                                     (65, 128), (80, 128), (96, 128),
                                     (128, 128), (129, 192), (160, 192),
                                     (192, 192), (256, 256), (257, 320),
                                     (320, 320)])
def test_padded_dim(D, width):
    assert fa._padded_dim(D) == width


def _bwd_launchers(monkeypatch, calls):
    """Replace the backward launchers (dQ and dK/dV of every variant) with
    recorders that return zeros of the right shapes."""
    def launcher(name):
        def launch(q, k, v, do, lse, delta, causal, scale):
            calls.append((name, q.shape[-1], do.shape[-1], causal, scale,
                          tuple(delta.shape)))
            if name.startswith("dq"):
                return torch.zeros_like(q)
            return torch.zeros_like(k), torch.zeros_like(v)
        return launch

    for name in ("dq_wgmma", "dkv_wgmma", "dq_simt", "dkv_simt", "dq_wide",
                 "dkv_wide", "dq_wgmma_wide", "dkv_wgmma_wide", "dq_tf32x3",
                 "dkv_tf32x3", "dq_wgmma_xwide", "dkv_wgmma_xwide",
                 "dq_tf32x3_xwide", "dkv_tf32x3_xwide", "dq_wgmma_xxwide",
                 "dkv_wgmma_xxwide"):
        monkeypatch.setattr(fa, "_flash_%s_cuda" % name, launcher(name))


@pytest.mark.parametrize("dtype,D,variant", [
    (BF16, 64, "wgmma"), (BF16, 128, "wgmma"), (BF16, 32, "simt"),
    (torch.float32, 128, "tf32x3"), (torch.float32, 64, "tf32x3"),
    (BF16, 256, "wgmma_wide"), (torch.float32, 192, "tf32x3"),
    (torch.float32, 256, "tf32x3"), (torch.float32, 320, "tf32x3_xwide"),
    (BF16, 320, "wgmma_xwide"), (BF16, 384, "wgmma_xwide"),
    (BF16, 448, "wgmma_xwide"), (BF16, 512, "wgmma_xwide"),
    (BF16, 576, "wgmma_xxwide"), (torch.float32, 384, "tf32x3_xwide"),
    (torch.float32, 448, "tf32x3_xwide"), (torch.float32, 512, "tf32x3_xwide"),
    (torch.float32, 576, "wide"), (BF16, 1024, "wgmma_xxwide"),
    (BF16, 1088, "wide")])
def test_flash_bwd_cuda_dispatches_by_variant(monkeypatch, dtype, D,
                                              variant):
    """``_flash_bwd_cuda`` hands the inputs to the dQ and the dK/dV
    launcher its variant names (f32 at 64 and 128: tf32x3), with the
    caller's arguments and ``delta`` [B, H, Tq]; tf32x3_xwide gets them
    padded to 384 or 512, wgmma_xxwide 576 padded to 640, and the gradients
    come back at D."""
    calls = []
    _bwd_launchers(monkeypatch, calls)
    q = torch.zeros(1, 5, 2, D, dtype=dtype)
    lse = torch.zeros(1, 2, 5)
    dq, dk, dv = fa._flash_bwd_cuda(q, q, q, q, lse, q, None, False, 0.5)
    W = fa._kernel_width(variant, D, backward=True)
    assert calls == [("dq_" + variant, W, W, False, 0.5, (1, 2, 5)),
                     ("dkv_" + variant, W, W, False, 0.5, (1, 2, 5))]
    assert dq.shape == dk.shape == dv.shape == q.shape


@pytest.mark.parametrize("dtype,D,width,variant", [
    (BF16, 48, 64, "wgmma"), (BF16, 80, 128, "wgmma"),
    (BF16, 96, 128, "wgmma"), (BF16, 20, 32, "simt"),
    (torch.float32, 48, 64, "tf32x3"), (torch.float32, 96, 128, "tf32x3")])
def test_padded_width_and_real_scale_reach_the_launchers(monkeypatch, dtype,
                                                         D, width, variant):
    """A head_dim the kernels lack runs at its padded width with ``scale``
    1/√D of the real D (``scale=None``), forward and backward on the same
    variant, and the outputs come back at D."""
    fwd = []

    def fwd_launcher(name):
        def launch(q, k, v, causal, scale, kv_len):
            fwd.append((name, q.shape[-1], k.shape[-1], v.shape[-1], scale))
            return (torch.zeros(q.shape, dtype=q.dtype),
                    torch.zeros(q.shape[0], q.shape[2], q.shape[1]))
        return launch

    for name in ("wgmma", "simt", "tf32x3"):
        monkeypatch.setattr(fa, "_flash_%s_cuda" % name, fwd_launcher(name))
    bwd = []
    _bwd_launchers(monkeypatch, bwd)
    q = torch.ones(1, 5, 2, D, dtype=dtype)
    o, lse = fa._flash_cuda(q, q, q)
    assert fwd == [(variant, width, width, width, 1.0 / D ** 0.5)]
    assert o.shape == q.shape and o.is_contiguous() and lse.shape == (1, 2, 5)
    grads = fa._flash_bwd_cuda(q, q, q, o, lse, q)
    assert [c[:5] for c in bwd] == [
        ("dq_" + variant, width, width, True, 1.0 / D ** 0.5),
        ("dkv_" + variant, width, width, True, 1.0 / D ** 0.5)]
    assert all(g.shape == q.shape and g.is_contiguous() for g in grads)


@pytest.mark.parametrize("D,width", [(33, 64), (40, 64), (64, 64),
                                     (65, 128), (96, 128), (100, 128),
                                     (128, 128)])
def test_padded_width_and_real_scale_reach_tf32x3_narrow(monkeypatch, D,
                                                        width):
    """f32 at head_dim 33-128: the tf32x3 forward, dQ and dK/dV launchers
    (the narrow plans) get q, k, v (and dO) zero-padded to 64 or 128 (the
    values unchanged, the new columns 0) with ``scale`` 1/√D of the real
    D, and ``delta`` from the unpadded o and dO; o and the gradients come
    back at D, contiguous, as the launchers computed them; no simt launcher
    runs."""
    fwd, seen = [], {}

    def narrow(q, k, v, causal, scale, kv_len):
        fwd.append((q, k, v, scale))
        return q * 5, torch.zeros(q.shape[0], q.shape[2], q.shape[1])

    def dq(q, k, v, do, lse, delta, causal, scale):
        seen["dq"] = (q, k, v, do, delta, scale)
        return q * 2

    def dkv(q, k, v, do, lse, delta, causal, scale):
        seen["dkv"] = (q, k, v, do, delta, scale)
        return k * 3, v * 4

    def refuse(*a):
        raise AssertionError("another variant ran")

    for kind in ("dq", "dkv"):
        for name in ("simt", "wgmma", "wide"):
            monkeypatch.setattr(fa, "_flash_%s_%s_cuda" % (kind, name),
                                refuse)
    for name in ("simt", "wgmma", "wide"):
        monkeypatch.setattr(fa, "_flash_%s_cuda" % name, refuse)
    monkeypatch.setattr(fa, "_flash_tf32x3_cuda", narrow)
    monkeypatch.setattr(fa, "_flash_dq_tf32x3_cuda", dq)
    monkeypatch.setattr(fa, "_flash_dkv_tf32x3_cuda", dkv)
    g = torch.Generator().manual_seed(D)
    q, k, v, do = (torch.randn(1, 6, 2, D, generator=g) for _ in range(4))
    o, lse = fa._flash_cuda(q, k, v)
    [(fq, fk, fv, fscale)] = fwd
    assert fscale == 1.0 / D ** 0.5
    for got, want in zip((fq, fk, fv), (q, k, v)):
        assert got.shape == (1, 6, 2, width)
        assert torch.equal(got[..., :D], want)
        assert not got[..., D:].any()
    assert o.shape == q.shape and o.is_contiguous()
    assert torch.equal(o, q * 5)
    grads = fa._flash_bwd_cuda(q, k, v, o, lse, do)
    for kind in ("dq", "dkv"):
        *ins, delta, scale = seen[kind]
        assert scale == 1.0 / D ** 0.5
        assert torch.equal(delta, fa._delta(o, do, None))
        for got, want in zip(ins, (q, k, v, do)):
            assert got.shape == (1, 6, 2, width)
            assert torch.equal(got[..., :D], want)
            assert not got[..., D:].any()
    for got, want in zip(grads, (q * 2, k * 3, v * 4)):
        assert got.shape == q.shape and got.is_contiguous()
        assert torch.equal(got, want)


def test_head_dim_zero_raises():
    """Every head_dim from 1 up runs on the card (padded where the kernels
    lack it); 0 is the only one refused, forward and backward."""
    q = torch.zeros(1, 4, 2, 0, dtype=BF16)
    with pytest.raises(ValueError, match="head_dim 0"):
        fa._flash_cuda(q, q, q)
    with pytest.raises(ValueError, match="head_dim 0"):
        fa._flash_bwd_cuda(q, q, q, q, torch.zeros(1, 2, 4), q)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("D,width", [(129, 192), (160, 192), (256, 256),
                                     (320, 320), (257, 320), (400, 448),
                                     (512, 512), (576, 576)])
def test_head_dims_above_128_reach_wide(monkeypatch, dtype, D, width):
    """Above 128 the forward, dQ and dK/dV go to the wide launchers or, up
    to 256, the wgmma_wide ones for bf16 and the tf32x3 ones for f32, at
    the width padded to a multiple of 64, with ``scale`` 1/√D of the real
    D; the outputs come back at D.  From 257 to 512 bf16 goes to the
    wgmma_xwide launchers and f32 to the tf32x3_xwide ones at 384 or 512,
    forward and backward; above 512 bf16 to wgmma_xwide's 2-CTA-cluster
    twin wgmma_xxwide at 640 (576), forward and backward, and f32 to
    wide."""
    fwd = []
    variant = bwd_variant = "wide"
    fwd_width = bwd_width = width
    if D <= 256:
        variant = bwd_variant = "wgmma_wide" if dtype == BF16 else "tf32x3"
    elif D <= 512 and dtype == BF16:
        variant = bwd_variant = "wgmma_xwide"
    elif D <= 512:
        variant = bwd_variant = "tf32x3_xwide"
        fwd_width = bwd_width = 384 if D <= 384 else 512
    elif dtype == BF16:
        variant = bwd_variant = "wgmma_xxwide"
        fwd_width = bwd_width = 640

    def launch(q, k, v, causal, scale, kv_len):
        fwd.append((q.shape[-1], k.shape[-1], v.shape[-1], scale))
        return (torch.zeros(q.shape, dtype=q.dtype),
                torch.zeros(q.shape[0], q.shape[2], q.shape[1]))

    def refuse(*a):
        raise AssertionError("another variant ran")

    for name in ("wgmma", "wgmma_wide", "wgmma_xwide", "wgmma_xxwide",
                 "tf32x3", "tf32x3_xwide", "simt", "wide"):
        monkeypatch.setattr(fa, "_flash_%s_cuda" % name,
                            launch if name == variant else refuse)
    bwd = []
    _bwd_launchers(monkeypatch, bwd)
    q = torch.ones(1, 5, 2, D, dtype=dtype)
    o, lse = fa._flash_cuda(q, q, q)
    assert fwd == [(fwd_width, fwd_width, fwd_width, 1.0 / D ** 0.5)]
    assert o.shape == q.shape and o.is_contiguous()
    grads = fa._flash_bwd_cuda(q, q, q, o, lse, q)
    assert [c[:5] for c in bwd] == [
        ("dq_" + bwd_variant, bwd_width, bwd_width, True, 1.0 / D ** 0.5),
        ("dkv_" + bwd_variant, bwd_width, bwd_width, True, 1.0 / D ** 0.5)]
    assert all(g.shape == q.shape and g.is_contiguous() for g in grads)


@pytest.mark.parametrize("D,width,bwd_width", [
    (257, 320, 384), (300, 320, 384), (384, 384, 384), (400, 448, 512),
    (512, 512, 512)])
def test_padded_width_and_real_scale_reach_tf32x3_xwide(monkeypatch, D,
                                                        width, bwd_width):
    """f32 at head_dim 257-512: the tf32x3_xwide forward gets q, k, v and
    the dQ and dK/dV launchers q, k, v and dO, zero-padded to 384 or 512
    (the values unchanged, the new columns 0; ``width``, the multiple of
    64, is what wide would take) with ``scale`` 1/√D of the real D; o and
    the gradients come back at D, contiguous, as the launchers computed
    them."""
    fwd, seen = [], {}

    def xwide(q, k, v, causal, scale, kv_len):
        fwd.append((q, k, v, scale))
        return q * 5, torch.zeros(q.shape[0], q.shape[2], q.shape[1])

    def dq(q, k, v, do, lse, delta, causal, scale):
        seen["dq"] = (q, k, v, do, scale)
        return q * 2

    def dkv(q, k, v, do, lse, delta, causal, scale):
        seen["dkv"] = (q, k, v, do, scale)
        return k * 3, v * 4

    monkeypatch.setattr(fa, "_flash_tf32x3_xwide_cuda", xwide)
    monkeypatch.setattr(fa, "_flash_dq_tf32x3_xwide_cuda", dq)
    monkeypatch.setattr(fa, "_flash_dkv_tf32x3_xwide_cuda", dkv)
    g = torch.Generator().manual_seed(D)
    q, k, v, do = (torch.randn(1, 6, 2, D, generator=g) for _ in range(4))
    assert fa._padded_dim(D) == width
    o, lse = fa._flash_cuda(q, k, v)
    [(fq, fk, fv, fscale)] = fwd
    assert fscale == 1.0 / D ** 0.5
    for got, want in zip((fq, fk, fv), (q, k, v)):
        assert got.shape == (1, 6, 2, bwd_width)
        assert torch.equal(got[..., :D], want)
        assert not got[..., D:].any()
    assert o.shape == q.shape and o.is_contiguous()
    assert torch.equal(o, q * 5)
    grads = fa._flash_bwd_cuda(q, k, v, o, lse, do)
    for kind in ("dq", "dkv"):
        *ins, scale = seen[kind]
        assert scale == 1.0 / D ** 0.5
        for got, want in zip(ins, (q, k, v, do)):
            assert got.shape == (1, 6, 2, bwd_width)
            assert torch.equal(got[..., :D], want)
            assert not got[..., D:].any()
    for got, want in zip(grads, (q * 2, k * 3, v * 4)):
        assert got.shape == (1, 6, 2, D) and got.is_contiguous()
        assert torch.equal(got, want)


def test_wide_launchers_refuse_other_widths_before_any_build(monkeypatch):
    """The wide launchers take head dims above 128 in multiples of 64 only
    (the wrapper pads); they raise before they build or count anything."""
    from mxnet_tpu_torch.ops.kernels import _build, common

    def no_build(*a, **k):
        raise AssertionError("built a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    common.reset_counts()
    lse = torch.zeros(1, 2, 8)
    for D in (128, 160):
        q = torch.zeros(1, 8, 2, D)
        with pytest.raises(ValueError, match="wide variant.*got %d" % D):
            fa._flash_wide_cuda(q, q, q)
        for launch in (fa._flash_dq_wide_cuda, fa._flash_dkv_wide_cuda):
            with pytest.raises(ValueError, match="wide variant.*got %d" % D):
                launch(q, q, q, q, lse, lse)
    assert common.launch_counts() == {}


@pytest.mark.parametrize("H,D", [(16, 128), (16, 64)])
@pytest.mark.parametrize("B,T", [(1, 4000), (1, 8192), (8, 1024), (1, 1),
                                 (2, 4001)])
def test_model_qkv_views_meet_the_preconditions(B, T, H, D):
    """The flagship's (16 x 128) and the long-context configuration's
    (16 x 64) q/k/v: [B, T, H, D] views of one fused qkv product, as
    models/transformer.py makes them; the check must not raise."""
    qkv = torch.zeros(B, T, 3 * H * D, dtype=BF16)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    fa._check_wgmma(q, k, v)
    fa._check_wgmma(q.contiguous(), k.contiguous(), v.contiguous())


def test_tma_strides_of_fused_and_contiguous_layouts():
    B, T, H, D = 2, 7, 3, 64
    qkv = torch.zeros(B, T, 3 * H * D, dtype=BF16)
    q = qkv[..., :H * D].view(B, T, H, D)
    assert fa._tma_strides(q) == (T * 3 * H * D, 3 * H * D, D)
    c = torch.zeros(B, T, H, D, dtype=BF16)
    assert fa._tma_strides(c) == c.stride()[:3]


@pytest.mark.parametrize("shape", [(1, 9, 3, 64), (2, 1, 3, 64),
                                   (2, 9, 1, 128), (1, 1, 1, 64)])
def test_tma_strides_replace_size_one_axes(shape):
    """A size-1 axis may carry any stride in PyTorch; the tensor map gets
    the contiguous one, so such a stride never fails the check."""
    B, T, H, D = shape
    t = torch.zeros(B, T, H, D, dtype=BF16).as_strided(
        shape, (1 if B == 1 else T * H * D, 3 if T == 1 else H * D,
                5 if H == 1 else D, 1))
    sb, st, sh = fa._tma_strides(t)
    assert sh == (D if H == 1 else t.stride(2))
    assert st == (H * sh if T == 1 else t.stride(1))
    assert sb == (T * st if B == 1 else t.stride(0))
    fa._check_wgmma(t, t, t)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_check_raises_on_misaligned_base(which):
    B, T, H, D = 1, 16, 2, 64
    good = torch.zeros(B, T, H, D, dtype=BF16)
    bad = torch.zeros(B * T * H * D + 1, dtype=BF16)[1:].view(B, T, H, D)
    args = [good, good, good]
    args[which] = bad
    name = "qkv"[which]
    with pytest.raises(ValueError,
                       match="%s's base address is not 16-byte aligned"
                       % name):
        fa._check_wgmma(*args)


@pytest.mark.parametrize("axis,stride", [("T", 132), ("B", 2 * 132 + 4),
                                         ("H", 68)])
def test_check_raises_on_strides_off_16_bytes(axis, stride):
    B, T, H, D = 2, 2, 2, 64
    strides = {"B": T * H * D, "T": H * D, "H": D}
    strides[axis] = stride
    n = max(strides[a] * (s - 1) for a, s in zip("BTH", (B, T, H))) * 3 + D
    t = torch.zeros(n, dtype=BF16).as_strided(
        (B, T, H, D), (strides["B"], strides["T"], strides["H"], 1))
    good = torch.zeros(B, T, H, D, dtype=BF16)
    with pytest.raises(ValueError,
                       match="k's %s stride %d is not a multiple of 8"
                       % (axis, stride)):
        fa._check_wgmma(good, t, good)


def test_wgmma_launcher_refuses_before_any_build(monkeypatch):
    """The tensor-core launcher raises on what it does not take before it
    builds or counts anything: another dtype or head_dim, a misaligned
    input."""
    from mxnet_tpu_torch.ops.kernels import _build, common

    def no_build(*a, **k):
        raise AssertionError("built a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    common.reset_counts()
    q32 = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="takes bf16 with head_dim"):
        fa._flash_wgmma_cuda(q32, q32, q32)
    q = torch.zeros(1, 8, 2, 32, dtype=BF16)
    with pytest.raises(ValueError, match="head_dim 32"):
        fa._flash_wgmma_cuda(q, q, q)
    bad = torch.zeros(8 * 2 * 64 + 1, dtype=BF16)[1:].view(1, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._flash_wgmma_cuda(bad, bad, bad)
    assert common.launch_counts() == {}


def test_bwd_launchers_refuse_before_any_build(monkeypatch):
    """The backward launchers raise on what they do not take before they
    build or count anything: the simt ones on a head_dim that is not a
    kernel width, the wgmma ones on another dtype or head_dim and on a
    misaligned q, k, v or dO."""
    from mxnet_tpu_torch.ops.kernels import _build, common

    def no_build(*a, **k):
        raise AssertionError("built a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    common.reset_counts()
    lse = torch.zeros(1, 2, 8)
    q48 = torch.zeros(1, 8, 2, 48)
    for launch in (fa._flash_dq_simt_cuda, fa._flash_dkv_simt_cuda):
        with pytest.raises(ValueError, match="simt variant.*got 48"):
            launch(q48, q48, q48, q48, lse, lse)
    q32 = torch.zeros(1, 8, 2, 64)
    good = torch.zeros(1, 8, 2, 64, dtype=BF16)
    bad = torch.zeros(8 * 2 * 64 + 1, dtype=BF16)[1:].view(1, 8, 2, 64)
    for launch in (fa._flash_dq_wgmma_cuda, fa._flash_dkv_wgmma_cuda):
        with pytest.raises(ValueError, match="takes bf16 with head_dim"):
            launch(q32, q32, q32, q32, lse, lse)
        for i, name in enumerate(("q", "k", "v", "dO")):
            args = [good] * 4
            args[i] = bad
            with pytest.raises(ValueError,
                               match="%s's base address" % name):
                launch(*args, lse, lse)
    assert common.launch_counts() == {}


@pytest.mark.parametrize("which", ["bwd", "fwd"])
def test_wgmma_wide_launchers_refuse_before_any_build(monkeypatch, which):
    """The wgmma_wide launchers (the forward; dQ and dK/dV) take bf16 at
    head_dim 192 or 256 only and raise on a misaligned q, k, v (or dO),
    before they build or count anything; never a hand-off to the wide
    kernels."""
    from mxnet_tpu_torch.ops.kernels import _build, common

    def no_build(*a, **k):
        raise AssertionError("built a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    common.reset_counts()
    lse = torch.zeros(1, 2, 8)
    good = torch.zeros(1, 8, 2, 256, dtype=BF16)
    bad = torch.zeros(8 * 2 * 256 + 1, dtype=BF16)[1:].view(1, 8, 2, 256)
    if which == "fwd":
        launchers = (lambda q, k, v, do: fa._flash_wgmma_wide_cuda(q, k, v),)
        names = ("q", "k", "v")
    else:
        launchers = (
            lambda q, k, v, do: fa._flash_dq_wgmma_wide_cuda(q, k, v, do,
                                                             lse, lse),
            lambda q, k, v, do: fa._flash_dkv_wgmma_wide_cuda(q, k, v, do,
                                                              lse, lse))
        names = ("q", "k", "v", "dO")
    for launch in launchers:
        for t in (torch.zeros(1, 8, 2, 256),
                  torch.zeros(1, 8, 2, 128, dtype=BF16),
                  torch.zeros(1, 8, 2, 320, dtype=BF16)):
            with pytest.raises(ValueError, match="wgmma_wide variant.*"
                               "takes bf16 with head_dim in \\(192, 256\\)"):
                launch(t, t, t, t)
        for i, name in enumerate(names):
            args = [good] * 4
            args[i] = bad
            with pytest.raises(ValueError, match="wgmma_wide variant.*%s's "
                               "base address" % name):
                launch(*args)
    assert common.launch_counts() == {}


@pytest.mark.parametrize("D", [160, 256])
def test_wgmma_wide_bwd_copies_a_dout_the_tma_cannot_read(monkeypatch, D):
    """As for the wgmma variant: a dO whose layout the TMA cannot read is
    copied before the wgmma_wide launchers see it (bf16, head_dim 160
    padded to 192, and 256)."""
    seen = []

    def dq(q, k, v, do, lse, delta, causal, scale):
        seen.append(do)
        return torch.zeros_like(q)

    monkeypatch.setattr(fa, "_flash_dq_wgmma_wide_cuda", dq)
    monkeypatch.setattr(fa, "_flash_dkv_wgmma_wide_cuda",
                        lambda q, k, v, *a: (torch.zeros_like(k),
                                             torch.zeros_like(v)))
    q = torch.zeros(1, 8, 2, D, dtype=BF16)
    bad = torch.arange(8 * 2 * D + 1).to(BF16)[1:].view(1, 8, 2, D)
    assert fa._tma_fault("dO", bad)
    fa._flash_bwd_cuda(q, q, q, q, torch.zeros(1, 2, 8), bad)
    assert fa._tma_fault("dO", seen[0]) is None
    assert seen[0].is_contiguous()
    assert torch.equal(seen[0][..., :D], bad)


@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("case", [
    "f32", "bf16_256", "bf16_576", "q", "k", "v", "dO", "k_stride",
    "dO_stride"])
def test_wgmma_xwide_launchers_refuse_before_any_build(monkeypatch, which,
                                                       case):
    """The wgmma_xwide launchers (dQ and dK/dV) take bf16 at head_dim 320,
    384, 448 or 512 only, read through TMA (bases 16-byte aligned, (B, T,
    H) strides multiples of 8 elements), and raise on anything else before
    they build or count anything; never a hand-off to the wide kernels."""
    from mxnet_tpu_torch.ops.kernels import _build, common

    def no_build(*a, **k):
        raise AssertionError("built a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    common.reset_counts()
    launch = {"dq": fa._flash_dq_wgmma_xwide_cuda,
              "dkv": fa._flash_dkv_wgmma_xwide_cuda}[which]
    shape = (1, 8, 2, 512)
    args = [torch.zeros(shape, dtype=BF16) for _ in range(4)]
    if case in ("f32", "bf16_256", "bf16_576"):
        dtype, D = {"f32": (torch.float32, 512), "bf16_256": (BF16, 256),
                    "bf16_576": (BF16, 576)}[case]
        args = [torch.zeros(1, 8, 2, D, dtype=dtype)] * 4
        match = ("wgmma_xwide variant.*takes bf16 with head_dim in "
                 "\\(320, 384, 448, 512\\); got %s, head_dim %d"
                 % (dtype, D))
    elif case.endswith("_stride"):
        name = case[:-len("_stride")]
        wide = torch.zeros(1, 8, 2 * 512 + 4, dtype=BF16)   # T stride 1028
        i = ("q", "k", "v", "dO").index(name)
        args[i] = wide[..., :2 * 512].view(shape)
        match = ("wgmma_xwide variant.*%s's T stride 1028 is not a multiple "
                 "of 8" % name)
    else:
        i = ("q", "k", "v", "dO").index(case)
        args[i] = _misaligned(shape, BF16)
        match = "wgmma_xwide variant.*%s's base address is not 16-byte" % case
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match=match):
        launch(*args, lse, lse)
    assert common.launch_counts() == {}


@pytest.mark.parametrize("D", [400, 512])
def test_wgmma_xwide_bwd_copies_a_dout_the_tma_cannot_read(monkeypatch, D):
    """As for the other bf16 tensor-core variants: a dO whose layout the
    TMA cannot read is copied before the wgmma_xwide launchers see it
    (head_dim 400 padded to 448, and 512)."""
    seen = []

    def dq(q, k, v, do, lse, delta, causal, scale):
        seen.append(do)
        return torch.zeros_like(q)

    monkeypatch.setattr(fa, "_flash_dq_wgmma_xwide_cuda", dq)
    monkeypatch.setattr(fa, "_flash_dkv_wgmma_xwide_cuda",
                        lambda q, k, v, *a: (torch.zeros_like(k),
                                             torch.zeros_like(v)))
    q = torch.zeros(1, 8, 2, D, dtype=BF16)
    bad = torch.arange(8 * 2 * D + 1).to(BF16)[1:].view(1, 8, 2, D)
    assert fa._tma_fault("dO", bad)
    fa._flash_bwd_cuda(q, q, q, q, torch.zeros(1, 2, 8), bad)
    assert len(seen) == 1
    assert fa._tma_fault("dO", seen[0]) is None
    assert seen[0].is_contiguous()
    assert torch.equal(seen[0][..., :D], bad)


@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("case", [
    "f32", "bf16_512", "bf16_576", "bf16_1088", "q", "k", "v", "dO",
    "k_stride", "dO_stride"])
def test_wgmma_xxwide_launchers_refuse_before_any_build(monkeypatch, which,
                                                        case):
    """The wgmma_xxwide launchers (dQ and dK/dV in 2-CTA clusters) take
    bf16 at head_dim 640, 768, 896 or 1024 only (the wrapper pads 513-1024
    to one of them), read through TMA (bases 16-byte aligned, (B, T, H)
    strides multiples of 8 elements), and raise on anything else before
    they build or count anything; never a hand-off to the wide kernels or
    the plain version."""
    from mxnet_tpu_torch.ops.kernels import _build, common

    def no_build(*a, **k):
        raise AssertionError("built a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    common.reset_counts()
    launch = {"dq": fa._flash_dq_wgmma_xxwide_cuda,
              "dkv": fa._flash_dkv_wgmma_xxwide_cuda}[which]
    shape = (1, 8, 2, 1024)
    args = [torch.zeros(shape, dtype=BF16) for _ in range(4)]
    if case in ("f32", "bf16_512", "bf16_576", "bf16_1088"):
        dtype, D = {"f32": (torch.float32, 1024), "bf16_512": (BF16, 512),
                    "bf16_576": (BF16, 576),
                    "bf16_1088": (BF16, 1088)}[case]
        args = [torch.zeros(1, 8, 2, D, dtype=dtype)] * 4
        match = ("wgmma_xxwide variant.*takes bf16 with head_dim in "
                 "\\(640, 768, 896, 1024\\); got %s, head_dim %d"
                 % (dtype, D))
    elif case.endswith("_stride"):
        name = case[:-len("_stride")]
        wide = torch.zeros(1, 8, 2 * 1024 + 4, dtype=BF16)  # T stride 2052
        i = ("q", "k", "v", "dO").index(name)
        args[i] = wide[..., :2 * 1024].view(shape)
        match = ("wgmma_xxwide variant.*%s's T stride 2052 is not a "
                 "multiple of 8" % name)
    else:
        i = ("q", "k", "v", "dO").index(case)
        args[i] = _misaligned(shape, BF16)
        match = ("wgmma_xxwide variant.*%s's base address is not 16-byte"
                 % case)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match=match):
        launch(*args, lse, lse)
    assert common.launch_counts() == {}


@pytest.mark.parametrize("D,kernel_width", [(576, 640), (700, 768),
                                            (1000, 1024), (1024, 1024)])
def test_padded_width_and_real_scale_reach_wgmma_xxwide_bwd(monkeypatch, D,
                                                            kernel_width):
    """bf16 at head_dim 513-1024: ``_flash_bwd_cuda`` hands the
    wgmma_xxwide dQ and dK/dV launchers q, k, v and dO zero-padded to the
    kernel width (the values unchanged, the new columns 0) with ``scale``
    1/√D of the real D, and slices the gradients back to D, contiguous, as
    the launchers computed them."""
    seen = {}

    def dq(q, k, v, do, lse, delta, causal, scale):
        seen["dq"] = (q, k, v, do, causal, scale)
        return q * 2

    def dkv(q, k, v, do, lse, delta, causal, scale):
        seen["dkv"] = (q, k, v, do, causal, scale)
        return k * 3, v * 4

    def refuse(*a):
        raise AssertionError("another variant ran")

    for name in ("wgmma", "wgmma_wide", "wgmma_xwide", "tf32x3",
                 "tf32x3_xwide", "simt", "wide"):
        for kind in ("dq", "dkv"):
            monkeypatch.setattr(fa, "_flash_%s_%s_cuda" % (kind, name),
                                refuse)
    monkeypatch.setattr(fa, "_flash_dq_wgmma_xxwide_cuda", dq)
    monkeypatch.setattr(fa, "_flash_dkv_wgmma_xxwide_cuda", dkv)
    g = torch.Generator().manual_seed(D)
    q, k, v, o, do = (torch.randn(1, 6, 2, D, generator=g).to(BF16)
                      for _ in range(5))
    grads = fa._flash_bwd_cuda(q, k, v, o, torch.zeros(1, 2, 6), do, None,
                               False)
    for kind in ("dq", "dkv"):
        *ins, causal, scale = seen[kind]
        assert causal is False and scale == 1.0 / D ** 0.5
        for got, want in zip(ins, (q, k, v, do)):
            assert got.shape == (1, 6, 2, kernel_width)
            assert got.dtype == BF16
            assert torch.equal(got[..., :D], want)
            assert not got[..., D:].any()
    for got, want in zip(grads, (q * 2, k * 3, v * 4)):
        assert got.shape == (1, 6, 2, D) and got.is_contiguous()
        assert torch.equal(got, want[..., :D])


@pytest.mark.parametrize("D", [576, 1024])
def test_wgmma_xxwide_bwd_copies_a_dout_the_tma_cannot_read(monkeypatch, D):
    """As for wgmma_xwide: a dO whose layout the TMA cannot read is copied
    before the wgmma_xxwide launchers see it (head_dim 576 padded to 640,
    and 1024)."""
    seen = []

    def dq(q, k, v, do, lse, delta, causal, scale):
        seen.append(do)
        return torch.zeros_like(q)

    monkeypatch.setattr(fa, "_flash_dq_wgmma_xxwide_cuda", dq)
    monkeypatch.setattr(fa, "_flash_dkv_wgmma_xxwide_cuda",
                        lambda q, k, v, *a: (torch.zeros_like(k),
                                             torch.zeros_like(v)))
    q = torch.zeros(1, 8, 2, D, dtype=BF16)
    bad = torch.arange(8 * 2 * D + 1).to(BF16)[1:].view(1, 8, 2, D)
    assert fa._tma_fault("dO", bad)
    fa._flash_bwd_cuda(q, q, q, q, torch.zeros(1, 2, 8), bad)
    assert len(seen) == 1
    assert fa._tma_fault("dO", seen[0]) is None
    assert seen[0].is_contiguous()
    assert torch.equal(seen[0][..., :D], bad)


def test_bwd_copies_a_dout_the_tma_cannot_read(monkeypatch):
    """dO is an internal cotangent: where its layout fails the wgmma
    variant's preconditions the backward copies it (the launchers see an
    aligned contiguous dO with the same values)."""
    seen = []

    def dq(q, k, v, do, lse, delta, causal, scale):
        seen.append(do)
        return torch.zeros_like(q)

    monkeypatch.setattr(fa, "_flash_dq_wgmma_cuda", dq)
    monkeypatch.setattr(fa, "_flash_dkv_wgmma_cuda",
                        lambda q, k, v, *a: (torch.zeros_like(k),
                                             torch.zeros_like(v)))
    q = torch.zeros(1, 8, 2, 64, dtype=BF16)
    bad = torch.arange(8 * 2 * 64 + 1).to(BF16)[1:].view(1, 8, 2, 64)
    assert fa._tma_fault("dO", bad)
    fa._flash_bwd_cuda(q, q, q, q, torch.zeros(1, 2, 8), bad)
    assert fa._tma_fault("dO", seen[0]) is None
    assert seen[0].is_contiguous() and torch.equal(seen[0], bad)


def test_lse_rows_padded_to_64():
    x = torch.arange(2 * 3 * 70, dtype=torch.float32).view(2, 3, 70)
    p = fa._rows_padded(x, 70)
    assert p.shape == (2, 3, 128) and p.is_contiguous()
    assert torch.equal(p[..., :70], x) and not p[..., 70:].any()
    assert fa._rows_padded(x[..., :64], 64).shape == (2, 3, 64)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    common = importlib.import_module("mxnet_tpu_torch.ops.kernels.common")
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 70, 2, 64, generator=g).to(BF16)
               for _ in range(3))
    common.reset_counts()
    o = fa.flash_attention(q, k, v)
    assert common.launch_counts() == {}
    assert common.selection_counts() == {
        "kernels.select.flash_attention.reference": 1}
    assert torch.equal(o, fa.flash_attention_reference(q, k, v))


def _misaligned(shape, dtype):
    """A ``shape`` tensor whose base is one element past a 16-byte
    boundary."""
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("case", [
    "bf16", "f32_128", "f32_320", "q", "k", "v", "dO", "k_stride",
    "f32_96", "f32_32", "bf16_64", "q_64", "dO_128", "k_stride_64"])
def test_tf32x3_launchers_refuse_before_any_build(monkeypatch, which, case):
    """The tf32x3 backward launchers take f32 at head_dim 64, 128, 192 or
    256 only (``f32_128`` gets past every check to the build), read through
    16-byte copies (a base 16-byte aligned, strides multiples of 4
    elements), and raise on anything else before they build or count
    anything; never a hand-off to the simt or the wide kernels."""
    from mxnet_tpu_torch.ops.kernels import _build, common

    def no_build(*a, **k):
        raise AssertionError("built a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    common.reset_counts()
    launch = {"dq": fa._flash_dq_tf32x3_cuda,
              "dkv": fa._flash_dkv_tf32x3_cuda}[which]
    width = {"q_64": 64, "dO_128": 128, "k_stride_64": 64}.get(case, 256)
    shape = (1, 8, 2, width)
    args = [torch.zeros(shape) for _ in range(4)]
    widths = {"bf16": (BF16, 256), "f32_128": (torch.float32, 128),
              "f32_320": (torch.float32, 320), "f32_96": (torch.float32, 96),
              "f32_32": (torch.float32, 32), "bf16_64": (BF16, 64)}
    if case in widths:
        dtype, D = widths[case]
        args = [torch.zeros(1, 8, 2, D, dtype=dtype)] * 4
        match = ("tf32x3 variant.*takes float32 with head_dim in "
                 "\\(64, 128, 192, 256\\); got %s, head_dim %d"
                 % (dtype, D))
    elif case.startswith("k_stride"):
        # T stride 2 * width + 2: 2 mod 4
        wide = torch.zeros(1, 8, 2 * width + 2)
        args[1] = wide[..., :2 * width].view(shape)
        match = ("tf32x3 variant.*k's T stride %d is not a multiple of 4"
                 % (2 * width + 2))
    else:
        name = case.split("_")[0]
        i = ("q", "k", "v", "dO").index(name)
        args[i] = _misaligned(shape, torch.float32)
        match = "tf32x3 variant.*%s's base address is not 16-byte" % name
    lse = torch.zeros(1, 2, 8)
    if case == "f32_128":
        with pytest.raises(AssertionError, match="built a kernel"):
            launch(*args, lse, lse)
    else:
        with pytest.raises(ValueError, match=match):
            launch(*args, lse, lse)
    assert common.launch_counts() == {}


@pytest.mark.parametrize("case", [
    "bf16", "f32_128", "f32_320", "q", "k", "v", "k_stride", "f32_64",
    "f32_96", "f32_32", "bf16_64", "q_64", "v_128", "k_stride_64",
    "v_stride_128"])
def test_tf32x3_forward_launcher_refuses_before_any_build(monkeypatch,
                                                          case):
    """The tf32x3 forward launcher takes f32 at head_dim 64, 128, 192 or 256
    only (``f32_128`` and ``f32_64`` get past every check to the build),
    read through 16-byte copies (a base 16-byte aligned, strides multiples
    of 4 elements), and raises on anything else before it builds or counts
    anything; never a hand-off to the simt or the wide kernel."""
    from mxnet_tpu_torch.ops.kernels import _build, common

    def no_build(*a, **k):
        raise AssertionError("built a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    common.reset_counts()
    width = {"q_64": 64, "v_128": 128, "k_stride_64": 64,
             "v_stride_128": 128}.get(case, 256)
    shape = (1, 8, 2, width)
    args = [torch.zeros(shape) for _ in range(3)]
    widths = {"bf16": (BF16, 256), "f32_128": (torch.float32, 128),
              "f32_320": (torch.float32, 320), "f32_64": (torch.float32, 64),
              "f32_96": (torch.float32, 96), "f32_32": (torch.float32, 32),
              "bf16_64": (BF16, 64)}
    if case in widths:
        dtype, D = widths[case]
        args = [torch.zeros(1, 8, 2, D, dtype=dtype)] * 3
        match = ("tf32x3 variant.*takes float32 with head_dim in "
                 "\\(64, 128, 192, 256\\); got %s, head_dim %d"
                 % (dtype, D))
    elif "_stride" in case:
        # T stride 2 * width + 2: 2 mod 4
        name = case[0]
        wide = torch.zeros(1, 8, 2 * width + 2)
        args[("q", "k", "v").index(name)] = wide[..., :2 * width].view(shape)
        match = ("tf32x3 variant.*%s's T stride %d is not a multiple of 4"
                 % (name, 2 * width + 2))
    else:
        name = case.split("_")[0]
        i = ("q", "k", "v").index(name)
        args[i] = _misaligned(shape, torch.float32)
        match = "tf32x3 variant.*%s's base address is not 16-byte" % name
    if case in ("f32_128", "f32_64"):
        with pytest.raises(AssertionError, match="built a kernel"):
            fa._flash_tf32x3_cuda(*args)
    else:
        with pytest.raises(ValueError, match=match):
            fa._flash_tf32x3_cuda(*args)
    assert common.launch_counts() == {}


@pytest.mark.parametrize("case", [
    "f32", "bf16_256", "bf16_576", "q", "k", "v", "k_stride"])
def test_wgmma_xwide_forward_launcher_refuses_before_any_build(monkeypatch,
                                                               case):
    """The wgmma_xwide forward launcher takes bf16 at head_dim 320, 384,
    448 or 512 only, read through TMA (bases 16-byte aligned, (B, T, H)
    strides multiples of 8 elements), and raises on anything else before
    it builds or counts anything; never a hand-off to the wide kernel."""
    from mxnet_tpu_torch.ops.kernels import _build, common

    def no_build(*a, **k):
        raise AssertionError("built a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    common.reset_counts()
    shape = (1, 8, 2, 512)
    args = [torch.zeros(shape, dtype=BF16) for _ in range(3)]
    if case in ("f32", "bf16_256", "bf16_576"):
        dtype, D = {"f32": (torch.float32, 512), "bf16_256": (BF16, 256),
                    "bf16_576": (BF16, 576)}[case]
        args = [torch.zeros(1, 8, 2, D, dtype=dtype)] * 3
        match = ("wgmma_xwide variant.*takes bf16 with head_dim in "
                 "\\(320, 384, 448, 512\\); got %s, head_dim %d"
                 % (dtype, D))
    elif case == "k_stride":
        wide = torch.zeros(1, 8, 2 * 512 + 4, dtype=BF16)   # T stride 1028
        args[1] = wide[..., :2 * 512].view(shape)
        match = "wgmma_xwide variant.*k's T stride 1028 is not a multiple of 8"
    else:
        i = ("q", "k", "v").index(case)
        args[i] = _misaligned(shape, BF16)
        match = "wgmma_xwide variant.*%s's base address is not 16-byte" % case
    with pytest.raises(ValueError, match=match):
        fa._flash_wgmma_xwide_cuda(*args)
    assert common.launch_counts() == {}


@pytest.mark.parametrize("stride,ok", [(4 * 129, True), (2 * 257, False)])
def test_f32_strides_need_16_bytes_not_8_elements(stride, ok):
    """The 16-byte copies count strides in bytes: an f32 T stride that is a
    multiple of 4 elements passes (it would fail a bf16 rule of 8), one of
    2 mod 4 does not."""
    t = torch.zeros(stride * 4).as_strided((1, 4, 2, 128), (4 * stride,
                                                           stride, 128, 1))
    fault = fa._tma_fault("q", t)
    assert (fault is None) == ok
    if not ok:
        assert "T stride %d is not a multiple of 4 elements" % stride in fault


@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("case", [
    "bf16", "f32_256", "f32_320", "f32_576", "q", "k", "v", "dO",
    "k_stride", "dO_stride"])
def test_tf32x3_xwide_launchers_refuse_before_any_build(monkeypatch, which,
                                                        case):
    """The tf32x3_xwide launchers take f32 at head_dim 384 or 512 only (the
    wrapper pads 257-512 to one of them), read through 16-byte copies (a
    base 16-byte aligned, (B, T, H) strides multiples of 4 elements), and
    raise on anything else before they build or count anything; never a
    hand-off to the wide kernels or the plain version."""
    from mxnet_tpu_torch.ops.kernels import _build, common

    def no_build(*a, **k):
        raise AssertionError("built a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    common.reset_counts()
    launch = {"dq": fa._flash_dq_tf32x3_xwide_cuda,
              "dkv": fa._flash_dkv_tf32x3_xwide_cuda}[which]
    shape = (1, 8, 2, 512)
    args = [torch.zeros(shape) for _ in range(4)]
    if case in ("bf16", "f32_256", "f32_320", "f32_576"):
        dtype, D = {"bf16": (BF16, 512), "f32_256": (torch.float32, 256),
                    "f32_320": (torch.float32, 320),
                    "f32_576": (torch.float32, 576)}[case]
        args = [torch.zeros(1, 8, 2, D, dtype=dtype)] * 4
        match = ("tf32x3_xwide variant.*takes float32 with head_dim in "
                 "\\(384, 512\\); got %s, head_dim %d" % (dtype, D))
    elif case.endswith("_stride"):
        name = case[:-len("_stride")]
        wide = torch.zeros(1, 8, 2 * 512 + 2)     # T stride 1026: 2 mod 4
        i = ("q", "k", "v", "dO").index(name)
        args[i] = wide[..., :2 * 512].view(shape)
        match = ("tf32x3_xwide variant.*%s's T stride 1026 is not a "
                 "multiple of 4" % name)
    else:
        i = ("q", "k", "v", "dO").index(case)
        args[i] = _misaligned(shape, torch.float32)
        match = ("tf32x3_xwide variant.*%s's base address is not 16-byte"
                 % case)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match=match):
        launch(*args, lse, lse)
    assert common.launch_counts() == {}


@pytest.mark.parametrize("D", [320, 512])
def test_tf32x3_xwide_bwd_copies_a_dout_the_copies_cannot_read(monkeypatch,
                                                               D):
    """As for tf32x3: an f32 dO whose layout the 16-byte copies cannot read
    is copied before the tf32x3_xwide launchers see it (head_dim 320
    padded to 384, and 512)."""
    seen = []

    def dq(q, k, v, do, lse, delta, causal, scale):
        seen.append(do)
        return torch.zeros_like(q)

    monkeypatch.setattr(fa, "_flash_dq_tf32x3_xwide_cuda", dq)
    monkeypatch.setattr(fa, "_flash_dkv_tf32x3_xwide_cuda",
                        lambda q, k, v, *a: (torch.zeros_like(k),
                                             torch.zeros_like(v)))
    q = torch.zeros(1, 8, 2, D)
    bad = torch.arange(8 * 2 * D + 1, dtype=torch.float32)[1:].view(
        1, 8, 2, D)
    assert fa._tma_fault("dO", bad)
    fa._flash_bwd_cuda(q, q, q, q, torch.zeros(1, 2, 8), bad)
    assert len(seen) == 1
    assert fa._tma_fault("dO", seen[0]) is None
    assert seen[0].is_contiguous()
    assert torch.equal(seen[0][..., :D], bad)


@pytest.mark.parametrize("D", [160, 256])
def test_tf32x3_bwd_copies_a_dout_the_copies_cannot_read(monkeypatch, D):
    """As for the bf16 tensor-core variants: an f32 dO whose layout the
    16-byte copies cannot read is copied before the tf32x3 launchers see it
    (head_dim 160 padded to 192, and 256)."""
    seen = []

    def dq(q, k, v, do, lse, delta, causal, scale):
        seen.append(do)
        return torch.zeros_like(q)

    monkeypatch.setattr(fa, "_flash_dq_tf32x3_cuda", dq)
    monkeypatch.setattr(fa, "_flash_dkv_tf32x3_cuda",
                        lambda q, k, v, *a: (torch.zeros_like(k),
                                             torch.zeros_like(v)))
    q = torch.zeros(1, 8, 2, D)
    bad = torch.arange(8 * 2 * D + 1, dtype=torch.float32)[1:].view(
        1, 8, 2, D)
    assert fa._tma_fault("dO", bad)
    fa._flash_bwd_cuda(q, q, q, q, torch.zeros(1, 2, 8), bad)
    assert fa._tma_fault("dO", seen[0]) is None
    assert seen[0].is_contiguous()
    assert torch.equal(seen[0][..., :D], bad)


@pytest.mark.parametrize("variant,case", [
    (variant, case) for variant in ("tf32x3_xwide", "wgmma_xxwide")
    for case in ("other_dtype", "one_cta_width", "wide_width", "odd_width",
                 "q", "k", "v", "k_stride")])
def test_cluster_forward_launchers_refuse_before_any_build(monkeypatch,
                                                           variant, case):
    """The 2-CTA-cluster forward launchers take their dtype at their own
    widths only (tf32x3_xwide: f32 at 384 or 512; wgmma_xxwide: bf16 at
    640, 768, 896 or 1024; the wrapper pads to them), read through 16-byte
    copies (bases 16-byte aligned, (B, T, H) strides multiples of 16
    bytes), and raise on anything else before they build or count
    anything; never a hand-off to the wide kernel."""
    from mxnet_tpu_torch.ops.kernels import _build, common

    def no_build(*a, **k):
        raise AssertionError("built a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    common.reset_counts()
    dtype = fa._TC_DTYPE[variant]
    widths = fa._TC_WIDTHS[variant]
    launch = getattr(fa, "_flash_%s_cuda" % variant)
    D = widths[-1]
    shape = (1, 8, 2, D)
    args = [torch.zeros(shape, dtype=dtype) for _ in range(3)]
    per = 16 // args[0].element_size()
    if case in ("other_dtype", "one_cta_width", "wide_width", "odd_width"):
        other = torch.float32 if dtype == BF16 else BF16
        bad_dtype, bad_D = {
            "other_dtype": (other, D),
            "one_cta_width": (dtype, D // 2),
            "wide_width": (dtype, 2 * D),
            "odd_width": (dtype, widths[0] - 64)}[case]
        args = [torch.zeros(1, 8, 2, bad_D, dtype=bad_dtype)] * 3
        match = ("%s variant.*takes %s with head_dim in \\(%s\\); got %s, "
                 "head_dim %d" % (variant, "bf16" if dtype == BF16
                                  else "float32",
                                  ", ".join(map(str, widths)), bad_dtype,
                                  bad_D))
    elif case == "k_stride":
        wide = torch.zeros(1, 8, 2 * D + per // 2, dtype=dtype)
        args[1] = wide[..., :2 * D].view(shape)
        match = ("%s variant.*k's T stride %d is not a multiple of %d"
                 % (variant, 2 * D + per // 2, per))
    else:
        i = ("q", "k", "v").index(case)
        args[i] = _misaligned(shape, dtype)
        match = "%s variant.*%s's base address is not 16-byte" % (variant,
                                                                  case)
    with pytest.raises(ValueError, match=match):
        launch(*args)
    assert common.launch_counts() == {}


@pytest.mark.parametrize("dtype,D,variant,kernel_width", [
    (torch.float32, 400, "tf32x3_xwide", 512),
    (torch.float32, 512, "tf32x3_xwide", 512),
    (BF16, 576, "wgmma_xxwide", 640),
    (BF16, 1000, "wgmma_xxwide", 1024),
    (BF16, 1024, "wgmma_xxwide", 1024)])
def test_padded_width_and_real_scale_reach_the_cluster_forwards(
        monkeypatch, dtype, D, variant, kernel_width):
    """``_flash_cuda`` hands the cluster forwards q, k and v zero-padded to
    the variant's kernel width (the values unchanged, the new columns 0)
    with ``scale`` 1/√D of the real D and the caller's ``causal`` and
    ``kv_len``, and slices o back to D, contiguous; lse as returned."""
    seen = []

    def launch(q, k, v, causal, scale, kv_len):
        seen.append((q, k, v, causal, scale, kv_len))
        return q * 3, "lse"

    def refuse(*a):
        raise AssertionError("another variant ran")

    for name in ("wgmma", "wgmma_wide", "wgmma_xwide", "wgmma_xxwide",
                 "tf32x3", "tf32x3_xwide", "simt", "wide"):
        monkeypatch.setattr(fa, "_flash_%s_cuda" % name,
                            launch if name == variant else refuse)
    g = torch.Generator().manual_seed(D)
    q, k, v = (torch.randn(1, 6, 2, D, generator=g).to(dtype)
               for _ in range(3))
    o, lse = fa._flash_cuda(q, k, v, False, None, 4)
    [(pq, pk, pv, causal, scale, kv_len)] = seen
    assert (causal, kv_len, lse) == (False, 4, "lse")
    assert scale == 1.0 / D ** 0.5
    for got, want in zip((pq, pk, pv), (q, k, v)):
        assert got.shape == (1, 6, 2, kernel_width) and got.dtype == dtype
        assert torch.equal(got[..., :D], want)
        assert not got[..., D:].any()
    assert o.shape == q.shape and o.is_contiguous()
    assert torch.equal(o, q * 3)
