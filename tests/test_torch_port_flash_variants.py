"""The flash kernels' three CUDA variants, from the Python side, on the CPU.

Which variant a dtype / head_dim selects (forward and backward), how a head
dim the kernels lack is padded to a kernel width with the real head_dim's
scale, how the tensor-core variants' tensor maps see a tensor's strides,
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
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    # head dims the kernels lack select by their padded width
    (BF16, 48, "wgmma"), (BF16, 80, "wgmma"), (BF16, 96, "wgmma"),
    (BF16, 33, "wgmma"), (BF16, 8, "simt"), (torch.float32, 48, "simt"),
    (torch.float32, 96, "simt"),
    # above 128 every dtype takes the wide variant
    (BF16, 129, "wide"), (BF16, 256, "wide"), (torch.float32, 160, "wide"),
    (torch.float32, 320, "wide")])
def test_variant_by_dtype_and_head_dim(dtype, D, variant):
    """The forward and the backward select alike."""
    assert fa._fwd_variant(dtype, D) == variant
    assert fa._bwd_variant(dtype, D) == variant


@pytest.mark.parametrize("dtype,D,variant", [
    (BF16, 64, "wgmma"), (BF16, 128, "wgmma"), (BF16, 32, "simt"),
    (torch.float32, 128, "simt"), (BF16, 256, "wide"),
    (torch.float32, 192, "wide")])
def test_flash_cuda_dispatches_by_variant(monkeypatch, dtype, D, variant):
    """``_flash_cuda`` hands the inputs to the launcher its variant names,
    with the caller's arguments."""
    calls = []

    def launcher(name):
        def launch(q, k, v, causal, scale, kv_len):
            calls.append((name, causal, scale, kv_len))
            return "out"
        return launch

    for name in ("wgmma", "simt", "wide"):
        monkeypatch.setattr(fa, "_flash_%s_cuda" % name, launcher(name))
    q = torch.zeros(1, 5, 2, D, dtype=dtype)
    assert fa._flash_cuda(q, q, q, False, 0.5, 3) == "out"
    assert calls == [(variant, False, 0.5, 3)]


@pytest.mark.parametrize("D,width", [(1, 16), (16, 16), (17, 32), (32, 32),
                                     (33, 64), (48, 64), (64, 64),
                                     (65, 128), (80, 128), (96, 128),
                                     (128, 128), (129, 192), (160, 192),
                                     (192, 192), (256, 256), (257, 320),
                                     (320, 320)])
def test_padded_dim(D, width):
    assert fa._padded_dim(D) == width


def _bwd_launchers(monkeypatch, calls):
    """Replace the four backward launchers with recorders that return
    zeros of the right shapes."""
    def launcher(name):
        def launch(q, k, v, do, lse, delta, causal, scale):
            calls.append((name, q.shape[-1], do.shape[-1], causal, scale,
                          tuple(delta.shape)))
            if name.startswith("dq"):
                return torch.zeros_like(q)
            return torch.zeros_like(k), torch.zeros_like(v)
        return launch

    for name in ("dq_wgmma", "dkv_wgmma", "dq_simt", "dkv_simt", "dq_wide",
                 "dkv_wide"):
        monkeypatch.setattr(fa, "_flash_%s_cuda" % name, launcher(name))


@pytest.mark.parametrize("dtype,D,variant", [
    (BF16, 64, "wgmma"), (BF16, 128, "wgmma"), (BF16, 32, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 64, "simt"),
    (BF16, 256, "wide"), (torch.float32, 192, "wide")])
def test_flash_bwd_cuda_dispatches_by_variant(monkeypatch, dtype, D,
                                              variant):
    """``_flash_bwd_cuda`` hands the inputs to the dQ and the dK/dV
    launcher its variant names, with the caller's arguments and ``delta``
    [B, H, Tq]."""
    calls = []
    _bwd_launchers(monkeypatch, calls)
    q = torch.zeros(1, 5, 2, D, dtype=dtype)
    lse = torch.zeros(1, 2, 5)
    dq, dk, dv = fa._flash_bwd_cuda(q, q, q, q, lse, q, None, False, 0.5)
    assert calls == [("dq_" + variant, D, D, False, 0.5, (1, 2, 5)),
                     ("dkv_" + variant, D, D, False, 0.5, (1, 2, 5))]
    assert dq.shape == dk.shape == dv.shape == q.shape


@pytest.mark.parametrize("dtype,D,width,variant", [
    (BF16, 48, 64, "wgmma"), (BF16, 80, 128, "wgmma"),
    (BF16, 96, 128, "wgmma"), (BF16, 20, 32, "simt"),
    (torch.float32, 48, 64, "simt"), (torch.float32, 96, 128, "simt")])
def test_padded_width_and_real_scale_reach_the_launchers(monkeypatch, dtype,
                                                         D, width, variant):
    """A head_dim the kernels lack runs at its padded width with ``scale``
    1/√D of the real D (``scale=None``), forward and backward, and the
    outputs come back at D."""
    fwd = []

    def fwd_launcher(name):
        def launch(q, k, v, causal, scale, kv_len):
            fwd.append((name, q.shape[-1], k.shape[-1], v.shape[-1], scale))
            return (torch.zeros(q.shape, dtype=q.dtype),
                    torch.zeros(q.shape[0], q.shape[2], q.shape[1]))
        return launch

    monkeypatch.setattr(fa, "_flash_wgmma_cuda", fwd_launcher("wgmma"))
    monkeypatch.setattr(fa, "_flash_simt_cuda", fwd_launcher("simt"))
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
                                     (320, 320)])
def test_head_dims_above_128_reach_wide(monkeypatch, dtype, D, width):
    """Above 128 the forward, dQ and dK/dV go to the wide launchers at the
    width padded to a multiple of 64, with ``scale`` 1/√D of the real D,
    and the outputs come back at D."""
    fwd = []

    def wide(q, k, v, causal, scale, kv_len):
        fwd.append((q.shape[-1], k.shape[-1], v.shape[-1], scale))
        return (torch.zeros(q.shape, dtype=q.dtype),
                torch.zeros(q.shape[0], q.shape[2], q.shape[1]))

    def refuse(*a):
        raise AssertionError("another variant ran")

    monkeypatch.setattr(fa, "_flash_wide_cuda", wide)
    monkeypatch.setattr(fa, "_flash_wgmma_cuda", refuse)
    monkeypatch.setattr(fa, "_flash_simt_cuda", refuse)
    bwd = []
    _bwd_launchers(monkeypatch, bwd)
    q = torch.ones(1, 5, 2, D, dtype=dtype)
    o, lse = fa._flash_cuda(q, q, q)
    assert fwd == [(width, width, width, 1.0 / D ** 0.5)]
    assert o.shape == q.shape and o.is_contiguous()
    grads = fa._flash_bwd_cuda(q, q, q, o, lse, q)
    assert [c[:5] for c in bwd] == [
        ("dq_wide", width, width, True, 1.0 / D ** 0.5),
        ("dkv_wide", width, width, True, 1.0 / D ** 0.5)]
    assert all(g.shape == q.shape and g.is_contiguous() for g in grads)


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
