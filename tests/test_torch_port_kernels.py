"""Port kernels against the JAX package: RMSNorm, flash attention and the
fused softmax cross-entropy, forward and gradients.

The same numpy inputs (from a seed) go through ``mxnet_tpu``'s Pallas
kernels, run on the CPU through the Pallas interpreter, and through
``mxnet_tpu_torch``'s plain PyTorch versions — what the port runs on a CPU
tensor.  The hand-written CUDA kernels are held against those plain
versions on the card by ``chip_smoke.py`` and by
tests/test_torch_port_cuda.py, which skips without a card.

Tolerances: f32 near 1e-5 (the conftest pins JAX matmuls to "highest", so
both sides compute in true f32 and differ only in summation order and
rsqrt/exp rounding).  bf16 outputs may land on the neighbouring bf16 value
when the f32 value before rounding differs in its last bits: one ulp is
2^-8 relative, so bf16 is held to 2^-7 relative after one rounding and to
2^-6 after RMSNorm's two.

Gradients go through ``jax.vjp`` of the JAX function (its custom VJP: the
Pallas backward kernels through the interpreter) and through
``torch.autograd.grad`` of the port's, with the same numpy cotangents.
f32 gradients are held to 1e-5 relative and 1e-5 absolute (2e-5 through
the attention backward: a sum over every key or query row in another
order).  bf16 gradients are rounded once from f32 sums that differ only in
order, so they are held to one rounding, 2^-7 relative.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax

from mxnet_tpu.ops.pallas import (flash_attention as jax_flash,
                                  flash_attention_lse as jax_flash_lse,
                                  fused_rmsnorm as jax_rmsnorm,
                                  fused_softmax_xent as jax_xent)
from mxnet_tpu.ops.pallas.layers import _rmsnorm_lax
from mxnet_tpu_torch.ops.kernels import (common, flash_attention,
                                         flash_attention_lse,
                                         flash_attention_bwd_reference,
                                         flash_attention_reference,
                                         fused_rmsnorm,
                                         fused_rmsnorm_reference,
                                         fused_softmax_xent, launch_counts,
                                         select_impl, selection_counts,
                                         softmax_xent_bwd_reference,
                                         softmax_xent_reference)
from mxnet_tpu_torch.ops.kernels import _build

F32_TOL = dict(rtol=1e-5, atol=1e-5)
F32_FLASH_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_ONE_ROUNDING = dict(rtol=2.0 ** -7, atol=1e-5)
BF16_TWO_ROUNDINGS = dict(rtol=2.0 ** -6, atol=1e-6)
F32_GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
F32_FLASH_GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_GRAD_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


def _np(shape, seed, dtype):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x if dtype == "float32" else np.asarray(
        jnp.asarray(x, jnp.bfloat16))


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
class TestRMSNormParity:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", [(8, 64), (3, 7, 128), (300, 96)])
    def test_matches_pallas_kernel_and_lax(self, shape, dtype):
        x = _np(shape, 0, dtype)
        scale = np.asarray(1.0 + 0.1 * _np(shape[-1:], 1, "float32"),
                           dtype=x.dtype)
        got = fused_rmsnorm_reference(_to_torch(x), _to_torch(scale))
        assert got.dtype == _to_torch(x).dtype
        tol = F32_TOL if dtype == "float32" else BF16_TWO_ROUNDINGS
        pallas = jax_rmsnorm(jnp.asarray(x), jnp.asarray(scale),
                             interpret=True)
        lax = _rmsnorm_lax(jnp.asarray(x), jnp.asarray(scale), 1e-6)
        np.testing.assert_allclose(_f32(got), _f32(pallas), **tol)
        np.testing.assert_allclose(_f32(got), _f32(lax), **tol)

    def test_two_roundings_in_model_dtype(self):
        """bf16: x·r is rounded to bf16 BEFORE the multiply by scale, as
        the TPU kernel does — not one fused f32 product."""
        x = _to_torch(_np((64, 128), 2, "bfloat16"))
        scale = _to_torch(np.asarray(
            1.0 + 0.3 * _np((128,), 3, "float32"), dtype=np.float32)
        ).to(torch.bfloat16)
        got = fused_rmsnorm_reference(x, scale)
        xf = x.float()
        r = torch.rsqrt((xf * xf).sum(-1, keepdim=True) / 128 + 1e-6)
        two = ((xf * r).to(torch.bfloat16) * scale)
        fused = (xf * r * scale.float()).to(torch.bfloat16)
        assert torch.equal(got, two)
        assert not torch.equal(two, fused)   # the rounding point matters

    def test_cpu_tensor_routes_to_reference(self):
        common.reset_counts()
        x = _to_torch(_np((4, 32), 4, "float32"))
        scale = torch.ones(32)
        fn, impl = select_impl("fused_rmsnorm", x)
        assert impl == "reference" and fn is fused_rmsnorm_reference
        out = fused_rmsnorm(x, scale)
        assert torch.equal(out, fused_rmsnorm_reference(x, scale))
        sel = selection_counts()
        assert sel["kernels.select.fused_rmsnorm.reference"] == 2
        assert "kernels.select.fused_rmsnorm.cuda" not in sel
        assert launch_counts() == {}


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
FLASH_CASES = [
    # (B, Tq, Tk, H, D, causal)
    (2, 16, 16, 2, 16, True),        # aligned
    (1, 37, 37, 2, 32, True),        # ragged T (pads inside the JAX kernel)
    (1, 37, 37, 2, 32, False),
    (1, 24, 40, 2, 16, False),       # Tq != Tk
    (1, 20, 33, 3, 64, True),        # causal, Tq != Tk (top-left aligned)
]


def _qkv(B, Tq, Tk, H, D, dtype):
    return (_np((B, Tq, H, D), 10, dtype), _np((B, Tk, H, D), 11, dtype),
            _np((B, Tk, H, D), 12, dtype))


class TestFlashAttentionParity:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("case", FLASH_CASES)
    def test_lse_matches_pallas_kernel(self, case, dtype):
        B, Tq, Tk, H, D, causal = case
        q, k, v = _qkv(B, Tq, Tk, H, D, dtype)
        o, lse = flash_attention_lse(_to_torch(q), _to_torch(k),
                                     _to_torch(v), causal=causal)
        jo, jlse = jax_flash_lse(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 interpret=True)
        assert o.shape == (B, Tq, H, D) and lse.shape == (B, H, Tq)
        assert o.dtype == _to_torch(q).dtype and lse.dtype == torch.float32
        tol = F32_FLASH_TOL if dtype == "float32" else BF16_ONE_ROUNDING
        np.testing.assert_allclose(_f32(o), _f32(jo), **tol)
        # lse is f32 on both sides; bf16 inputs are exact in f32
        np.testing.assert_allclose(lse.numpy(), _f32(jlse), **F32_FLASH_TOL)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal", [True, False])
    def test_output_matches_pallas_kernel(self, causal, dtype):
        q, k, v = _qkv(1, 37, 37, 2, 32, dtype)
        o = flash_attention(_to_torch(q), _to_torch(k), _to_torch(v),
                            causal=causal)
        jo = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, interpret=True)
        tol = F32_FLASH_TOL if dtype == "float32" else BF16_ONE_ROUNDING
        np.testing.assert_allclose(_f32(o), _f32(jo), **tol)

    def test_reads_strided_qkv_slices(self):
        """q/k/v as slices of one fused qkv tensor (the model's layout)
        give the same result as contiguous copies."""
        B, T, H, D = 1, 19, 2, 16
        qkv = _to_torch(_np((B, T, 3 * H * D), 5, "float32"))
        q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, -1))
        assert not q.is_contiguous()
        o, lse = flash_attention_lse(q, k, v)
        o2, lse2 = flash_attention_lse(q.contiguous(), k.contiguous(),
                                       v.contiguous())
        assert torch.equal(o, o2) and torch.equal(lse, lse2)

    def test_masked_scores_are_finite_filler(self):
        """The causal mask fills with the finite -1e30, never -inf: row 0
        attends only key 0, so its output is exactly v[0] and every lse is
        finite."""
        assert common._NEG == -1e30
        q, k, v = (_to_torch(a) for a in _qkv(1, 8, 8, 1, 16, "float32"))
        o, lse = flash_attention_reference(q, k, v, causal=True,
                                           return_lse=True)
        assert torch.isfinite(lse).all() and torch.isfinite(o).all()
        assert torch.equal(o[0, 0], v[0, 0])


# ---------------------------------------------------------------------------
# gradients: the custom VJPs through the Pallas interpreter vs autograd
# ---------------------------------------------------------------------------
def _leaves(*arrays):
    return [_to_torch(a).requires_grad_(True) for a in arrays]


class TestRMSNormGrad:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", [(16, 128), (3, 7, 96)])
    def test_dx_dscale_match_pallas_vjp(self, shape, dtype):
        x = _np(shape, 20, dtype)
        scale = np.asarray(1.0 + 0.1 * _np(shape[-1:], 21, "float32"),
                           dtype=x.dtype)
        g = _np(shape, 22, dtype)
        _, vjp = jax.vjp(lambda x, s: jax_rmsnorm(x, s, interpret=True),
                         jnp.asarray(x), jnp.asarray(scale))
        jdx, jds = vjp(jnp.asarray(g))
        tx, ts = _leaves(x, scale)
        dx, ds = torch.autograd.grad(fused_rmsnorm(tx, ts), (tx, ts),
                                     _to_torch(g))
        assert dx.dtype == tx.dtype and ds.dtype == ts.dtype
        tol = F32_GRAD_TOL if dtype == "float32" else BF16_GRAD_TOL
        np.testing.assert_allclose(_f32(dx), _f32(jdx), **tol)
        # dscale sums over every row: f32 to 1e-4 relative
        np.testing.assert_allclose(
            _f32(ds), _f32(jds), **(dict(rtol=1e-4, atol=1e-4)
                                    if dtype == "float32" else tol))


FLASH_GRAD_CASES = [
    # (B, Tq, Tk, H, D, causal)
    (2, 16, 16, 2, 16, True),        # aligned
    (1, 37, 37, 2, 32, True),        # ragged T
    (1, 37, 37, 2, 32, False),
    (1, 24, 40, 2, 16, False),       # Tq != Tk
    (1, 20, 33, 3, 64, True),        # causal, Tq < Tk (rows past Tq: dK=dV=0)
]


class TestFlashAttentionGrad:
    @pytest.mark.parametrize("case,dtype", [
        (c, "float32") for c in FLASH_GRAD_CASES] + [
        (FLASH_GRAD_CASES[i], "bfloat16") for i in (1, 4)])
    def test_lse_vjp_matches_pallas_kernels(self, case, dtype):
        """Cotangents on both outputs: the lse one folds into delta."""
        B, Tq, Tk, H, D, causal = case
        q, k, v = _qkv(B, Tq, Tk, H, D, dtype)
        do = _np((B, Tq, H, D), 13, dtype)
        dlse = _np((B, H, Tq), 14, "float32")
        _, vjp = jax.vjp(lambda q, k, v: jax_flash_lse(
            q, k, v, causal=causal, interpret=True),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
        tq, tk, tv = _leaves(q, k, v)
        o, lse = flash_attention_lse(tq, tk, tv, causal=causal)
        got = torch.autograd.grad((o, lse), (tq, tk, tv),
                                  (_to_torch(do), _to_torch(dlse)))
        tol = F32_FLASH_GRAD_TOL if dtype == "float32" else BF16_GRAD_TOL
        for g, w, name in zip(got, want, "qkv"):
            assert g.dtype == tq.dtype
            np.testing.assert_allclose(_f32(g), _f32(w), err_msg="d" + name,
                                       **tol)

    @pytest.mark.parametrize("causal,dtype", [(True, "float32"),
                                              (False, "bfloat16")])
    def test_output_vjp_matches_pallas_kernels(self, causal, dtype):
        q, k, v = _qkv(1, 37, 37, 2, 32, dtype)
        do = _np((1, 37, 2, 32), 15, dtype)
        _, vjp = jax.vjp(lambda q, k, v: jax_flash(
            q, k, v, causal=causal, interpret=True),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
        tq, tk, tv = _leaves(q, k, v)
        got = torch.autograd.grad(flash_attention(tq, tk, tv, causal=causal),
                                  (tq, tk, tv), _to_torch(do))
        tol = F32_FLASH_GRAD_TOL if dtype == "float32" else BF16_GRAD_TOL
        for g, w, name in zip(got, want, "qkv"):
            np.testing.assert_allclose(_f32(g), _f32(w), err_msg="d" + name,
                                       **tol)

    def test_causal_rows_past_tq_get_zero_dk_dv(self):
        """Causal Tq < Tk: keys past Tq - 1 are seen by no query."""
        q, k, v = (_to_torch(a) for a in _qkv(1, 20, 33, 3, 64, "float32"))
        o, lse = flash_attention_reference(q, k, v, True, return_lse=True)
        do = _to_torch(_np((1, 20, 3, 64), 16, "float32"))
        dq, dk, dv = flash_attention_bwd_reference(q, k, v, o, lse, do)
        assert not dk[:, 20:].any() and not dv[:, 20:].any()
        assert dk[:, :20].abs().sum() > 0 and dq.abs().sum() > 0

    def test_backward_routes_to_reference_on_cpu(self):
        common.reset_counts()
        tq, tk, tv = _leaves(*_qkv(1, 9, 9, 1, 16, "float32"))
        flash_attention(tq, tk, tv).sum().backward()
        sel = selection_counts()
        assert sel == {"kernels.select.flash_attention.reference": 1,
                       "kernels.select.flash_attention_bwd.reference": 1}
        assert launch_counts() == {}


def _plain_launchers(monkeypatch):
    """Route the CUDA wrappers' kernel launchers to the plain versions, so
    that ``_flash_cuda`` / ``_flash_bwd_cuda`` run on CPU tensors: their
    padding along D, the real-D scale and the slicing back run as on the
    card, with the plain arithmetic in place of the kernels.  Returns the
    module, the forward's (variant, width) pairs and the backward's
    (variant, width) pairs, one per call."""
    fa = importlib.import_module("mxnet_tpu_torch.ops.kernels.flash_attention")
    widths, bwd_variants = [], []

    def fwd_launcher(variant):
        def fwd(q, k, v, causal, scale, kv_len):
            widths.append((variant, q.shape[-1]))
            return flash_attention_reference(q, k, v, causal, scale,
                                             return_lse=True)
        return fwd

    def bwd(q, k, v, do, lse, delta, causal, scale):
        # o = 0 and dlse = -delta make the plain version's delta this one
        return flash_attention_bwd_reference(q, k, v, torch.zeros_like(do),
                                             lse, do, -delta, causal, scale)

    def dq_launcher(variant):
        def dq(*a):
            bwd_variants.append((variant, a[0].shape[-1]))
            return bwd(*a)[0]
        return dq

    # head_dim 129-256 runs forward and backward on wgmma_wide in bf16, on
    # tf32x3 in f32; bf16 at 257-512 on wgmma_xwide, both ways; f32 at
    # 257-512 on tf32x3_xwide (at 384 or 512), both ways; bf16 at
    # 513-1024 on wgmma_xxwide (at 640-1024), both ways
    for name in ("wgmma", "simt", "wide", "wgmma_wide", "tf32x3",
                 "wgmma_xwide", "tf32x3_xwide", "wgmma_xxwide"):
        monkeypatch.setattr(fa, "_flash_%s_cuda" % name, fwd_launcher(name))
    for name in ("wgmma", "simt", "wide", "wgmma_wide", "tf32x3",
                 "wgmma_xwide", "tf32x3_xwide", "wgmma_xxwide"):
        monkeypatch.setattr(fa, "_flash_dq_%s_cuda" % name, dq_launcher(name))
        monkeypatch.setattr(fa, "_flash_dkv_%s_cuda" % name,
                            lambda *a: bwd(*a)[1:])
    return fa, widths, bwd_variants


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,width", [(48, 64), (80, 128), (96, 128),
                                     (160, 192), (256, 256), (320, 320),
                                     (400, 448), (512, 512), (448, 448),
                                     (576, 576), (1000, 1024),
                                     (1024, 1024)])
def test_padded_head_dims_match_pallas_kernels(monkeypatch, D, width, dtype):
    """Head dims the kernels lack go through the CUDA wrappers' padding
    (launchers replaced by the plain versions) and match the JAX package's
    Pallas kernels through the interpreter: o, lse and the VJP with a
    cotangent on both outputs.  The VJP is held on the JAX forward's
    residuals (o, lse) in every case, and on the port's own forward too
    except for bf16 above head_dim 128: there the one bf16 rounding in
    which the two forwards' o may differ enters delta = rowsum(dO∘O) over
    more than 128 terms, which moves a few cancelling gradient entries
    past one rounding (D 160: 4 of 11840 dQ entries).  f32 at 257-512
    runs padded further, to 384 or 512 (tf32x3_xwide), both ways, and bf16
    at 513-1024 to 640-1024 (wgmma_xxwide), both ways."""
    fa, widths, bwd_variants = _plain_launchers(monkeypatch)
    B, T, H, causal = 1, 37, 2, True
    q, k, v = _qkv(B, T, T, H, D, dtype)
    do = _np((B, T, H, D), 17, dtype)
    dlse = _np((B, H, T), 18, "float32")
    (jo, jlse), vjp = jax.vjp(lambda q, k, v: jax_flash_lse(
        q, k, v, causal=causal, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv = (_to_torch(a) for a in (q, k, v))
    o, lse = fa._flash_cuda(tq, tk, tv, causal)
    variant = fa._variant(tq.dtype, D)
    assert widths == [(variant, fa._kernel_width(variant, D))]
    assert fa._padded_dim(D) == width
    assert o.shape == (B, T, H, D) and o.dtype == tq.dtype
    tol = F32_FLASH_TOL if dtype == "float32" else BF16_ONE_ROUNDING
    np.testing.assert_allclose(_f32(o), _f32(jo), **tol)
    np.testing.assert_allclose(lse.numpy(), _f32(jlse), **F32_FLASH_TOL)
    residuals = [(_to_torch(jo), _to_torch(jlse))]
    if dtype == "float32" or D <= 128:
        residuals.append((o, lse))
    gtol = F32_FLASH_GRAD_TOL if dtype == "float32" else BF16_GRAD_TOL
    for o_r, lse_r in residuals:
        got = fa._flash_bwd_cuda(tq, tk, tv, o_r, lse_r, _to_torch(do),
                                 _to_torch(dlse), causal)
        for g, w, name in zip(got, want, "qkv"):
            assert g.shape == (B, T, H, D) and g.dtype == tq.dtype
            np.testing.assert_allclose(_f32(g), _f32(w), err_msg="d" + name,
                                       **gtol)
    bwd_variant = fa._variant(tq.dtype, D, backward=True)
    bwd_width = width
    if bwd_variant == "tf32x3_xwide":
        bwd_width = 384 if D <= 384 else 512
    elif bwd_variant == "wgmma_xxwide":
        bwd_width = 640 if D <= 640 else 1024
    assert bwd_variants == [(bwd_variant, bwd_width)] * len(residuals)
    if D > 512:
        assert widths[0][0] == bwd_variant == (
            "wgmma_xxwide" if dtype == "bfloat16" else "wide")
    elif D > 256:
        assert widths[0][0] == bwd_variant == (
            "wgmma_xwide" if dtype == "bfloat16" else "tf32x3_xwide")
    elif D > 128:
        assert bwd_variant == ("wgmma_wide" if dtype == "bfloat16"
                               else "tf32x3")


XENT_CASES = [
    # (leading shape, V): V not a multiple of 128, N ragged
    ((37,), 77),
    ((3, 5), 300),
    ((64,), 1000),
]


def _labels(shape, V, seed=30):
    lab = np.random.default_rng(seed).integers(0, V, shape)
    flat = lab.reshape(-1)
    flat[0], flat[-1] = V, -1      # outside [0, V): gold 0, no one-hot
    return lab


class TestSoftmaxXentParity:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("case", XENT_CASES)
    def test_loss_and_dlogits_match_pallas_kernels(self, case, dtype):
        lead, V = case
        logits = _np(lead + (V,), 31, dtype)
        labels = _labels(lead, V)
        g = _np(lead, 32, "float32")
        jloss, vjp = jax.vjp(lambda l: jax_xent(
            l, jnp.asarray(labels, jnp.int32), interpret=True),
            jnp.asarray(logits))
        (jdl,) = vjp(jnp.asarray(g))
        tl = _to_torch(logits).requires_grad_(True)
        loss = fused_softmax_xent(tl, torch.from_numpy(labels))
        assert loss.shape == lead and loss.dtype == torch.float32
        (dl,) = torch.autograd.grad(loss, (tl,), _to_torch(g))
        assert dl.dtype == tl.dtype and dl.shape == tl.shape
        # the loss is f32 on both sides; bf16 inputs are exact in f32
        np.testing.assert_allclose(_f32(loss), _f32(jloss), **F32_GRAD_TOL)
        tol = F32_GRAD_TOL if dtype == "float32" else BF16_GRAD_TOL
        np.testing.assert_allclose(_f32(dl), _f32(jdl), **tol)

    def test_out_of_range_label_has_no_gold(self):
        logits = _to_torch(_np((2, 10), 33, "float32"))
        labels = torch.tensor([10, -1])
        loss, lse = softmax_xent_reference(logits, labels, return_lse=True)
        assert torch.equal(loss, lse)
        d = softmax_xent_bwd_reference(logits, labels, lse, torch.ones(2))
        assert torch.allclose(d, torch.softmax(logits, -1))

    def test_mean_cotangent_and_cpu_routing(self):
        """``.mean()`` hands the backward an expanded, stride-0 ``g``."""
        common.reset_counts()
        tl = _to_torch(_np((4, 6, 50), 34, "float32")).requires_grad_(True)
        labels = torch.from_numpy(_labels((4, 6), 50))
        fused_softmax_xent(tl, labels).mean().backward()
        want = softmax_xent_bwd_reference(
            tl.detach(), labels, torch.logsumexp(tl.detach(), -1),
            torch.full((4, 6), 1 / 24))
        np.testing.assert_allclose(_f32(tl.grad), _f32(want), **F32_TOL)
        assert selection_counts() == {
            "kernels.select.fused_softmax_xent.reference": 1,
            "kernels.select.fused_softmax_xent_bwd.reference": 1}
        assert launch_counts() == {}


# ---------------------------------------------------------------------------
# build keying (a stand-in nvcc: the real one exists only on the card's
# machine)
# ---------------------------------------------------------------------------
class TestBuild:
    def _fake_nvcc(self, tmp_path, monkeypatch):
        bindir = tmp_path / "cuda" / "bin"
        bindir.mkdir(parents=True)
        calls = tmp_path / "calls.txt"
        nvcc = bindir / "nvcc"
        nvcc.write_text(
            "#!/bin/sh\n"
            "if [ \"$1\" = --version ]; then echo 'fake nvcc 12.9'; "
            "exit 0; fi\n"
            "echo \"$@\" >> %s\n"
            "while [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then "
            "echo built > \"$2\"; fi; shift; done\n"
            "echo 'ptxas info    : Used 40 registers'\n" % calls)
        nvcc.chmod(0o755)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build, "_NVCC_VERSION", {})
        return calls

    def test_builds_in_parallel_then_reuses(self, tmp_path, monkeypatch):
        calls = self._fake_nvcc(tmp_path, monkeypatch)
        first = _build.build()
        assert set(first) == set(_build.SOURCES)
        for name, info in first.items():
            assert not info["cached"] and info["path"].is_file()
            assert info["path"].name.startswith(name + "-")
            assert "registers" in info["log"]
        lines = calls.read_text().splitlines()
        assert len(lines) == len(_build.SOURCES)
        assert all("arch=compute_90a,code=sm_90a" in ln
                   and "--use_fast_math" not in ln for ln in lines)
        again = _build.build()
        assert all(info["cached"] for info in again.values())
        assert len(calls.read_text().splitlines()) == len(_build.SOURCES)

    def test_key_follows_nvcc_version(self, tmp_path, monkeypatch):
        self._fake_nvcc(tmp_path, monkeypatch)
        exe = _build.nvcc()
        a = _build.library_path("rmsnorm", exe)
        monkeypatch.setattr(_build, "_NVCC_VERSION", {exe: "other nvcc"})
        assert _build.library_path("rmsnorm", exe) != a

    def test_no_nvcc_raises(self, tmp_path, monkeypatch):
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.nvcc()
