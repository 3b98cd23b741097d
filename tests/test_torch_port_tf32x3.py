"""The arithmetic of the tf32x3 flash backward, emulated on the CPU.

The f32 flash backward at padded head_dim 192 and 256 runs on the tensor
cores as split-TF32 products (``csrc/flash_attention_bwd_tf32x3.cu``): each
f32 operand x becomes ``hi`` (x with its 13 low significand bits cleared,
a TF32 value) and ``lo = x - hi`` (exact in f32), which the tensor cores
read at 11 significant bits (they skip a TF32 operand's 13 low bits), and
each product ``a·b`` is issued as the three TF32 products ``lo_a·hi_b +
hi_a·lo_b + hi_a·hi_b`` with f32 accumulation.  The kernel cannot run
here, so this file repeats that arithmetic in plain torch (TF32 values and
their products are exact in f32) through the
whole backward at a small shape and head_dim 256, and holds it to float64
and to the JAX package's Pallas backward (through the interpreter) within
the card tests' f32 gradient tolerance, 1e-4.  One TF32 product alone
(``tf32(a)·tf32(b)``) lands far further from float64: the split is what
keeps the gradients f32-accurate.  The helper is a test of the design, not
a plain version: on a CPU tensor the port runs
``flash_attention_bwd_reference``.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas import flash_attention_lse as jax_flash_lse

fa = importlib.import_module("mxnet_tpu_torch.ops.kernels.flash_attention")

F32_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _tf32(x):
    """f32 -> the nearest TF32 value (11 significant bits), ties away from
    zero: the single TF32 product's rounding."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _trunc(x):
    """x with its 13 low significand bits cleared: a TF32 operand as the
    tensor cores read it."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    """The kernel's ``split_tf32`` as the tensor cores see it: ``hi`` = x
    truncated to TF32, ``lo`` = ``x - hi`` truncated to TF32."""
    hi = _trunc(x)
    return hi, _trunc(x - hi)


def _mm3(a, b):
    """``a @ b`` as the kernel issues it: three TF32 products of the split
    operands, summed in f32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _mm1(a, b):
    """``a @ b`` as one TF32 product."""
    return _tf32(a) @ _tf32(b)


def _bwd(q, k, v, o, lse, do, dlse, causal, mm):
    """The flash backward's formulas ([B, T, H, D] in and out) with every
    product through ``mm``; ``p`` and ``ds`` as the kernel forms them."""
    D, Tq, Tk = q.shape[-1], q.shape[1], k.shape[1]
    scale = 1.0 / D ** 0.5
    qh, kh, vh, doh = (t.permute(0, 2, 1, 3) for t in (q, k, v, do))
    s = mm(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        keep = (torch.arange(Tq)[:, None] >= torch.arange(Tk)[None, :])
        p = torch.where(keep, p, torch.zeros_like(p))
    dp = mm(doh, vh.transpose(-1, -2))
    delta = (do * o).sum(-1).transpose(1, 2) - dlse
    ds = p * (dp - delta[..., None]) * scale
    grads = (mm(ds, kh), mm(ds.transpose(-1, -2), qh),
             mm(p.transpose(-1, -2), doh))
    return tuple(g.permute(0, 2, 1, 3) for g in grads)


def _inputs(B, Tq, Tk, H, D, causal):
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.normal(size=(B, T, H, D)).astype(np.float32)
                   for T in (Tq, Tk, Tk, Tq))
    dlse = rng.normal(size=(B, H, Tq)).astype(np.float32)
    o, lse = fa.flash_attention_reference(
        *(torch.from_numpy(t) for t in (q, k, v)), causal, return_lse=True)
    return q, k, v, do, dlse, o, lse


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_is_two_tf32_values_within_2_pow_20(seed):
    """``hi`` and ``lo`` are TF32 values (13 low bits zero), ``hi`` is x
    truncated, ``lo`` is ``x - hi`` truncated at 11 significant bits
    (checked on the significand in float64), and ``hi + lo`` is within
    2^-20 of x."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.integers(-30, 30, 4096))
                         .astype(np.float32))
    hi, lo = _split(x)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1fff).any()
    assert torch.equal(hi.view(torch.int32),
                       x.view(torch.int32) & -0x2000)
    r = (x.double() - hi.double()).numpy()
    m, e = np.frexp(r)                      # r = m 2^e, 0.5 <= |m| < 1
    want = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11) * 2.0 ** (e - 11)
    assert np.array_equal(lo.double().numpy(), want)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -20 * x.double().abs()).all()


@pytest.mark.parametrize("causal", [True, False])
def test_tf32x3_backward_matches_float64_and_pallas(causal):
    """dQ, dK and dV through the split-TF32 products at head_dim 256 (the
    kernel's width) against float64 and against the Pallas backward,
    within 1e-4; one TF32 product per product stays over ten times
    further from float64."""
    B, Tq, Tk, H, D = 1, 40, 40, 2, 256
    q, k, v, do, dlse, o, lse = _inputs(B, Tq, Tk, H, D, causal)
    tq, tk, tv, tdo, tdlse = (torch.from_numpy(t)
                              for t in (q, k, v, do, dlse))
    got = _bwd(tq, tk, tv, o, lse, tdo, tdlse, causal, _mm3)
    one = _bwd(tq, tk, tv, o, lse, tdo, tdlse, causal, _mm1)
    exact = _bwd(*(t.double() for t in (tq, tk, tv, o, lse, tdo, tdlse)),
                 causal, torch.matmul)
    (jo, jlse), vjp = jax.vjp(
        lambda q, k, v: jax_flash_lse(q, k, v, causal=causal,
                                      interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    pallas = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    for g, g1, x, w, name in zip(got, one, exact, pallas, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and g.shape == x.shape
        np.testing.assert_allclose(g.numpy(), x.numpy(), err_msg=name,
                                   **F32_GRAD_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **F32_GRAD_TOL)
        err3 = float((g.double() - x).abs().max())
        err1 = float((g1.double() - x).abs().max())
        assert err1 > 10 * err3, (name, err1, err3)
