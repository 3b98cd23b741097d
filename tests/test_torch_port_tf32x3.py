"""The arithmetic of the tf32x3 flash kernels, emulated on the CPU.

The f32 flash forward and backward at padded head_dim 64, 128, 192 and
256, and at 384 and 512 (tf32x3_xwide), run on the tensor cores as
split-TF32 products (``csrc/flash_attention_tf32x3.cu``,
``csrc/flash_attention_bwd_tf32x3.cu``): each
f32 operand x becomes ``hi`` (x with its 13 low significand bits cleared,
a TF32 value) and ``lo = x - hi`` (exact in f32), which the tensor cores
read at 11 significant bits (they skip a TF32 operand's 13 low bits), and
each product ``a·b`` is issued as the three TF32 products ``lo_a·hi_b +
hi_a·lo_b + hi_a·hi_b`` with f32 accumulation.  The kernel cannot run
here, so this file repeats that arithmetic in plain torch (TF32 values and
their products are exact in f32) through the whole forward and the whole
backward at small shapes and head_dim 256, and holds it to float64 and to
the JAX package's Pallas kernels (through the interpreter) within the card
tests' f32 tolerances: o within 1e-5 + 1e-4·|o| and lse within 1e-4 +
1e-5·|lse| forward, 1e-4 for the gradients.  The forward as the kernel
runs it: q split once, k, v and p split as they are read, key tiles of
64, the scores summed over each half of D and the halves added in f32,
each tile's p·v summed from zero and added as ``acc·alpha + pv``; the
tf32x3_xwide forward the same with the scores summed as its two-CTA
clusters sum them: over each quarter of D (a warp half of a CTA), the
quarters of each CTA's half added, the two CTAs' partials added.  The
tf32x3_xwide backward as its two-CTA clusters sum: the scores over each
quarter of D (a warp half of a CTA), the quarters of each CTA's half
added, the two CTAs' partials added; dQ over key tiles of 32 and dK, dV
over query tiles of 32, each tile's products summed from zero and added in
f32.  The tf32x3 backward at head_dim 64 and 128 (its narrow plan) sums
the scores over all of D in one product, dQ over key tiles and dK, dV over
query tiles of 64 rows at 64 and 32 at 128, each tile's products from zero
and added in f32; its forward there sums the scores over all of D in one
product, over key tiles of 64, each tile's p·v from
zero and added as ``acc·alpha + pv``.  One
TF32 product alone (``tf32(a)·tf32(b)``) lands far further from float64
and misses those tolerances: the split is what keeps the results
f32-accurate.  The helpers are a test of the design, not a plain version:
on a CPU tensor the port runs ``flash_attention_reference`` and
``flash_attention_bwd_reference``.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas import flash_attention_lse as jax_flash_lse
from mxnet_tpu.ops.pallas.flash_attention import _fwd as jax_pallas_fwd

fa = importlib.import_module("mxnet_tpu_torch.ops.kernels.flash_attention")

F32_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
F32_FWD_TOL = dict(rtol=1e-4, atol=1e-5)
F32_LSE_TOL = dict(rtol=1e-5, atol=1e-4)
NEG = -1e30                 # the kernels' mask filler
TILE = 64                   # keys a tile of the tf32x3 forward


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


TILE_BWD = 32               # streamed rows a tile of the backward


def _bwd_xwide(q, k, v, o, lse, do, dlse, causal, mm):
    """The tf32x3_xwide backward's arithmetic ([B, T, H, D] in and out,
    D 384 or 512): S and dP as the cluster sums them, each CTA's half of D
    the sum of its two warp halves' quarters and the pair's partials added
    in f32; ``p``, ``ds`` as in :func:`_bwd`; dQ summed over key tiles and
    dK, dV over query tiles of ``TILE_BWD`` rows, each tile's product from
    zero (every product through ``mm``)."""
    D, Tq, Tk = q.shape[-1], q.shape[1], k.shape[1]
    scale = 1.0 / D ** 0.5
    qh, kh, vh, doh = (t.permute(0, 2, 1, 3) for t in (q, k, v, do))
    quarters = [slice(i * D // 4, (i + 1) * D // 4) for i in range(4)]

    def scores(a, b):
        part = [mm(a[..., c], b[..., c].transpose(-1, -2)) for c in quarters]
        return (part[0] + part[1]) + (part[2] + part[3])

    s = scores(qh, kh) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        keep = (torch.arange(Tq)[:, None] >= torch.arange(Tk)[None, :])
        p = torch.where(keep, p, torch.zeros_like(p))
    dp = scores(doh, vh)
    delta = (do * o).sum(-1).transpose(1, 2) - dlse
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.zeros_like(qh)
    for k0 in range(0, Tk, TILE_BWD):
        kt = slice(k0, k0 + TILE_BWD)
        dq = dq + mm(ds[..., kt], kh[:, :, kt])
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for q0 in range(0, Tq, TILE_BWD):
        qt = slice(q0, q0 + TILE_BWD)
        dv = dv + mm(p[:, :, qt].transpose(-1, -2), doh[:, :, qt])
        dk = dk + mm(ds[:, :, qt].transpose(-1, -2), qh[:, :, qt])
    return tuple(g.permute(0, 2, 1, 3) for g in (dq, dk, dv))


@pytest.mark.parametrize("causal,Tq,Tk", [
    (True, 70, 70),                 # three tiles, the last ragged
    (False, 40, 90),                # Tq != Tk
])
def test_tf32x3_xwide_backward_matches_float64_and_pallas(causal, Tq, Tk):
    """dQ, dK and dV through the split-TF32 products at head_dim 512 (the
    tf32x3_xwide kernel's width: two CTAs of 256 columns), in the kernel's
    summation order, against float64 and against the Pallas backward
    within 1e-4; one TF32 product per product stays over ten times further
    from float64."""
    B, H, D = 1, 2, 512
    q, k, v, do, dlse, o, lse = _inputs(B, Tq, Tk, H, D, causal)
    tq, tk, tv, tdo, tdlse = (torch.from_numpy(t)
                              for t in (q, k, v, do, dlse))
    got = _bwd_xwide(tq, tk, tv, o, lse, tdo, tdlse, causal, _mm3)
    one = _bwd_xwide(tq, tk, tv, o, lse, tdo, tdlse, causal, _mm1)
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


# streamed rows a tile of the narrow plan's dQ and dK/dV (Narrow<D> in
# csrc/flash_attention_bwd_tf32x3.cu)
NARROW_TILE = {64: 64, 128: 32}


def _bwd_narrow(q, k, v, o, lse, do, dlse, causal, mm):
    """The tf32x3 backward's arithmetic at head_dim 64 or 128 (the narrow
    plan): S and dP as one product over all of D, ``p`` and ``ds`` as in
    :func:`_bwd`; dQ summed over key tiles and dK, dV over query tiles of
    ``NARROW_TILE[D]`` rows, each tile's product from zero (every product
    through ``mm``)."""
    D, Tq, Tk = q.shape[-1], q.shape[1], k.shape[1]
    bs = NARROW_TILE[D]
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
    dq = torch.zeros_like(qh)
    for k0 in range(0, Tk, bs):
        kt = slice(k0, k0 + bs)
        dq = dq + mm(ds[..., kt], kh[:, :, kt])
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for q0 in range(0, Tq, bs):
        qt = slice(q0, q0 + bs)
        dv = dv + mm(p[:, :, qt].transpose(-1, -2), doh[:, :, qt])
        dk = dk + mm(ds[:, :, qt].transpose(-1, -2), qh[:, :, qt])
    return tuple(g.permute(0, 2, 1, 3) for g in (dq, dk, dv))


@pytest.mark.parametrize("D,causal,Tq,Tk", [
    (64, True, 150, 150),           # three key / query tiles, the last ragged
    (64, False, 40, 90),            # Tq != Tk
    (128, True, 70, 70),
    (128, False, 90, 40),
])
def test_tf32x3_narrow_backward_matches_float64_and_pallas(D, causal, Tq,
                                                           Tk):
    """dQ, dK and dV through the split-TF32 products at head_dim 64 and 128
    (the narrow plan's widths), in the kernel's summation order, against
    float64 and against the Pallas backward within 1e-4; one TF32 product
    per product stays over ten times further from float64."""
    B, H = 1, 2
    q, k, v, do, dlse, o, lse = _inputs(B, Tq, Tk, H, D, causal)
    tq, tk, tv, tdo, tdlse = (torch.from_numpy(t)
                              for t in (q, k, v, do, dlse))
    got = _bwd_narrow(tq, tk, tv, o, lse, tdo, tdlse, causal, _mm3)
    one = _bwd_narrow(tq, tk, tv, o, lse, tdo, tdlse, causal, _mm1)
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


def _mm3_presplit(a_split, b):
    """``a @ b`` with ``a`` split once beforehand (the forward's resident
    q), ``a_split`` = ``(hi, lo, tf32(a))``: three TF32 products summed in
    f32."""
    ah, al, _ = a_split
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _mm1_presplit(a_split, b):
    """One TF32 product, for the ``a_split`` form: ``tf32(a)·tf32(b)``."""
    return a_split[2] @ _tf32(b)


def _fwd(q, k, v, causal, kv_len, three=True, cluster=False, narrow=False,
         scale=None):
    """The tf32x3 forward's arithmetic ([B, T, H, D] in, ``(o, lse)`` out):
    q split once; per key tile of 64 the scores of each half of D (split
    products from zero) added in f32, masked with -1e30 where k_pos >=
    kv_len or (causal and q_pos < k_pos), the online softmax in f32, and
    ``acc = acc·alpha + p·v`` with p·v summed from zero.  ``three=False``:
    every product one TF32 product instead.  ``cluster``: the
    tf32x3_xwide forward's scores, over the quarters of D, ``(q0 + q1) +
    (q2 + q3)`` (each CTA's two warp halves, then the pair).  ``narrow``:
    the narrow plan's at D 64 and 128, the scores as one product over all
    of D and key tiles of ``NARROW_FWD_TILE[D]``.  ``scale``: 1/√D of the
    width given unless set (a zero-padded head_dim keeps its own)."""
    mm = _mm3_presplit if three else _mm1_presplit
    D, Tq, Tk = q.shape[-1], q.shape[1], k.shape[1]
    if scale is None:
        scale = 1.0 / D ** 0.5
    tile = NARROW_FWD_TILE[D] if narrow else TILE
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    parts = 1 if narrow else 4 if cluster else 2
    cols = [slice(i * D // parts, (i + 1) * D // parts)
            for i in range(parts)]
    halves = []
    for c in cols:
        qc = qh[..., c].contiguous()
        halves.append(_split(qc) + (_tf32(qc),))
    B, H = qh.shape[:2]
    m = torch.full((B, H, Tq, 1), NEG)
    l = torch.zeros(B, H, Tq, 1)
    acc = torch.zeros(B, H, Tq, D)
    q_pos = torch.arange(Tq)[:, None]
    for k0 in range(0, kv_len, tile):
        kt, vt = kh[:, :, k0:k0 + tile], vh[:, :, k0:k0 + tile]
        part = [mm(halves[i], kt[..., c].transpose(-1, -2))
                for i, c in enumerate(cols)]
        if narrow:
            s = part[0]
        elif cluster:
            s = (part[0] + part[1]) + (part[2] + part[3])
        else:
            s = part[0] + part[1]
        k_pos = k0 + torch.arange(kt.shape[2])[None, :]
        ok = k_pos < kv_len
        if causal:
            ok = ok & (q_pos >= k_pos)
        s = torch.where(ok, s * scale, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = mm(_split(p) + (_tf32(p),), vt)
        acc = acc * alpha + pv
        m = m_new
    safe = torch.where(l == 0, torch.ones_like(l), l)
    return ((acc / safe).permute(0, 2, 1, 3),
            (m + torch.log(safe))[..., 0])


def _fwd64(q, k, v, causal, kv_len):
    """Dense attention in float64 over the first kv_len keys."""
    qd, kd, vd = (t.double() for t in (q, k[:, :kv_len], v[:, :kv_len]))
    D, Tq = q.shape[-1], q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / D ** 0.5
    if causal:
        keep = torch.arange(Tq)[:, None] >= torch.arange(kv_len)[None, :]
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, -1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]), vd)
    return o, lse


def _pallas(q, k, v, causal, kv_len):
    """The JAX package's Pallas forward (``_fwd``, through the interpreter)
    with its ``kv_len``, on inputs padded to its blocks of 32 rows."""
    D, Tq, Tk = q.shape[-1], q.shape[1], k.shape[1]

    def padded(x, T):
        x = jnp.asarray(x).transpose(0, 2, 1, 3)
        return jnp.pad(x, ((0, 0), (0, 0), (0, -T % 32), (0, 0)))

    o, lse = jax_pallas_fwd(padded(q, Tq), padded(k, Tk), padded(v, Tk),
                            causal, 1.0 / D ** 0.5, 32, 32, kv_len, True)
    return (np.asarray(o)[:, :, :Tq].transpose(0, 2, 1, 3),
            np.asarray(lse)[:, :, :Tq, 0])


@pytest.mark.parametrize("causal,Tq,Tk,kv_len", [
    (True, 100, 100, 100),          # two key tiles, the second ragged
    (False, 40, 150, 150),          # Tq != Tk
    (True, 150, 90, 70),            # kv_len < Tk, Tq > Tk
    (False, 60, 130, 100),          # kv_len < Tk
])
def test_tf32x3_forward_matches_float64_and_pallas(causal, Tq, Tk, kv_len):
    """o and lse through the forward's split-TF32 arithmetic at head_dim
    256 against float64 and against the Pallas forward, within the f32
    forward gates; the same forward with one TF32 product a product misses
    the gate on o and stays over ten times further from float64."""
    B, H, D = 1, 2, 256
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32)
               for T in (Tq, Tk, Tk))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    o, lse = _fwd(tq, tk, tv, causal, kv_len)
    o1, lse1 = _fwd(tq, tk, tv, causal, kv_len, three=False)
    o64, lse64 = _fwd64(tq, tk, tv, causal, kv_len)
    po, plse = _pallas(q, k, v, causal, kv_len)
    assert o.dtype == lse.dtype == torch.float32
    assert o.shape == (B, Tq, H, D) and lse.shape == (B, H, Tq)
    for want_o, want_lse in ((o64.numpy(), lse64.numpy()), (po, plse)):
        np.testing.assert_allclose(o.numpy(), want_o, **F32_FWD_TOL)
        np.testing.assert_allclose(lse.numpy(), want_lse, **F32_LSE_TOL)
    assert not np.allclose(o1.numpy(), o64.numpy(), **F32_FWD_TOL)
    err3 = float((o.double() - o64).abs().max())
    err1 = float((o1.double() - o64).abs().max())
    assert err1 > 10 * err3, (err1, err3)


@pytest.mark.parametrize("causal,Tq,Tk,kv_len", [
    (True, 100, 150, 150),          # Tq != Tk, the last key tile ragged
    (False, 40, 150, 130),          # kv_len < Tk
])
def test_tf32x3_xwide_forward_matches_float64_and_pallas(causal, Tq, Tk,
                                                         kv_len):
    """o and lse through the tf32x3_xwide forward's arithmetic at head_dim
    512 (two CTAs of 256 columns: the scores over quarters of D, each
    CTA's halves added, then the pair's) against float64 and against the
    Pallas forward, within the f32 forward gates; one TF32 product a
    product misses the gate on o and stays over ten times further from
    float64."""
    B, H, D = 1, 2, 512
    rng = np.random.default_rng(12)
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32)
               for T in (Tq, Tk, Tk))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    o, lse = _fwd(tq, tk, tv, causal, kv_len, cluster=True)
    o1, lse1 = _fwd(tq, tk, tv, causal, kv_len, three=False, cluster=True)
    o64, lse64 = _fwd64(tq, tk, tv, causal, kv_len)
    po, plse = _pallas(q, k, v, causal, kv_len)
    assert o.dtype == lse.dtype == torch.float32
    assert o.shape == (B, Tq, H, D) and lse.shape == (B, H, Tq)
    for want_o, want_lse in ((o64.numpy(), lse64.numpy()), (po, plse)):
        np.testing.assert_allclose(o.numpy(), want_o, **F32_FWD_TOL)
        np.testing.assert_allclose(lse.numpy(), want_lse, **F32_LSE_TOL)
    assert not np.allclose(o1.numpy(), o64.numpy(), **F32_FWD_TOL)
    err3 = float((o.double() - o64).abs().max())
    err1 = float((o1.double() - o64).abs().max())
    assert err1 > 10 * err3, (err1, err3)


# keys a tile of the narrow plan's forward (NarrowFwd<D> in
# csrc/flash_attention_tf32x3.cu)
NARROW_FWD_TILE = {64: 64, 128: 64}


@pytest.mark.parametrize("causal,Tq,Tk,kv_len", [
    (True, 70, 70, 70),             # two key tiles, the second ragged
    (False, 40, 100, 100),          # Tq != Tk
    (True, 90, 70, 50),             # kv_len < Tk, Tq > Tk
])
@pytest.mark.parametrize("D", [64, 128, 40, 96])
def test_tf32x3_narrow_forward_matches_float64_and_pallas(D, causal, Tq, Tk,
                                                          kv_len):
    """o and lse through the narrow forward's split-TF32 arithmetic at
    head_dim 64 and 128, and at 40 and 96 zero-padded to them with the
    real head_dim's scale, in the kernel's summation order (the scores one
    product over all of D, each key tile's p·v from zero, then ``acc·alpha
    + pv``), against float64 and against the Pallas forward within the f32
    forward gates; one TF32 product a product misses the gate on o and
    stays over ten times further from float64."""
    B, H = 1, 1
    width = 64 if D <= 64 else 128
    rng = np.random.default_rng(13)
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32)
               for T in (Tq, Tk, Tk))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    padded = [torch.nn.functional.pad(t, (0, width - D))
              for t in (tq, tk, tv)]
    o, lse = _fwd(*padded, causal, kv_len, narrow=True, scale=D ** -0.5)
    o1, lse1 = _fwd(*padded, causal, kv_len, three=False, narrow=True,
                    scale=D ** -0.5)
    assert not o[..., D:].any()
    o, o1 = o[..., :D], o1[..., :D]
    o64, lse64 = _fwd64(tq, tk, tv, causal, kv_len)
    po, plse = _pallas(q, k, v, causal, kv_len)
    assert o.dtype == lse.dtype == torch.float32
    assert o.shape == (B, Tq, H, D) and lse.shape == (B, H, Tq)
    for want_o, want_lse in ((o64.numpy(), lse64.numpy()), (po, plse)):
        np.testing.assert_allclose(o.numpy(), want_o, **F32_FWD_TOL)
        np.testing.assert_allclose(lse.numpy(), want_lse, **F32_LSE_TOL)
    assert not np.allclose(o1.numpy(), o64.numpy(), **F32_FWD_TOL)
    err3 = float((o.double() - o64).abs().max())
    err1 = float((o1.double() - o64).abs().max())
    assert err1 > 10 * err3, (err1, err3)
