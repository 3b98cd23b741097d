"""Port training step against the JAX TransformerLM: loss, every parameter
gradient, and SGD-momentum steps.

One JAX model is built from ``jax.random.PRNGKey(0)`` (2 layers, d_model
64, 4 heads of 16, d_ff 128, vocab 97); its flat parameter dict goes to
``mxnet_tpu_torch`` as numpy arrays, and tokens and targets are numpy ids
from a seed, so both packages train the same function from the same
weights.

Both attention routes are covered, as in tests/test_torch_port_model.py:
the dense route with ``MXTPU_PALLAS=off`` (JAX takes lax math throughout),
and the flash route with ``dense_attn_max_score_mb=0`` on the port and
``MXTPU_PALLAS=interpret`` on JAX, whose ``loss`` then runs the Pallas
flash, RMSNorm and softmax cross-entropy kernels and their custom VJPs
through the interpreter.

Tolerances:

* f32 loss within 1e-5 relative, and each gradient within 1e-5 of its
  tensor's largest entry (the conftest pins JAX matmuls to "highest", so
  both sides compute in true f32; they differ in summation order, and a
  gradient sums over every token and layer);
* f32 steps: params, velocity and loss within the same bounds after each
  of three steps (lr 1e-2 scales the gradient differences down);
* bf16 steps (loss within 5e-3 absolute; params within 2^-6 of the
  tensor's largest entry, velocity within 2e-2 of it): each side rounds
  activations and gradients to bf16 at its own points — XLA may keep f32
  excess precision across the fused ``momentum·v + g`` and across its
  fused backward, where PyTorch rounds after every op — so a one-ulp flip
  (2^-8 relative) in a gradient moves a velocity entry by that much, and
  the flips compound over three steps.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.models import transformer as jtf
from mxnet_tpu_torch import TransformerConfig, TransformerLM, make_train_step
from mxnet_tpu_torch.models.transformer import params_from_numpy
from mxnet_tpu_torch.ops.kernels import common

VOCAB = 97
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
BF16_LOSS_ATOL = 5e-3
BF16_PARAM_REL = 2.0 ** -6
BF16_VELOCITY_REL = 2e-2


def _cfg_kw(dtype, remat=False):
    return dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=2,
                d_ff=128, max_len=64, dtype=dtype, remat=remat)


_JAX_CACHE = {}


def _jax_model(dtype):
    if dtype not in _JAX_CACHE:
        model = jtf.TransformerLM(jtf.TransformerConfig(**_cfg_kw(dtype)))
        params = model.init(jax.random.PRNGKey(0))
        _JAX_CACHE[dtype] = (model, params,
                             {k: np.asarray(v) for k, v in params.items()})
    return _JAX_CACHE[dtype]


def _port_model(dtype, flash, remat=False):
    kw = _cfg_kw(dtype, remat)
    if flash:
        kw["dense_attn_max_score_mb"] = 0
    _, _, np_params = _jax_model(dtype)
    return TransformerLM(TransformerConfig(**kw), device="cpu"
                         ).load_jax_params(np_params)


def _batch(B=2, T=13, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, VOCAB, (B, T)), rng.integers(0, VOCAB, (B, T))


@pytest.fixture(params=["dense", "flash"])
def route(request, monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS",
                       "interpret" if request.param == "flash" else "off")
    return request.param


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_rel(got, want, rel, what):
    """Every entry within ``rel`` of the tensor's largest magnitude."""
    got, want = _f32(got), _f32(want)
    bound = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, "%s: max err %g > %g" % (what, err, bound)


def _port_dicts(model):
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return params, {k: torch.zeros_like(v) for k, v in params.items()}


def test_loss_and_every_gradient_match_jax(route):
    jm, params, _ = _jax_model("float32")
    m = _port_model("float32", flash=route == "flash")
    toks, tgts = _batch()
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        params, jnp.asarray(toks, jnp.int32), jnp.asarray(tgts, jnp.int32))
    common.reset_counts()
    loss, grads = m.value_and_grad(None, torch.from_numpy(toks),
                                   torch.from_numpy(tgts))
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        assert g.dtype == torch.float32 and g.shape == jgrads[name].shape
        _close_rel(g, jgrads[name], GRAD_REL, name)
    sel = common.selection_counts()
    assert sel["kernels.select.fused_softmax_xent.reference"] == 1
    assert sel["kernels.select.fused_softmax_xent_bwd.reference"] == 1
    n_flash = sel.get("kernels.select.flash_attention_bwd.reference", 0)
    assert n_flash == (2 if route == "flash" else 0)   # one per layer


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_jax(route, dtype):
    jm, params, _ = _jax_model(dtype)
    m = _port_model(dtype, flash=route == "flash")
    jstep = jax.jit(jtf.make_train_step(jm))
    jp = params
    jv = jax.tree_util.tree_map(jnp.zeros_like, params)
    step = make_train_step(m)
    p, v = _port_dicts(m)
    losses = []
    for i in range(3):
        toks, tgts = _batch(seed=10 + i)
        jp, jv, jloss = jstep(jp, jv, jnp.asarray(toks, jnp.int32),
                              jnp.asarray(tgts, jnp.int32))
        p2, v2, loss = step(p, v, torch.from_numpy(toks),
                            torch.from_numpy(tgts))
        assert p2 is p and v2 is v                 # updated in place
        losses.append(float(loss))
        if dtype == "float32":
            np.testing.assert_allclose(float(loss), float(jloss),
                                       rtol=LOSS_RTOL)
        else:
            assert abs(float(loss) - float(jloss)) <= BF16_LOSS_ATOL
        for name in p:
            assert p[name].dtype == getattr(torch, dtype)
            if dtype == "float32":
                _close_rel(p[name], jp[name], GRAD_REL, "step %d %s"
                           % (i, name))
                _close_rel(v[name], jv[name], GRAD_REL, "step %d v %s"
                           % (i, name))
            else:
                _close_rel(p[name], jp[name], BF16_PARAM_REL,
                           "step %d %s" % (i, name))
                _close_rel(v[name], jv[name], BF16_VELOCITY_REL,
                           "step %d v %s" % (i, name))
    assert all(np.isfinite(losses))


def test_remat_gives_equal_gradients():
    """Per-block checkpointing recomputes the same forward: gradients are
    equal, and each block's forward kernels run twice."""
    toks, tgts = _batch()
    out = {}
    for remat in (False, True):
        m = _port_model("float32", flash=True, remat=remat)
        common.reset_counts()
        out[remat] = m.value_and_grad(None, torch.from_numpy(toks),
                                      torch.from_numpy(tgts))
        sel = common.selection_counts()
        assert sel["kernels.select.flash_attention.reference"] == \
            (4 if remat else 2)
        assert sel["kernels.select.fused_rmsnorm.reference"] == \
            (9 if remat else 5)
    assert float(out[True][0]) == float(out[False][0])
    for name, g in out[False][1].items():
        np.testing.assert_allclose(_f32(out[True][1][name]), _f32(g),
                                   rtol=0, atol=1e-7, err_msg=name)


def test_trains_module_in_place_and_loss_falls():
    m = _port_model("float32", flash=False)
    params = dict(m.named_parameters())
    velocity = {k: torch.zeros_like(p) for k, p in params.items()}
    step = make_train_step(m, lr=0.05)
    toks, tgts = (torch.from_numpy(a) for a in _batch())
    losses = [float(step(params, velocity, toks, tgts)[2])
              for _ in range(4)]
    assert losses[-1] < losses[0]
    # the module's own parameters moved: its loss is the next step's
    with torch.no_grad():
        assert float(m.loss(None, toks, tgts)) < losses[0]
    assert all(p.grad is None for p in m.parameters())


def test_apply_returns_logits_and_zero_aux():
    m = _port_model("float32", flash=False)
    logits, aux = m.apply(torch.from_numpy(_batch()[0]))
    assert logits.shape == (2, 13, VOCAB) and logits.dtype == torch.float32
    assert aux.dtype == torch.float32 and float(aux) == 0.0


def test_value_and_grad_takes_a_params_dict():
    """``params`` may be a plain dict of tensors (not the module's)."""
    _, _, np_params = _jax_model("float32")
    m = _port_model("float32", flash=False)
    toks, tgts = (torch.from_numpy(a) for a in _batch())
    shifted = {k: v + 0.01 for k, v in
               params_from_numpy(np_params, "cpu").items()}
    base, _ = m.value_and_grad(None, toks, tgts)
    moved, grads = m.value_and_grad(shifted, toks, tgts)
    assert float(moved) != float(base)
    assert all(not v.requires_grad for v in shifted.values())
    assert set(grads) == set(shifted)


def test_sharding_rules_not_ported():
    """``rules`` is ported with the mesh (tests/test_torch_port_parallel*.py
    hold it on 4 ranks); outside a mesh it changes nothing, as a JAX
    sharding constraint outside a mesh does not: the same bits as the
    step without it."""
    from mxnet_tpu_torch.models.transformer import default_rules

    m = _port_model("float32", flash=False)
    toks, tgts = (torch.from_numpy(a) for a in _batch())
    out = []
    for rules in (None, default_rules()):
        P = {k: v.detach().clone() for k, v in m.named_parameters()}
        V = {k: torch.zeros_like(v) for k, v in P.items()}
        out.append(make_train_step(m, rules=rules)(P, V, toks, tgts))
    (p0, v0, l0), (p1, v1, l1) = out
    assert torch.equal(l0, l1)
    for k in p0:
        assert torch.equal(p0[k], p1[k]) and torch.equal(v0[k], v1[k])


# head_dim 256 (d_model 512, 2 heads): Gemma-style widths, whose flash
# backward runs on the tensor-core wgmma_wide kernels on the card in bf16
HD256 = dict(vocab_size=VOCAB, d_model=512, n_heads=2, n_layers=2,
             d_ff=256, max_len=64)
_HD256_CACHE = {}


def _hd256_models(dtype):
    """The JAX model at head_dim 256 with its parameters, and the port's
    on the flash route from the same numpy weights."""
    if dtype not in _HD256_CACHE:
        jm = jtf.TransformerLM(jtf.TransformerConfig(**HD256, dtype=dtype))
        _HD256_CACHE[dtype] = (jm, jm.init(jax.random.PRNGKey(0)))
    jm, params = _HD256_CACHE[dtype]
    m = TransformerLM(TransformerConfig(**HD256, dtype=dtype,
                                        dense_attn_max_score_mb=0),
                      device="cpu").load_jax_params(
        {k: np.asarray(v) for k, v in params.items()})
    assert m.cfg.head_dim == 256
    return jm, params, m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_256_flash_step_matches_jax(monkeypatch, dtype):
    """At head_dim 256 on the flash route (Pallas kernels through the
    interpreter on JAX's side): one SGD-momentum step's loss, parameters
    and velocity match the JAX step at the bounds above, and every flash
    backward ran (one per layer)."""
    monkeypatch.setenv("MXTPU_PALLAS", "interpret")
    jm, params, m = _hd256_models(dtype)
    toks, tgts = _batch(seed=21)
    jp, jv, jloss = jax.jit(jtf.make_train_step(jm))(
        params, jax.tree_util.tree_map(jnp.zeros_like, params),
        jnp.asarray(toks, jnp.int32), jnp.asarray(tgts, jnp.int32))
    p, v = _port_dicts(m)
    common.reset_counts()
    _, _, loss = make_train_step(m)(p, v, torch.from_numpy(toks),
                                    torch.from_numpy(tgts))
    sel = common.selection_counts()
    assert sel["kernels.select.flash_attention_bwd.reference"] == 2
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    else:
        assert abs(float(loss) - float(jloss)) <= BF16_LOSS_ATOL
    for name in p:
        prel, vrel = ((GRAD_REL, GRAD_REL) if dtype == "float32"
                      else (BF16_PARAM_REL, BF16_VELOCITY_REL))
        _close_rel(p[name], jp[name], prel, name)
        _close_rel(v[name], jv[name], vrel, "v " + name)


# head_dim 512 (d_model 1024, 2 heads) and 1024 (one head), one layer: the
# widths of the long-context head_dim-512 and head_dim-1024 legs, whose
# bf16 flash kernels run on the tensor cores on the card (wgmma_xwide at
# 512, wgmma_xxwide's 2-CTA clusters at 1024, both ways)
HD512 = dict(vocab_size=VOCAB, d_model=1024, n_heads=2, n_layers=1,
             d_ff=256, max_len=64)
HD1024 = dict(HD512, n_heads=1)
_WIDE_HEAD_CACHE = {}


def _wide_head_step_matches_jax(monkeypatch, cfg, dtype, T=24):
    """One SGD-momentum step at ``cfg`` on the flash route (Pallas kernels
    through the interpreter on JAX's side) over [2, T] tokens: the loss,
    parameters and velocity match the JAX step at the bounds above, and
    the flash backward ran once a layer.  The JAX model is built once per
    config and dtype."""
    monkeypatch.setenv("MXTPU_PALLAS", "interpret")
    key = (cfg["d_model"], cfg["n_heads"], dtype)
    if key not in _WIDE_HEAD_CACHE:
        jm = jtf.TransformerLM(jtf.TransformerConfig(**cfg, dtype=dtype))
        _WIDE_HEAD_CACHE[key] = (jm, jm.init(jax.random.PRNGKey(0)))
    jm, params = _WIDE_HEAD_CACHE[key]
    m = TransformerLM(TransformerConfig(**cfg, dtype=dtype,
                                        dense_attn_max_score_mb=0),
                      device="cpu").load_jax_params(
        {k: np.asarray(v) for k, v in params.items()})
    assert m.cfg.head_dim == cfg["d_model"] // cfg["n_heads"]
    toks, tgts = _batch(B=2, T=T, seed=23)
    jp, jv, jloss = jax.jit(jtf.make_train_step(jm))(
        params, jax.tree_util.tree_map(jnp.zeros_like, params),
        jnp.asarray(toks, jnp.int32), jnp.asarray(tgts, jnp.int32))
    p, v = _port_dicts(m)
    common.reset_counts()
    _, _, loss = make_train_step(m)(p, v, torch.from_numpy(toks),
                                    torch.from_numpy(tgts))
    sel = common.selection_counts()
    assert sel["kernels.select.flash_attention_bwd.reference"] == \
        cfg["n_layers"]
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    else:
        assert abs(float(loss) - float(jloss)) <= BF16_LOSS_ATOL
    for name in p:
        prel, vrel = ((GRAD_REL, GRAD_REL) if dtype == "float32"
                      else (BF16_PARAM_REL, BF16_VELOCITY_REL))
        _close_rel(p[name], jp[name], prel, name)
        _close_rel(v[name], jv[name], vrel, "v " + name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_512_flash_step_matches_jax(monkeypatch, dtype):
    """At head_dim 512 (2 heads of d_model 1024)."""
    _wide_head_step_matches_jax(monkeypatch, HD512, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_1024_flash_step_matches_jax(monkeypatch, dtype):
    """At head_dim 1024 (one head of d_model 1024: a size-1 head axis)."""
    _wide_head_step_matches_jax(monkeypatch, HD1024, dtype)


# head_dim 64 (the long-context configuration's) and 128 (the flagship's)
# in f32, 2 layers of 2 heads: on the card their flash backward runs on
# the tensor-core tf32x3 kernels' narrow plan, the forward on simt
@pytest.mark.parametrize("head_dim", [64, 128])
def test_narrow_head_f32_flash_step_matches_jax(monkeypatch, head_dim):
    """At f32 head_dim 64 and 128 over 64 tokens a row."""
    cfg = dict(vocab_size=VOCAB, d_model=2 * head_dim, n_heads=2,
               n_layers=2, d_ff=256, max_len=64)
    _wide_head_step_matches_jax(monkeypatch, cfg, "float32", T=64)
