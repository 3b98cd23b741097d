"""The dryrun's multi-rank legs (``mxnet_tpu_torch.tools.dryrun``, the port
of ``__graft_entry__._dryrun_impl``) against the JAX package's steps.

4 gloo rank processes on the CPU (the port's launcher, suite ``dryrun`` of
``torch_port_parallel_worker.py``, one torch thread each, their own
timeout) run the legs of the dryrun's ``_axes_for(4)`` on its f32 model
(vocab 128, d 64, 4 heads, 2 layers, d_ff 128, batch 8 x 16) with the JAX
package's initial parameters: dp×sp×tp = 1×2×2, dp×fsdp×tp = 1×2×2 with
``rules=default_rules()`` and the ZeRO bytes check, pp 4, pp×tp at 2×2
(the dryrun runs it only at 8 devices), ep 2 × dp 2.  Each is held to the
JAX package's meshless step and to its 4-device mesh step; in the rank
processes the train legs' gradients are also held to the single-rank
step's (``dryrun.GRAD_REL``).  Two routing legs (``cases.ROUTING_LEGS``)
check which attention the mesh path takes when heads or batch do not
divide their axes.

Tolerances: losses within 2e-6 of JAX's (the dryrun's own bound is 1e-3 ·
max(1, |ref|)); parameters after one step within 1e-5 absolute; the pp
gradients within 2e-5 and pp×tp's within 1e-6 of JAX's (the dryrun's: 1e-3
and 1e-4).
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_parallel_cases as cases
from mxnet_tpu.models import TransformerConfig, TransformerLM, make_train_step
from mxnet_tpu.models.transformer import default_rules
from mxnet_tpu.parallel import make_mesh, pipeline_spmd
from mxnet_tpu.parallel.sharding import auto_shard
from test_torch_port_parallel import WORLD, run_ranks

DEVS = jax.devices()[:WORLD]
LOSS_TOL = 2e-6
PARAM_TOL = 1e-5


def _model(**kw):
    cfg = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
               dtype="float32", remat=False)
    cfg.update(kw)
    return TransformerLM(TransformerConfig(**cfg))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


ROUTING = {leg: (cfg, axes, tok)
           for leg, cfg, axes, tok in cases.ROUTING_LEGS}


@functools.lru_cache(maxsize=None)
def jax_params():
    out = {"dense": _np(_model().init(jax.random.PRNGKey(0))),
           "pp": _np(_model(n_layers=4).init(jax.random.PRNGKey(1))),
           "moe": _np(_model(use_moe=True, n_experts=2).init(
               jax.random.PRNGKey(2)))}
    for i, (leg, (cfg, _, _)) in enumerate(ROUTING.items()):
        out[leg] = _np(_model(**cfg).init(jax.random.PRNGKey(3 + i)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_dryrun")
    for name, p in jax_params().items():
        np.savez(os.path.join(d, "params_%s.npz" % name), **p)
    return run_ranks(d, "dryrun")


def _tokens():
    toks, tgts = cases.dryrun_tokens()
    return jnp.asarray(toks, jnp.int32), jnp.asarray(tgts, jnp.int32)


@functools.lru_cache(maxsize=None)
def jax_step(kind, leg=None):
    """(loss, updated params) of the JAX step: meshless, or on the leg's
    4-device mesh."""
    model = _model(**({"use_moe": True, "n_experts": 2} if kind == "moe"
                      else {}))
    params = {k: jnp.asarray(v) for k, v in jax_params()[kind].items()}
    toks, tgts = _tokens()
    if leg is None:
        step = jax.jit(make_train_step(model, lr=0.1))
        vel = jax.tree_util.tree_map(jnp.zeros_like, params)
        p, _, loss = step(params, vel, toks, tgts)
        return float(loss), _np(p)
    axes, rules = leg
    with make_mesh(devices=DEVS, **dict(axes)):
        params = auto_shard(params, default_rules())
        vel = jax.tree_util.tree_map(jnp.zeros_like, params)
        step = jax.jit(make_train_step(
            model, lr=0.1, rules=default_rules() if rules else None))
        p, _, loss = step(params, vel, toks, tgts)
        return float(loss), _np(p)


LEGS = {leg: (axes, rules) for leg, axes, rules in cases.DRYRUN_TRAIN_LEGS}


@functools.lru_cache(maxsize=None)
def jax_routing_step(leg):
    """(loss, updated params) of the JAX meshless step on a routing leg's
    model and tokens."""
    cfg, _, tok = ROUTING[leg]
    model = _model(**cfg)
    params = {k: jnp.asarray(v) for k, v in jax_params()[leg].items()}
    toks, tgts = (jnp.asarray(a, jnp.int32)
                  for a in cases.routing_tokens(*tok))
    vel = jax.tree_util.tree_map(jnp.zeros_like, params)
    p, _, loss = jax.jit(make_train_step(model, lr=0.1))(params, vel, toks,
                                                         tgts)
    return float(loss), _np(p)


@pytest.mark.parametrize("leg", list(ROUTING))
def test_attention_routing_under_a_mesh(ranks, leg):
    """Heads that do not divide tp run the flash kernel on each rank's whole
    set of heads (its forward and backward once a layer, in the gradient
    and in the step); a batch that does not divide dp is whole on each
    rank, so the dense/flash gate reads the meshless score size and stays
    dense (no flash selected).  Loss and parameters after one step match
    the JAX package's meshless step."""
    cfg, _, _ = ROUTING[leg]
    loss, params = jax_routing_step(leg)
    n_flash = 2 * 2 if cfg["dense_attn_max_score_mb"] == 0 else 0
    for r in range(WORLD):
        assert list(ranks[r]["%s.flash_selects" % leg]) == [n_flash] * 2
        assert abs(float(ranks[r]["%s.loss" % leg]) - loss) <= LOSS_TOL
        for k, v in params.items():
            np.testing.assert_allclose(ranks[r]["%s.param.%s" % (leg, k)], v,
                                       rtol=0, atol=PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("leg", list(LEGS))
def test_train_leg_loss_matches_jax(ranks, leg):
    axes, rules = LEGS[leg]
    ref, _ = jax_step("dense")
    mesh_loss, _ = jax_step("dense", (tuple(axes.items()), rules))
    for r in range(WORLD):
        got = float(ranks[r]["%s.loss" % leg])
        assert abs(got - ref) <= LOSS_TOL, (leg, got, ref)
        assert abs(got - mesh_loss) <= LOSS_TOL, (leg, got, mesh_loss)
        assert abs(float(ranks[r]["ref.loss"]) - ref) <= LOSS_TOL


@pytest.mark.parametrize("leg", list(LEGS))
def test_train_leg_updated_params_match_jax(ranks, leg):
    axes, rules = LEGS[leg]
    _, want = jax_step("dense")
    _, want_mesh = jax_step("dense", (tuple(axes.items()), rules))
    for r in range(WORLD):
        for k in want:
            got = ranks[r]["%s.param.%s" % (leg, k)]
            np.testing.assert_allclose(got, want[k], rtol=0, atol=PARAM_TOL,
                                       err_msg=k)
            np.testing.assert_allclose(got, want_mesh[k], rtol=0,
                                       atol=PARAM_TOL, err_msg=k)


def test_zero_bytes_match_jax_device_shards(ranks):
    """dp×fsdp×tp with rules: each rank stores what JAX stores on its
    device (the same shard shapes), within the dryrun's bound."""
    with make_mesh(devices=DEVS, dp=1, fsdp=2, tp=2):
        params = auto_shard({k: jnp.asarray(v) for k, v in
                             jax_params()["dense"].items()}, default_rules())
        per_dev = [sum(s.data.nbytes for v in params.values() if v.ndim >= 2
                       for s in v.addressable_shards if s.device == d)
                   for d in DEVS]
    full = sum(v.nbytes for v in jax_params()["dense"].values()
               if v.ndim >= 2)
    for r in range(WORLD):
        got_p, got_v, got_full = ranks[r]["dp_fsdp_tp.zero"]
        assert got_full == full
        assert got_p == got_v == per_dev[r]
        assert got_p <= full / 4 * 1.5


def _jax_pp_loss(ppm, stacked, other, toks, tgts):
    M, mb = 4, 2
    x = other["embed"][toks]
    B, T, E = x.shape

    def stage(bp, h):
        return ppm._block(bp, h, use_ring=False)[0]

    h = pipeline_spmd(stage, stacked, x.reshape(M, mb, T, E), M)
    h = ppm._rmsnorm(h.reshape(B, T, E), other["final_ln_scale"])
    logits = jnp.einsum("bte,ev->btv", h, other["unembed"],
                        preferred_element_type=jnp.float32)
    logz = jax.nn.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(logits, tgts[..., None], axis=-1)[..., 0]
    return (logz - gold).mean()


@functools.lru_cache(maxsize=None)
def jax_pp(on_mesh):
    ppm = _model(n_layers=4)
    p = {k: jnp.asarray(v) for k, v in jax_params()["pp"].items()}
    stacked = {k.split(".", 1)[1]: v for k, v in p.items()
               if k.startswith("blocks.")}
    other = {k: v for k, v in p.items() if not k.startswith("blocks.")}
    toks, tgts = _tokens()
    f = jax.jit(jax.value_and_grad(functools.partial(_jax_pp_loss, ppm),
                                   argnums=(0, 1)))
    if on_mesh:
        with make_mesh(devices=DEVS, pp=4):
            loss, (gs, go) = f(stacked, other, toks, tgts)
    else:
        loss, (gs, go) = f(stacked, other, toks, tgts)
    grads = {"blocks." + k: np.asarray(v) for k, v in gs.items()}
    grads.update(_np(go))
    return float(loss), grads


@pytest.mark.parametrize("on_mesh", [False, True], ids=["seq", "pp4"])
def test_pp_leg_matches_jax(ranks, on_mesh):
    loss, grads = jax_pp(on_mesh)
    for r in range(WORLD):
        assert abs(float(ranks[r]["pp.loss"]) - loss) <= LOSS_TOL
        assert abs(float(ranks[r]["pp.ref_loss"]) - loss) <= LOSS_TOL
        for k, g in grads.items():
            name = k.split(".", 1)[1] if k.startswith("blocks.") else k
            np.testing.assert_allclose(ranks[r]["pp.grad.%s" % name], g,
                                       rtol=0, atol=2e-5, err_msg=k)


@functools.lru_cache(maxsize=None)
def jax_pp_tp(on_mesh):
    from jax import lax

    from mxnet_tpu_torch.tools.dryrun import pp_tp_params

    tpp, x2, t2 = pp_tp_params()
    tpp = {k: jnp.asarray(v[:2]) for k, v in tpp.items()}
    F2, ntp, M2 = 32, 2, 4

    def tp_stage(p, h):
        k = lax.axis_index("tp")
        c = F2 // ntp
        w1 = lax.dynamic_slice_in_dim(p["w1"], k * c, c, axis=1)
        b1 = lax.dynamic_slice_in_dim(p["b1"], k * c, c, axis=0)
        w2 = lax.dynamic_slice_in_dim(p["w2"], k * c, c, axis=0)
        return lax.psum(jnp.tanh(h @ w1 + b1) @ w2, "tp")

    def full_stage(p, h):
        return jnp.tanh(h @ p["w1"] + p["b1"]) @ p["w2"]

    def loss(stage):
        return lambda p, x, t: ((pipeline_spmd(stage, p, x, M2) - t)
                                ** 2).mean()

    args = (tpp, jnp.asarray(x2), jnp.asarray(t2))
    if on_mesh:
        with make_mesh(devices=DEVS, pp=2, tp=2):
            l, g = jax.jit(jax.value_and_grad(loss(tp_stage)))(*args)
    else:
        l, g = jax.jit(jax.value_and_grad(loss(full_stage)))(*args)
    return float(l), _np(g)


@pytest.mark.parametrize("on_mesh", [False, True], ids=["seq", "pp2xtp2"])
def test_pp_tp_leg_matches_jax(ranks, on_mesh):
    loss, grads = jax_pp_tp(on_mesh)
    for r in range(WORLD):
        assert abs(float(ranks[r]["pptp.loss"]) - loss) <= LOSS_TOL
        for k, g in grads.items():
            np.testing.assert_allclose(ranks[r]["pptp.grad.%s" % k], g,
                                       rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("on_mesh", [False, True], ids=["seq", "ep2xdp2"])
def test_ep_leg_matches_jax(ranks, on_mesh):
    loss, params = jax_step(
        "moe", ((("ep", 2), ("dp", 2)), False) if on_mesh else None)
    for r in range(WORLD):
        assert abs(float(ranks[r]["ep.loss"]) - loss) <= LOSS_TOL
        assert abs(float(ranks[r]["ep.ref_loss"]) - loss) <= LOSS_TOL
        for k, v in params.items():
            np.testing.assert_allclose(ranks[r]["ep.param.%s" % k], v,
                                       rtol=0, atol=PARAM_TOL, err_msg=k)
