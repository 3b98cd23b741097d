"""Port model against the JAX TransformerLM: forward, prefill and decode.

One JAX model is built from ``jax.random.PRNGKey(0)``; its flat parameter
dict goes to ``mxnet_tpu_torch`` as numpy arrays through
``TransformerLM.load_jax_params``, so both packages compute the same
function on the same weights.  Prompts are numpy token ids from a seed.

Both attention routes are covered: the dense route (the default at these
sizes) and the flash route, forced on the port with
``dense_attn_max_score_mb=0`` and on JAX with ``MXTPU_PALLAS=interpret``
(the Pallas kernels through the interpreter, RMSNorm included).

Tolerances: f32 logits and K/V within 1e-5 (the conftest pins JAX matmuls
to "highest", so both sides compute in true f32 and differ only in
summation order).  bf16: each side rounds every activation to bf16 at the
same cast points, but an f32 value that differs in its last bits can round
to the neighbouring bf16 value (2^-8 relative), and such flips compound
over two layers; K/V (one layer of rounding) are held to 2^-6 relative,
the f32 logits to 3e-2 absolute (they are of order 1).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.models import transformer as jtf
from mxnet_tpu_torch import TransformerConfig, TransformerLM
from mxnet_tpu_torch.models.transformer import (_dense_self_attention,
                                                params_from_numpy)
from mxnet_tpu_torch.ops.kernels import common

VOCAB = 97
PAGE = 8
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_KV_TOL = dict(rtol=2.0 ** -6, atol=2.0 ** -6)
BF16_LOGITS_TOL = dict(rtol=0, atol=3e-2)


def _cfg_kw(dtype):
    return dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=2,
                d_ff=128, max_len=64, dtype=dtype, remat=False)


_JAX_CACHE = {}


def _jax_model(dtype):
    if dtype not in _JAX_CACHE:
        model = jtf.TransformerLM(jtf.TransformerConfig(**_cfg_kw(dtype)))
        params = model.init(jax.random.PRNGKey(0))
        _JAX_CACHE[dtype] = (model, params,
                             {k: np.asarray(v) for k, v in params.items()})
    return _JAX_CACHE[dtype]


def _port_model(dtype, flash):
    kw = _cfg_kw(dtype)
    if flash:
        kw["dense_attn_max_score_mb"] = 0
    _, _, np_params = _jax_model(dtype)
    return TransformerLM(TransformerConfig(**kw), device="cpu"
                         ).load_jax_params(np_params)


@pytest.fixture(params=["dense", "flash"])
def route(request, monkeypatch):
    if request.param == "flash":
        monkeypatch.setenv("MXTPU_PALLAS", "interpret")
    else:
        monkeypatch.setenv("MXTPU_PALLAS", "off")
    return request.param


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tol(dtype, what):
    if dtype == "float32":
        return F32_TOL
    return BF16_KV_TOL if what == "kv" else BF16_LOGITS_TOL


def _prompt(n, seed=7):
    return np.random.default_rng(seed).integers(0, VOCAB, n)


# ---------------------------------------------------------------------------
# weights and config
# ---------------------------------------------------------------------------
class TestWeights:
    def test_config_fields_and_defaults_match(self):
        jf = {f.name: f.default for f in dataclasses.fields(
            jtf.TransformerConfig)}
        pf = {f.name: f.default for f in dataclasses.fields(
            TransformerConfig)}
        assert jf == pf
        cfg = TransformerConfig(**_cfg_kw("float32"))
        assert cfg.head_dim == 16

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_state_dict_keys_are_jax_names(self, dtype):
        _, params, np_params = _jax_model(dtype)
        m = _port_model(dtype, flash=False)
        sd = m.state_dict()
        assert set(sd) == set(params)
        for k, v in sd.items():
            assert tuple(v.shape) == params[k].shape
            assert v.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(_f32(v), _f32(params[k]))

    def test_bf16_numpy_arrays_carried_bit_for_bit(self):
        """A JAX bf16 array arrives as numpy's extension ``bfloat16``
        type, which ``torch.from_numpy`` rejects; it crosses as uint16."""
        _, _, np_params = _jax_model("bfloat16")
        arr = np.array(np_params["blocks.wqkv"])
        assert arr.dtype.name == "bfloat16"
        with pytest.raises(TypeError):
            torch.from_numpy(arr)
        t = params_from_numpy({"w": arr}, "cpu")["w"]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      arr.view(np.int16))

    def test_load_rejects_missing_names(self):
        _, _, np_params = _jax_model("float32")
        m = TransformerLM(TransformerConfig(**_cfg_kw("float32")),
                          device="cpu")
        partial = {k: v for k, v in np_params.items() if k != "unembed"}
        with pytest.raises(RuntimeError, match="unembed"):
            m.load_jax_params(partial)

    def test_seeded_init_is_reproducible(self):
        cfg = TransformerConfig(**_cfg_kw("float32"))
        a = TransformerLM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))
        b = TransformerLM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))
        for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                      b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
        assert torch.equal(a.blocks.ln1_scale, torch.ones(2, 64))
        std = float(a.blocks.w_down.std())
        assert abs(std * np.sqrt(128) - 1.0) < 0.1   # N(0,1)/sqrt(fan_in)

    def test_moe_refused(self):
        """MoE trains since the mesh slice; the paged decode refuses it,
        as the JAX package's does."""
        m = TransformerLM(TransformerConfig(use_moe=True, **{
            k: v for k, v in _cfg_kw("float32").items()}), device="cpu")
        kp, vp = m.init_kv_pages(4, 8)
        with pytest.raises(NotImplementedError, match="MoE"):
            m.prefill(kp, vp, torch.zeros((1, 8), dtype=torch.long), 3,
                      torch.tensor([1, 2, 3, 0]))
        with pytest.raises(NotImplementedError, match="MoE"):
            m.decode_step(kp, vp, torch.zeros(1, dtype=torch.long),
                          torch.tensor([[1, 2, 3, 0]]), torch.tensor([3]),
                          torch.tensor([True]))


# ---------------------------------------------------------------------------
# semantic traps: each cast point and filler as the JAX model has it
# ---------------------------------------------------------------------------
class TestSemanticTraps:
    def test_gelu_is_tanh_approximation(self):
        x = np.linspace(-4, 4, 101).astype(np.float32)
        j = np.asarray(jax.nn.gelu(jnp.asarray(x)))
        tanh = torch.nn.functional.gelu(torch.from_numpy(x),
                                        approximate="tanh").numpy()
        erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(tanh, j, **F32_TOL)
        assert np.abs(erf - j).max() > 1e-4    # the default would differ

    def test_dense_attention_rounds_p_before_pv(self):
        """bf16: ``p`` is cast to the model dtype before P·V, as the JAX
        dense attention does (transformer.py:102)."""
        rng = np.random.default_rng(0)
        q, k, v = (rng.normal(size=(1, 12, 2, 16)).astype(np.float32)
                   for _ in range(3))
        tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, k, v))
        got = _dense_self_attention(tq, tk, tv)
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        want = jtf._dense_self_attention(jq, jk, jv)
        np.testing.assert_array_equal(_f32(got), _f32(want))

    def test_masked_scores_use_finite_filler(self):
        assert common._NEG == -1e30
        q = torch.zeros(1, 3, 1, 16)
        o = _dense_self_attention(q, q, q)
        assert torch.isfinite(o).all()

    def test_dense_flash_gate_is_score_megabytes(self):
        """The gate is ``B·H·T²·4/1e6 > dense_attn_max_score_mb``: at the
        default 768 MB the flagship (H=16) switches at T=4096."""
        cfg = TransformerConfig()
        H = 16
        assert 1 * H * 2048 ** 2 * 4 / 1e6 <= cfg.dense_attn_max_score_mb
        assert 1 * H * 4096 ** 2 * 4 / 1e6 > cfg.dense_attn_max_score_mb
        common.reset_counts()
        m = _port_model("float32", flash=False)
        m.apply(torch.from_numpy(_prompt(9))[None])
        assert "kernels.select.flash_attention.reference" not in \
            common.selection_counts()
        mf = _port_model("float32", flash=True)
        mf.apply(torch.from_numpy(_prompt(9))[None])
        assert common.selection_counts()[
            "kernels.select.flash_attention.reference"] == 2   # per layer


# ---------------------------------------------------------------------------
# forward, prefill and decode against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_logits_match_jax(route, dtype):
    jm, params, _ = _jax_model(dtype)
    m = _port_model(dtype, flash=route == "flash")
    toks = np.stack([_prompt(13, 1), _prompt(13, 2)])
    want, _ = jm.apply(params, jnp.asarray(toks, jnp.int32))
    got, aux = m.apply(torch.from_numpy(toks))
    assert float(aux) == 0.0                   # JAX's aux for the dense MLP
    assert got.dtype == torch.float32 and got.shape == (2, 13, VOCAB)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype,
                                                             "logits"))


def _jax_prefill(jm, params, n_pages, toks, length, table):
    kp, vp = jm.init_kv_pages(n_pages, PAGE)
    return jm.prefill(params, kp, vp, jnp.asarray(toks, jnp.int32),
                      jnp.int32(length), jnp.asarray(table, jnp.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_pages_match_jax(route, dtype):
    jm, params, _ = _jax_model(dtype)
    m = _port_model(dtype, flash=route == "flash")
    n_pages, length, tpad = 12, 11, 16
    toks = np.zeros((1, tpad), np.int64)
    toks[0, :length] = _prompt(length)
    table = np.zeros(8, np.int64)
    table[:2] = [5, 3]                         # out of order on purpose
    jk, jv, jlogits = _jax_prefill(jm, params, n_pages, toks, length, table)
    kp, vp = m.init_kv_pages(n_pages, PAGE)
    with torch.inference_mode():
        logits = m.prefill(kp, vp, torch.from_numpy(toks), length,
                           torch.from_numpy(table))
    assert logits.shape == (VOCAB,) and logits.dtype == torch.float32
    np.testing.assert_allclose(_f32(logits), _f32(jlogits),
                               **_tol(dtype, "logits"))
    # page 0 takes the padding writes: duplicate indices, order undefined
    for got, want in ((kp, jk), (vp, jv)):
        np.testing.assert_allclose(_f32(got[:, 1:]), _f32(want[:, 1:]),
                                   **_tol(dtype, "kv"))
    written = np.zeros(n_pages, bool)
    written[[5, 3]] = True
    assert not kp[:, 1:][:, ~written[1:]].any()   # nothing else touched


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_six_decode_steps_match_jax_and_full_forward(route, dtype):
    """Two slots (one inactive pad slot) decode 6 greedy steps; each
    step's logits match JAX's decode_step and, at f32, the full forward
    pass of the sequence so far (the oracle of tests/test_generation.py)."""
    jm, params, _ = _jax_model(dtype)
    m = _port_model(dtype, flash=route == "flash")
    n_pages, M, length, tpad = 12, 8, 7, 8
    prompt = _prompt(length, 4)
    toks = np.zeros((1, tpad), np.int64)
    toks[0, :length] = prompt
    table = np.zeros(M, np.int64)
    table[0] = 2
    jk, jv, jlogits = _jax_prefill(jm, params, n_pages, toks, length, table)
    kp, vp = m.init_kv_pages(n_pages, PAGE)
    with torch.inference_mode():
        logits = m.prefill(kp, vp, torch.from_numpy(toks), length,
                           torch.from_numpy(table))
    jdecode = jax.jit(jm.decode_step)          # one trace for the 6 steps
    seq = list(prompt)
    last = int(np.argmax(_f32(jlogits)))
    assert last == int(torch.argmax(logits))
    n_used = 1
    for step in range(6):
        seq.append(last)
        if length // PAGE + 1 > n_used:         # crossing a page boundary
            table[n_used] = 7 + n_used
            n_used += 1
        tables = np.stack([table, np.zeros(M, np.int64)])
        lens = np.array([length, 0])
        active = np.array([True, False])
        tok = np.array([last, 0])
        jk, jv, jl = jdecode(
            params, jk, jv, jnp.asarray(tok, jnp.int32),
            jnp.asarray(tables, jnp.int32), jnp.asarray(lens, jnp.int32),
            jnp.asarray(active))
        with torch.inference_mode():
            got = m.decode_step(kp, vp, torch.from_numpy(tok),
                                torch.from_numpy(tables),
                                torch.from_numpy(lens),
                                torch.from_numpy(active))
        assert got.shape == (2, VOCAB)
        np.testing.assert_allclose(_f32(got[0]), _f32(jl[0]),
                                   **_tol(dtype, "logits"))
        if dtype == "float32":
            full = m.apply(torch.tensor(seq)[None])[0][0, -1]
            np.testing.assert_allclose(_f32(got[0]), _f32(full), **F32_TOL)
        length += 1
        last = int(np.argmax(_f32(jl[0])))
        assert last == int(torch.argmax(got[0]))
    for got, want in ((kp, jk), (vp, jv)):
        np.testing.assert_allclose(_f32(got[:, 1:]), _f32(want[:, 1:]),
                                   **_tol(dtype, "kv"))
