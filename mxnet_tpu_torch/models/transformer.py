"""Decoder-only Transformer LM: the port of ``mxnet_tpu/models/transformer.py``.

It carries the forward pass, the paged-KV serving path (``init_kv_pages``
/ ``prefill`` / ``decode_step``) and training (``loss``,
:func:`make_train_step`, SGD with momentum) on one device.  MoE and the
mesh paths (ring attention, sharding rules) come in later slices.

The parameters are those of the JAX model, under the same names: the
stacked per-layer tensors ``[L, ...]`` live in the ``blocks`` submodule, so
``state_dict()`` keys are exactly the JAX flat-dict keys (``"embed"``,
``"blocks.wqkv"``, ...) and :meth:`TransformerLM.load_jax_params` carries a
JAX model's weights across.  Like the JAX model's, ``apply`` and ``loss``
are functions of a flat parameter dict under those names; ``params=None``
means the module's own parameters.

Numerics follow the JAX model's cast points: matmuls accumulate in f32 and
round to the model dtype where JAX casts back (``.astype(x.dtype)``), and
stay f32 where it does not (the MLP's ``up`` before gelu, the logits).  The
dense and decode attention round ``p`` to the model dtype before P·V; the
flash kernel keeps it f32.  ``gelu`` is the tanh approximation, as
``jax.nn.gelu`` is by default.  Masked scores use the finite ``-1e30``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..ops.kernels.common import _NEG
from ..ops.kernels.flash_attention import flash_attention
from ..ops.kernels.layers import fused_rmsnorm, fused_softmax_xent

__all__ = ["TransformerConfig", "TransformerLM", "make_train_step",
           "params_from_numpy"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX model's configuration, same fields and defaults.  ``remat``
    recomputes each block's forward in the backward pass (per-block
    activation checkpointing, as ``jax.checkpoint`` of the scan body).
    ``scan_unroll`` has no meaning in eager PyTorch (the layers are a
    Python loop); ``n_experts`` and ``moe_aux_weight`` matter only to MoE,
    which is not ported: ``use_moe=True`` is refused."""
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_len: int = 2048
    dtype: str = "bfloat16"
    use_moe: bool = False
    n_experts: int = 8
    moe_aux_weight: float = 0.01
    remat: bool = True
    scan_unroll: bool = True
    # dense attention while the f32 score tensor B*H*T^2*4 bytes stays at
    # or under this many MB; past it, the flash kernel
    dense_attn_max_score_mb: int = 768

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


def params_from_numpy(np_params, device, dtype=None):
    """Turn a JAX model's flat parameter dict, as numpy arrays, into
    tensors on ``device`` (cast to ``dtype`` when given).

    A JAX bf16 array arrives as a numpy array of the ``bfloat16`` extension
    type, which ``torch.from_numpy`` rejects: it is viewed as ``uint16`` and
    the tensor viewed back as ``torch.bfloat16``, bit for bit."""
    out = {}
    for name, arr in np_params.items():
        arr = np.array(arr, order="C")       # a writable copy: JAX's are not
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out[name] = t.to(device=device, dtype=dtype)
    return out


def _dense_self_attention(q, k, v, causal=True):
    """Materialized attention for short sequences, [B, T, H, D] in and out:
    f32 scores scaled by ``1/sqrt(D)``, softmax in f32, ``p`` rounded to the
    model dtype before the f32-accumulated P·V."""
    B, T, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return o.to(q.dtype)


def _param(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class _Blocks(nn.Module):
    """The per-layer weights, stacked on a leading ``L`` axis."""

    def __init__(self, cfg, device, dtype):
        super().__init__()
        L, E, F_ = cfg.n_layers, cfg.d_model, cfg.d_ff
        HD = cfg.n_heads * cfg.head_dim
        self.ln1_scale = _param((L, E), device, dtype)
        self.ln2_scale = _param((L, E), device, dtype)
        self.wqkv = _param((L, E, 3 * HD), device, dtype)
        self.wo = _param((L, HD, E), device, dtype)
        self.w_up = _param((L, E, F_), device, dtype)
        self.w_down = _param((L, F_, E), device, dtype)


class TransformerLM(nn.Module):
    """Decoder-only LM over the JAX model's parameters.

    ``device`` defaults to ``cuda:0`` and raises without a CUDA device
    unless ``device="cpu"`` is given.  Weights are drawn at construction
    from ``generator`` (a :class:`torch.Generator` on ``device``; seed 0 by
    default) — or carried over from JAX with :meth:`load_jax_params`.
    """

    def __init__(self, config: TransformerConfig, device=None,
                 generator=None):
        super().__init__()
        if config.use_moe:
            raise NotImplementedError("mxnet_tpu_torch: MoE is not ported "
                                      "yet")
        if config.dtype not in _DTYPES:
            raise ValueError("dtype %r not in %s" % (config.dtype,
                                                      sorted(_DTYPES)))
        self.cfg = config
        dev = resolve_device(device)
        dt = _DTYPES[config.dtype]
        E, V = config.d_model, config.vocab_size
        self.embed = _param((V, E), dev, dt)
        self.blocks = _Blocks(config, dev, dt)
        self.final_ln_scale = _param((E,), dev, dt)
        self.unembed = _param((E, V), dev, dt)
        self.init(generator)

    @property
    def device(self):
        return self.embed.device

    @property
    def dtype(self):
        return self.embed.dtype

    # -- init ----------------------------------------------------------
    @torch.no_grad()
    def init(self, generator=None):
        """Draw fresh weights as the JAX ``init`` does: each matrix
        ``N(0, 1) / sqrt(fan_in)`` drawn in f32 and cast to the model dtype,
        every norm scale 1.  ``jax.random`` cannot be replayed in torch, so
        the values differ from JAX's for the same seed."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        cfg = self.cfg
        HD = cfg.n_heads * cfg.head_dim
        fan_in = {"embed": cfg.d_model, "blocks.wqkv": cfg.d_model,
                  "blocks.wo": HD, "blocks.w_up": cfg.d_model,
                  "blocks.w_down": cfg.d_ff, "unembed": cfg.d_model}
        for name, p in self.named_parameters():
            if name in fan_in:
                w = torch.randn(p.shape, generator=generator,
                                device=p.device, dtype=torch.float32)
                p.copy_(w / math.sqrt(fan_in[name]))
            else:
                p.fill_(1.0)
        return self

    @torch.no_grad()
    def load_jax_params(self, np_params):
        """Copy a JAX model's flat parameter dict (numpy arrays, e.g.
        ``{k: np.asarray(v) for k, v in jax_params.items()}``) into this
        module.  Names and shapes must match exactly."""
        self.load_state_dict(params_from_numpy(np_params, self.device,
                                               self.dtype), strict=True)
        return self

    # -- forward -------------------------------------------------------
    def _params(self, params):
        return dict(self.named_parameters()) if params is None else params

    def _rmsnorm(self, x, scale):
        return fused_rmsnorm(x, scale.to(x.dtype))

    def _block(self, P, layer, x, with_kv=False):
        cfg = self.cfg
        B, T, _ = x.shape
        H, D = cfg.n_heads, cfg.head_dim
        h = self._rmsnorm(x, P["blocks.ln1_scale"][layer])
        qkv = torch.matmul(h, P["blocks.wqkv"][layer])
        q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1))
        score_mb = B * H * T * T * 4 / 1e6
        if score_mb <= cfg.dense_attn_max_score_mb:
            attn = _dense_self_attention(q, k, v, causal=True)
        else:
            attn = flash_attention(q, k, v, causal=True)
        o = torch.matmul(attn.reshape(B, T, H * D), P["blocks.wo"][layer])
        x = x + o
        h = self._rmsnorm(x, P["blocks.ln2_scale"][layer])
        up = torch.matmul(h.float(), P["blocks.w_up"][layer].float())
        ff = torch.matmul(F.gelu(up, approximate="tanh").to(x.dtype),
                          P["blocks.w_down"][layer])
        x = x + ff
        if with_kv:
            return x, k, v
        return x

    def _logits(self, P, x):
        x = self._rmsnorm(x, P["final_ln_scale"])
        return torch.matmul(x.float(), P["unembed"].float())

    def apply(self, tokens, params=None):
        """tokens [B, T] (int) -> ``(logits [B, T, V] f32, aux)``, ``aux``
        the f32 scalar MoE auxiliary loss (0 for the dense MLP).  The full
        forward pass: the oracle for the incremental decode path.

        With ``cfg.remat`` and gradients enabled, each block runs under
        non-reentrant activation checkpointing and its forward runs again
        in the backward pass, as under ``jax.checkpoint``."""
        P = self._params(params)
        x = P["embed"][tokens]
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in range(self.cfg.n_layers):
            if remat:
                x = checkpoint(self._block, P, layer, x, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = self._block(P, layer, x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._logits(P, x), aux

    def forward(self, tokens):
        return self.apply(tokens)

    # -- training ------------------------------------------------------
    def loss(self, params, tokens, targets):
        """Causal LM loss: the mean token cross-entropy of the fused
        softmax-xent kernel, plus ``moe_aux_weight·aux``.  ``params`` is a
        flat ``{name: tensor}`` dict or ``None`` (the module's own
        parameters); tokens, targets: [B, T] int."""
        logits, aux = self.apply(tokens, params)
        nll = fused_softmax_xent(logits, targets).mean()
        return nll + self.cfg.moe_aux_weight * aux

    def value_and_grad(self, params, tokens, targets):
        """``(loss, grads)`` of :meth:`loss` with respect to every tensor of
        ``params`` (``None``: the module's own), the counterpart of
        ``jax.value_and_grad(model.loss)``.  ``grads`` is a dict under the
        same names, each gradient in its parameter's dtype."""
        P = self._params(params)
        leaves = {k: p.detach().requires_grad_(True) for k, p in P.items()}
        loss = self.loss(leaves, tokens, targets)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    # -- generative decode (paged KV cache) ----------------------------
    #
    # Layout: k_pages / v_pages are [L, P, page_size, H, D] in the model
    # dtype.  Page 0 is the reserved GARBAGE page: writes from prompt
    # padding and inactive decode slots go there, so neither function
    # branches on validity — the attention mask (position <= length) is the
    # only filter.  Page tables are [M] (per sequence) int64, padded with
    # 0; position t lives at flat slot page_table[t // ps] * ps + t % ps.
    # Unlike the JAX functions, which return new page arrays, these write
    # the pages in place.

    def init_kv_pages(self, num_pages, page_size):
        """Zeroed paged KV storage: a ([L, P, ps, H, D], same) pair."""
        cfg = self.cfg
        shape = (cfg.n_layers, num_pages, page_size, cfg.n_heads,
                 cfg.head_dim)
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    def prefill(self, k_pages, v_pages, tokens, length, page_table,
                params=None):
        """Run a prompt through the model, writing each layer's K/V into the
        pages, and return the next-token logits [V] (f32).

        tokens: [1, Tpad] int64 (prompt left-aligned, padded to a bucket);
        length: int, the true prompt length; page_table: [M] int64, the
        pages backing positions 0..length-1; params: a flat dict under the
        JAX names (``None``: the module's own parameters)."""
        cfg = self.cfg
        H, D = cfg.n_heads, cfg.head_dim
        ps = k_pages.shape[2]
        Tpad = tokens.shape[1]
        P = self._params(params)
        x = P["embed"][tokens]
        t = torch.arange(Tpad, device=tokens.device)
        dest = torch.where(t < length, page_table[t // ps] * ps + t % ps,
                           t % ps)
        for layer in range(cfg.n_layers):
            x, k, v = self._block(P, layer, x, with_kv=True)
            k_pages[layer].view(-1, H, D)[dest] = k[0]
            v_pages[layer].view(-1, H, D)[dest] = v[0]
        return self._logits(P, x[:, length - 1])[0]

    def decode_step(self, k_pages, v_pages, tokens, page_tables, lens,
                    active, params=None):
        """One autoregressive step for a batch of decode slots; returns the
        next-token logits [S, V] (f32).

        tokens: [S] int64, the token each slot appends; page_tables: [S, M]
        int64; lens: [S] int64, the sequence length BEFORE this token (it
        is written at position ``lens`` and attends 0..lens); active: [S]
        bool — inactive slots write to the garbage page; params: as in
        :meth:`prefill`."""
        cfg = self.cfg
        H, D = cfg.n_heads, cfg.head_dim
        S = tokens.shape[0]
        ps = k_pages.shape[2]
        P = self._params(params)
        x = P["embed"][tokens][:, None, :]                  # [S, 1, E]
        cur_page = page_tables.gather(1, (lens // ps)[:, None])[:, 0]
        dest = torch.where(active, cur_page, 0) * ps + lens % ps
        span = page_tables.shape[1] * ps
        attn_mask = (torch.arange(span, device=lens.device)[None, :]
                     <= lens[:, None])                      # [S, span]
        for layer in range(cfg.n_layers):
            h = self._rmsnorm(x, P["blocks.ln1_scale"][layer])
            qkv = torch.matmul(h, P["blocks.wqkv"][layer])
            q, k, v = qkv.split(H * D, dim=-1)
            q = q.reshape(S, H, D)
            kp, vp = k_pages[layer], v_pages[layer]
            kp.view(-1, H, D)[dest] = k.reshape(S, H, D)
            vp.view(-1, H, D)[dest] = v.reshape(S, H, D)
            kg = kp[page_tables].reshape(S, span, H, D)
            vg = vp[page_tables].reshape(S, span, H, D)
            s = torch.einsum("shd,skhd->shk", q.float(),
                             kg.float()) / math.sqrt(D)
            s = s.masked_fill(~attn_mask[:, None, :], _NEG)
            p = torch.softmax(s, dim=-1).to(x.dtype)
            attn = torch.einsum("shk,skhd->shd", p.float(),
                                vg.float()).to(x.dtype)
            o = torch.matmul(attn.reshape(S, 1, H * D), P["blocks.wo"][layer])
            x = x + o
            h = self._rmsnorm(x, P["blocks.ln2_scale"][layer])
            up = torch.matmul(h.float(), P["blocks.w_up"][layer].float())
            ff = torch.matmul(F.gelu(up, approximate="tanh").to(x.dtype),
                              P["blocks.w_down"][layer])
            x = x + ff
        return self._logits(P, x[:, 0])


def make_train_step(model, lr=1e-2, momentum=0.9, rules=None):
    """SGD with momentum, the counterpart of the JAX ``make_train_step``:
    returns ``step(params, velocity, tokens, targets) -> (params, velocity,
    loss)`` over flat ``{name: tensor}`` dicts under the JAX names (the
    ``state_dict`` keys, e.g. ``dict(model.named_parameters())`` and zeros
    of the same shapes).

    The update is JAX's, in each parameter's dtype: ``v = momentum·v + g``,
    then ``p = p − lr·v`` (``lr·v`` rounded to the dtype first).  It is made
    IN PLACE: the returned dicts are the ones passed in, their tensors
    overwritten, so passing the module's own parameters trains the module.
    ``rules`` (sharding) is not ported until the mesh slice."""
    if rules is not None:
        raise NotImplementedError("mxnet_tpu_torch: sharding rules are not "
                                  "ported yet (one device only)")

    def step(params, velocity, tokens, targets):
        loss, grads = model.value_and_grad(params, tokens, targets)
        with torch.no_grad():
            for name, p in params.items():
                v = velocity[name]
                v.mul_(momentum).add_(grads[name].to(v.dtype))
                p.sub_(v.to(p.dtype) * lr)
        return params, velocity, loss

    return step
