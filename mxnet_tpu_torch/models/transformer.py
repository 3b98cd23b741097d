"""Decoder-only Transformer LM: the port of ``mxnet_tpu/models/transformer.py``.

It carries the forward pass, the paged-KV serving path (``init_kv_pages``
/ ``prefill`` / ``decode_step``) and training (``loss``,
:func:`make_train_step`, SGD with momentum), on one device or under a
:class:`~mxnet_tpu_torch.parallel.DeviceMesh`; ``use_moe`` trains (the
paged decode refuses it, as the JAX package's does).

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

Under a mesh each rank runs the model on its shards (``_Plan``): the batch
is cut over ``dp`` and ``fsdp``, the sequence over ``sp`` (ring attention,
the streaming form, as in JAX), heads, the MLP's hidden units and the
vocabulary over ``tp``, experts over ``ep``.  Parameters are stored in
their rule's layout (:func:`default_rules`; a DTensor's placements say
which) and gathered per layer over the axes the compute does not cut
(``fsdp`` always, ZeRO-style; ``wqkv`` over ``tp`` too, since its stored
column blocks cut across q, k and v).  The dense/flash gate reads the
global B·H·T² score size.  The routing differs from the JAX package's
under a mesh: there GSPMD cannot partition a custom call, so RMSNorm, the
cross-entropy and, unless wrapped in ``shard_map``, flash fall back to lax.
Here every rank runs the hand-written kernels on its local shards: RMSNorm
over E (no rule cuts it), flash on the local batch and heads (whole where
their axes do not divide, where JAX's wrapper falls back to the blockwise
form), and the cross-entropy on whole rows, the vocab-cut logits gathered
over ``tp`` first.
"""
from __future__ import annotations

import contextlib
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
from ..parallel import collectives as C
from ..parallel.mesh import current_mesh
from ..parallel.moe import moe_layer
from ..parallel.ring_attention import ring_attention
from ..parallel.sharding import (PartitionSpec as P_, ShardingRules,
                                 _entry_axes, _filter_spec, local_shard,
                                 local_tensor, shard_array, spec_of, gather)

__all__ = ["TransformerConfig", "TransformerLM", "make_train_step",
           "params_from_numpy", "default_rules"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX model's configuration, same fields and defaults.  ``remat``
    recomputes each block's forward in the backward pass (per-block
    activation checkpointing, as ``jax.checkpoint`` of the scan body).
    ``scan_unroll`` has no meaning in eager PyTorch (the layers are a
    Python loop)."""
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


def default_rules() -> ShardingRules:
    """The JAX model's layout: qkv and the MLP's up projection cut on
    their output features over ``tp``, the output and down projections on
    their input features; ``fsdp`` cuts the other large dimension; experts
    over ``ep``."""
    return ShardingRules([
        (r"embed",        P_("tp", "fsdp")),
        (r".*wqkv",       P_(None, "fsdp", "tp")),
        (r".*wo",         P_(None, "tp", "fsdp")),
        (r".*w_up",       P_(None, "fsdp", "tp")),
        (r".*w_down",     P_(None, "tp", "fsdp")),
        (r".*moe_up",     P_(None, "ep", "fsdp", None)),
        (r".*moe_down",   P_(None, "ep", None, "fsdp")),
        (r".*gate",       P_(None, "fsdp", None)),
        (r"unembed",      P_("fsdp", "tp")),
        (r".*",           P_()),
    ])


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
        if cfg.use_moe:
            n = cfg.n_experts
            self.gate = _param((L, E, n), device, dtype)
            self.moe_up = _param((L, n, E, F_), device, dtype)
            self.moe_down = _param((L, n, F_, E), device, dtype)
        else:
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
        fan_in = self.fan_in()
        for name, p in self.named_parameters():
            if name in fan_in:
                w = torch.randn(p.shape, generator=generator,
                                device=p.device, dtype=torch.float32)
                p.copy_(w / math.sqrt(fan_in[name]))
            else:
                p.fill_(1.0)
        return self

    def fan_in(self):
        """Each matrix's fan-in, by name: its ``init`` draws N(0, 1) /
        sqrt(fan-in); every other parameter (a norm scale) is 1."""
        cfg = self.cfg
        return {"embed": cfg.d_model, "blocks.wqkv": cfg.d_model,
                "blocks.wo": cfg.n_heads * cfg.head_dim,
                "blocks.w_up": cfg.d_model, "blocks.w_down": cfg.d_ff,
                "unembed": cfg.d_model, "blocks.gate": cfg.d_model,
                "blocks.moe_up": cfg.d_model, "blocks.moe_down": cfg.d_ff}

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

    def _block(self, P, layer, x, with_kv=False, plan=None):
        """One layer: ``(x, aux)``, or ``(x, aux, k, v)`` with ``with_kv``.
        ``plan`` (a :class:`_Plan`) runs it on this rank's shards under a
        mesh; ``None`` is one device."""
        cfg = self.cfg
        plan = plan or _ONE_DEVICE
        B, T, _ = x.shape
        H, D = cfg.n_heads, cfg.head_dim
        h = self._rmsnorm(x, plan.weight(P, "blocks.ln1_scale", layer))
        qkv = torch.matmul(h, plan.qkv_weight(P, layer))
        Hl = qkv.shape[-1] // (3 * D)                   # this rank's heads
        q, k, v = (t.view(B, T, Hl, D) for t in qkv.split(Hl * D, dim=-1))
        Bg, Tg = plan.global_bt(B, T)
        score_mb = Bg * H * Tg * Tg * 4 / 1e6
        if plan.ring:
            attn = ring_attention(q, k, v, "sp", causal=True)
        elif score_mb <= cfg.dense_attn_max_score_mb:
            attn = _dense_self_attention(q, k, v, causal=True)
        else:
            attn = flash_attention(q, k, v, causal=True)
        o = torch.matmul(attn.reshape(B, T, Hl * D),
                         plan.weight(P, "blocks.wo", layer,
                                     {0: "tp"} if plan.heads else None))
        x = x + plan.tp_sum(o, plan.heads)
        h = self._rmsnorm(x, plan.weight(P, "blocks.ln2_scale", layer))
        if cfg.use_moe:
            ff, aux = plan.moe(self, P, layer, h)
        else:
            cut = {1: "tp"} if plan.ff else None
            up = torch.matmul(h.float(),
                              plan.weight(P, "blocks.w_up", layer, cut).float())
            ff = torch.matmul(
                F.gelu(up, approximate="tanh").to(x.dtype),
                plan.weight(P, "blocks.w_down", layer,
                            {0: "tp"} if plan.ff else None))
            ff = plan.tp_sum(ff, plan.ff)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x = x + ff
        if with_kv:
            return x, aux, k, v
        return x, aux

    def _block_in_mesh(self, P, layer, x, plan):
        """:meth:`_block` inside the plan's mesh: the checkpoint's
        recomputation may run on autograd's device thread, where the
        caller's mesh is not current."""
        with plan.mesh if plan.mesh is not None else contextlib.nullcontext():
            return self._block(P, layer, x, plan=plan)

    def _logits(self, P, x, plan=None):
        plan = plan or _ONE_DEVICE
        x = self._rmsnorm(x, plan.weight(P, "final_ln_scale"))
        w = plan.weight(P, "unembed", None, {1: "tp"} if plan.vocab else None)
        logits = torch.matmul(x.float(), w.float())
        if plan.vocab:                  # whole rows for the cross-entropy
            logits = C.allgather(logits, "tp", axis=-1)
        return logits

    def apply(self, tokens, params=None):
        """tokens [B, T] (int) -> ``(logits [B, T, V] f32, aux)``, ``aux``
        the f32 scalar MoE auxiliary loss (0 for the dense MLP).  The full
        forward pass: the oracle for the incremental decode path.

        With ``cfg.remat`` and gradients enabled, each block runs under
        non-reentrant activation checkpointing and its forward runs again
        in the backward pass, as under ``jax.checkpoint`` (under a mesh its
        collectives run again too, in the same order on every rank).

        Under a mesh ``tokens`` is the global batch (the same on every
        rank) and the logits are this rank's rows of it, whole over the
        vocabulary."""
        P = self._params(params)
        return self._run(tokens, P, _plan_for(self, P, tokens.shape))

    def _run(self, tokens, P, plan):
        tokens = plan.local_tokens(tokens)
        x = plan.embed(P, tokens)
        remat = self.cfg.remat and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in range(self.cfg.n_layers):
            if remat:
                x, a = checkpoint(self._block_in_mesh, P, layer, x, plan,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = self._block(P, layer, x, plan=plan)
            aux = aux + a
        return self._logits(P, x, plan), aux

    def forward(self, tokens):
        return self.apply(tokens)

    # -- training ------------------------------------------------------
    def loss(self, params, tokens, targets):
        """Causal LM loss: the mean token cross-entropy of the fused
        softmax-xent kernel, plus ``moe_aux_weight·aux``.  ``params`` is a
        flat ``{name: tensor}`` dict or ``None`` (the module's own
        parameters); tokens, targets: [B, T] int (under a mesh the global
        batch; the loss is the global mean, the same on every rank)."""
        P = self._params(params)
        return self._loss(P, tokens, targets,
                          _plan_for(self, P, tokens.shape))

    def _loss(self, P, tokens, targets, plan):
        logits, aux = self._run(tokens, P, plan)
        nll = fused_softmax_xent(logits, plan.local_tokens(targets))
        if plan.mesh is None:
            nll = nll.mean()
        else:
            nll = C.allreduce(nll.sum(), plan.batch_axes + plan.seq_axes) \
                / targets.numel()
        return nll + self.cfg.moe_aux_weight * aux

    def value_and_grad(self, params, tokens, targets):
        """``(loss, grads)`` of :meth:`loss` with respect to every tensor of
        ``params`` (``None``: the module's own), the counterpart of
        ``jax.value_and_grad(model.loss)``.  ``grads`` is a dict under the
        same names, each gradient in its parameter's dtype.

        Under a mesh each parameter is this rank's shard (a DTensor, or a
        plain tensor for a replicated one) and its gradient is the local
        shard of the whole gradient, summed over the ranks that share the
        shard (the transposes of :mod:`~mxnet_tpu_torch.parallel.
        collectives`)."""
        P = self._params(params)
        plan = _plan_for(self, P, tokens.shape)
        leaves = {k: local_tensor(p).detach().requires_grad_(True)
                  for k, p in P.items()}
        loss = self._loss(plan.enter(leaves), tokens, targets, plan)
        grads = torch.autograd.grad(plan.leave(loss), list(leaves.values()))
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
        _refuse_moe(cfg)
        H, D = cfg.n_heads, cfg.head_dim
        ps = k_pages.shape[2]
        Tpad = tokens.shape[1]
        P = self._params(params)
        x = P["embed"][tokens]
        t = torch.arange(Tpad, device=tokens.device)
        dest = torch.where(t < length, page_table[t // ps] * ps + t % ps,
                           t % ps)
        for layer in range(cfg.n_layers):
            x, _, k, v = self._block(P, layer, x, with_kv=True)
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
        _refuse_moe(cfg)
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

    Under a mesh the step runs on each rank's shards and the loss is the
    global one.  With ``rules`` (a :class:`ShardingRules`) the parameters
    and the velocity are pinned to their rule's placement first (a dict
    entry whose layout differs is replaced by a DTensor in the rule's
    layout): on an ``fsdp`` axis each rank then stores 1/fsdp of every
    parameter and of its velocity, ZeRO-style, and updates only that.
    Outside a mesh ``rules`` changes nothing, as a JAX sharding constraint
    outside a mesh does not."""

    def step(params, velocity, tokens, targets):
        mesh = current_mesh()
        if rules is not None and mesh is not None:
            for tree in (params, velocity):
                _pin(tree, rules, mesh)
        loss, grads = model.value_and_grad(params, tokens, targets)
        with torch.no_grad():
            for name, p in params.items():
                p, v = local_tensor(p), local_tensor(velocity[name])
                v.mul_(momentum).add_(grads[name].to(v.dtype))
                p.sub_(v.to(p.dtype) * lr)
        return params, velocity, loss

    return step


def _pin(tree, rules, mesh):
    """Re-store each tensor of ``tree`` in its rule's layout, in place."""
    for name, t in tree.items():
        want = _filter_spec(rules.spec_for(name), mesh, tuple(t.shape))
        have = spec_of(t)
        if _filter_spec(have, mesh, tuple(t.shape)) != want:
            full = gather(local_tensor(t).detach(), have, mesh)
            tree[name] = shard_array(full, want, mesh)


def _refuse_moe(cfg):
    if cfg.use_moe:
        raise NotImplementedError("paged decode does not support MoE yet")


def _pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


class _Plan:
    """How one call's tensors are cut over the current mesh: the batch
    over ``dp`` and ``fsdp``, the sequence over ``sp`` (each where it
    divides), heads, the MLP's hidden units and the vocabulary over ``tp``
    and experts over ``ep`` where those divide; each parameter's stored
    spec.  ``mesh=None`` is one device: every method is then the plain
    read of the parameter, with no collective."""

    def __init__(self, cfg=None, mesh=None, specs=None, shape=None):
        self.mesh = mesh
        self.specs = specs or {}
        self.batch_axes = self.seq_axes = ()
        self.ring = self.heads = self.ff = self.vocab = self.experts = False
        if mesh is None:
            return
        tok = _filter_spec(P_(("dp", "fsdp"), "sp"), mesh, tuple(shape))
        self.token_spec = tok
        self.batch_axes, self.seq_axes = (_entry_axes(tok[0]),
                                          _entry_axes(tok[1]))
        self.ring = bool(self.seq_axes)
        tp, ep = mesh.size("tp"), mesh.size("ep")
        self.heads = tp > 1 and cfg.n_heads % tp == 0
        self.ff = tp > 1 and cfg.d_ff % tp == 0 and not cfg.use_moe
        self.vocab = tp > 1 and cfg.vocab_size % tp == 0
        self.experts = ep > 1 and cfg.n_experts % ep == 0

    # -- the boundary of the per-rank region (shard_map's transposes) ---
    def enter(self, leaves):
        if self.mesh is None:
            return leaves
        out = {}
        for name, t in leaves.items():
            cut = {a for e in self.specs.get(name, ()) for a in _entry_axes(e)}
            out[name] = C.region_in(t, tuple(a for a in self.mesh.axis_names
                                             if a not in cut))
        return out

    def leave(self, loss):
        if self.mesh is None:
            return loss
        return C.region_out(loss, self.mesh.axis_names)

    # -- tensors --------------------------------------------------------
    def weight(self, P, name, layer=None, cut=None):
        """Parameter ``name`` (layer ``layer`` of a stack) as the compute
        reads it: whole, but for the dims in ``cut`` (``{dim: axis}``),
        which stay this rank's chunk on that axis."""
        t = local_tensor(P[name])
        if self.mesh is None:
            return t if layer is None else t[layer]
        spec = _pad(self.specs.get(name, ()), t.ndim)
        if layer is not None:
            t, spec = t[layer], spec[1:]
        cut = cut or {}
        for dim, entry in enumerate(spec):
            if entry is not None and cut.get(dim) != entry:
                t = C.allgather(t, _entry_axes(entry), axis=dim)
        for dim, axis in cut.items():
            if spec[dim] != axis:       # stored whole: take the chunk
                n = self.mesh.size(axis)
                t = t.chunk(n, dim)[self.mesh.index(axis)]
        return t

    def qkv_weight(self, P, layer):
        """``wqkv`` whole, then, with heads cut over ``tp``, the q, k and v
        columns of this rank's heads."""
        w = self.weight(P, "blocks.wqkv", layer)
        if not self.heads:
            return w
        HD = w.shape[-1] // 3
        n, i = self.mesh.size("tp"), self.mesh.index("tp")
        per = HD // n
        return torch.cat([w[:, j * HD + i * per:j * HD + (i + 1) * per]
                          for j in range(3)], dim=-1)

    def tp_sum(self, x, on):
        return C.allreduce(x, "tp") if on else x

    def embed(self, P, tokens):
        """The lookup; over a vocabulary cut on ``tp``, each rank looks up
        the ids it holds and the rows sum over ``tp``."""
        w = self.weight(P, "embed", None, {0: "tp"} if self.vocab else None)
        if not self.vocab:
            return w[tokens]
        Vl = w.shape[0]
        local = tokens - self.mesh.index("tp") * Vl
        inside = (local >= 0) & (local < Vl)
        rows = w[local.clamp(0, Vl - 1)]
        rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
        return C.allreduce(rows, "tp")

    def local_tokens(self, tokens):
        if self.mesh is None:
            return tokens
        return local_shard(tokens, self.token_spec, self.mesh)

    def global_bt(self, B, T):
        """The global batch and sequence of a rank's [B, T]: cut only over
        the axes the plan cuts them on (an axis that does not divide leaves
        the dim whole on every rank)."""
        if self.mesh is None:
            return B, T
        return (B * C.axis_size(self.batch_axes),
                T * C.axis_size(self.seq_axes))

    def moe(self, model, P, layer, h):
        """The MoE feed-forward on the global tokens (gathered over the
        batch and sequence axes; JAX's routing and capacity count them
        all), this rank's experts; returns this rank's rows and aux."""
        x = h
        if self.mesh is not None:
            if self.seq_axes:
                x = C.allgather(x, self.seq_axes, axis=1)
            if self.batch_axes:
                x = C.allgather(x, self.batch_axes, axis=0)
        ex = {0: "ep"} if self.experts else None
        y, aux = moe_layer(x, self.weight(P, "blocks.gate", layer),
                           self.weight(P, "blocks.moe_up", layer, ex),
                           self.weight(P, "blocks.moe_down", layer, ex))
        if self.mesh is not None:
            y = local_shard(y, self.token_spec, self.mesh)
        return y, aux


_ONE_DEVICE = _Plan()


def _plan_for(model, P, shape):
    mesh = current_mesh()
    if mesh is None:
        return _ONE_DEVICE
    specs = {k: spec_of(v) for k, v in P.items()}
    return _Plan(model.cfg, mesh, specs, shape)
