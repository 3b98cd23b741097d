"""Ring attention: the port of ``mxnet_tpu/parallel/ring_attention.py``.

The sequence is cut over mesh axis ``sp``: each rank holds [B, T/n, H, D]
of q, k and v.  In n steps each rank attends its q to the k/v block it
holds, then passes that block one hop around the ring
(:func:`.collectives.ppermute_shift`).  A streaming softmax (running max,
normalizer, unnormalized output, all f32) makes the result the softmax
over the whole sequence; the causal mask reads global positions.  The
backward is autograd through the loop; the ring's sends run again in the
reverse direction (the transpose of a rotation is the reverse rotation).
k and v travel as one tensor, so the sends form one chain and every rank
meets its neighbours in the same order in the backward too.

``use_pallas=True`` is the kernel form (``_ring_attention_flash``): each
block is one :func:`~mxnet_tpu_torch.ops.kernels.flash_attention_lse` call
(the hand-written flash forward on a CUDA tensor, its dQ and dK/dV kernels
in the backward with the lse cotangent; the plain versions on a CPU
tensor), and blocks merge by their logsumexps (:func:`_merge_partials`).
The keyword keeps the JAX package's name.  Under a causal mask the blocks
of later ranks are computed and given weight zero (lse = -1e30), as in JAX:
every rank runs the same program, which keeps the backward's sends
matched.
"""
from __future__ import annotations

import math

import torch

from .collectives import axis_index, axis_size, ppermute_shift

__all__ = ["ring_attention", "blockwise_attention", "ring_self_attention"]

_NEG = -1e30


def _block_scores(q, k, scale):
    # [B, Tq, H, D] x [B, Tk, H, D] -> [B, H, Tq, Tk], f32
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def _stream_update(o, m, l, s, v):
    """One step of the streaming-softmax recurrence."""
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * alpha.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def ring_attention(q, k, v, axis_name, causal=True, scale=None,
                   use_pallas=False):
    """Attention over a sequence cut on ``axis_name``: q, k, v are this
    rank's [B, T_local, H, D] slices; returns [B, T_local, H, D]."""
    if use_pallas:
        return _ring_attention_flash(q, k, v, axis_name, causal, scale)
    B, Tq, H, D = q.shape
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    n = axis_size(axis_name)
    my = axis_index(axis_name)
    Tk = k.shape[1]
    q_pos = my * Tq + torch.arange(Tq, device=q.device)

    o = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)

    def block(o, m, l, k_blk, v_blk, owner):
        s = _block_scores(q, k_blk, scale)
        if causal:
            k_pos = owner * Tk + torch.arange(Tk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = s.masked_fill(~mask, _NEG)
        return _stream_update(o, m, l, s, v_blk)

    o, m, l = block(o, m, l, k, v, my)
    kv = torch.stack([k, v])
    for i in range(1, n):
        # receive the block owned by (my + i) from the next rank
        kv = ppermute_shift(kv, axis_name, -1)
        o, m, l = block(o, m, l, kv[0], kv[1], (my + i) % n)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def _merge_partials(o_a, lse_a, o_b, lse_b):
    """Merge two normalized softmax partials over disjoint key sets
    (o: [B, T, H, D] f32, lse: [B, H, T] f32)."""
    lse_new = torch.logaddexp(lse_a, lse_b)
    w_a = torch.exp(lse_a - lse_new).transpose(1, 2)[..., None]
    w_b = torch.exp(lse_b - lse_new).transpose(1, 2)[..., None]
    return o_a * w_a + o_b * w_b, lse_new


def _ring_attention_flash(q, k, v, axis_name, causal, scale):
    """Ring attention with the flash kernel as the block kernel: the
    diagonal block under the kernel's causal mask, every other rank's block
    whole (non-causal), later ranks' blocks weighted zero."""
    from ..ops.kernels.flash_attention import flash_attention_lse

    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    n = axis_size(axis_name)
    my = axis_index(axis_name)

    def blk(k_blk, v_blk, blk_causal):
        o_b, lse_b = flash_attention_lse(q, k_blk, v_blk, causal=blk_causal,
                                         scale=scale)
        return o_b.float(), lse_b

    o, lse = blk(k, v, causal)
    kv = torch.stack([k, v])
    for i in range(1, n):
        kv = ppermute_shift(kv, axis_name, -1)
        o_b, lse_b = blk(kv[0], kv[1], False)
        if causal and (my + i) % n > my:    # a later rank's keys
            lse_b = torch.full_like(lse_b, _NEG)
        o, lse = _merge_partials(o, lse, o_b, lse_b)
    return o.to(q.dtype)


def blockwise_attention(q, k, v, block_size=512, causal=True, scale=None,
                        return_lse=False):
    """Attention in key blocks with the streaming-softmax recurrence
    (memory O(T·block) for the scores).  ``return_lse=True`` also returns
    the per-row logsumexp [B, H, T] (``_NEG`` for a fully masked row), as
    ``flash_attention_lse`` does."""
    B, T, H, D = q.shape
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    nb = max(1, math.ceil(k.shape[1] / block_size))
    q_pos = torch.arange(T, device=q.device)
    o = torch.zeros((B, T, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    for bi in range(nb):
        lo = bi * block_size
        k_blk = k[:, lo:lo + block_size]
        v_blk = v[:, lo:lo + block_size]
        s = _block_scores(q, k_blk, scale)
        if causal:
            k_pos = lo + torch.arange(k_blk.shape[1], device=q.device)
            s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), _NEG)
        if k_blk.shape[1] < block_size:
            # the JAX version pads the last block with masked columns:
            # they add exp(_NEG - m) = 0 to l, and change m only when a
            # whole row is masked
            pad = s.new_full(s.shape[:-1] + (block_size - k_blk.shape[1],),
                             _NEG)
            s = torch.cat([s, pad], -1)
            v_blk = torch.cat([v_blk, v_blk.new_zeros(
                (B, block_size - k_blk.shape[1], H, D))], 1)
        o, m, l = _stream_update(o, m, l, s, v_blk)
    out = (o / l.transpose(1, 2)[..., None]).to(q.dtype)
    if return_lse:
        lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                          torch.full_like(l, _NEG))
        return out, lse
    return out


def ring_self_attention(q, k, v, mesh=None, seq_axis="sp", batch_axis="dp",
                        head_axis="tp", causal=True, use_pallas=False):
    """Per-rank counterpart of the JAX ``shard_map`` wrapper: q, k, v are
    this rank's slices (batch on ``batch_axis``, sequence on ``seq_axis``,
    heads on ``head_axis``; attention is per head and per batch element,
    so only the sequence axis needs the ring).  Without an ``sp`` axis it
    is :func:`blockwise_attention`, or with ``use_pallas`` the flash
    kernel."""
    from .mesh import current_mesh

    del batch_axis, head_axis
    mesh = mesh or current_mesh()
    if mesh is None or mesh.size(seq_axis) == 1:
        if use_pallas:
            from ..ops.kernels.flash_attention import flash_attention
            return flash_attention(q, k, v, causal=causal)
        return blockwise_attention(q, k, v, causal=causal)
    with mesh:
        return ring_attention(q, k, v, axis_name=seq_axis, causal=causal,
                              use_pallas=use_pallas)
