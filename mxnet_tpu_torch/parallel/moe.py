"""Expert parallelism: the port of ``mxnet_tpu/parallel/moe.py``.

A top-k routed mixture-of-experts feed-forward (k=1 the Switch router,
k>=2 GShard's) with the load-balancing auxiliary loss, capacity per expert
and dense one-hot dispatch and combine, as in the JAX package.  The
expert dimension is cut over mesh axis ``ep``: each rank holds
``n_exp / ep`` experts' weights, routes every token over all experts,
dispatches to and runs its own experts only, and the combine's partial
sums add over ``ep`` (:func:`.collectives.allreduce`).  The tokens are
the same on every ``ep`` rank.

Ties: ``torch.topk`` does not promise JAX's order among equal gate values
(``lax.top_k`` takes the lower index); random inputs have none.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .collectives import allreduce, axis_index

__all__ = ["moe_layer"]


def moe_layer(x, gate_w, w_up, w_down, ep_axis="ep", capacity_factor=1.25,
              top_k=1, renormalize=True):
    """Top-k routed MoE feed-forward.

    x: [B, T, E]; gate_w: [E, n_exp]; w_up: [n_local, E, H]; w_down:
    [n_local, H, E], where ``n_local`` is ``n_exp`` or, cut over
    ``ep_axis``, this rank's ``n_exp / ep`` experts.  Returns (y [B, T,
    E], aux_loss f32 scalar).  Tokens past an expert's capacity are dropped
    for that slot; positions count in slot-major order, so first choices
    take places first."""
    B, T, E = x.shape
    n_exp = gate_w.shape[1]
    n_local = w_up.shape[0]
    k = int(top_k)
    if not 1 <= k <= n_exp:
        raise ValueError("top_k must be in [1, n_experts]")
    S = B * T
    capacity = max(1, int(capacity_factor * k * S / n_exp))
    first = axis_index(ep_axis) * n_local if n_local != n_exp else 0

    tokens = x.reshape(S, E)
    logits = tokens.float() @ gate_w.float()
    gates = torch.softmax(logits, dim=-1)                        # [S, n]
    topg, tope = torch.topk(gates, k, dim=-1)                    # [S, k]
    if renormalize and k > 1:
        topg = topg / topg.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(tope, n_exp).to(gates.dtype)              # [S, k, n]

    # the Switch Transformer's balance loss, over the first choice
    density = onehot[:, 0, :].mean(0)
    density_proxy = gates.mean(0)
    aux_loss = n_exp * torch.sum(density * density_proxy)

    # each (slot, token)'s place in its expert's queue
    flat = onehot.transpose(0, 1).reshape(k * S, n_exp)          # [kS, n]
    pos = torch.cumsum(flat, 0) * flat
    keep = (pos <= capacity) & (flat > 0)
    pos_idx = (pos.sum(-1).to(torch.int64) - 1).clamp(0, capacity - 1)

    # dispatch mask [kS, n_local, c] -> this rank's expert inputs
    keep_l = keep[:, first:first + n_local]
    disp = (keep_l.to(x.dtype)[:, :, None]
            * F.one_hot(pos_idx, capacity).to(x.dtype)[:, None, :])
    tokens_k = tokens.expand(k, S, E).reshape(k * S, E)
    expert_in = torch.einsum("znc,ze->nce", disp.float(),
                             tokens_k.float()).to(x.dtype)
    h = torch.einsum("nce,neh->nch", expert_in.float(), w_up.float())
    h = torch.relu(h).to(x.dtype)
    expert_out = torch.einsum("nch,nhe->nce", h.float(),
                              w_down.float()).to(x.dtype)

    # combine: each slot's expert output, weighted by its gate value
    gate_flat = topg.transpose(0, 1).reshape(k * S)              # [kS]
    y_flat = torch.einsum("znc,nce->ze", disp.float(),
                          expert_out.float()).to(x.dtype) \
        * gate_flat[:, None].to(x.dtype)
    if n_local != n_exp:
        y_flat = allreduce(y_flat, ep_axis)
    y = y_flat.reshape(k, S, E).sum(0)
    return y.reshape(B, T, E), aux_loss
