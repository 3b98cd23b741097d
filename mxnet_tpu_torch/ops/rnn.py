"""The fused multi-layer RNN operator: LSTM, GRU and Elman (tanh / relu).

Counterpart of ``mxnet_tpu/ops/rnn.py`` (reference ``src/operator/
rnn-inl.h`` and ``cudnn_rnn-inl.h``).  Where the JAX package runs each
layer and direction as a ``lax.scan`` over time, the port calls cuDNN's
fused RNN through PyTorch (``torch._VF.lstm`` / ``gru`` / ``rnn_tanh`` /
``rnn_relu``, which reach ``_cudnn_rnn``) on a CUDA tensor, forward and
backward; on any other device it runs :func:`rnn_reference`, the plain
time loop the scan is, step by step.

Parameter packing is MXNet's, as in the JAX package: all weights (per
layer, per direction: W_i2h then W_h2h), then all biases (b_i2h then
b_h2h).  cuDNN takes its weights per layer and direction as w_ih, w_hh,
b_ih, b_hh, each here a view into the packed vector; they are not one
cuDNN-shaped buffer, so PyTorch copies them into one on every call (and
warns once), and its backward hands the gradients back to the views.

Layouts: data (T, N, I); states (L*dirs, N, H).  Gate order: LSTM i, f,
g, o; GRU r, z, n, with the reset gate multiplying only the h-side "new"
term, its bias included (cuDNN's and PyTorch's GRU, and the JAX
package's).

Inter-layer dropout (``p > 0`` in training) draws its masks from the
port's generator of the data's device (``mx.random``), as ``Dropout``
does.  cuDNN's own RNN dropout draws from torch's global generator, so
with dropout on the card each layer is one cuDNN call and the mask goes
between them (never after the last layer); otherwise all layers are one
call.  ``lstm_state_clip_*``, ``projection_size`` and
``use_sequence_length`` are accepted and ignored, as the JAX package
ignores them.
"""
from __future__ import annotations

import torch

from .nn import _attr_bool
from .registry import register

__all__ = ["rnn_param_size", "rnn_reference", "rnn_cudnn"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _gates(mode):
    if mode not in _GATES:
        raise ValueError("RNN: mode must be one of %s, not %r"
                         % (sorted(_GATES), mode))
    return _GATES[mode]


def rnn_param_size(mode, input_size, state_size, num_layers, bidirectional):
    """Length of the packed parameter vector."""
    g = _gates(mode)
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        size += dirs * g * state_size * (in_sz + state_size)   # weights
    size += num_layers * dirs * 2 * g * state_size             # biases
    return size


def _unpack(params, mode, input_size, state_size, num_layers,
            bidirectional):
    """``(weights, biases)``: per layer and direction ``(W_i2h, W_h2h)``
    and ``(b_i2h, b_h2h)``, views into ``params``."""
    g = _gates(mode)
    dirs = 2 if bidirectional else 1
    H = state_size
    ptr = 0
    weights, biases = [], []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else H * dirs
        for _ in range(dirs):
            wi = params[ptr:ptr + g * H * in_sz].view(g * H, in_sz)
            ptr += g * H * in_sz
            wh = params[ptr:ptr + g * H * H].view(g * H, H)
            ptr += g * H * H
            weights.append((wi, wh))
    for _ in range(num_layers * dirs):
        bi = params[ptr:ptr + g * H]
        ptr += g * H
        bh = params[ptr:ptr + g * H]
        ptr += g * H
        biases.append((bi, bh))
    return weights, biases


def _dropout(x, p):
    """Inverted dropout of a layer's output, the mask from ``mx.random``'s
    generator of ``x``'s device."""
    from .. import random as _random

    keep = torch.rand(x.shape, generator=_random.generator(x.device),
                      device=x.device) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# the plain version: the JAX package's scan, one step at a time
# ---------------------------------------------------------------------------
def _step(mode, h, c, xt, hw):
    """One time step from the x-side and h-side pre-activations."""
    if mode == "lstm":
        i, f, g_, o = (xt + hw).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g_)
        return torch.sigmoid(o) * torch.tanh(c), c
    if mode == "gru":
        xr, xz, xn = xt.chunk(3, dim=-1)
        hr, hz, hn = hw.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * h
        return h, h
    h = torch.tanh(xt + hw) if mode == "rnn_tanh" else torch.relu(xt + hw)
    return h, h


def _layer_loop(mode, x, h, c, wi, wh, bi, bh, reverse):
    """One direction of one layer, x (T, N, I) -> ys (T, N, H), hT, cT.
    The input projection is one product over all steps; GRU keeps its
    h-side bias apart for the reset gate."""
    if mode == "gru":
        xw = torch.einsum("tni,gi->tng", x, wi) + bi
    else:
        xw = torch.einsum("tni,gi->tng", x, wi) + bi + bh
    ys = [None] * x.shape[0]
    steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    for t in steps:
        hw = h @ wh.t()
        if mode == "gru":
            hw = hw + bh
        h, c = _step(mode, h, c, xw[t], hw)
        ys[t] = h
    return torch.stack(ys), h, c


def rnn_reference(data, parameters, state, state_cell=None, mode="lstm",
                  state_size=0, num_layers=1, bidirectional=False, p=0.0,
                  train=False):
    """The fused RNN as a plain time loop (the JAX package's ``_rnn``):
    ``(out, hy, cy)``, ``cy`` None unless ``mode == "lstm"``."""
    T, N, I = data.shape
    dirs = 2 if bidirectional else 1
    num_layers = int(num_layers)
    weights, biases = _unpack(parameters, mode, I, int(state_size),
                              num_layers, bidirectional)
    x = data
    h_out, c_out = [], []
    for layer in range(num_layers):
        ys = []
        for d in range(dirs):
            idx = layer * dirs + d
            h0 = state[idx]
            c0 = state_cell[idx] if (mode == "lstm"
                                     and state_cell is not None) \
                else torch.zeros_like(h0)
            y, hT, cT = _layer_loop(mode, x, h0, c0, *weights[idx],
                                    *biases[idx], reverse=d == 1)
            ys.append(y)
            h_out.append(hT)
            c_out.append(cT)
        x = torch.cat(ys, dim=-1) if dirs == 2 else ys[0]
        if p > 0 and train and layer < num_layers - 1:
            x = _dropout(x, p)
    cy = torch.stack(c_out) if mode == "lstm" else None
    return x, torch.stack(h_out), cy


# ---------------------------------------------------------------------------
# the card: cuDNN through PyTorch
# ---------------------------------------------------------------------------
def _cudnn_layers(mode, x, hx, cx, weights, biases, num_layers,
                  bidirectional):
    """One cuDNN call over ``num_layers`` layers: ``(out, hy, cy)``."""
    flat = []
    for (wi, wh), (bi, bh) in zip(weights, biases):
        flat += [wi, wh, bi, bh]
    # cuDNN keeps what its backward needs only in its training mode
    keep = torch.is_grad_enabled()
    if mode == "lstm":
        return torch._VF.lstm(x, (hx, cx), flat, True, num_layers, 0.0,
                              keep, bidirectional, False)
    out, hy = getattr(torch._VF, mode)(       # gru, rnn_tanh, rnn_relu
        x, hx, flat, True, num_layers, 0.0, keep, bidirectional, False)
    return out, hy, None


def rnn_cudnn(data, parameters, state, state_cell=None, mode="lstm",
              state_size=0, num_layers=1, bidirectional=False, p=0.0,
              train=False):
    """:func:`rnn_reference`'s function through cuDNN, on a CUDA tensor
    cuDNN accepts (f16, f32, f64); raises on any other."""
    if not torch.backends.cudnn.is_acceptable(data):
        raise RuntimeError(
            "RNN: cuDNN does not take this %s tensor on %s (cuDNN enabled: "
            "%s); the fused RNN has no other path on the card"
            % (data.dtype, data.device, torch.backends.cudnn.enabled))
    T, N, I = data.shape
    dirs = 2 if bidirectional else 1
    num_layers = int(num_layers)
    weights, biases = _unpack(parameters, mode, I, int(state_size),
                              num_layers, bidirectional)
    cx = None
    if mode == "lstm":
        cx = state_cell if state_cell is not None \
            else torch.zeros_like(state)
    if not (p > 0 and train) or num_layers == 1:
        return _cudnn_layers(mode, data, state, cx, weights, biases,
                             num_layers, bidirectional)
    x, hy, cy = data, [], []
    for layer in range(num_layers):
        sl = slice(layer * dirs, (layer + 1) * dirs)
        x, h, c = _cudnn_layers(mode, x, state[sl],
                                None if cx is None else cx[sl],
                                weights[sl], biases[sl], 1, bidirectional)
        hy.append(h)
        cy.append(c)
        if layer < num_layers - 1:
            x = _dropout(x, p)
    return x, torch.cat(hy), (torch.cat(cy) if mode == "lstm" else None)


def _rnn_visible(attrs):
    """Symbol-visible outputs: ``(out[, hy[, cy]])`` only when
    ``state_outputs`` is given explicitly and true, the reference's
    graph-level default being false; ``nd.RNN`` returns ``[out, hy(, cy)]``
    by default, as the JAX package's does."""
    if not _attr_bool(attrs.get("state_outputs", False)):
        return [0]
    return [0, 1, 2] if str(attrs.get("mode", "lstm")) == "lstm" else [0, 1]


@register("RNN", input_names=("data", "parameters", "state", "state_cell"),
          train_aware=True, visible_out=_rnn_visible)
def _rnn(data, parameters, state, state_cell=None, mode="lstm",
         state_size=0, num_layers=1, bidirectional=False, p=0.0,
         state_outputs=True, lstm_state_clip_min=None,
         lstm_state_clip_max=None, lstm_state_clip_nan=False,
         projection_size=None, use_sequence_length=False, _train=False):
    mode = str(mode)
    # cuDNN on a CUDA tensor, the plain loop on any other device
    fn = rnn_cudnn if data.device.type == "cuda" else rnn_reference
    out, hy, cy = fn(data, parameters, state, state_cell, mode=mode,
                     state_size=int(state_size), num_layers=int(num_layers),
                     bidirectional=_attr_bool(bidirectional), p=float(p),
                     train=bool(_train))
    if not _attr_bool(state_outputs):
        return out
    return (out, hy, cy) if mode == "lstm" else (out, hy)
