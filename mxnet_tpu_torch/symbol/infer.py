"""Graph shape inference for ``simple_bind``.

Counterpart of ``mxnet_tpu/symbol/infer.py``: a forward walk in which each
op first derives its parameter input shapes from its (known) data input
shape through a small hook table, then gets its output shapes by running
its own function on ``meta`` tensors (shapes and dtypes, no data) — one
source of truth, no per-op shape math.  A ``Custom`` node takes both from
the user's ``infer_shape`` / ``infer_type``.

As in the reference, a variable without a known dtype is float32, and an op
that cannot run on what it is given leaves its outputs unknown: on a
quantized graph, whose int8 weights are declared without a dtype, the walk
loses the shapes past the first quantized op, and ``simple_bind`` raises
for the first argument it cannot size (bind such graphs with ``bind``).
"""
from __future__ import annotations

import math

import torch

from ..base import torch_dtype


def _conv_params(node, in_shapes):
    p = node.attrs
    d = in_shapes[0]
    k = tuple(p.get("kernel", ()))
    nf = int(p.get("num_filter", 1))
    ng = int(p.get("num_group", 1))
    return {"weight": (nf, d[1] // ng) + k, "bias": (nf,)}


def _fc_params(node, in_shapes):
    p = node.attrs
    d = in_shapes[0]
    in_dim = math.prod(d[1:]) if p.get("flatten", True) else d[-1]
    nh = int(p["num_hidden"])
    return {"weight": (nh, in_dim), "bias": (nh,)}


def _norm_params(node, in_shapes):
    c = in_shapes[0][int(node.attrs.get("axis", 1)) % len(in_shapes[0])]
    return {"gamma": (c,), "beta": (c,), "moving_mean": (c,),
            "moving_var": (c,)}


def _embedding_params(node, in_shapes):
    p = node.attrs
    return {"weight": (int(p["input_dim"]), int(p["output_dim"]))}


def _rnn_params(node, in_shapes):
    """The packed parameter vector and the (L*dirs, N, H) states of a
    (T, N, I) input."""
    from ..ops.nn import _attr_bool
    from ..ops.rnn import rnn_param_size

    p = node.attrs
    d = in_shapes[0]
    bidir = _attr_bool(p.get("bidirectional", False))
    layers = int(p.get("num_layers", 1))
    ss = int(p.get("state_size", 0))
    state = (layers * (2 if bidir else 1), d[1], ss)
    return {"parameters": (rnn_param_size(p.get("mode", "lstm"), d[2], ss,
                                          layers, bidir),),
            "state": state, "state_cell": state}


def _custom_params(node, in_shapes):
    """A ``Custom`` node's inputs by position, from the user's
    ``infer_shape`` (keys are positions: its inputs have no fixed names)."""
    from ..operator import custom_arg_shapes

    return custom_arg_shapes(node.attrs, in_shapes)


def _softmax_label(node, in_shapes):
    d = in_shapes[0]
    if node.attrs.get("multi_output"):
        return {"label": (d[0],) + tuple(d[2:])}
    return {"label": tuple(d[:-1])}


_PARAM_HOOKS = {
    "Convolution": _conv_params,
    "FullyConnected": _fc_params,
    "BatchNorm": _norm_params,
    "Embedding": _embedding_params,
    "RNN": _rnn_params,
    "SoftmaxOutput": _softmax_label,
    "Custom": _custom_params,
}


def _eval_out(node, ins):
    """Output meta tensors of ``node`` on meta inputs ``ins``."""
    out = node.op.fn(*ins, **node.attrs)
    return list(out) if isinstance(out, (tuple, list)) else [out]


def infer_shapes(sym, known):
    """``(arg_shapes, out_shapes, aux_shapes)`` aligned with
    ``list_arguments`` / ``list_outputs`` / ``list_auxiliary_states``."""
    outs = {}        # id(node) -> [meta tensor or None]
    var_shape = {}
    for node in sym._topo():
        if node.is_var:
            s = known.get(node.name, node.shape_hint)
            var_shape[node.name] = tuple(s) if s is not None else None
            dt = torch_dtype(node.dtype_hint or "float32")
            outs[id(node)] = [None if s is None else
                              torch.empty(tuple(s), dtype=dt, device="meta")]
            continue
        ins = [outs[id(src)][oi] for src, oi in node.inputs]
        missing = [i for i, t in enumerate(ins) if t is None]
        if missing and ins[0] is not None:
            hints = _PARAM_HOOKS.get(node.op.name, lambda n, s: {})(
                node, [None if t is None else tuple(t.shape) for t in ins])
            names = node.op.input_names
            for i in missing:
                src = node.inputs[i][0]
                key = names[i] if i < len(names) else i
                if key in hints and src.is_var:
                    s = tuple(int(x) for x in hints[key])
                    var_shape[src.name] = s
                    ins[i] = torch.empty(s, device="meta", dtype=torch_dtype(
                        src.dtype_hint or "float32"))
                    outs[id(src)] = [ins[i]]
        n_out = max(node.op.num_outputs, 1)
        if any(t is None for t in ins):
            outs[id(node)] = [None] * n_out
            continue
        try:
            outs[id(node)] = _eval_out(node, ins)
        except Exception:   # the op cannot run on these inputs: unknown
            outs[id(node)] = [None] * n_out

    def shape(t):
        return None if t is None else tuple(t.shape)

    return ([var_shape.get(n) for n in sym.list_arguments()],
            [shape(outs[id(n)][oi]) for n, oi in sym._outputs],
            [var_shape.get(n) for n in sym.list_auxiliary_states()])
