"""Post-training INT8 quantization.

Counterpart of ``mxnet_tpu/contrib/quantization.py`` (reference
``python/mxnet/contrib/quantization.py``), carried over function for
function so that both packages rewrite a graph into the same nodes, names
and parameters:

1. pick quantizable nodes (Convolution / FullyConnected, minus exclusions);
2. calibrate the fp32 graph on sample data through the executor, recording
   each quantized input's range — ``naive`` min/max or ``entropy`` (the
   KL-divergence optimal threshold, :func:`_get_optimal_threshold`);
3. rewrite the graph: ``quantize_v2`` (with the calibrated ranges) feeding
   the int8 ops, ``dequantize`` back to fp32 after each; weights are
   quantized offline into the returned ``qarg_params``;
4. optionally first :func:`fold_bn` (inference BatchNorm into the
   preceding convolution) and afterwards :func:`fuse_int8_chains` (adjacent
   quantized layers hand each other int8).

New parameter arrays are made on the context of the arrays they derive
from (``quantize_model``'s ``ctx`` for the quantized weights and ranges).
"""
from __future__ import annotations

import logging

import numpy as np

from .. import ndarray as nd
from ..symbol.symbol import Symbol, Variable, _Node

_QUANTIZABLE = {"Convolution", "FullyConnected"}

__all__ = ["quantize_model", "fold_bn", "fuse_int8_chains",
           "quantize_symbol_only", "set_calib_table_to_symbol",
           "_get_optimal_threshold"]


def _get_optimal_threshold(arr, num_bins=8001, num_quantized_bins=255):
    """KL-divergence-minimizing saturation threshold (reference
    contrib/quantization.py _get_optimal_threshold)."""
    arr = np.asarray(arr).ravel()
    max_abs = float(np.max(np.abs(arr))) or 1e-8
    hist, edges = np.histogram(arr, bins=num_bins, range=(-max_abs, max_abs))
    return _optimal_threshold_from_hist(hist, edges,
                                        num_quantized_bins)


def _smooth_distribution(p, eps=1e-4):
    """Replace zeros with eps, taking the mass off the nonzero entries
    (KL-smoothing per the reference's _smooth_distribution — uniform
    mixing instead would fabricate probability where the clipped
    distribution has none and wrecks the threshold choice for spiky
    histograms, e.g. post-ReLU activations that are ~80% exact zeros)."""
    is_zero = p == 0
    n_zero = int(is_zero.sum())
    n_nonzero = p.size - n_zero
    if not n_nonzero:
        return None
    out = p.astype(np.float64).copy()
    out[is_zero] = eps
    out[~is_zero] *= 1.0 - eps * n_zero / n_nonzero
    return out


def _optimal_threshold_from_hist(hist, edges, num_quantized_bins=255):
    num_bins = len(hist)
    hist = hist.astype(np.float64)
    zero = num_bins // 2
    best_kl, best_thr = np.inf, float(edges[-1])
    for i in range(num_quantized_bins // 2, zero + 1, 16):
        # with odd num_bins p_stop <= num_bins always; clamp so an even
        # bin count (i == zero makes p_stop = num_bins + 1) stays in range
        p_start, p_stop = zero - i, min(zero + i + 1, num_bins)
        thr = edges[p_stop]
        sliced = hist[p_start:p_stop].copy()
        # p: clipped distribution — outlier mass folds into the edge bins
        p = sliced.copy()
        p[0] += hist[:p_start].sum()
        p[-1] += hist[p_stop:].sum()
        if p.sum() == 0:
            continue
        # q: int8-quantized rendering of the in-range histogram, with
        # mass placed ONLY where p is nonzero (reference
        # _get_optimal_threshold: `q[p == 0] = 0`) — without the mask a
        # spiky histogram's empty bins make fine-grained (small-i)
        # renderings look spuriously faithful
        isnz = p != 0
        n = sliced.size  # n = 2i+1 >= num_quantized_bins, so nm >= 1
        nm = n // num_quantized_bins
        q = np.zeros(n)
        for j in range(num_quantized_bins):
            s = j * nm
            e = n if j == num_quantized_bins - 1 else s + nm
            norm = isnz[s:e].sum()
            if norm:
                q[s:e] = sliced[s:e].sum() / norm
        q[~isnz] = 0
        pp = _smooth_distribution(p)
        qq = _smooth_distribution(q)
        if pp is None or qq is None:
            continue
        pp = pp / pp.sum()
        qq = qq / qq.sum()
        kl = float(np.sum(pp * np.log(pp / qq)))
        if kl < best_kl:
            best_kl, best_thr = kl, float(thr)
    return best_thr


def _node_key(node, oi):
    return (id(node), oi)


def _collect_calibration(sym, arg_params, aux_params, calib_data,
                         entries, calib_mode, num_calib_examples, ctx,
                         num_bins=8001):
    """Run the fp32 graph on calibration batches and return
    {entry_key: (min, max)} for the requested graph entries.

    Reductions are streaming (running min/max per batch; for entropy a
    second pass accumulates fixed-range histograms) so host memory stays
    O(entries), not O(activations) — reference collector semantics."""
    group = Symbol([e for e in entries])
    data_desc = calib_data.provide_data
    shapes = {d.name: tuple(d.shape) for d in data_desc}
    exe = group.simple_bind(ctx=ctx, grad_req="null", **shapes)
    exe.copy_params_from(arg_params, aux_params, allow_extra_params=True)

    def batches():
        seen = 0
        calib_data.reset()
        for batch in calib_data:
            feed = {d.name: v for d, v in zip(data_desc, batch.data)}
            yield exe.forward(is_train=False, **feed)
            seen += batch.data[0].shape[0]
            if num_calib_examples is not None and \
                    seen >= num_calib_examples:
                return

    # pass 1: running min/max (reduced on the device: the same values as
    # the reference's reduction of the host copy)
    mins = np.full(len(entries), np.inf)
    maxs = np.full(len(entries), -np.inf)
    for outs in batches():
        for i, o in enumerate(outs):
            mins[i] = min(mins[i], float(o.data.min()))
            maxs[i] = max(maxs[i], float(o.data.max()))

    if calib_mode == "naive":
        return {_node_key(*e): (mins[i], maxs[i])
                for i, e in enumerate(entries)}

    # pass 2 (entropy): fixed-range histograms, then KL thresholds
    abs_max = np.maximum(np.abs(mins), np.abs(maxs))
    hists = [np.zeros(num_bins) for _ in entries]
    for outs in batches():
        for i, o in enumerate(outs):
            h, _ = np.histogram(o.asnumpy().ravel(), bins=num_bins,
                                range=(-abs_max[i], abs_max[i]))
            hists[i] += h
    ranges = {}
    for i, e in enumerate(entries):
        edges = np.linspace(-abs_max[i], abs_max[i], num_bins + 1)
        thr = _optimal_threshold_from_hist(hists[i], edges)
        ranges[_node_key(*e)] = (-thr, thr)
    return ranges


def _quantize_weight(w):
    arr = w.asnumpy() if hasattr(w, "asnumpy") else np.asarray(w)
    thr = max(abs(float(arr.min())), abs(float(arr.max())), 1e-10)
    scale = thr / 127.0
    q = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
    return q, -thr, thr


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   ctx=None, excluded_sym_names=(), calib_mode="entropy",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", logger=None,
                   fold_bn=False, fuse_int8=False):
    """Quantize a model (reference contrib/quantization.py:quantize_model).

    ``fold_bn`` folds inference-mode BatchNorm into the preceding convs
    first (see :func:`fold_bn`); ``fuse_int8`` runs the int8
    chain-fusion peephole on the result (:func:`fuse_int8_chains`) so
    adjacent quantized layers talk int8 instead of round-tripping
    through fp32.  Calibration runs on ``ctx`` (default: the current
    context, ``gpu(0)``), and the quantized parameters are made there.

    Returns ``(qsym, qarg_params, aux_params)``.
    """
    logger = logger or logging.getLogger(__name__)
    if quantized_dtype != "int8":
        raise ValueError("only int8 is supported")
    if calib_mode not in ("none", "naive", "entropy"):
        raise ValueError("calib_mode must be none/naive/entropy")
    if fold_bn:
        sym, arg_params, aux_params = _fold_bn_inference(
            sym, arg_params, aux_params)
    excluded = set(excluded_sym_names)

    topo = sym._topo()

    def _quantizable(n):
        if n.is_var or n.op.name not in _QUANTIZABLE \
                or n.name in excluded:
            return False
        # weight (and bias) must be plain Variables with known params —
        # computed weights (weight tying through expressions, masking…)
        # stay fp32 (reference behavior: such nodes are excluded)
        for e in n.inputs[1:]:
            if not e[0].is_var or e[0].name not in arg_params:
                logger.warning(
                    "not quantizing %s: input %r is not a parameter "
                    "Variable", n.name, e[0].name)
                return False
        return True

    quant_nodes = [n for n in topo if _quantizable(n)]

    # -- calibration: ranges of each quantized op's data input -----------
    calib_entries = []
    for n in quant_nodes:
        src = n.inputs[0]  # (node, oi) feeding `data`
        if src not in calib_entries:
            calib_entries.append(src)
    ranges = {}
    if calib_mode != "none":
        if calib_data is None:
            raise ValueError("calib_data is required for calib_mode=%r"
                             % calib_mode)
        ranges = _collect_calibration(sym, arg_params, aux_params,
                                      calib_data, calib_entries,
                                      calib_mode, num_calib_examples, ctx)

    # -- graph rewrite ----------------------------------------------------
    qarg_params = dict(arg_params)

    def const_var(name, value):
        qarg_params[name] = nd.array(np.float32(value).reshape(1), ctx=ctx)
        return Variable(name, shape=(1,))._outputs[0][0]

    def weight_entries(node, w_entry, tag, map_entry):
        # offline-quantize the param; quantized values live under fresh
        # `_quantize` names so an fp32 consumer sharing the original
        # Variable (weight tying, excluded twin layer) keeps its fp32
        # values
        w_name = w_entry[0].name
        qw, wmin, wmax = _quantize_weight(arg_params[w_name])
        qw_name = w_name + "_quantize"
        qarg_params[qw_name] = nd.array(qw, ctx=ctx)
        qw_var = Variable(qw_name, shape=qw.shape)._outputs[0][0]
        return [(qw_var, 0),
                (const_var("%s_%smin" % (node.name, tag), wmin), 0),
                (const_var("%s_%smax" % (node.name, tag), wmax), 0)]

    def data_attrs(node):
        key = _node_key(node.inputs[0][0], node.inputs[0][1])
        if key in ranges:
            mn, mx = ranges[key]
            return {"min_calib_range": float(mn),
                    "max_calib_range": float(mx)}
        return {}

    qsym = _rewrite_quantized_graph(sym, quant_nodes, data_attrs,
                                    weight_entries)
    if fuse_int8:
        qsym, _n = fuse_int8_chains(qsym)
    logger.info("quantized %d nodes (%s calibration)",
                len(quant_nodes), calib_mode)
    return qsym, qarg_params, aux_params


def _rewrite_quantized_graph(sym, quant_nodes, data_attrs, weight_entries):
    """Shared rewrite behind ``quantize_model`` and
    ``quantize_symbol_only``: replace each node in ``quant_nodes`` with
    quantize_v2 -> int8 kernel -> dequantize.

    ``data_attrs(node)`` supplies the activation quantize node's attrs
    (calib ranges or empty); ``weight_entries(node, w_entry, tag,
    map_entry)`` supplies the (qweight, min, max) graph entries for one
    weight input — offline-quantized Variables, in-graph quantize
    nodes, whatever the caller's mode needs.
    """
    from ..ops.registry import get_op

    mapped = {}   # id(old node) -> new node
    q_cache = {}  # entry key -> activation quantize node

    def map_entry(e):
        node, oi = e
        return (mapped[id(node)], oi)

    for node in sym._topo():
        if node.is_var:
            mapped[id(node)] = node
            continue
        if node in quant_nodes:
            data_e = node.inputs[0]
            key = _node_key(data_e[0], data_e[1])
            # quantize the activation input (cached across consumers)
            if key not in q_cache:
                q_cache[key] = _Node(get_op("_contrib_quantize_v2"),
                                     node.name + "_data_quantize",
                                     [map_entry(data_e)],
                                     data_attrs(node))
            qn = q_cache[key]
            # input layout of the quantized ops:
            # (data, weight, min_data, max_data, min_w, max_w[, bias,
            #  min_b, max_b]) — bias group last so no_bias stays positional
            w_group = weight_entries(node, node.inputs[1], "w", map_entry)
            ins = [(qn, 0), w_group[0], (qn, 1), (qn, 2),
                   w_group[1], w_group[2]]
            no_bias = len(node.inputs) < 3 or \
                str(node.attrs.get("no_bias", False)) in ("True", "1")
            if not no_bias:
                ins += weight_entries(node, node.inputs[2], "b", map_entry)
            qop = "_contrib_quantized_conv" if node.op.name == \
                "Convolution" else "_contrib_quantized_fully_connected"
            attrs = dict(node.attrs)
            if no_bias:
                attrs["no_bias"] = True
            qnode = _Node(get_op(qop), node.name + "_quantized", ins,
                          attrs)
            deq = _Node(get_op("_contrib_dequantize"),
                        node.name + "_dequantize",
                        [(qnode, 0), (qnode, 1), (qnode, 2)], {})
            mapped[id(node)] = deq
        else:
            new = _Node(node.op, node.name,
                        [map_entry(e) for e in node.inputs],
                        dict(node.attrs), user_attrs=dict(node.user_attrs)
                        if node.user_attrs else None)
            mapped[id(node)] = new

    replaced = {id(n) for n in quant_nodes}
    return Symbol([(mapped[id(n)], 0 if id(n) in replaced else oi)
                   for n, oi in sym._outputs])


def quantize_symbol_only(sym, excluded_names=(), offline_params=(),
                         quantized_dtype="int8"):
    """Graph-only quantization pass (reference MXQuantizeSymbol,
    ``src/c_api/c_api_symbolic.cc`` -> ``quantize_graph.cc``): no
    concrete params needed.

    Weights named in ``offline_params`` are replaced by fresh
    ``<name>_quantize`` / ``<node>_wmin`` / ``<node>_wmax`` Variables
    whose values the caller supplies at load time (the convention
    ``quantize_model`` fills with its returned qarg_params); other
    weights get an in-graph ``quantize_v2`` node, so the symbol stays
    runnable against original fp32 params.  Activation inputs get
    uncalibrated ``quantize_v2`` nodes — attach ranges afterwards with
    :func:`set_calib_table_to_symbol`.
    """
    from ..ops.registry import get_op

    if quantized_dtype != "int8":
        raise ValueError("only int8 is supported")
    excluded = set(excluded_names)
    offline = set(offline_params)

    def _quantizable(n):
        if n.is_var or n.op.name not in _QUANTIZABLE \
                or n.name in excluded:
            return False
        return all(e[0].is_var for e in n.inputs[1:])

    quant_nodes = [n for n in sym._topo() if _quantizable(n)]

    def weight_entries(node, w_entry, tag, map_entry):
        w_name = w_entry[0].name
        if w_name in offline:
            qv = Variable(w_name + "_quantize")._outputs[0][0]
            mn = Variable("%s_%smin" % (node.name, tag),
                          shape=(1,))._outputs[0][0]
            mx_ = Variable("%s_%smax" % (node.name, tag),
                           shape=(1,))._outputs[0][0]
            return [(qv, 0), (mn, 0), (mx_, 0)]
        qn = _Node(get_op("_contrib_quantize_v2"),
                   "%s_%squantize" % (node.name, tag),
                   [map_entry(w_entry)], {})
        return [(qn, 0), (qn, 1), (qn, 2)]

    return _rewrite_quantized_graph(sym, quant_nodes, lambda node: {},
                                    weight_entries)


def set_calib_table_to_symbol(qsym, table):
    """Attach calibrated min/max ranges to a quantized symbol's
    ``quantize_v2`` nodes (reference MXSetCalibTableToQuantizedSymbol).

    ``table`` maps names to ``(min, max)``; a quantize node matches on
    its own name or its input node's name.  Returns a new Symbol; nodes
    with no table entry keep runtime min/max.
    """
    topo = qsym._topo()
    mapped = {}
    n_set = 0
    for node in topo:
        if node.is_var:
            mapped[id(node)] = node
            continue
        ins = [(mapped[id(s)], oi) for s, oi in node.inputs]
        attrs = dict(node.attrs)
        if node.op.name == "_contrib_quantize_v2":
            entry = table.get(node.name)
            if entry is None and node.inputs:
                entry = table.get(node.inputs[0][0].name)
            if entry is not None:
                attrs["min_calib_range"] = float(entry[0])
                attrs["max_calib_range"] = float(entry[1])
                n_set += 1
        mapped[id(node)] = _Node(node.op, node.name, ins, attrs,
                                 user_attrs=dict(node.user_attrs)
                                 if node.user_attrs else None)
    logging.getLogger(__name__).info(
        "set calib ranges on %d quantize nodes", n_set)
    return Symbol([(mapped[id(n)], oi) for n, oi in qsym._outputs])


def fold_bn(sym, arg_params, aux_params):
    """Fold inference-mode BatchNorm into the preceding Convolution
    (the standard int8 preparation pass; reference quantization flows
    do the same so conv chains stay unbroken).

    For each ``BatchNorm(conv(x, W, b), gamma, beta, mean, var)`` whose
    conv output has no other consumer:
    ``W' = W * s[:,None,..]``, ``b' = beta - mean*s (+ b*s)`` with
    ``s = gamma / sqrt(var + eps)`` — exactly BN applied to the conv
    output using the RUNNING statistics, i.e. inference semantics.
    Returns ``(folded_sym, folded_args, remaining_auxs)``.
    """
    topo = sym._topo()
    consumers = {}
    for n in topo:
        if n.is_var:
            continue
        for src, _ in n.inputs:
            consumers[id(src)] = consumers.get(id(src), 0) + 1
    # a node that IS a graph output has an extra (external) consumer —
    # folding a conv that the caller also reads pre-BN would silently
    # hand them post-BN values
    for n, _oi in sym._outputs:
        consumers[id(n)] = consumers.get(id(n), 0) + 1

    def _attr_bool(attrs, key, default=False):
        return str(attrs.get(key, default)).lower() in ("true", "1")

    foldable = {}  # id(bn node) -> conv node
    for n in topo:
        if n.is_var or n.op.name != "BatchNorm":
            continue
        if int(n.attrs.get("axis", 1)) != 1:
            continue
        src = n.inputs[0][0]
        if src.is_var or src.op.name != "Convolution":
            continue
        if consumers.get(id(src), 0) != 1:
            continue  # conv output used elsewhere: cannot rewrite it
        # all bn params must be plain Variables with known values
        names = [e[0].name for e in n.inputs[1:]]
        if not all(e[0].is_var for e in n.inputs[1:]):
            continue
        if not (names[0] in arg_params and names[1] in arg_params
                and names[2] in aux_params and names[3] in aux_params):
            continue
        w_name = src.inputs[1][0].name
        if w_name not in arg_params:
            continue
        foldable[id(n)] = src
    folded_conv_ids = {id(c) for c in foldable.values()}

    args = dict(arg_params)
    auxs = dict(aux_params)
    mapped = {}

    def map_entry(e):
        return (mapped[id(e[0])], e[1])

    def _pop_if_sole(store, var_node):
        # a param Variable shared with another node (weight tying, a
        # sibling BN) must survive in the param dict
        if consumers.get(id(var_node), 0) <= 1:
            store.pop(var_node.name, None)

    n_folded = 0
    for node in topo:
        if node.is_var:
            mapped[id(node)] = node
            continue
        if id(node) in foldable:
            conv = foldable[id(node)]
            bn_vars = [e[0] for e in node.inputs[1:]]
            g_name, b_name, m_name, v_name = [v.name for v in bn_vars]
            if not (g_name in args and b_name in args
                    and m_name in auxs and v_name in auxs):
                # params consumed by an earlier fold: keep this pair
                # unfolded rather than corrupt it (the conv was skipped
                # on its own visit, so materialize its copy first)
                if id(conv) not in mapped:
                    mapped[id(conv)] = _Node(
                        conv.op, conv.name,
                        [map_entry(e) for e in conv.inputs],
                        dict(conv.attrs))
                folded_conv_ids.discard(id(conv))
                mapped[id(node)] = _Node(
                    node.op, node.name,
                    [map_entry(e) for e in node.inputs],
                    dict(node.attrs))
                continue
            eps = float(node.attrs.get("eps", 1e-3))
            gamma = args[g_name].asnumpy()
            beta = args[b_name].asnumpy()
            mean = auxs[m_name].asnumpy()
            var = auxs[v_name].asnumpy()
            for v, store in zip(bn_vars, (args, args, auxs, auxs)):
                _pop_if_sole(store, v)
            if _attr_bool(node.attrs, "fix_gamma", True):
                gamma = np.ones_like(gamma)
            s = gamma / np.sqrt(var + eps)

            w_var = conv.inputs[1][0]
            W = args[w_var.name].asnumpy()
            # fresh names keyed by the (unique) BN node name: shared
            # conv weights fold independently per consumer pair
            w_new = node.name + "_bnfold_weight"
            ctx = args[w_var.name].context
            args[w_new] = nd.array(
                W * s.reshape((-1,) + (1,) * (W.ndim - 1)), ctx=ctx)
            bias = beta - mean * s
            conv_no_bias = len(conv.inputs) < 3 or \
                _attr_bool(conv.attrs, "no_bias")
            if not conv_no_bias:
                b0_var = conv.inputs[2][0]
                bias = bias + args[b0_var.name].asnumpy() * s
                _pop_if_sole(args, b0_var)
            _pop_if_sole(args, w_var)
            b_new = node.name + "_bnfold_bias"
            args[b_new] = nd.array(bias.astype(np.float32), ctx=ctx)

            attrs = dict(conv.attrs)
            attrs["no_bias"] = False
            ins = [map_entry(conv.inputs[0]),
                   (Variable(w_new, shape=W.shape)._outputs[0][0], 0),
                   (Variable(b_new, shape=bias.shape)._outputs[0][0], 0)]
            fused = _Node(conv.op, node.name + "_bnfold", ins, attrs)
            mapped[id(node)] = fused
            mapped[id(conv)] = fused  # nothing else consumes it
            n_folded += 1
        elif id(node) in folded_conv_ids:
            continue  # handled with its BN
        else:
            mapped[id(node)] = _Node(
                node.op, node.name,
                [map_entry(e) for e in node.inputs], dict(node.attrs),
                user_attrs=dict(node.user_attrs)
                if node.user_attrs else None)

    out_sym = Symbol([(mapped[id(n)], oi) for n, oi in sym._outputs])
    logging.getLogger(__name__).info("folded %d BatchNorm nodes",
                                     n_folded)
    return out_sym, args, auxs


_fold_bn_inference = fold_bn  # callable under quantize_model's kwarg shadow


#: fp32 Pooling attrs the quantized kernel understands; anything else
#: (layout, p_value, ...) must keep the node out of the int8 chain
_QPOOL_ATTRS = ("kernel", "pool_type", "stride", "pad", "global_pool",
                "pooling_convention", "count_include_pad", "cudnn_off")


_QADD_OPS = ("broadcast_add", "elemwise_add", "_plus")

_CALIB_ATTRS = ("min_calib_range", "max_calib_range")


def fuse_int8_chains(qsym):
    """Peephole over a quantized graph: re-express
    ``quantize_v2( chain( seam ) )`` — where ``chain`` is a (possibly
    empty) sequence of relu / pooling / flatten and ``seam`` is either a
    ``dequantize`` or a residual ``broadcast_add`` of two int8-available
    tensors — entirely in the quantized domain, via
    ``_contrib_quantized_act / quantized_pooling / quantized_flatten /
    quantized_elemwise_add``.  Calibrated ranges on the quantize node
    ride on the requantize / quantized add.

    Every rewritten fp32 node records its int8 twin, so an identity
    shortcut that reads a previous block's fp32 relu finds that relu's
    quantized form and the residual add runs int8-in/int8-out.
    """
    from ..ops.registry import get_op

    def _chain_ok(node):
        if node.op.name == "Activation":
            return str(node.attrs.get("act_type", "relu")) == "relu"
        if node.op.name == "Pooling":
            # max pooling only: symmetric clipping to the requantize
            # target range commutes with max, NOT with avg — an avg pool
            # inside the chain would average post-clip values against a
            # post-pool calib range and corrupt outputs (the final
            # GAP->FC seam stays fp32; its tensors are tiny)
            return str(node.attrs.get("pool_type", "max")) == "max" \
                and all(k in _QPOOL_ATTRS for k in node.attrs)
        return node.op.name in ("Flatten", "flatten")

    topo = qsym._topo()
    mapped = {}
    int8_twin = {}   # id(original fp32 node) -> [(qnode, oi) x3]
    n_fused = 0
    n_add_miss = 0   # residual adds left fp32 (no int8 form available)
    n_concat_miss = [0]  # concats left fp32 (a branch didn't resolve)

    def map_entry(e):
        return (mapped[id(e[0])], e[1])

    def q_triple_of(e):
        """int8 (q, min, max) entries for an fp32 input of a residual
        add, or None when it has no quantized form."""
        src, _ = e
        if not src.is_var and src.op.name == "_contrib_dequantize":
            return [map_entry(x) for x in src.inputs]
        return int8_twin.get(id(src))

    def q_triple_deep(e):
        """Like q_triple_of, but a branch that is itself a
        relu/pool/flatten chain over a dequantize (an inception branch
        tail feeding only the concat, so it never grew a twin) gets its
        chain re-emitted quantized on top of a runtime-range requantize
        (data-dependent min/max — tight, and commutes with the chain)."""
        t = q_triple_of(e)
        if t is not None:
            return t
        chain = []
        cur = e[0]
        while not cur.is_var and _chain_ok(cur):
            chain.append(cur)
            cur = cur.inputs[0][0]
        if cur.is_var:
            return None
        if cur.op.name == "_contrib_dequantize" and chain:
            rq = _Node(get_op("_contrib_requantize"),
                       chain[0].name + "_requant",
                       [map_entry(x) for x in cur.inputs], {})
            return wrap_chain(chain, [(rq, 0), (rq, 1), (rq, 2)])
        # chain over an already-quantized node (e.g. a reduction block's
        # pool branch riding the PREVIOUS quantized concat)
        base = int8_twin.get(id(cur))
        if base is None and cur.op.name in ("Concat", "concat"):
            # inner concat feeding an outer one (inception towers):
            # recurse — its own branches resolve the same way
            base = q_concat_of(cur)
        if base is not None:
            return wrap_chain(chain, base)
        return None

    def q_concat_of(cat, extra_attrs=None):
        """Quantized form of a Concat node: every branch resolved via
        q_triple_deep, interleaved min/max layout, twin registered.
        Without ``extra_attrs`` the branch ranges set the common scale;
        the main loop passes the quantize node's calib attrs instead."""
        triples = [q_triple_deep(e) for e in cat.inputs]
        if any(t is None for t in triples):
            n_concat_miss[0] += 1
            return None
        attrs = dict(extra_attrs or {})
        attrs["dim"] = cat.attrs.get("dim", 1)
        attrs["num_args"] = len(triples)
        ins = [t[0] for t in triples]
        for t in triples:
            ins += [t[1], t[2]]
        qc = _Node(get_op("_contrib_quantized_concat"),
                   cat.name + "_q", ins, attrs)
        triple = [(qc, 0), (qc, 1), (qc, 2)]
        int8_twin[id(cat)] = triple
        return triple

    def wrap_chain(chain, triple):
        """Re-emit the fp32 relu/pool/flatten links as quantized ops on
        top of ``triple``, recording each link's int8 twin."""
        for link in reversed(chain):
            qop, attrs = {
                "Activation": ("_contrib_quantized_act",
                               {"act_type": "relu"}),
                "Pooling": ("_contrib_quantized_pooling",
                            dict(link.attrs)),
                "Flatten": ("_contrib_quantized_flatten", {}),
                "flatten": ("_contrib_quantized_flatten", {}),
            }[link.op.name]
            qn = _Node(get_op(qop), link.name + "_q", triple, attrs)
            triple = [(qn, 0), (qn, 1), (qn, 2)]
            int8_twin[id(link)] = triple
        return triple

    for node in topo:
        if node.is_var:
            mapped[id(node)] = node
            continue
        if node.op.name == "_contrib_quantize_v2":
            # walk down through the fp32 chain to a seam
            chain = []
            cur, oi = node.inputs[0]
            while not cur.is_var and _chain_ok(cur):
                chain.append(cur)
                cur, oi = cur.inputs[0]
            triple = None
            if not cur.is_var and cur.op.name == "_contrib_dequantize":
                src = [map_entry(e) for e in cur.inputs]  # (q, mn, mx)
                rq = _Node(get_op("_contrib_requantize"),
                           node.name + "_requant", src,
                           dict(node.attrs))  # calib ranges if any
                triple = [(rq, 0), (rq, 1), (rq, 2)]
            elif not cur.is_var and cur.op.name in ("Concat", "concat"):
                # inception-style branch merge: re-bin every branch onto
                # a common int8 scale instead of an fp32 round trip
                triple = q_concat_of(
                    cur, {k: node.attrs[k] for k in _CALIB_ATTRS
                          if k in node.attrs})
            elif not cur.is_var and cur.op.name in _QADD_OPS:
                a = q_triple_of(cur.inputs[0])
                b = q_triple_of(cur.inputs[1])
                if a is None or b is None:
                    # int8 twins are recorded in topo order; an
                    # architecture whose shortcut consumer precedes the
                    # main branch's quantize keeps its fp32 seam — make
                    # that visible instead of silent
                    n_add_miss += 1
                if a is not None and b is not None:
                    attrs = {k: node.attrs[k] for k in _CALIB_ATTRS
                             if k in node.attrs}
                    qadd = _Node(
                        get_op("_contrib_quantized_elemwise_add"),
                        cur.name + "_q",
                        [a[0], b[0], a[1], a[2], b[1], b[2]], attrs)
                    triple = [(qadd, 0), (qadd, 1), (qadd, 2)]
                    int8_twin[id(cur)] = triple
            if triple is not None:
                triple = wrap_chain(chain, triple)
                # map the quantize node to the chain tail: consumers
                # read outputs 0..2, which every quantized op exposes
                mapped[id(node)] = triple[0][0]
                n_fused += 1
                continue
        mapped[id(node)] = _Node(node.op, node.name,
                                 [map_entry(e) for e in node.inputs],
                                 dict(node.attrs),
                                 user_attrs=dict(node.user_attrs)
                                 if node.user_attrs else None)

    log = logging.getLogger(__name__)
    log.info("fused %d int8 chains", n_fused)
    if n_add_miss:
        log.warning(
            "%d residual add(s) kept an fp32 seam (no int8 twin for an "
            "input at rewrite time — expected for adds behind "
            "non-fusable chains, e.g. global avg pool)", n_add_miss)
    if n_concat_miss[0]:
        log.warning(
            "%d concat(s) kept an fp32 seam (a branch did not resolve "
            "to int8 — expected for avg-pool towers, whose chains are "
            "excluded by the calib-commute rule)", n_concat_miss[0])
    return Symbol([(mapped[id(n)], oi) for n, oi in qsym._outputs]), \
        n_fused
