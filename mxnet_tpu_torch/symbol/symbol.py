"""Symbol: the declarative graph value type.

Counterpart of ``mxnet_tpu/symbol/symbol.py`` (reference
``python/mxnet/symbol/symbol.py``): graph nodes, composition,
``list_arguments`` / ``list_outputs`` / ``list_auxiliary_states``,
``get_internals``, ``infer_shape``, ``attr_dict`` (the ``__init__``,
``__lr_mult__`` and ``__wd_mult__`` attributes of Variables, which the
initializer and the optimizer read), the nnvm-shaped ``tojson`` and
``load_json``, and ``bind`` / ``simple_bind`` into an
:class:`~mxnet_tpu_torch.executor.Executor` (with a per-argument
``grad_req``).  Node names and the JSON are the JAX package's, byte for
byte, for the same graph.

An auxiliary state is a Variable feeding an input slot that its op
mutates (BatchNorm's moving statistics, a ``Custom`` op's trailing
``list_auxiliary_states`` inputs, whose map depends on the node's
attributes).
"""
from __future__ import annotations

import ast
import json
import threading

from .. import ops as _ops  # noqa: F401  (registers the op corpus)
from ..ops.registry import get_op

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]


class _Node:
    """One graph node: a variable (op None) or an op application."""

    __slots__ = ("op", "name", "inputs", "attrs", "shape_hint", "dtype_hint",
                 "user_attrs")

    def __init__(self, op, name, inputs=(), attrs=None, shape_hint=None,
                 dtype_hint=None, user_attrs=None):
        self.op = op                      # OpDef or None (variable)
        self.name = name
        self.inputs = list(inputs)        # [(node, out_index)]
        self.attrs = dict(attrs or {})    # static op params
        self.shape_hint = shape_hint      # for variables
        self.dtype_hint = dtype_hint
        self.user_attrs = dict(user_attrs or {})

    @property
    def is_var(self):
        return self.op is None

    def num_visible_outputs(self):
        return len(self.visible_output_indices())

    def visible_output_indices(self):
        if self.is_var:
            return [0]
        if self.op.visible_out is not None:
            return list(self.op.visible_out(self.attrs))
        n = max(self.op.num_outputs, 1)
        return [i for i in range(n) if i not in self.op.mutate]


class _NameManager:
    """Process-wide counters behind automatic node names (``pooling0``,
    ``broadcast_add3``, ...), as in the reference."""

    _lock = threading.Lock()
    _counts: dict = {}

    @classmethod
    def get(cls, hint):
        with cls._lock:
            c = cls._counts.get(hint, 0)
            cls._counts[hint] = c + 1
        return "%s%d" % (hint, c)

    @classmethod
    def reset(cls):
        with cls._lock:
            cls._counts.clear()


class Symbol:
    """A (multi-)output slice of the graph."""

    __slots__ = ("_outputs",)

    def __init__(self, outputs):
        self._outputs = list(outputs)     # [(node, out_index)]

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __repr__(self):
        if len(self._outputs) == 1:
            return "<Symbol %s>" % self._outputs[0][0].name
        return "<Symbol Grouped>"

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index in names:
                return Symbol([self._outputs[names.index(index)]])
            for node, oi in self._outputs:
                if node.name == index:
                    return Symbol([(node, oi)])
            raise ValueError("cannot find output %r" % index)
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def get_internals(self):
        """A symbol grouping every internal output."""
        return Symbol([(node, oi) for node in self._topo()
                       for oi in node.visible_output_indices()])

    # -- graph walks ----------------------------------------------------
    def _topo(self):
        """Topological order of all reachable nodes (inputs first)."""
        seen, order = set(), []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for inp, _ in node.inputs:
                visit(inp)
            order.append(node)

        for node, _ in self._outputs:
            visit(node)
        return order

    def _aux_nodes(self):
        """Variables feeding a mutated (aux-state) input slot, e.g.
        BatchNorm's moving_mean / moving_var."""
        aux = set()
        for node in self._topo():
            if node.is_var:
                continue
            mut = node.op.mutate_map(node.attrs, len(node.inputs))
            for in_idx in mut.values():
                if in_idx < len(node.inputs) and \
                        node.inputs[in_idx][0].is_var:
                    aux.add(id(node.inputs[in_idx][0]))
        return aux

    def list_arguments(self):
        aux = self._aux_nodes()
        return [n.name for n in self._topo()
                if n.is_var and id(n) not in aux]

    def list_auxiliary_states(self):
        aux = self._aux_nodes()
        return [n.name for n in self._topo() if n.is_var and id(n) in aux]

    def list_outputs(self):
        names = []
        for node, oi in self._outputs:
            if node.is_var:
                names.append(node.name)
            elif node.num_visible_outputs() == 1:
                names.append(node.name + "_output")
            else:
                names.append("%s_output%d" % (node.name, oi))
        return names

    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)``; a shape that cannot be
        inferred comes back as None."""
        from .infer import infer_shapes

        known = dict(kwargs)
        for name, shp in zip(self.list_arguments(), args):
            if shp is not None:
                known[name] = shp
        return infer_shapes(self, known)

    # -- attributes -------------------------------------------------------
    def attr(self, key):
        """Attribute ``key`` of this (single-output) symbol's node."""
        return self._outputs[0][0].user_attrs.get(key)

    def list_attr(self):
        return dict(self._outputs[0][0].user_attrs)

    def attr_dict(self):
        """``{node name: {attribute: value}}`` over the graph."""
        return {n.name: dict(n.user_attrs) for n in self._topo()
                if n.user_attrs}

    # -- serialization --------------------------------------------------
    def tojson(self):
        """nnvm-shaped graph JSON (nodes / arg_nodes / heads)."""
        nodes_list = self._topo()
        nid = {id(n): i for i, n in enumerate(nodes_list)}
        nodes_json = []
        for n in nodes_list:
            entry = {
                "op": "null" if n.is_var else n.op.name,
                "name": n.name,
                "inputs": [[nid[id(src)], oi, 0] for src, oi in n.inputs],
            }
            attrs = {k: json.dumps(v) for k, v in n.attrs.items()}
            if attrs:
                entry["attrs"] = attrs
            if n.user_attrs:
                entry["user_attrs"] = dict(n.user_attrs)
            if n.is_var and n.shape_hint is not None:
                entry["shape_hint"] = list(n.shape_hint)
            nodes_json.append(entry)
        return json.dumps({
            "nodes": nodes_json,
            "arg_nodes": [nid[id(n)] for n in nodes_list if n.is_var],
            "node_row_ptr": list(range(len(nodes_list) + 1)),
            "heads": [[nid[id(n)], oi, 0] for n, oi in self._outputs],
            "attrs": {"mxnet_version": ["int", 10400],
                      "mxnet_tpu_format": ["int", 1]},
        }, indent=2)

    # -- binding --------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **kwargs):
        """An executor whose arguments, auxiliary states and gradients are
        zeros of the shapes inferred from ``kwargs`` (``data=(N, C, H,
        W)``, ...).  ``grad_req``: one string, or a list or dict per
        argument."""
        from ..executor import Executor

        return Executor(self, ctx=ctx, grad_req=grad_req, arg_shapes=kwargs,
                        type_dict=type_dict)

    def bind(self, ctx=None, args=None, grad_req="write", aux_states=None):
        """An executor over the given argument and auxiliary arrays."""
        from ..executor import Executor

        return Executor(self, ctx=ctx, grad_req=grad_req, args=args,
                        aux_states=aux_states)

    # -- arithmetic -----------------------------------------------------
    def __add__(self, other):
        if isinstance(other, Symbol):
            return _apply("broadcast_add", [self, other], {})
        if isinstance(other, (int, float)):
            return _apply("_plus_scalar", [self], {"scalar": float(other)})
        raise TypeError(type(other))

    __radd__ = __add__


def _single(node):
    oi = node.visible_output_indices()
    return Symbol([(node, i) for i in oi]) if len(oi) > 1 \
        else Symbol([(node, oi[0])])


def _apply(op_name, input_syms, attrs, name=None):
    """Compose: apply a registered op to symbols."""
    opdef = get_op(op_name)
    name = name or _NameManager.get(opdef.name.lower().lstrip("_"))
    inputs = []
    for s in input_syms:
        if len(s._outputs) != 1:
            raise ValueError("cannot compose with a grouped symbol input")
        inputs.append(s._outputs[0])
    return _single(_Node(opdef, name, inputs, attrs))


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs):
    """A symbolic variable.  ``lr_mult``, ``wd_mult`` and ``init`` (an
    Initializer or its ``dumps()``) become the ``__lr_mult__``,
    ``__wd_mult__`` and ``__init__`` attributes, beside ``attr`` and any
    ``__name__=value`` keyword."""
    ua = dict(attr or {})
    if lr_mult is not None:
        ua["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        ua["__wd_mult__"] = str(wd_mult)
    if init is not None:
        ua["__init__"] = init if isinstance(init, str) else init.dumps()
    for k, v in kwargs.items():
        if k.startswith("__") and k.endswith("__"):
            ua[k] = str(v)
    return Symbol([(_Node(None, name, shape_hint=tuple(shape) if shape
                          else None, dtype_hint=dtype, user_attrs=ua), 0)])


var = Variable


def Group(symbols):
    """One multi-output symbol of ``symbols``' outputs."""
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def load(fname):
    """The Symbol of a graph-JSON file (:func:`load_json`)."""
    with open(fname) as f:
        return load_json(f.read())


def _parse_legacy_attr(value):
    """One reference-JSON attribute string (``"(1, 1)"``, ``"64"``,
    ``"True"``, ``"relu"``) as a Python value, else the string."""
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def load_json(json_str):
    """Rebuild a Symbol from graph JSON: this package's (json-encoded
    attrs, marked by ``attrs.mxnet_tpu_format``) or the reference's nnvm
    JSON (attrs as MXNet strings under ``attrs`` / ``attr`` / ``param``)."""
    g = json.loads(json_str)
    native = "mxnet_tpu_format" in g.get("attrs", {})
    nodes = []
    for entry in g["nodes"]:
        raw = (entry.get("attrs") or entry.get("attr")
               or entry.get("param") or {})
        if native:
            attrs = {k: json.loads(v) for k, v in raw.items()}
        else:
            attrs = {k: _parse_legacy_attr(v) for k, v in raw.items()}
        if entry["op"] == "null":
            node = _Node(None, entry["name"],
                         shape_hint=tuple(entry["shape_hint"])
                         if entry.get("shape_hint") else None,
                         user_attrs=entry.get("user_attrs"))
        else:
            node = _Node(get_op(entry["op"]), entry["name"],
                         [(nodes[e[0]], e[1]) for e in entry["inputs"]],
                         attrs, user_attrs=entry.get("user_attrs"))
        nodes.append(node)
    return Symbol([(nodes[e[0]], e[1]) for e in g["heads"]])
