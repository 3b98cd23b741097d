"""Symbolic op wrappers, generated from the op registry.

Counterpart of ``mxnet_tpu/symbol/register.py``: each wrapper composes
symbols into a node and creates ``{name}_{input}`` Variables for the named
inputs a caller leaves out (``conv0_weight``, ``bn1_moving_mean``, ...).
"""
from __future__ import annotations

import sys

from ..ops.registry import OPS
from .symbol import Symbol, Variable, _NameManager, _Node, _single


def _skip_input(in_name, params):
    """``bias`` is no input when ``no_bias`` is set, nor ``RNN``'s
    ``state_cell`` outside the lstm mode."""
    if in_name == "state_cell":
        return params.get("mode", "lstm") != "lstm"
    return in_name == "bias" and bool(params.get("no_bias"))


def _make_wrapper(opdef):
    input_names = tuple(opdef.input_names)

    def creator(*args, **kwargs):
        name = kwargs.pop("name", None)
        kwargs.pop("attr", None)
        sym_kwargs, params = {}, {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                sym_kwargs[k] = v
            elif v is not None:
                params[k] = v
        name = name or _NameManager.get(opdef.name.lower().lstrip("_"))

        if input_names:
            if len(args) > len(input_names):
                raise TypeError("%s takes at most %d positional inputs"
                                % (opdef.name, len(input_names)))
            bound = {}
            for in_name, a in zip(input_names, args):
                if not isinstance(a, Symbol):
                    raise TypeError("positional input %r of %s must be a "
                                    "Symbol" % (in_name, opdef.name))
                bound[in_name] = a
            bound.update(sym_kwargs)
            inputs = []
            for i, in_name in enumerate(input_names):
                if _skip_input(in_name, params):
                    continue
                if in_name in bound:
                    inputs.append(bound[in_name]._outputs[0])
                elif i == 0:
                    raise TypeError("%s requires input %r"
                                    % (opdef.name, in_name))
                else:
                    v = Variable("%s_%s" % (name, in_name))
                    inputs.append(v._outputs[0])
        else:
            inputs = []
            for a in list(args) + list(sym_kwargs.values()):
                if len(a._outputs) != 1:
                    raise ValueError("cannot compose with grouped symbol")
                inputs.append(a._outputs[0])
        return _single(_Node(opdef, name, inputs, params))

    creator.__name__ = opdef.name
    creator.__doc__ = (opdef.fn.__doc__ or "") + \
        "\n\n(symbolic wrapper; composes a graph node)"
    return creator


def _init_symbol_module():
    mod = sys.modules[__package__]
    for name, opdef in OPS.items():
        setattr(mod, name, _make_wrapper(opdef))
