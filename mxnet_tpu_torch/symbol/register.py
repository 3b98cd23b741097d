"""Symbolic op wrappers, generated from the op registry.

Counterpart of ``mxnet_tpu/symbol/register.py``: each wrapper composes
symbols into a node and creates ``{name}_{input}`` Variables for the named
inputs a caller leaves out (``conv0_weight``, ``bn1_moving_mean``, ...).
Non-Symbol positional arguments after the inputs set the op's parameters
in signature order, as the ``nd`` functions take them (``clip(x, 0, 6)``,
which MobileNet's relu6 composes; the JAX package's wrapper raises there).
"""
from __future__ import annotations

import sys

from ..ops.registry import OPS
from .symbol import Symbol, Variable, _NameManager, _Node, _single


def _skip_input(op_name, in_name, params):
    """``bias`` is no input when ``no_bias`` is set, nor ``RNN``'s
    ``state_cell`` outside the lstm mode, nor ``LeakyReLU``'s ``gamma``
    outside the prelu mode."""
    if in_name == "state_cell":
        return params.get("mode", "lstm") != "lstm"
    if in_name == "gamma" and op_name == "LeakyReLU":
        return params.get("act_type", "leaky") != "prelu"
    return in_name == "bias" and bool(params.get("no_bias"))


def _split_positional(opdef, args, params):
    """``(inputs, params)``: the leading Symbol (or None: an input not
    given, as Dense's missing bias) arguments, and ``params`` with the
    other ones after them set on the op's parameters in signature order
    (``clip(x, 0, 6)``)."""
    from ..ndarray import positional_params

    slots = len(opdef.input_names)
    n = 0
    while n < len(args) and (isinstance(args[n], Symbol) or (
            args[n] is None and n < slots)):
        n += 1
    extra = list(args[n:])
    if any(isinstance(a, Symbol) for a in extra):
        raise TypeError("%s: a Symbol input after a positional parameter"
                        % opdef.name)
    if extra:
        params = positional_params(opdef, extra, params)
    return list(args[:n]), params


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
        args, params = _split_positional(opdef, args, params)

        if input_names:
            if len(args) > len(input_names):
                raise TypeError("%s takes at most %d positional inputs"
                                % (opdef.name, len(input_names)))
            bound = {k: a for k, a in zip(input_names, args)
                     if a is not None}
            bound.update(sym_kwargs)
            inputs = []
            for i, in_name in enumerate(input_names):
                if _skip_input(opdef.name, in_name, params):
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
            for a in [a for a in args if a is not None] + list(
                    sym_kwargs.values()):
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
