"""``mx.nd``: NDArray and one function per registered op.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: every name in the op
registry becomes ``nd.<name>``, and every ``_contrib_*`` op also
``nd.contrib.<short name>``; ``save`` / ``load`` / ``load_frombuffer``
are :mod:`.utils`'.  Each function takes NDArrays as positional
(or named) inputs and the op's parameters as keywords, or, after the
inputs, positionally in the order of the op's signature (``clip(x, 0,
6)``).
"""
from __future__ import annotations

import inspect as _inspect
import sys as _sys

from .. import ops as _ops  # noqa: F401  (registers the op corpus)
from ..ops.registry import OPS as _OPS, invoke as _invoke
from .ndarray import (NDArray, array, concat, ones, ones_like,  # noqa: F401
                      zeros, zeros_like)
from .. import operator as _operator  # noqa: E402,F401  (registers Custom)
from .utils import load, load_frombuffer, save  # noqa: E402,F401


def param_names(opdef):
    """The op's non-tensor parameters, in signature order: those with a
    default, outside its ``input_names``."""
    try:
        sig = _inspect.signature(opdef.fn)
    except (TypeError, ValueError):
        return ()
    skip = set(opdef.input_names) | {"_train"}
    return tuple(p.name for p in sig.parameters.values()
                 if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
                 and p.name not in skip and p.default is not p.empty)


def positional_params(opdef, extra, params):
    """``params`` with the positional non-tensor arguments ``extra`` set
    on the op's parameters that ``params`` leaves out, in order (the
    reference's ``clip(x, 0, 6)``)."""
    params = dict(params)
    free = [n for n in param_names(opdef) if n not in params]
    if len(extra) > len(free):
        raise TypeError("%s: %d positional parameters, %d free: %s"
                        % (opdef.name, len(extra), len(free), free))
    params.update(zip(free, extra))
    return params


def _make_op_func(opname, opdef):
    input_names = opdef.input_names

    def f(*args, **kwargs):
        kwargs.pop("name", None)
        inputs, extra = [], []
        for i, a in enumerate(args):
            if isinstance(a, NDArray):
                if extra:
                    raise TypeError("%s: an NDArray input after a "
                                    "positional parameter" % opname)
                inputs.append(a)
            elif a is not None or extra or i >= len(input_names):
                extra.append(a)        # None in an input's slot: not given
        # inputs may also come by name (the reference's kwarg convention)
        inputs += [kwargs.pop(n) for n in input_names
                   if isinstance(kwargs.get(n), NDArray)]
        if extra:
            kwargs = positional_params(opdef, extra, kwargs)
        return _invoke(opdef, inputs, kwargs)

    f.__name__ = opname
    f.__doc__ = (opdef.fn.__doc__ or "") + "\n(op: %s)" % opdef.name
    return f


_mod = _sys.modules[__name__]
for _name, _opdef in list(_OPS.items()):
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _make_op_func(_name, _opdef))

from . import contrib  # noqa: E402,F401
