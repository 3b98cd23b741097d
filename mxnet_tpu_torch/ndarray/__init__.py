"""``mx.nd``: NDArray and one function per registered op.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: every name in the op
registry becomes ``nd.<name>``, and every ``_contrib_*`` op also
``nd.contrib.<short name>``; ``save`` / ``load`` / ``load_frombuffer``
are :mod:`.utils`'.  Each function takes NDArrays as positional
(or named) inputs and the op's parameters as keywords.
"""
from __future__ import annotations

import sys as _sys

from .. import ops as _ops  # noqa: F401  (registers the op corpus)
from ..ops.registry import OPS as _OPS, invoke as _invoke
from .ndarray import (NDArray, array, concat, ones, ones_like,  # noqa: F401
                      zeros, zeros_like)
from .. import operator as _operator  # noqa: E402,F401  (registers Custom)
from .utils import load, load_frombuffer, save  # noqa: E402,F401


def _make_op_func(opname, opdef):
    input_names = opdef.input_names

    def f(*args, **kwargs):
        kwargs.pop("name", None)
        inputs = [a for a in args if a is not None]
        for a in inputs:
            if not isinstance(a, NDArray):
                raise TypeError("%s: positional inputs must be NDArrays, "
                                "got %s" % (opname, type(a).__name__))
        # inputs may also come by name (the reference's kwarg convention)
        inputs += [kwargs.pop(n) for n in input_names
                   if isinstance(kwargs.get(n), NDArray)]
        return _invoke(opdef, inputs, kwargs)

    f.__name__ = opname
    f.__doc__ = (opdef.fn.__doc__ or "") + "\n(op: %s)" % opdef.name
    return f


_mod = _sys.modules[__name__]
for _name, _opdef in list(_OPS.items()):
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _make_op_func(_name, _opdef))

from . import contrib  # noqa: E402,F401
