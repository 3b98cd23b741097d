"""Checkpoints of symbolic models, and model parameters across packages.

Counterpart of ``mxnet_tpu/model.py`` (reference ``python/mxnet/model.py``:
``save_checkpoint`` :394, ``load_checkpoint`` :424).  A checkpoint is
``prefix-symbol.json`` (``Symbol.tojson``'s graph) and
``prefix-####.params`` (``nd.save``'s container, the keys ``arg:<name>``
and ``aux:<name>``): the JAX package's files, which each package reads
from the other.

:func:`params_from_numpy` takes the ``arg_params`` / ``aux_params`` dicts of
a symbolic model — as the JAX package's ``mx.model.load_checkpoint`` or an
executor's ``arg_dict`` give them, turned into numpy arrays — and makes the
port's NDArray dicts on a Context, so that both packages compute the same
thing from the same numbers.
"""
from __future__ import annotations

import numpy as np

from . import ndarray as nd

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam",
           "params_from_numpy"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``symbol`` (unless None) and the parameters of ``epoch``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    nd.save("%s-%04d.params" % (prefix, epoch), save_dict)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint, the arrays on
    the current context."""
    from .symbol import load as sym_load

    symbol = sym_load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


def params_from_numpy(arg_params, aux_params=None, ctx=None):
    """``(args, auxs)``: ``{name: NDArray}`` copies of the numpy arrays in
    ``arg_params`` and ``aux_params`` on ``ctx`` (default: the current
    context), each keeping its dtype."""
    def conv(d):
        return {k: nd.array(np.asarray(v), ctx=ctx)
                for k, v in (d or {}).items()}

    return conv(arg_params), conv(aux_params)


from .module.base_module import BatchEndParam  # noqa: E402,F401
