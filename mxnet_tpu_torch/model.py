"""Model parameters across packages.

:func:`params_from_numpy` takes the ``arg_params`` / ``aux_params`` dicts of
a symbolic model — as the JAX package's ``mx.model.load_checkpoint`` or an
executor's ``arg_dict`` give them, turned into numpy arrays — and makes the
port's NDArray dicts on a Context, so that both packages compute the same
thing from the same numbers.
"""
from __future__ import annotations

import numpy as np

from . import ndarray as nd

__all__ = ["params_from_numpy"]


def params_from_numpy(arg_params, aux_params=None, ctx=None):
    """``(args, auxs)``: ``{name: NDArray}`` copies of the numpy arrays in
    ``arg_params`` and ``aux_params`` on ``ctx`` (default: the current
    context), each keeping its dtype."""
    def conv(d):
        return {k: nd.array(np.asarray(v), ctx=ctx)
                for k, v in (d or {}).items()}

    return conv(arg_params), conv(aux_params)
