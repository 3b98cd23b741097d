"""``nd.contrib``: every ``_contrib_*`` registry op under its short name
(``nd.contrib.quantize_v2``, ``nd.contrib.quantized_dense``, ...), as in
``mxnet_tpu/ndarray/contrib.py``."""
from __future__ import annotations

import sys

from ..ops.registry import OPS


def _attach_registry_ops():
    from . import _make_op_func

    mod = sys.modules[__name__]
    for name, opdef in list(OPS.items()):
        if name.startswith("_contrib_"):
            short = name[len("_contrib_"):]
            if not hasattr(mod, short):
                setattr(mod, short, _make_op_func(short, opdef))


_attach_registry_ops()
