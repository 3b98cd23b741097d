"""``sym.contrib``: every ``_contrib_*`` registry op under its short name,
as in ``mxnet_tpu/symbol/contrib.py``."""
from __future__ import annotations

import sys

from ..ops.registry import OPS
from .register import _make_wrapper


def _attach_registry_ops():
    mod = sys.modules[__name__]
    for name, opdef in list(OPS.items()):
        if name.startswith("_contrib_"):
            short = name[len("_contrib_"):]
            if not hasattr(mod, short):
                setattr(mod, short, _make_wrapper(opdef))


_attach_registry_ops()
