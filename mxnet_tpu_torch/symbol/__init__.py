"""Symbolic (declarative) API — ``mx.sym``.

Counterpart of ``mxnet_tpu/symbol``: a Symbol is a Python DAG of op nodes;
``sym.<op>`` and ``sym.contrib.<op>`` are generated from the op registry;
``bind`` / ``simple_bind`` give an inference executor that runs the graph
node by node on the bound context's device.
"""
from .symbol import (Group, Symbol, Variable, load, load_json,  # noqa: F401
                     var)
from .register import _init_symbol_module

_init_symbol_module()

from . import contrib  # noqa: E402,F401
