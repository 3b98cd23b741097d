"""Gluon: imperative model authoring and training.

Counterpart of ``mxnet_tpu/gluon`` (reference ``python/mxnet/gluon/``):
``Parameter`` / ``ParameterDict``, ``Block`` / ``HybridBlock`` (with
``export``), ``SymbolBlock``, ``nn`` layers, ``rnn`` layers and cells,
``loss``, ``Trainer``, ``utils``, the vision model zoo and
``contrib.FusedTrainStep``.  ``data`` is not ported yet.
"""
from .parameter import (Constant, DeferredInitializationError,  # noqa: F401
                        Parameter, ParameterDict)
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import loss  # noqa: F401
from . import model_zoo  # noqa: F401
from . import utils  # noqa: F401
from . import contrib  # noqa: F401
