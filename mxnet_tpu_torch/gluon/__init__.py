"""Gluon: imperative model authoring and training.

Counterpart of ``mxnet_tpu/gluon`` (reference ``python/mxnet/gluon/``):
``Parameter`` / ``ParameterDict``, ``Block`` / ``HybridBlock``, ``nn``
layers, ``loss``, ``Trainer``, ``utils``, the model zoo's ResNets and
``contrib.FusedTrainStep``.  ``data``, ``rnn``, ``SymbolBlock`` and the
other model-zoo families are not ported yet.
"""
from .parameter import (Constant, DeferredInitializationError,  # noqa: F401
                        Parameter, ParameterDict)
from .block import Block, HybridBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import model_zoo  # noqa: F401
from . import utils  # noqa: F401
from . import contrib  # noqa: F401
