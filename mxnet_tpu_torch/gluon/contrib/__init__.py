"""Gluon contrib (counterpart of ``mxnet_tpu/gluon/contrib/``):
``FusedTrainStep``; the contrib layers are not ported."""
from .fused import FusedTrainStep

__all__ = ["FusedTrainStep"]
