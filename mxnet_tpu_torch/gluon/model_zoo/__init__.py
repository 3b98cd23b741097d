"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo/``)."""
from . import vision  # noqa: F401
from .vision import get_model  # noqa: F401
