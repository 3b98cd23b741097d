"""``mx.mod``: the symbolic training stack (counterpart of
``mxnet_tpu/module``): ``BaseModule.fit`` and ``Module``."""
from .base_module import BaseModule, BatchEndParam  # noqa: F401
from .module import Module  # noqa: F401
