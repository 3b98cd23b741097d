"""``mx.mod``: the symbolic training stack (counterpart of
``mxnet_tpu/module``): ``BaseModule.fit``, ``Module`` and
``BucketingModule``."""
from .base_module import BaseModule, BatchEndParam  # noqa: F401
from .module import Module  # noqa: F401
from .bucketing_module import BucketingModule  # noqa: F401
