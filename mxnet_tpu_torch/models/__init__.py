"""Flagship models of the port; counterpart of ``mxnet_tpu/models``."""
from .transformer import (TransformerConfig, TransformerLM,  # noqa: F401
                          make_train_step, params_from_numpy)
