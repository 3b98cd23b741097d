"""Optimizer package (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import (SGD, Adam, Optimizer, Updater, create,  # noqa: F401
                        get_updater, register)
from .loss_scaler import DynamicLossScaler  # noqa: F401

opt_registry = Optimizer.opt_registry
