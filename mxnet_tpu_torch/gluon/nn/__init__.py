"""Neural network layers (counterpart of ``mxnet_tpu/gluon/nn/``)."""
from ..block import Block, HybridBlock  # noqa: F401
from .activations import (Activation, LeakyReLU, PReLU, ELU, SELU, Swish,  # noqa: F401
                          GELU)
from .basic_layers import (Sequential, HybridSequential, Dense, Dropout,  # noqa: F401
                           BatchNorm, InstanceNorm, LayerNorm, Embedding,
                           Flatten, Lambda, HybridLambda)
from .conv_layers import (Conv1D, Conv2D, Conv3D, MaxPool1D,  # noqa: F401
                          MaxPool2D, MaxPool3D, AvgPool1D, AvgPool2D,
                          AvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, ReflectionPad2D)
