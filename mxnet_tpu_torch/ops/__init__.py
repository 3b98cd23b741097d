"""Operators of the port.  ``ops.kernels`` holds the hand-written CUDA
kernels and their plain PyTorch versions; ``registry`` the op registry,
which importing this package fills with the ops of ``nn``, ``tensor``,
``rnn``, ``sequence``, ``quantization`` and ``optimizer_ops`` (``Custom``
comes from ``mxnet_tpu_torch.operator``)."""
from . import (nn, optimizer_ops, quantization, rnn,  # noqa: F401
               sequence, tensor)
