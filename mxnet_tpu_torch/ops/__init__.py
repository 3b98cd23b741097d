"""Operators of the port.  ``ops.kernels`` holds the hand-written CUDA
kernels and their plain PyTorch versions; ``registry`` the op registry,
which importing this package fills with the ops of ``nn``, ``tensor``,
``rnn``, ``sequence``, ``quantization``, ``optimizer_ops``, ``spatial``,
``contrib_ops`` and ``detection`` (``Custom`` comes from
``mxnet_tpu_torch.operator``)."""
from . import (contrib_ops, detection, nn, optimizer_ops,  # noqa: F401
               quantization, rnn, sequence, spatial, tensor)
