"""Operators of the port.  ``ops.kernels`` holds the hand-written CUDA
kernels and their plain PyTorch versions; ``registry`` the op registry,
which importing this package fills with the ops of ``nn``, ``tensor`` and
``quantization``."""
from . import nn, quantization, tensor  # noqa: F401
