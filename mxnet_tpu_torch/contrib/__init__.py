"""Contrib modules; ``contrib.quantization`` is the INT8 pipeline."""
from . import quantization  # noqa: F401
