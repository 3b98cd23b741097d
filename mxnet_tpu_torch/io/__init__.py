"""Data iterators (``mx.io``); counterpart of ``mxnet_tpu/io``."""
from .io import DataBatch, DataDesc, DataIter, NDArrayIter  # noqa: F401
