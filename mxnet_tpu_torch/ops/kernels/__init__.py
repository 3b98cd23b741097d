"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) with their plain
PyTorch versions; the counterpart of ``mxnet_tpu/ops/pallas``, and the
greedy NMS of the detection ops (``nms``), which the JAX package leaves to
a ``lax.fori_loop``."""
from .common import (kernel_unit, kernel_units,  # noqa: F401
                     launch_counts, register_entry, register_impl,
                     reset_counts, resolve_entry, select_impl,
                     selection_counts)
from .flash_attention import (flash_attention,  # noqa: F401
                              flash_attention_bwd_reference,
                              flash_attention_lse,
                              flash_attention_reference,
                              flash_self_attention)
from .int8_matmul import int8_matmul, int8_matmul_reference  # noqa: F401
from .nms import greedy_nms, greedy_nms_reference  # noqa: F401
from .layers import (fused_rmsnorm, fused_rmsnorm_reference,  # noqa: F401
                     fused_softmax_xent, rmsnorm_bwd_reference,
                     softmax_xent_bwd_reference, softmax_xent_reference)
