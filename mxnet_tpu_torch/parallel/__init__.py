"""Parallelism over ``torch.distributed``: the port of ``mxnet_tpu/parallel``.

One process per rank, one device per rank (:mod:`mxnet_tpu_torch._dist`,
started by ``python -m mxnet_tpu_torch.tools.launch``).  A
:class:`~.mesh.DeviceMesh` names the axes of the grid of ranks; arrays are
cut over them by :class:`~.sharding.ShardingRules`; per-rank code runs on
local shards and meets the other ranks through the named-axis
:mod:`.collectives`.  The axes are the JAX package's (any may be size 1):

* ``dp``   — data parallel (the batch);
* ``fsdp`` — ZeRO-style sharding of parameters and optimizer state (the
  batch is cut over it too);
* ``tp``   — tensor parallel (heads, the MLP's hidden units, the vocab);
* ``pp``   — pipeline parallel (:mod:`.pipeline`);
* ``sp``   — sequence parallel (:mod:`.ring_attention`);
* ``ep``   — expert parallel (:mod:`.moe`).
"""
from __future__ import annotations

from .mesh import (DeviceMesh, make_mesh, current_mesh, get_mesh,  # noqa: F401
                   local_mesh, mesh_slices)
from .sharding import (ShardingRules, auto_shard, constraint,  # noqa: F401
                       param_sharding, shard_array)
from . import collectives  # noqa: F401
from .ring_attention import ring_attention, blockwise_attention  # noqa: F401
from .pipeline import pipeline_spmd, pipeline_train_1f1b  # noqa: F401
from .moe import moe_layer  # noqa: F401
