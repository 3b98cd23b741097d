"""Multi-process initialization: the port of ``mxnet_tpu/_dist.py``.

``mxnet_tpu_torch.tools.launch`` starts one process per rank and sets::

    MXNET_TPU_COORDINATOR = host:port   of rank 0's TCP store
    MXNET_TPU_NUM_WORKERS = N
    MXNET_TPU_WORKER_ID   = 0..N-1
    MXNET_TPU_PLATFORM    = cpu|gpu     (optional; default the card)
    MXNET_TPU_BACKEND     = gloo|nccl   (optional; see below)

and ``import mxnet_tpu_torch`` in the worker calls :func:`init_from_env`,
which joins ``torch.distributed``'s default process group.  After that the
mesh (:mod:`mxnet_tpu_torch.parallel`) and the ``dist_*`` kvstores run real
collectives across the ranks.

One rank drives one device: ``cuda:<rank mod device count>`` with the
``nccl`` backend by default, or the CPU with ``gloo`` when the platform is
``cpu``.  ``gloo`` on a CUDA device is taken only when asked for
(``backend="gloo"`` or ``MXNET_TPU_BACKEND=gloo``): NCCL refuses two ranks
on one device, so that is how several ranks share one card.  The JAX
package's ``MXNET_TPU_LOCAL_DEVICES`` (several virtual devices in one
process) has no counterpart and is refused above 1.

Unlike the JAX package, a coordinator with ``N = 1`` still initializes: a
process group of one rank is a real communicator, and the mesh needs one.
A process that builds a mesh without a launcher gets a group of one rank
from :func:`ensure_initialized`.
"""
from __future__ import annotations

import os
import threading

__all__ = ["init_from_env", "ensure_initialized", "device", "rank",
           "world_size"]

_ENV = ("MXNET_TPU_COORDINATOR", "MXNET_TPU_NUM_WORKERS",
        "MXNET_TPU_WORKER_ID", "MXNET_TPU_PLATFORM", "MXNET_TPU_BACKEND",
        "MXNET_TPU_LOCAL_DEVICES")
_PLATFORMS = ("cpu", "gpu", "cuda")
_lock = threading.Lock()
_device = None


def _resolve(platform, backend, rank):
    """(torch.device, backend) of a rank on ``platform``."""
    import torch

    if platform not in (None,) + _PLATFORMS:
        raise ValueError("mxnet_tpu_torch: platform %r (known: %s)"
                         % (platform, ", ".join(_PLATFORMS)))
    if platform == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError("mxnet_tpu_torch: backend %r cannot run on "
                             "the CPU; use gloo" % (backend,))
        return torch.device("cpu"), "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mxnet_tpu_torch: no CUDA device is available for this rank; "
            "launch with --platform cpu (MXNET_TPU_PLATFORM=cpu) to run "
            "the ranks on the CPU over gloo")
    if backend not in (None, "nccl", "gloo"):
        raise ValueError("mxnet_tpu_torch: backend %r (known: nccl, gloo)"
                         % (backend,))
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev, backend or "nccl"


def init_from_env(backend=None):
    """Join the default process group from the ``MXNET_TPU_*`` variables.

    A no-op (returns False) without ``MXNET_TPU_COORDINATOR`` or when the
    group exists.  ``backend`` overrides ``MXNET_TPU_BACKEND``.  The
    variables are removed afterwards, so child processes of a worker do
    not try to join again as the same rank."""
    global _device
    import torch
    import torch.distributed as dist

    coord = os.environ.get("MXNET_TPU_COORDINATOR")
    if not coord or dist.is_initialized():
        return False
    local = int(os.environ.get("MXNET_TPU_LOCAL_DEVICES", "1"))
    if local > 1:
        raise ValueError(
            "mxnet_tpu_torch: MXNET_TPU_LOCAL_DEVICES=%d: one rank drives "
            "one device (there are no virtual devices in a torch process); "
            "launch %d ranks instead" % (local, local))
    nproc = int(os.environ.get("MXNET_TPU_NUM_WORKERS", "1"))
    rank_id = int(os.environ.get("MXNET_TPU_WORKER_ID", "0"))
    dev, be = _resolve(os.environ.get("MXNET_TPU_PLATFORM"),
                       backend or os.environ.get("MXNET_TPU_BACKEND"),
                       rank_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    with _lock:
        dist.init_process_group(be, init_method="tcp://" + coord,
                                world_size=nproc, rank=rank_id)
        _device = dev
    for var in _ENV:
        os.environ.pop(var, None)
    return True


def ensure_initialized(device=None, backend=None):
    """The default process group, joined as a group of one rank when there
    is none (an in-process store: no network).  ``device`` picks the
    platform as entry points do: ``None`` is the card, which raises without
    one; ``"cpu"`` takes gloo.  Returns this rank's device."""
    global _device
    import torch
    import torch.distributed as dist

    init_from_env(backend)
    with _lock:
        if not dist.is_initialized():
            platform = None
            if device is not None and torch.device(device).type == "cpu":
                platform = "cpu"
            dev, be = _resolve(platform, backend, 0)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(be, store=dist.HashStore(), rank=0,
                                    world_size=1)
            _device = dev
        elif _device is None:
            # a group made by the caller: the device follows its backend
            if dist.get_backend() == "nccl":
                _device = torch.device("cuda", torch.cuda.current_device())
            else:
                _device = torch.device("cpu") if device is None \
                    else torch.device(device)
        if device is not None and torch.device(device).type != _device.type:
            raise ValueError("mxnet_tpu_torch: this rank drives %s, not %s"
                             % (_device, device))
        return _device


def device():
    """This rank's device (after :func:`init_from_env` or
    :func:`ensure_initialized`), else None."""
    return _device


def rank():
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def world_size():
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1
