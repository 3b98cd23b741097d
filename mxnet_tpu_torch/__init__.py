"""mxnet_tpu_torch — the PyTorch / CUDA port of ``mxnet_tpu``.

A second package beside the JAX one: plain tensor code is PyTorch, and every
kernel that ``mxnet_tpu`` wrote in Pallas for the TPU is a CUDA C++ kernel
written by hand for Hopper (``ops/kernels/csrc``), built with ``nvcc`` at
first use.  The package imports ``torch`` and ``numpy``, never ``jax`` and
nothing of ``mxnet_tpu``; only the parity tests import both.

It carries these paths:

* serving the flagship TransformerLM: ``GenerationServer.submit_async`` ->
  scheduler -> ``GenerationEngine`` -> ``TransformerLM.prefill`` /
  ``decode_step``, with the fused RMSNorm and flash-attention forward
  kernels; around it the serving plane's host half — QoS preemption,
  ``resume_from``, live KV migration and defrag, ``swap_params``, the
  SIGTERM drain, and the modules the server reads (``telemetry``,
  ``profiler``'s dispatch counters, ``tenancy``, ``chaos``, ``memory``,
  ``leakcheck``, ``debug``, ``dispatch``, ``elastic``, ``config``), with
  ``loadgen`` to drive it;
* training it: ``make_train_step`` -> ``TransformerLM.loss`` -> ``apply``
  and backward, with, besides those, the flash-attention dQ and dK/dV
  kernels and the fused softmax cross-entropy forward and backward kernels;
* INT8 post-training quantization and int8 inference of a symbolic graph
  (the MXNet API core: ``Context``, ``nd``, ``sym``, the executor,
  ``io.NDArrayIter``): ``contrib.quantization.quantize_model`` -> ``bind``
  -> ``forward``, with the int8 matmul kernels (int32 out, and with the
  per-channel dequant fused);
* symbolic training: ``mod.Module.fit`` -> ``bind`` / ``init_params``
  (``init``) / ``init_optimizer`` (``optimizer``, ``lr_scheduler``) -> per
  batch ``forward_backward`` (the executor's autograd backward) ->
  ``update`` -> ``update_metric`` (``metric``), with ``callback`` and
  ``random``; user operators (``operator.CustomOp``, ``sym.Custom``) on
  that path may launch CUDA kernels compiled at runtime by ``rtc``
  (NVRTC), the counterpart of the JAX package's Pallas ``rtc``;
* imperative training: ``autograd.record()`` over ``nd`` ops and Gluon
  (``gluon.Parameter``, ``HybridBlock`` and ``hybridize``, ``nn`` layers,
  ``loss``, ``model_zoo.vision`` ResNets) -> ``loss.backward()`` ->
  ``gluon.Trainer.step`` (SGD with f32 master weights under
  ``multi_precision``), or all of it in one call with
  ``gluon.contrib.FusedTrainStep``; convolutions, BatchNorm and products
  go to cuDNN / cuBLAS through PyTorch, as XLA generates them in the JAX
  package;
* model serving: the predict API (``predict.Predictor`` and the C-shaped
  ``MXPred*``, over ``nd.load`` / ``nd.save`` in the npz and the dmlc
  formats) behind ``serving.ModelServer`` (bounded admission, bucketed
  batching, deadlines, hedging, circuit breakers, drain, hot reload);
  ``benchmark``'s throughput harness (one CUDA graph of K chained
  forwards a draw); and the numerical-health ``sentinel`` with
  ``FusedTrainStep(numeric_guard=)`` / ``Trainer(numeric_guard=)``, the
  loss scaler and ``monitor``.

Entry points take ``device=`` (or, on the symbolic path, ``ctx=``).  The
default is ``cuda:0`` (``gpu(0)``); without a CUDA device they raise unless
the caller asks for the CPU explicitly (``device="cpu"`` / ``ctx=cpu()``,
which the tests do), and then every kernel runs its plain PyTorch version.
"""
from __future__ import annotations

import torch

__all__ = ["default_device", "resolve_device", "TransformerConfig",
           "TransformerLM", "make_train_step", "GenerationConfig",
           "GenerationEngine", "GenerationServer", "Context", "cpu", "gpu",
           "current_context", "nd", "sym", "io", "contrib", "init", "mod",
           "metric", "optimizer", "lr_scheduler", "callback", "random",
           "operator", "rtc", "autograd", "gluon", "predict", "serving",
           "benchmark", "monitor", "Monitor", "sentinel"]


def default_device() -> torch.device:
    """The device entry points use when none is given: ``cuda:0``.

    Raises :class:`RuntimeError` when no CUDA device is visible — the port
    never carries on on the CPU unless the caller asks for it.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mxnet_tpu_torch: no CUDA device is available; pass "
            "device='cpu' explicitly to run the plain PyTorch versions of "
            "the kernels on the CPU")
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means
    :func:`default_device`.  A CUDA device that is not there raises."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            default_device()                     # raises the clear error
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("mxnet_tpu_torch runs on 'cuda' or 'cpu', not %r"
                         % (device,))
    return dev


from .models.transformer import (TransformerConfig,  # noqa: E402
                                 TransformerLM, make_train_step)
from .generation import (GenerationConfig, GenerationEngine,  # noqa: E402
                         GenerationServer)
from .context import Context, cpu, current_context, gpu  # noqa: E402
from . import ndarray as nd  # noqa: E402
from . import symbol as sym  # noqa: E402
from . import contrib, io, model  # noqa: E402,F401
from . import (callback, lr_scheduler, metric, operator,  # noqa: E402,F401
               optimizer, random, rtc)
from . import initializer as init  # noqa: E402
from . import module as mod  # noqa: E402
from . import autograd, gluon  # noqa: E402,F401
from . import benchmark, monitor, predict, sentinel, serving  # noqa: E402,F401
from .monitor import Monitor  # noqa: E402,F401
