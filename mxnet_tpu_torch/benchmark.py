"""Throughput measurement utilities (reference:
``example/image-classification/benchmark_score.py``); counterpart of
``mxnet_tpu/benchmark.py``.

Two disciplines, each reporting the MEDIAN of ``draws`` timed
repetitions with min/max beside it (``{median, min, max, draws}`` in
items per second):

* :func:`compiled_throughput` — the K-step inference loop as one unit of
  device work, with a runtime-zero probe chaining step *i*'s output into
  step *i+1*'s input (``carry + out.flat[0] * zero``), so no step can be
  skipped or hoisted.  Where the JAX package compiles the loop into one
  XLA program (``lax.fori_loop``), on the card the port captures the K
  chained forwards once as ONE CUDA graph (``torch.cuda.graph``; the warm
  forwards that let cuDNN pick its algorithms run on a side stream before
  capture) and times each draw as one replay plus the scalar fetch.  A
  capture that fails raises: eager calls are never timed under this name.
  On the CPU the same chained loop runs eagerly.
* :func:`percall_throughput` — the user path: one framework dispatch per
  ``net(x)`` call, ``steps`` chained calls per draw ended by a host scalar
  fetch.

:func:`interleaved_throughput` alternates draws of several (net, x)
pairs.  ``graph_replays()`` counts the CUDA-graph replays this module
launched (a draw is exactly one).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import autograd
from .ndarray.ndarray import NDArray

__all__ = ["compiled_throughput", "interleaved_throughput",
           "percall_throughput", "compiled_loop", "chained_forward",
           "graph_replays"]

_REPLAYS = [0]


def graph_replays():
    """CUDA-graph replays launched by :func:`compiled_throughput` so far."""
    return _REPLAYS[0]


def _first_out(out):
    if isinstance(out, (list, tuple)):
        out = out[0]
    return out


def _summarize(draws, items_per_draw):
    rates = [items_per_draw / dt for dt in draws]
    return {
        "median": float(np.median(rates)),
        "min": float(min(rates)),
        "max": float(max(rates)),
        "draws": len(rates),
    }


def chained_forward(net, carry, zero, steps):
    """``steps`` forwards of ``net``, each on the previous carry plus its
    first output element times ``zero``.  Returns ``(carry, last output)``
    as tensors (the carry equals the input while the outputs are finite)."""
    out = None
    for _ in range(steps):
        out = _first_out(net(NDArray(carry))).data
        carry = carry + out.reshape(-1)[0].to(carry.dtype) * zero
    return carry, out


class _GraphLoop:
    """The K chained forwards of ``net`` on ``x`` captured as one CUDA
    graph; :meth:`draw` replays it once and fetches one scalar."""

    def __init__(self, net, x, steps):
        xd = x.data
        self.static_x = xd.clone()
        self.zero = torch.zeros((), dtype=xd.dtype, device=xd.device)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with autograd.pause(train_mode=False), torch.cuda.stream(side):
            # warm-up off the capture: cuDNN / cuBLAS choose algorithms and
            # the allocator grows, neither of which may happen in capture
            for _ in range(2):
                chained_forward(net, self.static_x, self.zero, 1)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with autograd.pause(train_mode=False), \
                torch.cuda.graph(self.graph):
            self.carry, self.out = chained_forward(net, self.static_x,
                                                   self.zero, steps)
        self.replay()
        torch.cuda.synchronize()

    def replay(self):
        self.graph.replay()
        _REPLAYS[0] += 1

    def draw(self):
        """One timed draw: one replay plus the scalar fetch; seconds."""
        t0 = time.perf_counter()
        self.replay()
        float(self.carry.reshape(-1)[0].item())
        return time.perf_counter() - t0


class _EagerLoop:
    """The chained loop run eagerly (the CPU's counterpart of
    :class:`_GraphLoop`, with its interface)."""

    def __init__(self, net, x, steps):
        self.net, self.x, self.steps = net, x.data, steps
        self.zero = torch.zeros((), dtype=x.data.dtype,
                                device=x.data.device)
        with autograd.pause(train_mode=False):
            chained_forward(net, self.x, self.zero, 1)
        self.draw()

    def draw(self):
        """One timed draw of the eager chain; seconds."""
        with autograd.pause(train_mode=False):
            t0 = time.perf_counter()
            self.carry, self.out = chained_forward(self.net, self.x,
                                                   self.zero, self.steps)
            float(self.carry.reshape(-1)[0].item())
            return time.perf_counter() - t0


def compiled_loop(net, x, steps):
    """The K-step chained loop of ``net`` on ``x``, built and run once: a
    :class:`_GraphLoop` on the card (a capture failure raises), the eager
    :class:`_EagerLoop` on the CPU.  ``draw()`` times one more run;
    ``carry`` and ``out`` are the last run's carry and output."""
    if x.data.is_cuda:
        return _GraphLoop(net, x, steps)
    return _EagerLoop(net, x, steps)


def compiled_throughput(net, x, steps=30, draws=5):
    """items/sec of ``net`` forward on batch ``x``, K steps per draw (one
    CUDA-graph replay on the card); returns ``{median, min, max, draws}``
    over ``draws`` repetitions.  Runs in inference mode."""
    batch = x.shape[0]
    loop = compiled_loop(net, x, steps)
    times = [loop.draw() for _ in range(draws)]
    return _summarize(times, batch * steps)


def interleaved_throughput(pairs, steps=20, reps=3):
    """A/B measurement immune to drift: build each (net, x) loop ONCE,
    then alternate timed draws A, B, A, B, ...  Returns each pair's
    median items/sec."""
    draws = [compiled_loop(net, x, steps).draw for net, x in pairs]
    results = [[] for _ in pairs]
    for _ in range(reps):
        for i, d in enumerate(draws):
            results[i].append(pairs[i][1].shape[0] * steps / d())
    return [float(np.median(r)) for r in results]


def percall_throughput(net, x, steps=30, draws=5):
    """items/sec of the per-dispatch user path: ``steps`` framework-level
    ``net(x)`` calls per draw, chained through a runtime-zero probe, ended
    by a host scalar fetch."""
    batch = x.shape[0]
    zero = NDArray(torch.zeros((1,), dtype=x.data.dtype,
                               device=x.data.device))
    with autograd.pause(train_mode=False):
        _first_out(net(x)).asnumpy()           # first call off the clock
        times = []
        for _ in range(draws):
            xi = x
            t0 = time.perf_counter()
            for _ in range(steps):
                out = _first_out(net(xi))
                xi = xi + out[0, 0] * zero
            float(out[0, 0].asnumpy())
            times.append(time.perf_counter() - t0)
    return _summarize(times, batch * steps)
