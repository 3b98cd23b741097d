"""Random number state: ``seed``, and one :class:`torch.Generator` per
device.

Counterpart of ``mxnet_tpu/random.py`` (reference ``mx.random.seed`` with
per-context generators).  Where the JAX package splits one ``jax.random``
key chain, the port keeps an explicit ``torch.Generator`` for each device,
made on first use from the last seed (0 until :func:`seed` is called).
The initializers and ``io.NDArrayIter(shuffle=True)`` draw from them.  The
two packages draw different numbers from the same seed; the parity tests
carry values across as numpy arrays and compare distributions, never
draws.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]

_LOCK = threading.Lock()
_GENERATORS: dict = {}
_SEEDS = {"all": 0}


def _key(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def seed(seed_state, ctx="all"):
    """Seed the generator of every device (``ctx="all"``) or of the device
    of one Context."""
    seed_state = int(seed_state)
    with _LOCK:
        if ctx == "all":
            _SEEDS.clear()
            _SEEDS["all"] = seed_state
            for gen in _GENERATORS.values():
                gen.manual_seed(seed_state)
            return
        key = _key(ctx.torch_device())
        _SEEDS[key] = seed_state
        if key in _GENERATORS:
            _GENERATORS[key].manual_seed(seed_state)


def generator(device):
    """The generator of ``device`` (a :class:`torch.device` or its
    string), made from the last seed on first use."""
    key = _key(device)
    with _LOCK:
        gen = _GENERATORS.get(key)
        if gen is None:
            gen = torch.Generator(device=key)
            gen.manual_seed(_SEEDS.get(key, _SEEDS["all"]))
            _GENERATORS[key] = gen
        return gen
