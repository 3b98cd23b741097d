"""Shared helpers of the serving-plane parity tests
(``tests/test_torch_port_{generation_qos,migration,serving_plane}.py``).

The same f32 weights (a JAX ``init`` carried across as numpy arrays) and
the same numpy prompts go through ``mxnet_tpu.generation`` and
``mxnet_tpu_torch.generation`` (``device="cpu"``).  :func:`gated` holds
servers' schedulers inside a task while requests queue, so every request
is queued before the first one runs and both packages schedule the same
turns in the same order.
"""
import contextlib
import threading
import time

import numpy as np

import jax

from mxnet_tpu import generation as jgen
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu_torch import GenerationConfig, TransformerConfig, TransformerLM

VOCAB = 97
# few prefill buckets keep the JAX servers' warmup compiles short
PREFILL_BUCKETS = "8,16,32"


def cfg_kw(max_len=64, dtype="float32"):
    return dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=2,
                d_ff=128, max_len=max_len, dtype=dtype, remat=False)


_JAX = {}


def jax_model(max_len=64):
    """(JAX model, params), built once per ``max_len``."""
    if max_len not in _JAX:
        m = jtf.TransformerLM(jtf.TransformerConfig(**cfg_kw(max_len)))
        _JAX[max_len] = (m, m.init(jax.random.PRNGKey(0)))
    return _JAX[max_len]


def np_params(max_len=64):
    _, params = jax_model(max_len)
    return {k: np.asarray(v) for k, v in params.items()}


def port_model(max_len=64, params=None):
    """A port TransformerLM on the CPU over the JAX weights (or over
    ``params``, a flat numpy dict)."""
    return TransformerLM(TransformerConfig(**cfg_kw(max_len)),
                         device="cpu").load_jax_params(
        np_params(max_len) if params is None else params)


def gcfg(jax_side=False, **kw):
    kw.setdefault("page_size", 8)
    kw.setdefault("max_pages", 32)
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_new_tokens", 8)
    kw.setdefault("prefill_buckets", PREFILL_BUCKETS)
    cls = jgen.GenerationConfig if jax_side else GenerationConfig
    return cls(**kw)


def prompts(ns, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=n).astype(np.int32) for n in ns]


def wait(cond, timeout=30.0, interval=0.002, msg="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("timed out waiting for " + msg)
        time.sleep(interval)


@contextlib.contextmanager
def gated(*servers):
    """Hold each server's scheduler inside a posted task until the block
    exits: requests submitted inside the block queue up untouched."""
    gates = []
    try:
        for srv in servers:
            entered, release = threading.Event(), threading.Event()

            def task(entered=entered, release=release):
                entered.set()
                release.wait(60)
                return True

            th = threading.Thread(target=srv._run_on_scheduler,
                                  args=(task, 120.0), daemon=True)
            th.start()
            gates.append((release, th))
            assert entered.wait(30), "scheduler never ran the gate task"
        yield
    finally:
        for release, th in gates:
            release.set()
            th.join(30)
            assert not th.is_alive()


def outcome(fut, timeout=60):
    """``("ok", tokens)`` or ``(error class name, streamed tokens)``."""
    try:
        return ("ok", fut.result(timeout=timeout))
    except Exception as e:            # typed outcomes, compared by name
        return (type(e).__name__, fut.stream_tokens)
