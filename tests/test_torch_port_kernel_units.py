"""The kernel library's front door in the port, against the JAX package's:
``dispatch.pallas_mode`` (``MXTPU_PALLAS``), the JAX-form
``select_impl(name)`` and ``kernel_unit`` / ``kernel_units``.

* ``pallas_mode`` parses every value as the JAX package's does and raises
  the same ``ValueError`` on a bad one (``tests/test_pallas.py``'s
  ``TestSelectImpl``).
* The tensor form routes by device: the plain version on a CPU tensor
  under every mode; on a CUDA tensor the kernel under ``auto``, and
  ``off`` and ``interpret`` raise (a stand-in object with a CUDA device:
  the routing reads only ``x.device``).
* The JAX form (``resolve_entry``) hands out the public entries of the
  kernels the ``kernels`` leg resolves, ``flash_attention`` and
  ``int8_matmul``, and of no other kernel.
* ``kernel_unit`` memoizes by name, labels ``kernel.<name>`` and counts
  each new input signature as a ``recompile``.
* The flash forward and backward through the JAX-form ``select_impl``
  and a kernel unit (the shape of bench.py's ``kernels`` leg, cut to
  B 1, T 128, H 2, D 64, f32) match the JAX package's ``flash_attention``
  through the Pallas interpreter within 1e-5.
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import dispatch as jdispatch
from mxnet_tpu.ops.pallas import flash_attention as jax_flash
from mxnet_tpu.ops.pallas.common import select_impl as jax_select_impl
from mxnet_tpu_torch import dispatch, profiler, telemetry
from mxnet_tpu_torch.ops.kernels import (common, flash_attention,
                                         fused_rmsnorm, int8_matmul,
                                         kernel_unit, kernel_units,
                                         resolve_entry, select_impl)

torch.set_num_threads(1)

MODE_VALUES = ["", "1", "on", "true", "0", "false", "no", "auto", "off",
               "interpret", "AUTO", " off "]


@pytest.mark.parametrize("raw", MODE_VALUES)
def test_pallas_mode_parses_like_the_jax_package(monkeypatch, raw):
    monkeypatch.setenv("MXTPU_PALLAS", raw)
    assert dispatch.pallas_mode() == jdispatch.pallas_mode()


def test_pallas_mode_default_is_auto(monkeypatch):
    monkeypatch.delenv("MXTPU_PALLAS", raising=False)
    assert dispatch.pallas_mode() == "auto"


@pytest.mark.parametrize("raw", ["sideways", "pallas", "2"])
def test_invalid_mode_raises_like_the_jax_package(monkeypatch, raw):
    monkeypatch.setenv("MXTPU_PALLAS", raw)
    with pytest.raises(ValueError, match="MXTPU_PALLAS"):
        jax_select_impl("int8_matmul")
    with pytest.raises(ValueError, match="MXTPU_PALLAS"):
        select_impl("int8_matmul")
    with pytest.raises(ValueError, match="MXTPU_PALLAS"):
        select_impl("int8_matmul", _on_cuda())


def test_unknown_kernel_raises():
    with pytest.raises(KeyError):
        select_impl("no_such_kernel")


@pytest.mark.parametrize("name,entry", [
    ("flash_attention", flash_attention), ("int8_matmul", int8_matmul)])
def test_jax_form_returns_the_public_entry(monkeypatch, name, entry):
    """The model paths' entry (for flash attention the autograd-aware
    one, whose backward launches dQ and dK/dV), never a forward-only
    launcher; ``'cuda'`` under ``auto`` with a card present."""
    monkeypatch.delenv("MXTPU_PALLAS", raising=False)
    fn, impl = select_impl(name)
    assert fn is entry
    assert impl == ("cuda" if torch.cuda.is_available() else "reference")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert select_impl(name) == (entry, "cuda")
    monkeypatch.setenv("MXTPU_PALLAS", "off")
    assert select_impl(name) == (entry, "reference")
    assert resolve_entry(name) == (entry, "reference")


@pytest.mark.parametrize("name", ["fused_rmsnorm", "fused_softmax_xent",
                                  "fused_softmax_xent_bwd"])
def test_jax_form_covers_only_the_front_door_kernels(name):
    """Entries exist for the kernels the ``kernels`` leg resolves; the
    others are reached through their wrappers' tensor form only."""
    with pytest.raises(KeyError):
        resolve_entry(name)
    assert select_impl(name, torch.zeros(1))[1] == "reference"


def test_jax_form_bumps_the_resolve_counter(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "off")
    c = telemetry.registry().counter(
        "kernels.resolve.flash_attention.reference")
    before = c.value
    common.reset_counts()
    select_impl("flash_attention")
    assert c.value == before + 1
    assert common.selection_counts() == {}     # no kernel was resolved


def _on_cuda():
    """A stand-in for a CUDA tensor: the routing reads only ``device``."""
    return types.SimpleNamespace(device=torch.device("cuda", 0))


def test_tensor_form_routes_by_mode(monkeypatch):
    common.reset_counts()
    monkeypatch.delenv("MXTPU_PALLAS", raising=False)
    assert select_impl("fused_rmsnorm", _on_cuda())[1] == "cuda"
    assert select_impl("fused_rmsnorm", torch.zeros(1))[1] == "reference"
    monkeypatch.setenv("MXTPU_PALLAS", "off")
    fn, impl = select_impl("fused_rmsnorm", torch.zeros(1))
    assert impl == "reference"
    assert fn is common._REGISTRY["fused_rmsnorm"]["reference"]
    # no plain version on the card because of the knob
    with pytest.raises(RuntimeError, match="MXTPU_PALLAS=off"):
        select_impl("fused_rmsnorm", _on_cuda())
    monkeypatch.setenv("MXTPU_PALLAS", "interpret")
    assert select_impl("fused_rmsnorm", torch.zeros(1))[1] == "reference"
    with pytest.raises(RuntimeError, match="interpret"):
        select_impl("fused_rmsnorm", _on_cuda())
    # a raise selects nothing; the CPU's plain version is counted
    assert common.selection_counts() == {
        "kernels.select.fused_rmsnorm.cuda": 1,
        "kernels.select.fused_rmsnorm.reference": 3}


def test_off_runs_the_plain_version_visibly(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "off")
    common.reset_counts()
    x = torch.randn(4, 16)
    out = fused_rmsnorm(x, torch.ones(16))
    torch.testing.assert_close(out, common._REGISTRY["fused_rmsnorm"][
        "reference"](x, torch.ones(16)))
    assert common.selection_counts() == {
        "kernels.select.fused_rmsnorm.reference": 1}
    assert common.launch_counts() == {}


def test_kernel_unit_memoized_labelled_and_counted():
    unit = kernel_unit("test_unit_port_xyz", lambda x: x + 1)
    assert kernel_unit("test_unit_port_xyz") is unit
    assert unit.label == "kernel.test_unit_port_xyz"
    assert kernel_units()["test_unit_port_xyz"] is unit
    r0 = profiler.dispatch_value("recompile")
    assert int(unit(torch.tensor([1]))[0]) == 2
    unit(torch.tensor([5]))                     # same signature
    assert unit.tracker.signatures == 1
    unit(torch.zeros(2, 3))                     # a new one
    assert unit.tracker.signatures == 2
    assert profiler.dispatch_value("recompile") == r0 + 2
    with pytest.raises(KeyError, match="not yet bound"):
        kernel_unit("test_unit_never_bound")


def _qkv(B, T, H, D):
    rng = np.random.default_rng(0)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_bwd_through_the_front_door_matches_pallas(causal):
    """bench.py's kernels-leg loss, (o ** 2).sum(), forward and backward:
    the port through ``select_impl`` + ``kernel_unit`` against the JAX
    package's kernel through the Pallas interpreter."""
    q, k, v = _qkv(1, 128, 2, 64)

    def jloss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, interpret=True)
        return (o.astype(jnp.float32) ** 2).sum()

    want_l, want_g = jax.value_and_grad(jloss, (0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    attn, impl = select_impl("flash_attention")
    assert attn is flash_attention
    assert impl == ("cuda" if torch.cuda.is_available() else "reference")

    def loss(q, k, v):
        o = attn(q, k, v, causal=causal)
        return (o.float() ** 2).sum()

    step = kernel_unit("test_flash_fwd_bwd_%s" % causal, loss)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    common.reset_counts()
    got_l = step(tq, tk, tv)
    got_g = torch.autograd.grad(got_l, (tq, tk, tv))
    assert common.selection_counts() == {
        "kernels.select.flash_attention.reference": 1,
        "kernels.select.flash_attention_bwd.reference": 1}
    np.testing.assert_allclose(float(got_l.detach()), float(want_l),
                               rtol=1e-5)
    for g, w, name in zip(got_g, want_g, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg="d" + name)
