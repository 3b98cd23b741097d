"""The RMSNorm kernel's planner, on the CPU.

``plan_rmsnorm`` picks the variant of ``csrc/rmsnorm.cu`` and its launch
shape from (rows, E, dtype, row stride, base alignment, number of SMs); the
numbers below are an H100's 132 SMs.  Three variants:

* ``warp`` — rows to row groups of 1, 2 or 4 warps on a persistent grid,
  for more rows than SMs on rows up to 16 KB (the prefills and the
  training steps);
* ``block`` — one CTA a row, for at most one row per SM (decode) and for
  rows of 16 to 128 KB;
* ``simt`` — the scalar kernel, for a row, row stride or base that is not
  whole 16-byte vectors, and for rows over 128 KB.

The budgets each plan stays under: a thread of a vector variant holds at
most 8 vectors of a row (32 registers); warp holds two rows (64 registers
of data, at most 256 threads a CTA and 128 registers a thread) and keeps
scale in shared memory (at most 16 KB, beside the reduction's 64 bytes);
block holds one row and, up to 4 vectors, scale (at most 32 registers of
data within the 64 a thread has at 1024 threads; 128 bytes of shared
memory); simt holds nothing (32 bytes of shared memory).  The kernels are held against
``fused_rmsnorm_reference`` on the card (tests/test_torch_port_cuda.py,
chip_smoke.py); here the reference is held against the JAX package's
``_rmsnorm_lax`` and its Pallas kernel through the interpreter at one
small case of each plan class, at tests/test_torch_port_kernels.py's
tolerances (f32 1e-5; bf16 one ulp after each of the two roundings, 2^-6).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas import fused_rmsnorm as jax_rmsnorm
from mxnet_tpu.ops.pallas.layers import _rmsnorm_lax
from mxnet_tpu_torch.ops.kernels import layers
from mxnet_tpu_torch.ops.kernels.layers import (fused_rmsnorm_reference,
                                                plan_rmsnorm)

SMS = 132                                       # one H100
BF16, F32 = torch.bfloat16, torch.float32
ITEMSIZE = {BF16: 2, F32: 4}
# registers of row data a thread may hold, and threads a CTA, per variant
WARP_DATA_REGS, WARP_THREADS, WARP_SCALE_SMEM = 64, 256, 16 * 1024
BLOCK_DATA_REGS, BLOCK_THREADS = 32, 1024
MAX_VEC = 8
# (warps per row, vectors per thread) the source instantiates for warp
WARP_KERNELS = {(1, 1), (1, 2), (1, 4), (1, 8), (2, 8), (4, 8)}
BLOCK_KERNELS = {1, 2, 4, 8}


def _plan(n, E, dtype, stride=None, align=16):
    return plan_rmsnorm(n, E, dtype, E if stride is None else stride, align,
                        SMS)


def _check_budget(plan, n, E, dtype):
    """The plan covers the row with the vectors its threads hold, stays
    within its variant's register and thread budget, and names a kernel
    the source instantiates."""
    row_bytes = E * ITEMSIZE[dtype]
    if plan.variant == "simt":
        assert (plan.threads, plan.vec_per_thread, plan.grid) == (256, 0, n)
        return
    chunks = row_bytes // 16
    assert plan.vec_per_thread <= MAX_VEC
    threads_per_row = 32 * plan.warps_per_row
    assert threads_per_row * plan.vec_per_thread >= chunks
    # no thread of the row left without a vector, unless the row is short
    assert (threads_per_row * (plan.vec_per_thread - 1) < chunks
            or plan.vec_per_thread == 1)
    assert plan.threads == threads_per_row * plan.rows_per_cta
    if plan.variant == "warp":
        assert (plan.warps_per_row, plan.vec_per_thread) in WARP_KERNELS
        assert 2 * 4 * plan.vec_per_thread <= WARP_DATA_REGS
        assert row_bytes <= WARP_SCALE_SMEM
        assert plan.threads <= WARP_THREADS
        assert 1 <= plan.grid <= 2 * SMS or n == 0
        # the persistent grid's row groups cover every row
        assert plan.grid * plan.rows_per_cta >= min(n, 2 * SMS
                                                     * plan.rows_per_cta)
    else:
        assert plan.variant == "block"
        assert plan.vec_per_thread in BLOCK_KERNELS
        assert plan.rows_per_cta == 1 and plan.grid == n
        assert plan.threads <= BLOCK_THREADS and plan.threads % 32 == 0
        held = plan.vec_per_thread * (2 if plan.vec_per_thread <= 4 else 1)
        assert 4 * held <= BLOCK_DATA_REGS


# ---------------------------------------------------------------------------
# the main paths' shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,E,dtype,plan", [
    # decode, 7-8 streams: one CTA of 256 threads a row, one vector each
    (8, 2048, BF16, ("block", 8, 1, 1, 256, 8)),
    # the 4000-token prompt's prefill (and any prefill over 132 rows), the
    # flagship step, the long-context step: a warp a row, 8 rows a CTA,
    # two CTAs per SM, persistent
    (4000, 2048, BF16, ("warp", 1, 8, 8, 256, 264)),
    (4096, 2048, BF16, ("warp", 1, 8, 8, 256, 264)),
    (8192, 2048, BF16, ("warp", 1, 8, 8, 256, 264)),
    (8192, 1024, BF16, ("warp", 1, 8, 4, 256, 264)),
    # the f32 rows chip_smoke.py times: two warps a row
    (4096, 2048, F32, ("warp", 2, 4, 8, 256, 264)),
    (8, 2048, F32, ("block", 16, 1, 1, 512, 8)),
    # the serve path's other prefill buckets and the final norm's one row
    (16, 2048, BF16, ("block", 8, 1, 1, 256, 16)),
    (128, 2048, BF16, ("block", 8, 1, 1, 256, 128)),
    (256, 2048, BF16, ("warp", 1, 1, 8, 32, 256)),
    (512, 2048, BF16, ("warp", 1, 3, 8, 96, 171)),
    (1, 2048, BF16, ("block", 8, 1, 1, 256, 1)),
])
def test_plan_at_main_path_shapes(n, E, dtype, plan):
    got = _plan(n, E, dtype)
    assert tuple(got) == plan
    _check_budget(got, n, E, dtype)


# ---------------------------------------------------------------------------
# edges
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("E", [1, 7, 1000, 2047, 2048, 16384, 65536])
@pytest.mark.parametrize("n", [0, 1, 8, 132, 4000, 8192])
def test_plan_edges(n, E, dtype):
    plan = _plan(n, E, dtype)
    _check_budget(plan, n, E, dtype)
    row_bytes = E * ITEMSIZE[dtype]
    if row_bytes % 16:                          # E 1, 7, 2047; f32 1000 is
        want = "simt"                           # whole vectors, bf16 too
    elif row_bytes > 128 * 1024:                # f32 65536: 256 KB
        want = "simt"
    elif n > SMS and row_bytes <= 16 * 1024:
        want = "warp"
    else:
        want = "block"
    assert plan.variant == want, plan


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("stride_extra,align,want", [
    (0, 16, "vector"),
    (64, 16, "vector"),            # rows 64 elements apart past E: aligned
    (8, 16, "vector"),             # 8 elements: 16 or 32 bytes
    (1, 16, "simt"),               # a row stride off whole vectors
    (3, 16, "simt"),
    (0, 8, "simt"),                # a base 8 bytes off: an offset view
    (0, 2, "simt"),
    (64, 4, "simt"),
])
def test_plan_strides_and_alignment(dtype, stride_extra, align, want):
    for n, E in ((8, 2048), (4096, 2048), (8192, 1024), (300, 16384)):
        plan = _plan(n, E, dtype, stride=E + stride_extra, align=align)
        _check_budget(plan, n, E, dtype)
        assert (plan.variant == "simt") == (want == "simt"), plan
    # one row: its stride is never used
    assert _plan(1, 2048, dtype, stride=2049).variant == "block"


def test_layout_of_views():
    """The wrapper's stride and alignment of a CPU view, as it hands them to
    the planner: an offset view's base is off 16 bytes, a column slice
    keeps its parent's row stride."""
    big = torch.zeros(64, 2112, dtype=BF16)
    scale = torch.ones(2048, dtype=BF16)
    stride, align = layers._layout(big[:, :2048], scale)
    assert stride == 2112 and align == 16
    stride, align = layers._layout(big[:, 1:2049], scale)
    assert stride == 2112 and align == 2
    assert _plan(64, 2048, BF16, stride, align).variant == "simt"
    _, align = layers._layout(big[:, :2048], torch.ones(2050, dtype=BF16)[2:])
    assert align == 4


def test_plan_many_rows_walk_a_persistent_grid():
    # more rows than two CTAs per SM hold: each row group walks several
    plan = _plan(1 << 20, 2048, BF16)
    assert plan.grid == 2 * SMS and plan.rows_per_cta == 8
    # between one row per SM and a full CTA: as many rows a CTA as keep
    # every SM busy
    assert _plan(133, 2048, BF16).rows_per_cta == 1
    assert _plan(4 * SMS, 2048, BF16).rows_per_cta == 4
    assert _plan(4 * SMS, 2048, F32).rows_per_cta == 4
    assert _plan(4 * SMS, 2048, F32).threads == 256


# ---------------------------------------------------------------------------
# the plain version at one case of each plan class, against the JAX package
# ---------------------------------------------------------------------------
def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    s = (1 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    if dtype == "bfloat16":
        x, s = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (x, s))
    return x, s


def _torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(BF16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,variant", [
    ((200, 512), "warp"),          # one warp a row
    ((200, 2048), "warp"),         # f32: two warps a row
    ((8, 2048), "block"),          # decode
    ((133, 8704), "block"),        # rows past a row group's 16 KB (bf16)
    ((6, 7), "simt"),              # odd E
    ((1, 65536), None),            # f32 256 KB: simt; bf16 128 KB: block
])
def test_reference_matches_jax_at_each_plan_class(shape, variant, dtype):
    tdt = F32 if dtype == "float32" else BF16
    plan = _plan(shape[0], shape[1], tdt)
    if variant is None:
        variant = "simt" if dtype == "float32" else "block"
    if shape == (200, 2048):
        assert plan.warps_per_row == (2 if dtype == "float32" else 1)
    assert plan.variant == variant
    x, s = _inputs(shape, dtype, seed=sum(shape))
    got = fused_rmsnorm_reference(_torch(x), _torch(s))
    assert got.dtype == tdt and tuple(got.shape) == shape
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2.0 ** -6, atol=1e-6))
    got = got.float().numpy()
    lax = np.asarray(jnp.asarray(_rmsnorm_lax(jnp.asarray(x), jnp.asarray(s),
                                              1e-6), jnp.float32))
    pallas = np.asarray(jnp.asarray(jax_rmsnorm(jnp.asarray(x),
                                                jnp.asarray(s),
                                                interpret=True),
                                    jnp.float32))
    np.testing.assert_allclose(got, lax, **tol)
    np.testing.assert_allclose(got, pallas, **tol)
