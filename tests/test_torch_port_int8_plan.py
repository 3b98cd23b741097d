"""The int8 matmul's planner and split-K, on the CPU.

``plan_int8_matmul`` picks the variant (``wgmma`` for every layout TMA can
read, ``mma`` otherwise), the CTA tile and the split of K for the card's
wgmma kernel from (M, N, K, number of SMs); the numbers below are an
H100's 132 SMs.  Split-K is exact by construction: int32 addition with
wraparound is associative and commutative, so the partial sums over the
planner's K ranges, added in int32 in any order, are the one-pass sum bit
for bit, past 2^31 too.  Those partial sums are held against the port's
plain version, the JAX package's XLA lowering ``int8_matmul_lax`` and its
Pallas kernel through the interpreter, bit for bit.  The kernels themselves
are held against the plain version on the card (tests/test_torch_port_cuda.py,
chip_smoke.py).
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas.int8_matmul import (_int8_matmul_pallas,
                                              int8_matmul_lax)

# (the package exports a function under the module's name)
km = importlib.import_module("mxnet_tpu_torch.ops.kernels.int8_matmul")

SMS = 132                                       # one H100


@pytest.mark.parametrize("shape,plan", [
    # ResNet-50's classifier at batch 128 (the int8 path's fc1)
    ((128, 1000, 2048), ("wgmma", 128, 64, 8, 2)),
    # VGG16's fc6 at batch 128: 64 column tiles x 2 splits fill one wave
    # with the fewest split-K partials
    ((128, 4096, 25088), ("wgmma", 128, 64, 2, 98)),
    # bench.py's 2048^3: one wave of 128 x 256 tiles, no split
    ((2048, 2048, 2048), ("wgmma", 128, 256, 1, 16)),
    # ragged, K odd: TMA cannot read it
    ((777, 1001, 301), ("mma", 64, 64, 1, 5)),
    ((1, 1000, 2048), ("wgmma", 128, 64, 8, 2)),
    ((128, 1000, 16), ("wgmma", 128, 64, 1, 1)),
    ((1, 64, 64), ("wgmma", 128, 64, 1, 1)),
])
def test_plan_by_shape(shape, plan):
    M, N, K = shape
    got = km.plan_int8_matmul(M, N, K, SMS, aligned=K % 16 == 0)
    assert tuple(got) == plan


def test_large_grids_pick_the_tile_that_fills_its_waves():
    # 128 x 256 tiles: 144 CTAs, two waves of which the second holds 12;
    # 128 x 128: 288 CTAs in three waves, 73 % of them full
    assert tuple(km.plan_int8_matmul(2048, 2304, 1024, SMS)) == (
        "wgmma", 128, 128, 1, 8)
    # a tie (4 and 8 full waves) goes to the fewer, larger tiles
    assert tuple(km.plan_int8_matmul(4096, 4096, 4096, SMS)) == (
        "wgmma", 128, 256, 1, 32)


def test_unaligned_view_takes_the_mma_variant():
    """An offset view (base not 16-byte aligned) or a row stride that is
    not a multiple of 16 is what TMA cannot read."""
    a = torch.zeros(70, 96, dtype=torch.int8)
    b = torch.zeros(40, 80, dtype=torch.int8)
    assert km._tma_aligned(a[:, :64], b[:, :64])
    offset = a[:, 3:67]                          # base 3 bytes in
    assert not km._tma_aligned(offset, b[:, :64])
    rows_72 = torch.zeros(40, 72, dtype=torch.int8)[:, :64]
    assert not km._tma_aligned(a[:, :64], rows_72)
    plan = km.plan_int8_matmul(70, 40, 64, SMS,
                               km._tma_aligned(offset, b[:, :64]))
    assert plan.variant == "mma" and plan.splits == 1


def _split_k_ranges(plan, K):
    """The [begin, end) ranges of K, in elements, that the wgmma kernel's
    splits cover: split z takes K tiles z·per .. min((z + 1)·per, tiles) of
    128 bytes (int8_mm_wgmma_kernel: kt0, nk)."""
    step = plan.k_tiles_per_split * 128
    return [(k, min(k + step, K)) for k in range(0, K, step)]


@pytest.mark.parametrize("M", [1, 127, 128, 129, 1000])
@pytest.mark.parametrize("N", [8, 1000, 4096])
@pytest.mark.parametrize("K", [16, 144, 2048, 25088])
def test_every_split_covers_k_exactly_once(M, N, K):
    plan = km.plan_int8_matmul(M, N, K, SMS)
    assert plan.variant == "wgmma"
    ranges = _split_k_ranges(plan, K)
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1
    assert all(b < e for b, e in ranges)                 # none empty
    k_tiles = -(-K // 128)
    assert (plan.splits - 1) * plan.k_tiles_per_split < k_tiles
    assert plan.splits * plan.k_tiles_per_split >= k_tiles
    tiles = -(-M // 128) * -(-N // plan.block_n)
    if plan.splits > 1:
        assert tiles * plan.splits <= SMS                 # one wave at most
        assert plan.k_tiles_per_split >= 2


def _wrap32(x):
    """int64 -> the int32 that a wrapping int32 sum leaves."""
    return ((np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31) \
        .astype(np.int32)


def _operands(M, N, K, seed, saturate):
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, (M, K)).astype(np.int8)
    b = rng.integers(-127, 128, (N, K)).astype(np.int8)
    if saturate:         # rows whose sums pass +2^31 and -2^31
        a[0], a[1], b[0] = 127, -127, 127
    return a, b


@pytest.mark.parametrize("M,N,K,saturate", [
    (128, 1000, 2048, False),          # fc1's plan: 8 splits of 256
    (5, 7, 4096, False),
    (3, 4, 140032, True),              # 140032 * 127^2 > 2^31
])
def test_split_k_partial_sums_are_the_one_pass_bits(M, N, K, saturate):
    a, b = _operands(M, N, K, 3, saturate)
    plan = km.plan_int8_matmul(M, N, K, SMS)
    ranges = _split_k_ranges(plan, K)
    assert plan.splits == len(ranges) > 1
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    parts = [torch.matmul(ta[:, k0:k1].to(torch.int32),
                          tb[:, k0:k1].to(torch.int32).t())
             for k0, k1 in ranges]
    fwd = torch.zeros(M, N, dtype=torch.int32)
    for p in parts:                                   # in K order
        fwd = fwd + p
    rev = torch.zeros(M, N, dtype=torch.int32)
    for p in reversed(parts):                         # the other order
        rev = rev + p
    exact = _wrap32(a.astype(np.int64) @ b.astype(np.int64).T)
    if saturate:
        full = a[:2].astype(np.int64) @ b[:1].astype(np.int64).T
        assert full[0, 0] > 2 ** 31 and full[1, 0] < -2 ** 31
    np.testing.assert_array_equal(fwd.numpy(), exact)
    np.testing.assert_array_equal(rev.numpy(), exact)
    np.testing.assert_array_equal(
        km.int8_matmul_reference(ta, tb).numpy(), exact)
    np.testing.assert_array_equal(
        np.asarray(int8_matmul_lax(jnp.asarray(a), jnp.asarray(b))), exact)
    # the Pallas kernel through the interpreter, with one K block where K is
    # long (the grid runs in order either way)
    bk = 128 if K <= 4096 else -(-K // 128) * 128
    np.testing.assert_array_equal(
        np.asarray(_int8_matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                                       block_k=bk, interpret=True)), exact)


def test_dequant_scales_the_complete_sum_once():
    """The dequant epilogue applies ``f32(acc) · s[n]`` to the complete
    int32 sum: scaling each split's partial sum and adding the f32 results
    is another function (it rounds once per split)."""
    M, N, K = 4, 6, 4096
    a, b = _operands(M, N, K, 5, False)
    rng = np.random.default_rng(6)
    sb = rng.uniform(0.01, 0.11, N).astype(np.float32)
    sa = np.float32([0.05])
    plan = km.plan_int8_matmul(M, N, K, SMS)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    acc = torch.zeros(M, N, dtype=torch.int32)
    for k0, k1 in _split_k_ranges(plan, K):
        acc = acc + torch.matmul(ta[:, k0:k1].to(torch.int32),
                                 tb[:, k0:k1].to(torch.int32).t())
    s = km._dequant_scale(torch.from_numpy(sa), torch.from_numpy(sb), N,
                          torch.device("cpu"))
    got = (acc.to(torch.float32) * s).numpy()
    want = np.asarray(int8_matmul_lax(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(sa), jnp.asarray(sb)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        km.int8_matmul_reference(ta, tb, torch.from_numpy(sa),
                                 torch.from_numpy(sb)).numpy().view(np.int32),
        want.view(np.int32))


@pytest.mark.parametrize("sa,sb", [
    ("one", "per_channel"), (None, "per_channel"), ("one", None),
    ("per_channel", "one"), ("per_channel", "per_channel"), ("one", "one"),
    ("float", "float")])
def test_kernel_scales_are_the_wrappers_product(sa, sb):
    """The kernels read ``scale_a`` and ``scale_b`` as they come and form
    ``scale_a[n·a_step] · scale_b[n·b_step]`` in f32 in their epilogue; bit
    for bit the product ``_dequant_scale`` builds (and the plain version
    uses)."""
    N = 7
    rng = np.random.default_rng(8)

    def make(kind):
        if kind == "one":
            return torch.tensor([rng.uniform(0.01, 0.1)], dtype=torch.float32)
        if kind == "per_channel":
            return torch.from_numpy(rng.uniform(0.01, 0.1, N)
                                    .astype(np.float32))
        return None if kind is None else float(rng.uniform(0.01, 0.1))

    a, b = make(sa), make(sb)
    ta, a_step, tb, b_step = km._scale_operands(a, b, N, torch.device("cpu"))
    one = torch.ones((), dtype=torch.float32)
    got = torch.stack([(one if ta is None else ta[n * a_step])
                       * (one if tb is None else tb[n * b_step])
                       for n in range(N)])
    want = km._dequant_scale(a, b, N, torch.device("cpu"))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("sa,sb", [(None, (3,)), ((7, 1), (7,)), ((2,), None)])
def test_kernel_scales_refuse_what_the_plain_version_refuses(sa, sb):
    N = 7
    a = None if sa is None else torch.ones(sa)
    b = None if sb is None else torch.ones(sb)
    with pytest.raises(ValueError, match="scales"):
        km._scale_operands(a, b, N, torch.device("cpu"))
    with pytest.raises(ValueError, match="scales"):
        km._dequant_scale(a, b, N, torch.device("cpu"))
