"""Parity of the port's ``parallel/`` (over ``torch.distributed``) with the
JAX package's (``shard_map`` over a virtual mesh).

The port side runs once per module: 4 gloo rank processes on the CPU,
started by the port's launcher (``torch_port_parallel_worker.py``, suite
``ops``, one torch thread each, its own timeout).  The JAX side runs in this
process on ``jax.devices()[:4]`` of the 8 virtual CPU devices.  Inputs come
from numpy seeds (``torch_port_parallel_cases.py``); rank r of a (dp=2,
tp=2) mesh is device r of the JAX mesh of the same shape.

Tolerances (f32): collectives, the shard / gather round trip and the
1F1B loss 1e-6 relative (the same sums, maybe in another order); ring
attention, ``moe_layer`` and the pipelines 2e-5 on outputs and 5e-5 on
gradients.
"""
import functools
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as JP

import torch_port_parallel_cases as cases
from mxnet_tpu.models.transformer import default_rules as j_default_rules
from mxnet_tpu.parallel import collectives as JC
from mxnet_tpu.parallel import make_mesh as j_make_mesh
from mxnet_tpu.parallel.mesh import mesh_slices as j_mesh_slices
from mxnet_tpu.parallel.moe import moe_layer as j_moe_layer
from mxnet_tpu.parallel.pipeline import (bubble_fraction as
                                         j_bubble_fraction,
                                         pipeline_spmd as j_pipeline_spmd,
                                         pipeline_train_1f1b as j_1f1b)
from mxnet_tpu.parallel.ring_attention import (
    ring_self_attention as j_ring_self_attention)
from mxnet_tpu.parallel.sharding import (_filter_spec as j_filter_spec,
                                         match_partition_rules as j_match)
from mxnet_tpu_torch.models.transformer import default_rules
from mxnet_tpu_torch.parallel.pipeline import bubble_fraction
from mxnet_tpu_torch.parallel.sharding import _filter_spec, match_partition_rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
WORLD = 4
RANK_TIMEOUT = 150


def run_ranks(out_dir, suite):
    """The worker suite on WORLD gloo ranks through the port's launcher;
    returns each rank's results."""
    r = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
         str(WORLD), "--platform", "cpu", "--timeout", str(RANK_TIMEOUT),
         "--", sys.executable,
         os.path.join(TESTS, "torch_port_parallel_worker.py"), str(out_dir),
         suite],
        cwd=REPO, capture_output=True, text=True, timeout=RANK_TIMEOUT + 30,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, "ranks failed:\n%s\n%s" % (r.stdout[-3000:],
                                                         r.stderr[-6000:])
    return [dict(np.load(os.path.join(out_dir, "%s_rank%d.npz" % (suite, i))))
            for i in range(WORLD)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("parallel_ops"), "ops")


def jmesh(**axes):
    return j_make_mesh(devices=jax.devices()[:WORLD], **axes)


def close(got, want, rtol, atol=None, what=""):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol,
                               atol=rtol if atol is None else atol,
                               err_msg=what)


# -- collectives ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_collective(name):
    X, W = cases.coll_inputs()
    fn = cases.COLLECTIVES[name]
    spec = JP(("dp", "tp"))
    f = JC.shard_map(lambda x: fn(JC, x[0])[None], mesh=jmesh(dp=2, tp=2).mesh,
                     in_specs=spec, out_specs=spec, check_vma=False)
    y = jax.jit(f)(jnp.asarray(X))
    dx = jax.jit(jax.grad(lambda X: (f(X) * W[name]).sum()))(jnp.asarray(X))
    return np.asarray(y), np.asarray(dx)


@pytest.mark.parametrize("name", list(cases.COLLECTIVES))
def test_collective_and_its_gradient_match_jax(ranks, name):
    y, dx = jax_collective(name)
    for r in range(WORLD):
        close(ranks[r]["coll.%s.y" % name], y[r], 1e-6, what=name)
        close(ranks[r]["coll.%s.dx" % name], dx[r], 1e-6,
              what="grad " + name)


@pytest.mark.parametrize("name", list(cases.FORWARD_ONLY))
def test_forward_only_collective_matches_jax(ranks, name):
    X, _ = cases.coll_inputs()
    fn = cases.FORWARD_ONLY[name]
    spec = JP(("dp", "tp"))
    f = JC.shard_map(lambda x: fn(JC, x[0])[None], mesh=jmesh(dp=2, tp=2).mesh,
                     in_specs=spec, out_specs=spec, check_vma=False)
    y = np.asarray(jax.jit(f)(jnp.asarray(X)))
    for r in range(WORLD):
        close(ranks[r]["fwd.%s.y" % name], y[r], 1e-6, what=name)


def test_axis_index_is_the_mesh_coordinate(ranks):
    for r in range(WORLD):
        assert list(ranks[r]["coll.axis_index"]) == [r // 2, r % 2]


def test_region_boundaries_give_shard_map_gradients(ranks):
    """An operand replicated over the mesh and a replicated result: the
    gradient ``jax.grad`` gives through ``shard_map(check_vma=False)``."""
    X, _ = cases.coll_inputs()
    axes = ("dp", "tp")
    f = JC.shard_map(lambda w, x: JC.allreduce(w * x[0], axes),
                     mesh=jmesh(dp=2, tp=2).mesh,
                     in_specs=(JP(), JP(axes)), out_specs=JP(),
                     check_vma=False)
    w, Xj = jnp.asarray(cases.REGION_W), jnp.asarray(X)
    y = jax.jit(f)(w, Xj)
    dw, dX = jax.jit(jax.grad(lambda w, X: (f(w, X) ** 2).sum(),
                              (0, 1)))(w, Xj)
    for r in range(WORLD):
        close(ranks[r]["region.y"], y, 1e-6)
        close(ranks[r]["region.dw"], dw, 1e-6)
        close(ranks[r]["region.dx"], dX[r], 1e-6)


# -- meshes ----------------------------------------------------------------------

def test_make_mesh_rules_match_jax(ranks):
    """Absent axes have size 1 and are left out, ``dp`` takes the ranks
    left over, sizes that do not fit raise ValueError; in AXIS_ORDER."""
    import json

    for r in range(WORLD):
        got = json.loads(str(ranks[r]["mesh.make"]))
        for kw, g in zip(cases.MESH_CASES, got):
            try:
                want = dict(jmesh(**kw).shape)
            except ValueError:
                assert g.get("error") == "ValueError", (kw, g)
                continue
            assert list(g.items()) == list(want.items()), (kw, g, want)


def test_mesh_slices_match_jax(ranks):
    """Disjoint slices of consecutive ranks, the rest unused (not put into
    dp); each slice's rank grid is JAX's device grid."""
    import json

    devs = jax.devices()[:WORLD]
    for r in range(WORLD):
        got = json.loads(str(ranks[r]["mesh.slices"]))
        for kw, g in zip(cases.SLICE_CASES, got):
            want = j_mesh_slices(devices=devs, **kw)
            assert [s["shape"] for s in g] == [dict(m.shape) for m in want]
            assert [s["ranks"] for s in g] == [
                [devs.index(d) for d in m.mesh.devices.flatten()]
                for m in want]


def test_local_mesh_and_the_thread_local_stack(ranks):
    for r in range(WORLD):
        assert list(ranks[r]["mesh.local"]) == [1, r]
        assert ranks[r]["mesh.stack"].all()


def test_bubble_fraction_matches_jax():
    for P in (1, 2, 4, 8):
        for M in (1, 4, 16):
            for sched in ("gpipe", "1f1b"):
                assert bubble_fraction(P, M, sched) == \
                    j_bubble_fraction(P, M, sched)
    with pytest.raises(ValueError):
        bubble_fraction(2, 2, "zigzag")


# -- sharding rules ----------------------------------------------------------

def _flagship_shapes():
    V, E, H, L, F, n = 32000, 2048, 16, 4, 8192, 8
    return {"embed": (V, E), "blocks.ln1_scale": (L, E),
            "blocks.ln2_scale": (L, E), "blocks.wqkv": (L, E, 3 * E),
            "blocks.wo": (L, E, E), "blocks.w_up": (L, E, F),
            "blocks.w_down": (L, F, E), "final_ln_scale": (E,),
            "unembed": (E, V), "blocks.gate": (L, E, n),
            "blocks.moe_up": (L, n, E, F), "blocks.moe_down": (L, n, F, E),
            "odd_vocab": (97, E)}


MESHES = [dict(fsdp=2, tp=2), dict(dp=2, tp=2), dict(tp=4), dict(dp=4),
          dict(ep=2, dp=2), dict(pp=2, sp=2), dict(fsdp=4)]


def test_default_rules_are_the_jax_models():
    ours = [(p.pattern, tuple(s)) for p, s in default_rules().rules]
    theirs = [(p.pattern, tuple(s)) for p, s in j_default_rules().rules]
    assert ours == theirs


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
    "%s%d" % kv for kv in a.items()))
def test_filter_spec_matches_jax_on_every_flagship_parameter(axes):
    """``_filter_spec`` reads only the mesh's axis sizes."""
    mesh = types.SimpleNamespace(shape=dict(jmesh(**axes).shape))
    for name, shape in _flagship_shapes().items():
        spec = default_rules().spec_for(name)
        got = _filter_spec(spec, mesh, shape)
        want = j_filter_spec(j_default_rules().spec_for(name),
                             jmesh(**axes), shape)
        assert tuple(got) == tuple(want), (name, got, want)
        assert tuple(_filter_spec(spec, mesh)) == tuple(
            j_filter_spec(j_default_rules().spec_for(name), jmesh(**axes)))


def test_match_partition_rules_matches_jax():
    arrays = {k: types.SimpleNamespace(shape=s)
              for k, s in _flagship_shapes().items()}
    arrays["step"] = types.SimpleNamespace(shape=())
    arrays["bias1"] = types.SimpleNamespace(shape=(1, 1))
    got = match_partition_rules(default_rules(), arrays)
    want = j_match(j_default_rules(), arrays)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    pairs = [(r".*w.*", ("fsdp", None))]
    got = match_partition_rules(pairs, arrays)
    want = j_match([(r".*w.*", JP("fsdp", None))], arrays)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("name", list(cases.shard_arrays()))
def test_shard_and_gather_round_trip_matches_jax_shards(ranks, name):
    """Rank r's DTensor holds what JAX puts on device r; the gather gives
    the array back."""
    a = cases.shard_arrays()[name]
    mesh = jmesh(fsdp=2, tp=2)
    spec = j_filter_spec(j_match(j_default_rules(), {name: a})[name], mesh,
                         a.shape)
    placed = jax.device_put(a, NamedSharding(mesh.mesh, spec))
    shards = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    for r in range(WORLD):
        want = shards[jax.devices()[r]]
        np.testing.assert_array_equal(ranks[r]["shard.%s.local" % name], want)
        np.testing.assert_array_equal(ranks[r]["shard.%s.slice" % name], want)
        np.testing.assert_array_equal(ranks[r]["shard.%s.back" % name], a)


# -- ring attention ------------------------------------------------------------

def _dense(q, k, v, causal):
    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    T = q.shape[1]
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        s = np.where(np.tril(np.ones((T, T), bool)), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@functools.lru_cache(maxsize=None)
def jax_ring(causal, form):
    q, k, v, w = (jnp.asarray(a) for a in cases.ring_inputs())
    use_pallas = form == "kernel"
    with jmesh(sp=4):
        def f(q, k, v):
            return j_ring_self_attention(q, k, v, causal=causal,
                                         use_pallas=use_pallas)
        o = jax.jit(f)(q, k, v)
        grads = jax.jit(jax.grad(lambda q, k, v: (f(q, k, v) * w).sum(),
                                 (0, 1, 2)))(q, k, v)
    return np.asarray(o), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("form", ["stream", "kernel"])
def test_ring_attention_matches_jax_and_dense(ranks, causal, form):
    """sp=4: each rank's output and q / k / v gradients against the JAX
    ring on the same slice (its kernel form runs the blockwise block
    kernel on the CPU, ours the flash kernel's plain version), and the
    output against dense attention in float64."""
    o, grads = jax_ring(causal, form)
    dense = _dense(*cases.ring_inputs()[:3], causal)
    key = "ring.%s.%s" % (form, causal)
    for r in range(WORLD):
        sl = slice(8 * r, 8 * (r + 1))
        close(ranks[r][key + ".o"], o[:, sl], 2e-5)
        close(ranks[r][key + ".o"], dense[:, sl], 2e-5)
        for n, g in zip(("dq", "dk", "dv"), grads):
            close(ranks[r]["%s.%s" % (key, n)], g[:, sl], 5e-5, what=n)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [8, 12, 512])
def test_blockwise_attention_and_its_lse_match_jax(causal, block):
    """One rank, no mesh: the key-blocked streaming form with its
    logsumexp (a ragged last block at 12), against JAX's."""
    import torch

    from mxnet_tpu.parallel.ring_attention import (
        blockwise_attention as j_blockwise)
    from mxnet_tpu_torch.parallel import blockwise_attention

    q, k, v, _ = cases.ring_inputs()
    o, lse = blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 block_size=block, causal=causal,
                                 return_lse=True)
    jo, jlse = j_blockwise(*(jnp.asarray(a) for a in (q, k, v)),
                           block_size=block, causal=causal, return_lse=True)
    close(o.numpy(), jo, 2e-5)
    close(lse.numpy(), jlse, 2e-5)
    close(o.numpy(), _dense(q, k, v, causal), 2e-5)


def test_ring_self_attention_without_sp_is_blockwise_like_jax():
    import torch

    from mxnet_tpu_torch.parallel.ring_attention import ring_self_attention

    q, k, v, _ = cases.ring_inputs()
    got = ring_self_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    want = j_ring_self_attention(*(jnp.asarray(a) for a in (q, k, v)))
    close(got.numpy(), want, 2e-5)
    got = ring_self_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              use_pallas=True)
    close(got.numpy(), want, 2e-5)


# -- MoE -----------------------------------------------------------------------

@pytest.mark.parametrize("top_k,cf", cases.MOE_CASES)
def test_moe_layer_over_ep_matches_unsharded_jax(ranks, top_k, cf):
    """ep=2 × dp=2: each rank holds 2 of 4 experts; outputs, aux loss and
    gradients (experts': this rank's slice) against JAX's unsharded layer.
    ``cf=0.5`` drops tokens past capacity."""
    x, gate, up, down, w = (jnp.asarray(a) for a in cases.moe_inputs())

    def f(x, gate, up, down):
        y, aux = j_moe_layer(x, gate, up, down, top_k=top_k,
                             capacity_factor=cf)
        return (y * w).sum() + aux, (y, aux)

    grads, (y, aux) = jax.jit(jax.grad(f, (0, 1, 2, 3), has_aux=True))(
        x, gate, up, down)
    key = "moe.%d.%s" % (top_k, cf)
    for r in range(WORLD):
        e = slice(2 * (r % 2), 2 * (r % 2) + 2)
        close(ranks[r][key + ".y"], y, 2e-5)
        close(ranks[r][key + ".aux"], aux, 2e-5)
        close(ranks[r][key + ".dx"], grads[0], 5e-5)
        close(ranks[r][key + ".dgate"], grads[1], 5e-5)
        close(ranks[r][key + ".dup"], grads[2][e], 5e-5)
        close(ranks[r][key + ".ddown"], grads[3][e], 5e-5)


def test_moe_capacity_drops_tokens_in_both(ranks):
    """At capacity factor 0.5 some slots are dropped (zero rows in y)."""
    y = ranks[0]["moe.1.0.5.y"].reshape(-1, 16)
    assert (np.abs(y).sum(-1) == 0).any()


# -- pipelines -------------------------------------------------------------------

def test_gpipe_matches_jax_and_sequential(ranks):
    params, x, _, w = cases.pipe_inputs()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    M = x.shape[0]

    def loss(p, x):
        return (j_pipeline_spmd(cases.pipe_stage, p, x, M) * w).sum()

    def fwd(p, x):
        return j_pipeline_spmd(cases.pipe_stage, p, x, M)

    seq = np.asarray(jax.jit(fwd)(jp, jnp.asarray(x)))
    with jmesh(pp=4):
        y = np.asarray(jax.jit(fwd)(jp, jnp.asarray(x)))
        gp, gx = jax.jit(jax.grad(loss, (0, 1)))(jp, jnp.asarray(x))
    close(y, seq, 1e-6)
    for r in range(WORLD):
        close(ranks[r]["gpipe.y"], y, 2e-5)
        close(ranks[r]["gpipe.dx"], gx, 5e-5)
        for k in params:
            close(ranks[r]["gpipe.d%s" % k], gp[k], 5e-5, what=k)


@pytest.mark.parametrize("axes,dp_axis", cases.ONEF1B_MESHES,
                         ids=["pp4", "pp2xdp2"])
def test_1f1b_matches_jax_and_sequential(ranks, axes, dp_axis):
    params, x, tgt, _ = cases.pipe_inputs()
    jp = {k: jnp.asarray(v[:axes["pp"]]) for k, v in params.items()}
    M = x.shape[0]

    def run(p, x, t, dp_axis=None):
        return j_1f1b(cases.pipe_stage, cases.pipe_loss, p, x, t, M,
                      dp_axis=dp_axis)

    args = (jp, jnp.asarray(x), jnp.asarray(tgt))
    seq = jax.jit(run)(*args)
    with jmesh(**axes):
        loss, outs, grads = jax.jit(functools.partial(
            run, dp_axis=dp_axis))(*args)
    close(loss, seq[0], 1e-5)
    key = "1f1b.%s" % "x".join("%s%d" % kv for kv in axes.items())
    for r in range(WORLD):
        close(ranks[r][key + ".loss"], loss, 1e-6)
        close(ranks[r][key + ".outs"], outs, 2e-5)
        for k in params:
            close(ranks[r]["%s.d%s" % (key, k)], grads[k], 5e-5, what=k)
            close(ranks[r]["%s.d%s" % (key, k)], seq[2][k], 5e-5, what=k)


def test_backward_on_another_thread_keeps_the_mesh(ranks):
    """The sharded remat step with its backward run from a thread that
    never entered the mesh (as CUDA's device thread) gives the same
    gradients, bit for bit, as on the caller's thread."""
    names = sorted(k[len("thread.same."):] for k in ranks[0]
                   if k.startswith("thread.same."))
    assert names
    for r in range(WORLD):
        for k in names:
            np.testing.assert_array_equal(ranks[r]["thread.thread." + k],
                                          ranks[r]["thread.same." + k])
