"""Cases shared by the multi-rank parity tests and their rank processes
(``torch_port_parallel_worker.py``): numpy inputs from fixed seeds, and
functions written once for both packages (their collectives modules have
the same names; the array code runs on torch tensors and JAX arrays
alike)."""
import numpy as np

# per-rank operand [4, 6]; the mesh is dp=2 × tp=2, rank = 2·dp + tp
COLLECTIVES = {
    "psum_tp": lambda C, x: C.allreduce(x, "tp"),
    "psum_dp_tp": lambda C, x: C.allreduce(x, ("dp", "tp")),
    "pmean_dp": lambda C, x: C.pmean(x, "dp"),
    "psum_of_square": lambda C, x: C.allreduce(x * x, "tp") * x,
    "allgather_tp_0": lambda C, x: C.allgather(x, "tp", axis=0),
    "allgather_dp_1": lambda C, x: C.allgather(x, "dp", axis=1),
    "reduce_scatter_tp_0": lambda C, x: C.reduce_scatter(x, "tp", axis=0),
    "reduce_scatter_dp_1": lambda C, x: C.reduce_scatter(x, "dp", axis=1),
    "ppermute_tp_+1": lambda C, x: C.ppermute_shift(x, "tp", 1),
    "ppermute_dp_-1": lambda C, x: C.ppermute_shift(x, "dp", -1),
    "all_to_all_tp": lambda C, x: C.all_to_all(x, "tp", 0, 1),
    "broadcast_dp_1": lambda C, x: C.broadcast(x, "dp", src=1),
}
# max / min carry no gradient (as in JAX): forward only
FORWARD_ONLY = {
    "pmax_tp": lambda C, x: C.allreduce(x, "tp", op="max"),
    "pmin_dp_tp": lambda C, x: C.allreduce(x, ("dp", "tp"), op="min"),
    "allreduce_mean_dp": lambda C, x: C.allreduce(x, "dp", op="mean"),
    "allgather_untiled_tp": lambda C, x: C.allgather(x, "tp", axis=0,
                                                     tiled=False),
}
OUT_SHAPES = {"allgather_tp_0": (8, 6), "allgather_dp_1": (4, 12),
              "reduce_scatter_tp_0": (2, 6), "reduce_scatter_dp_1": (4, 3),
              "all_to_all_tp": (2, 12)}
REGION_W = np.random.RandomState(11).randn(4, 6).astype(np.float32)


def coll_inputs():
    """X [4 ranks, 4, 6] and each case's cotangents [4 ranks, *out]."""
    X = np.random.RandomState(10).randn(4, 4, 6).astype(np.float32)
    W = {}
    for i, name in enumerate(COLLECTIVES):
        shape = OUT_SHAPES.get(name, (4, 6))
        W[name] = np.random.RandomState(100 + i).randn(
            4, *shape).astype(np.float32)
    return X, W


def shard_arrays():
    """A small model's parameter shapes (and a vocab of 97, which tp=2 does
    not divide, and a scalar) as numpy arrays."""
    shapes = {"embed": (128, 64), "blocks.wqkv": (2, 64, 192),
              "blocks.wo": (2, 64, 64), "blocks.w_up": (2, 64, 128),
              "blocks.w_down": (2, 128, 64), "unembed": (64, 97),
              "blocks.ln1_scale": (2, 64), "final_ln_scale": (64,),
              "blocks.gate": (2, 64, 4), "blocks.moe_up": (2, 4, 64, 128),
              "blocks.moe_down": (2, 4, 128, 64), "step": ()}
    r = np.random.RandomState(12)
    return {k: np.asarray(r.randn(*s), np.float32) for k, s in shapes.items()}


def ring_inputs():
    r = np.random.RandomState(13)
    return tuple(r.randn(2, 32, 4, 8).astype(np.float32) for _ in range(4))


MOE_CASES = ((1, 1.25), (2, 1.25), (1, 0.5), (2, 0.5))


def moe_inputs():
    r = np.random.RandomState(14)
    return (r.randn(2, 8, 16).astype(np.float32),
            (r.randn(16, 4) * 0.5).astype(np.float32),
            (r.randn(4, 16, 32) * 0.2).astype(np.float32),
            (r.randn(4, 32, 16) * 0.2).astype(np.float32),
            r.randn(2, 8, 16).astype(np.float32))


def pipe_inputs():
    """Stacked stage parameters for 4 stages, x and targets [M=8, mb=2, 16],
    and the output's cotangent."""
    r = np.random.RandomState(15)
    params = {"w": (r.randn(4, 16, 16) * 0.3).astype(np.float32),
              "b": (r.randn(4, 16) * 0.1).astype(np.float32)}
    return (params, r.randn(8, 2, 16).astype(np.float32),
            r.randn(8, 2, 16).astype(np.float32),
            r.randn(8, 2, 16).astype(np.float32))


def pipe_stage(p, h):
    z = h @ p["w"] + p["b"]
    return z / (1 + abs(z))             # softsign: no framework call


def pipe_loss(y, t):
    return ((y - t) ** 2).sum()


# (mesh axes, dp_axis) of the 1F1B cases; each takes the first pp stages
ONEF1B_MESHES = ((dict(pp=4), None), (dict(pp=2, dp=2), "dp"))


def dryrun_tokens():
    toks = np.random.RandomState(0).randint(0, 128, (8, 16))
    return toks, np.roll(toks, -1, axis=1)


# (leg, mesh axes, rules=default_rules()) of the dryrun's train legs at 4
DRYRUN_TRAIN_LEGS = (("dp_sp_tp", dict(dp=1, sp=2, tp=2), False),
                     ("dp_fsdp_tp", dict(dp=1, fsdp=2, tp=2), True))


# The mesh path's attention routing at 4 ranks, each leg (model config
# overrides, mesh axes, tokens' seed and shape):
# * heads3_tp2: 3 heads at tp=2 (do not divide), past the dense gate: each
#   rank holds every head and runs the flash kernel on them (JAX's wrapper
#   falls back to the blockwise form there; the math is the same);
# * b2_dp4: a batch of 2 at dp=4 (does not divide): each rank holds the
#   whole batch, so the gate reads B·H·T²·4 = 0.52 MB under its 1 MB and
#   stays dense, as the meshless model does (the batch counted dp times
#   over would read 2.1 MB and take flash).
ROUTING_LEGS = (
    ("heads3_tp2", dict(d_model=48, n_heads=3, dense_attn_max_score_mb=0),
     dict(dp=2, tp=2), (0, 8, 16)),
    ("b2_dp4", dict(dense_attn_max_score_mb=1), dict(dp=4), (1, 2, 128)),
)


def routing_tokens(seed, B, T):
    toks = np.random.RandomState(seed).randint(0, 128, (B, T))
    return toks, np.roll(toks, -1, axis=1)


# make_mesh on 4 ranks / devices: the mesh's axis sizes, or the error
MESH_CASES = (dict(tp=2), dict(dp=2, tp=2), dict(sp=4), dict(pp=2, sp=2),
              dict(), dict(dp=1, tp=2, sp=2), dict(tp=3), dict(dp=2, tp=1),
              dict(ep=2, fsdp=2), dict(bogus=2))
SLICE_CASES = (dict(tp=2), dict(tp=3), dict(sp=2, tp=2), dict(dp=1))
