"""One rank of the port's multi-rank parity tests, started on the CPU by
``python -m mxnet_tpu_torch.tools.launch -n 4 --platform cpu``.

``python torch_port_parallel_worker.py OUT_DIR SUITE`` runs every case of
SUITE on this rank and saves what it computed to
``OUT_DIR/SUITE_rank<r>.npz`` (``ops``: the collectives and their
gradients, the shard / gather round trip, ring attention, ``moe_layer``,
the pipelines; ``dryrun``: the dryrun's legs on the JAX parameters in
``OUT_DIR/params_<leg>.npz``).  The tests compute the same cases with the
JAX package and compare.  Inputs come from numpy seeds shared with the
tests (:mod:`torch_port_parallel_cases`).  Imports no JAX.
"""
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import mxnet_tpu_torch  # noqa: E402,F401  (joins the launcher's group)
import torch_port_parallel_cases as cases  # noqa: E402
from mxnet_tpu_torch import _dist  # noqa: E402
from mxnet_tpu_torch.parallel import collectives as C  # noqa: E402
from mxnet_tpu_torch.parallel import (make_mesh, moe_layer,  # noqa: E402
                                      pipeline_spmd, pipeline_train_1f1b,
                                      ring_attention)
from mxnet_tpu_torch.parallel.sharding import (  # noqa: E402
    PartitionSpec as P, local_shard, make_shard_and_gather_fns,
    match_partition_rules)


def t(a, grad=False):
    x = torch.as_tensor(np.asarray(a)).clone()
    return x.requires_grad_(True) if grad else x


def npy(x):
    return x.detach().float().numpy()


def collectives(out):
    r = _dist.rank()
    X, W = cases.coll_inputs()
    with make_mesh(dp=2, tp=2):
        for name, fn in cases.COLLECTIVES.items():
            x = t(X[r], grad=True)
            y = fn(C, x)
            (y * t(W[name][r])).sum().backward()
            out["coll.%s.y" % name] = npy(y)
            out["coll.%s.dx" % name] = npy(x.grad)
        for name, fn in cases.FORWARD_ONLY.items():
            out["fwd.%s.y" % name] = npy(fn(C, t(X[r])))
        out["coll.axis_index"] = np.array([C.axis_index("dp"),
                                           C.axis_index("tp")])
        # the shard_map boundary: an operand replicated over the mesh, a
        # replicated result
        w, x = t(cases.REGION_W, grad=True), t(X[r], grad=True)
        axes = ("dp", "tp")
        y = C.region_out(C.allreduce(C.region_in(w, axes) * x, axes), axes)
        (y ** 2).sum().backward()
        out["region.y"] = npy(y)
        out["region.dw"] = npy(w.grad)
        out["region.dx"] = npy(x.grad)


def meshes(out):
    """make_mesh's sizes (or its error) for each case; mesh_slices' groups
    of ranks and local_mesh; the thread-local stack."""
    import json

    from mxnet_tpu_torch.parallel import (current_mesh, local_mesh,
                                          mesh_slices)

    res = []
    for kw in cases.MESH_CASES:
        try:
            res.append(make_mesh(**kw).shape)
        except ValueError as e:
            res.append({"error": type(e).__name__, "msg": str(e)})
    out["mesh.make"] = np.array(json.dumps(res))
    sl = []
    for kw in cases.SLICE_CASES:
        sl.append([{"shape": m.shape,
                    "ranks": m.mesh.mesh.flatten().tolist()}
                   for m in mesh_slices(**kw)])
    out["mesh.slices"] = np.array(json.dumps(sl))
    lm = local_mesh()
    a, b = make_mesh(dp=4), make_mesh(tp=4)
    stack = [current_mesh() is None]
    with a:
        with b:
            stack.append(current_mesh() is b)
        stack.append(current_mesh() is a)
    stack.append(current_mesh() is None)
    out["mesh.local"] = np.array([lm.size(), lm.mesh.mesh.flatten()[0]])
    out["mesh.stack"] = np.array(stack)


def sharding(out):
    from mxnet_tpu_torch.models.transformer import default_rules

    arrays = cases.shard_arrays()
    with make_mesh(fsdp=2, tp=2) as mesh:
        specs = match_partition_rules(default_rules(), arrays)
        shard_fns, gather_fns = make_shard_and_gather_fns(specs, mesh)
        for name, a in arrays.items():
            d = shard_fns[name](a)
            out["shard.%s.local" % name] = npy(d.to_local())
            out["shard.%s.back" % name] = gather_fns[name](d)
            out["shard.%s.slice" % name] = npy(local_shard(t(a), specs[name],
                                                           mesh))


def ring(out):
    q, k, v, w = cases.ring_inputs()
    with make_mesh(sp=4):
        spec = P(None, "sp")
        for causal in (True, False):
            for form in ("stream", "kernel"):
                lq, lk, lv = (local_shard(t(a), spec).clone().requires_grad_()
                              for a in (q, k, v))
                o = ring_attention(lq, lk, lv, "sp", causal=causal,
                                   use_pallas=(form == "kernel"))
                (o * local_shard(t(w), spec)).sum().backward()
                key = "ring.%s.%s" % (form, causal)
                out[key + ".o"] = npy(o)
                for n, g in (("dq", lq), ("dk", lk), ("dv", lv)):
                    out["%s.%s" % (key, n)] = npy(g.grad)


def moe(out):
    with make_mesh(ep=2, dp=2):
        axes = ("dp", "ep")
        for top_k, cf in cases.MOE_CASES:
            x, gate, up, down, w = cases.moe_inputs()
            leaves = [t(a, grad=True) for a in
                      (x, gate, local_shard(t(up), P("ep")),
                       local_shard(t(down), P("ep")))]
            ins = [C.region_in(leaves[0], axes), C.region_in(leaves[1], axes),
                   C.region_in(leaves[2], ("dp",)),
                   C.region_in(leaves[3], ("dp",))]
            y, aux = moe_layer(*ins, top_k=top_k, capacity_factor=cf)
            loss = C.region_out((y * t(w)).sum() + aux, axes)
            loss.backward()
            key = "moe.%d.%s" % (top_k, cf)
            out[key + ".y"] = npy(y)
            out[key + ".aux"] = npy(aux)
            for n, g in zip(("dx", "dgate", "dup", "ddown"), leaves):
                out["%s.%s" % (key, n)] = npy(g.grad)


def pipelines(out):
    params, x, tgt, w = cases.pipe_inputs()
    M = x.shape[0]
    with make_mesh(pp=4):
        leaves = {k: t(v, grad=True) for k, v in params.items()}
        xs = t(x, grad=True)
        y = pipeline_spmd(cases.pipe_stage, leaves, xs, M)
        (y * t(w)).sum().backward()
        out["gpipe.y"] = npy(y)
        out["gpipe.dx"] = npy(xs.grad)
        for k, v in leaves.items():
            out["gpipe.d%s" % k] = npy(v.grad)
    for axes, dp_axis in cases.ONEF1B_MESHES:
        with make_mesh(**axes):
            loss, outs, grads = pipeline_train_1f1b(
                cases.pipe_stage, cases.pipe_loss,
                {k: t(v[:axes["pp"]]) for k, v in params.items()}, t(x),
                t(tgt), M,
                dp_axis=dp_axis)
        key = "1f1b.%s" % "x".join("%s%d" % kv for kv in axes.items())
        out[key + ".loss"] = npy(loss)
        out[key + ".outs"] = npy(outs)
        for k, g in grads.items():
            out["%s.d%s" % (key, k)] = npy(g)


def backward_thread(out):
    """Autograd runs a CUDA backward on the device's own thread, where the
    caller's mesh is not current: the same step with its backward (and
    the remat recomputation in it) run from a fresh thread."""
    import threading

    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM,
                                                    _plan_for)
    from mxnet_tpu_torch.tools import dryrun as dr

    toks, tgts = (t(a) for a in cases.dryrun_tokens())
    model = TransformerLM(TransformerConfig(**dict(
        dr.DRYRUN_MODEL, remat=True)), device="cpu")
    full = {k: v.detach() for k, v in model.named_parameters()}
    for where in ("same", "thread"):
        with make_mesh(dp=1, sp=2, tp=2) as mesh:
            from mxnet_tpu_torch.parallel.sharding import auto_shard
            P_ = auto_shard(full, dr.default_rules(), mesh)
            plan = _plan_for(model, P_, toks.shape)
            leaves = {k: v.to_local().detach().requires_grad_(True)
                      for k, v in P_.items()}
            loss = plan.leave(model._loss(plan.enter(leaves), toks, tgts,
                                          plan))
        box = {}

        def back():
            box["g"] = torch.autograd.grad(loss, list(leaves.values()))

        if where == "same":
            with mesh:
                back()
        else:
            th = threading.Thread(target=back)
            th.start()
            th.join()
        for k, g in zip(leaves, box["g"]):
            out["thread.%s.%s" % (where, k)] = npy(g)


def dryrun(out, d):
    from mxnet_tpu_torch.tools import dryrun as dr

    toks, tgts = cases.dryrun_tokens()
    dev = _dist.device()
    model = dr.model_for(dev)
    p = dict(np.load(os.path.join(d, "params_dense.npz")))
    ref = dr.single_step(model, p, toks, tgts, keep=True, grads=True)
    out["ref.loss"] = np.array(ref["loss"])
    for leg, axes, rules in cases.DRYRUN_TRAIN_LEGS:
        rec = dr.train_leg(leg, model, p, toks, tgts, axes,
                           rules=dr.default_rules() if rules else None,
                           ref=ref["loss"], keep=True,
                           zero_factor=(axes.get("fsdp", 1) * axes.get("tp", 1)
                                        if rules else None),
                           ref_grads=ref["grads"], grad_rel=dr.GRAD_REL)
        out["%s.loss" % leg] = np.array(rec["losses"][0])
        for k, v in rec["params"].items():
            out["%s.param.%s" % (leg, k)] = v
        if "zero" in rec:
            out["%s.zero" % leg] = np.array(
                [rec["zero"]["params"]["rank_bytes"],
                 rec["zero"]["velocity"]["rank_bytes"],
                 rec["zero"]["params"]["full_bytes"]])
    ppm = dr.model_for(dev, n_layers=4)
    rec = dr.pp_leg(ppm, dict(np.load(os.path.join(d, "params_pp.npz"))),
                    toks, tgts, 4, 2, dict(pp=4), keep=True)
    out["pp.loss"] = np.array(rec["losses"][0])
    out["pp.ref_loss"] = np.array(rec["ref_loss"])
    for k, v in rec["grads"].items():
        out["pp.grad.%s" % k] = v
    rec = dr.pp_tp_leg(*dr.pp_tp_params(), dict(pp=2, tp=2), keep=True)
    out["pptp.loss"] = np.array(rec["losses"][0])
    for k, v in rec["grads"].items():
        out["pptp.grad.%s" % k] = v
    moe = dr.model_for(dev, use_moe=True, n_experts=2)
    pm = dict(np.load(os.path.join(d, "params_moe.npz")))
    ref_moe = dr.single_step(moe, pm, toks, tgts)["loss"]
    rec = dr.train_leg("ep", moe, pm, toks, tgts, dict(ep=2, dp=2),
                       ref=ref_moe, keep=True)
    out["ep.loss"] = np.array(rec["losses"][0])
    out["ep.ref_loss"] = np.array(ref_moe)
    for k, v in rec["params"].items():
        out["ep.param.%s" % k] = v
    routing(out, d)


def routing(out, d):
    """The attention routing legs (:data:`cases.ROUTING_LEGS`): one step
    each against the single-rank one, with the kernel selections of the
    sharded gradient and step alone."""
    from mxnet_tpu_torch.ops.kernels import common
    from mxnet_tpu_torch.tools import dryrun as dr

    dev = _dist.device()
    for leg, cfg, axes, tok in cases.ROUTING_LEGS:
        toks, tgts = cases.routing_tokens(*tok)
        model = dr.model_for(dev, **cfg)
        p = dict(np.load(os.path.join(d, "params_%s.npz" % leg)))
        ref = dr.single_step(model, p, toks, tgts, grads=True)
        common.reset_counts()
        rec = dr.train_leg(leg, model, p, toks, tgts, axes, ref=ref["loss"],
                           keep=True, ref_grads=ref["grads"],
                           grad_rel=dr.GRAD_REL)
        sel = common.selection_counts()
        out["%s.loss" % leg] = np.array(rec["losses"][0])
        out["%s.flash_selects" % leg] = np.array(
            [sel.get("kernels.select.flash_attention.reference", 0),
             sel.get("kernels.select.flash_attention_bwd.reference", 0)])
        for k, v in rec["params"].items():
            out["%s.param.%s" % (leg, k)] = v


def main(out_dir, suite):
    out = {}
    if suite == "ops":
        collectives(out)
        meshes(out)
        sharding(out)
        ring(out)
        moe(out)
        pipelines(out)
        backward_thread(out)
    elif suite == "dryrun":
        dryrun(out, out_dir)
    else:
        raise SystemExit("unknown suite %r" % suite)
    np.savez(os.path.join(out_dir, "%s_rank%d.npz" % (suite, _dist.rank())),
             **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
