"""The multi-rank training legs: the port of ``__graft_entry__._dryrun_impl``.

Each leg runs the sharded TransformerLM step (or a pipeline) on the world
of ranks it finds and holds it against the single-rank step on the same
parameters:

* ``dp×sp×tp`` — :func:`train_leg` with the ring over ``sp``;
* ``dp×fsdp×tp`` — the same with ``make_train_step(rules=default_rules())``
  and the ZeRO bytes check (:func:`zero_bytes_check`: this rank's bytes of
  parameters and velocity at most full / (fsdp·tp) × 1.5);
* ``pp`` — :func:`pp_leg`, a GPipe pipeline of the model's blocks, loss
  and gradients against the sequential stages;
* ``pp×tp`` — :func:`pp_tp_leg`, a tensor-parallel MLP stage in the
  pipeline;
* ``ep`` — :func:`train_leg` on the MoE model.

Losses must agree within ``1e-3 · max(1, |ref|)`` (:func:`assert_loss_parity`),
pp gradients within 1e-3 and pp×tp's within 1e-4, as in the JAX package's
dryrun; the train legs' gradients, which the JAX dryrun does not check,
within ``GRAD_REL`` of each one's largest entry.  Parameters are numpy arrays, the same on every rank; each rank
takes its shards of them.

Run it on 4 CPU ranks (the JAX dryrun's legs at its f32 size)::

    python -m mxnet_tpu_torch.tools.launch -n 4 --platform cpu -- \\
        python -m mxnet_tpu_torch.tools.dryrun
"""
from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
import torch

from .. import _dist
from ..models.transformer import (TransformerConfig, TransformerLM,
                                  default_rules, make_train_step,
                                  params_from_numpy)
from ..ops.kernels.common import reset_counts
from ..ops.kernels.layers import fused_softmax_xent
from ..parallel import collectives as C
from ..parallel import make_mesh, pipeline_spmd
from ..parallel.sharding import (auto_shard, gather, local_tensor, spec_of,
                                 zeros_like)

__all__ = ["assert_loss_parity", "axes_for", "numpy_params", "model_for",
           "single_step", "rel_to_max", "train_leg", "zero_bytes_check", "pp_leg",
           "pp_tp_leg", "run", "main"]

# the train legs' gradients against the single-rank step's, each within
# this of its largest entry (f32; not in the JAX dryrun, which holds the
# train legs by their loss alone)
GRAD_REL = 1e-5
DRYRUN_MODEL = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2,
                    d_ff=128, dtype="float32", remat=False)


def _require(cond, msg):
    if not cond:                # raised under ``python -O`` too
        raise AssertionError(msg)


def assert_loss_parity(loss, ref, leg):
    loss, ref = float(loss), float(ref)
    _require(np.isfinite(loss), "%s step produced nan" % leg)
    _require(abs(loss - ref) < 1e-3 * max(1.0, abs(ref)),
             "%s loss %r != reference %r" % (leg, loss, ref))


def axes_for(n):
    """Factor n ranks into (dp, sp, tp), sp and tp taking 2 each when they
    can (the JAX dryrun's ``_axes_for``)."""
    tp = 2 if n % 2 == 0 else 1
    rem = n // tp
    sp = 2 if rem % 2 == 0 else 1
    return rem // sp, sp, tp


def model_for(device, **cfg_kw):
    kw = dict(DRYRUN_MODEL)
    kw.update(cfg_kw)
    return TransformerLM(TransformerConfig(**kw), device=device)


def numpy_params(model, seed):
    """The JAX ``init``'s distribution drawn with numpy (f32; each matrix
    N(0, 1)/sqrt(fan_in), each norm scale 1), the same on every rank."""
    fan_in = model.fan_in()
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in model.named_parameters():
        if name in fan_in:
            w = rng.standard_normal(tuple(p.shape), dtype=np.float32)
            out[name] = w / np.float32(math.sqrt(fan_in[name]))
        else:
            out[name] = np.ones(tuple(p.shape), np.float32)
    return out


def _sync():
    if torch.cuda.is_available() and _dist.device().type == "cuda":
        torch.cuda.synchronize()


def _peak_reset():
    if _dist.device().type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak():
    if _dist.device().type == "cuda":
        return torch.cuda.max_memory_allocated()
    return None


def _as_torch(a):
    return torch.as_tensor(np.asarray(a), device=_dist.device())


def single_step(model, np_params, toks, tgts, lr=0.1, keep=False, steps=1,
                grads=False):
    """The meshless step on this rank's device: the oracle.  Returns the
    first step's loss, every step's (``losses``), the last of ``steps``
    steps' wall ms, with ``keep`` the parameters after the first step as
    numpy (f32), and with ``grads`` the gradients at the initial
    parameters (tensors on the device)."""
    P = params_from_numpy(np_params, _dist.device(), model.dtype)
    V = {k: torch.zeros_like(p) for k, p in P.items()}
    step = make_train_step(model, lr=lr)
    toks, tgts = _as_torch(toks), _as_torch(tgts)
    out = {"losses": []}
    if grads:
        out["grads"] = model.value_and_grad(P, toks, tgts)[1]
    for i in range(steps):
        _sync()
        t0 = time.perf_counter()
        loss = float(step(P, V, toks, tgts)[2])
        _sync()
        out["ms"] = (time.perf_counter() - t0) * 1e3
        out["losses"].append(loss)
        if i == 0:
            out["loss"] = loss
            if keep:
                out["params"] = {k: p.float().cpu().numpy()
                                 for k, p in P.items()}
    return out


def rel_to_max(got, want):
    """max |got − want| over max |want|, both taken in f32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def zero_bytes_check(params, velocity, factor):
    """The JAX dryrun's ZeRO proof on this rank: the bytes of its shards of
    every 2-D+ tensor, for parameters and velocity, at most the full bytes
    / ``factor`` × 1.5 (slack for replicated edges)."""
    out = {}
    for name, tree in (("params", params), ("velocity", velocity)):
        got = sum(local_tensor(v).numel() * v.element_size()
                  for v in tree.values() if v.ndim >= 2)
        full = sum(v.numel() * v.element_size()
                   for v in tree.values() if v.ndim >= 2)
        limit = full / factor * 1.5
        _require(got <= limit, "fsdp did not shrink %s memory: this rank "
                 "holds %d bytes of %d total (limit %d)"
                 % (name, got, full, limit))
        out[name] = {"rank_bytes": got, "full_bytes": full, "limit": limit}
    return out


def train_leg(name, model, np_params, toks, tgts, axes, rules=None, lr=0.1,
              ref=None, steps=1, zero_factor=None, keep=False,
              ref_losses=None, ref_grads=None, grad_rel=None):
    """``steps`` steps of the sharded model on a mesh of ``axes``
    (parameters placed by :func:`default_rules`), the first one's loss held
    to ``ref`` and, with ``ref_losses`` (the single-rank step's), every
    step's to its own by :func:`assert_loss_parity`.  With ``ref_grads``
    (the single-rank gradients at the same parameters) the sharded
    gradients are gathered whole first and each held within ``grad_rel``
    of its largest entry (:func:`rel_to_max`).  Returns a record: losses,
    the last step's wall ms, this rank's peak device bytes (None on the
    CPU), the host-staged gloo ops, the gradients' errors; with ``keep``
    the updated parameters gathered whole (numpy f32)."""
    toks, tgts = _as_torch(toks), _as_torch(tgts)
    with make_mesh(**axes) as mesh:
        full = params_from_numpy(np_params, _dist.device(), model.dtype)
        params = auto_shard(full, default_rules(), mesh)
        del full
        velocity = {k: zeros_like(v) for k, v in params.items()}
        step = make_train_step(model, lr=lr, rules=rules)
        grad_rel_to_max = None
        if ref_grads is not None:
            grads = model.value_and_grad(params, toks, tgts)[1]
            grad_rel_to_max = {
                k: rel_to_max(gather(g, spec_of(params[k]), mesh),
                              ref_grads[k]) for k, g in grads.items()}
            del grads
        losses, ms = [], None
        C.reset_host_staged()
        for _ in range(steps):
            _sync()
            _peak_reset()
            t0 = time.perf_counter()
            params, velocity, loss = step(params, velocity, toks, tgts)
            losses.append(float(loss))
            _sync()
            ms = (time.perf_counter() - t0) * 1e3
        rec = {"leg": name, "axes": dict(mesh.shape), "losses": losses,
               "ms": ms, "peak_bytes": _peak(),
               "host_staged": C.host_staged_counts()}
        if ref is not None:
            rec["ref_loss"] = ref
            rec["loss_diff"] = losses[0] - ref
            assert_loss_parity(losses[0], ref, name)
        if ref_losses is not None:
            rec["ref_losses"] = list(ref_losses)
            rec["loss_diffs"] = [a - b for a, b in zip(losses, ref_losses)]
            for i, (a, b) in enumerate(zip(losses, ref_losses)):
                assert_loss_parity(a, b, "%s step %d" % (name, i + 1))
        if grad_rel_to_max is not None:
            worst = max(grad_rel_to_max, key=grad_rel_to_max.get)
            rec["grad_rel_to_max"] = grad_rel_to_max
            rec["grad_max_rel_to_max"] = grad_rel_to_max[worst]
            if grad_rel is not None:
                rec["grad_rel_tol"] = grad_rel
                _require(grad_rel_to_max[worst] <= grad_rel,
                         "%s gradient of %s is %g of its largest entry off "
                         "the single-rank one (bound %g)"
                         % (name, worst, grad_rel_to_max[worst], grad_rel))
        if zero_factor is not None:
            rec["zero"] = zero_bytes_check(params, velocity, zero_factor)
        if keep:
            rec["params"] = {
                k: gather(local_tensor(v), spec_of(v), mesh).float().cpu()
                .numpy() for k, v in params.items()}
    return rec


def _pp_loss(model, stacked, other, toks, tgts, M, mb):
    """The JAX dryrun's ``pp_loss``: embed, the blocks as a GPipe pipeline
    of M microbatches of mb, the final norm, the logits and the mean
    cross-entropy (the fused kernel: the same function)."""
    x = other["embed"][toks]
    B, T, E = x.shape

    def stage(bp, h):
        return model._block({"blocks." + k: v[None] for k, v in bp.items()},
                            0, h)[0]

    h = pipeline_spmd(stage, stacked, x.reshape(M, mb, T, E), M)
    h = model._rmsnorm(h.reshape(B, T, E), other["final_ln_scale"])
    logits = torch.matmul(h.float(), other["unembed"].float())
    return fused_softmax_xent(logits, tgts).mean()


def _value_and_grad(fn, *trees):
    leaves = [{k: v.detach().requires_grad_(True) for k, v in t.items()}
              for t in trees]
    loss = fn(*leaves)
    flat = [v for t in leaves for v in t.values()]
    grads = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), [{k: next(grads) for k in t} for t in leaves]


def pp_leg(model, np_params, toks, tgts, M, mb, axes, atol=1e-3, rtol=1e-3,
           grad_rel=None, keep=False):
    """The pipeline leg: loss and gradients of :func:`_pp_loss` on a mesh
    of ``axes`` against the same stages run in order (no mesh), loss to
    :func:`assert_loss_parity` and every gradient within ``atol`` /
    ``rtol`` elementwise, or, with ``grad_rel``, within ``grad_rel`` of
    its largest entry (a bf16 model: its gradients add per microbatch in
    bf16).  The kernel counters are zeroed before the pipelined step, so
    they count it alone.  Returns a record (with ``keep``, the gradients as
    numpy)."""
    full = params_from_numpy(np_params, _dist.device(), model.dtype)
    stacked = {k.split(".", 1)[1]: v for k, v in full.items()
               if k.startswith("blocks.")}
    other = {k: v for k, v in full.items() if not k.startswith("blocks.")}
    toks, tgts = _as_torch(toks), _as_torch(tgts)

    def f(s, o):
        return _pp_loss(model, s, o, toks, tgts, M, mb)

    ref_loss, ref_grads = _value_and_grad(f, stacked, other)
    with make_mesh(**axes) as mesh:
        reset_counts()                  # the counters: the pipelined step
        C.reset_host_staged()
        _sync()
        _peak_reset()
        t0 = time.perf_counter()
        loss, grads = _value_and_grad(f, stacked, other)
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"leg": "pp", "axes": dict(mesh.shape), "losses": [float(loss)],
               "ref_loss": float(ref_loss),
               "loss_diff": float(loss) - float(ref_loss), "ms": ms,
               "peak_bytes": _peak(), "host_staged": C.host_staged_counts()}
    assert_loss_parity(loss, ref_loss, "pp")
    worst, worst_rel = 0.0, 0.0
    for got_t, want_t in zip(grads, ref_grads):
        for k in want_t:
            got, want = got_t[k].float(), want_t[k].float()
            diff = (got - want).abs()
            worst = max(worst, float(diff.max()))
            rel = rel_to_max(got, want)
            worst_rel = max(worst_rel, rel)
            if grad_rel is None:
                ok = bool((diff <= atol + rtol * want.abs()).all())
            else:
                ok = rel <= grad_rel
            _require(ok, "pp grad mismatch for %s" % k)
    rec["grad_max_abs_err"] = worst
    rec["grad_max_rel_to_max"] = worst_rel
    if keep:
        rec["grads"] = {k: v.float().cpu().numpy()
                        for t in grads for k, v in t.items()}
    return rec


def pp_tp_params():
    """The JAX dryrun's pp×tp stage parameters and data (numpy, seed 7)."""
    P2, E2, F2, M2, mb2 = 4, 16, 32, 4, 2
    r = np.random.RandomState(7)
    tpp = {"w1": r.randn(P2, E2, F2).astype(np.float32) * .1,
           "b1": r.randn(P2, F2).astype(np.float32) * .1,
           "w2": r.randn(P2, F2, E2).astype(np.float32) * .1}
    x2 = r.randn(M2, mb2, E2).astype(np.float32)
    t2 = r.randn(M2, mb2, E2).astype(np.float32)
    return tpp, x2, t2


def pp_tp_leg(tpp, x2, t2, axes, keep=False):
    """pp×tp: a column-parallel ``w1`` / row-parallel ``w2`` stage (each tp
    rank its slice, a psum over tp) in the pipeline, against the full-weight
    stage in order; loss by :func:`assert_loss_parity`, gradients within
    1e-4."""
    ntp = axes.get("tp", 1)
    M2 = x2.shape[0]
    F2 = tpp["w1"].shape[-1]

    def tp_stage(p, h):
        c = F2 // ntp
        k = C.axis_index("tp")
        w1 = p["w1"][:, k * c:(k + 1) * c]
        b1 = p["b1"][k * c:(k + 1) * c]
        w2 = p["w2"][k * c:(k + 1) * c]
        return C.allreduce(torch.tanh(h @ w1 + b1) @ w2, "tp")

    def full_stage(p, h):
        return torch.tanh(h @ p["w1"] + p["b1"]) @ p["w2"]

    def loss_of(stage):
        def f(params, xm, tm):
            return ((pipeline_spmd(stage, params, xm, M2) - tm) ** 2).mean()
        return f

    # the first pp of the dryrun's four stages
    params = {k: _as_torch(v[:axes["pp"]]) for k, v in tpp.items()}
    xm, tm = _as_torch(x2), _as_torch(t2)
    ref_loss, (ref_grads,) = _value_and_grad(
        lambda p: loss_of(full_stage)(p, xm, tm), params)
    with make_mesh(**axes) as mesh:
        loss, (grads,) = _value_and_grad(
            lambda p: loss_of(tp_stage)(p, xm, tm), params)
        rec = {"leg": "pp×tp", "axes": dict(mesh.shape),
               "losses": [float(loss)], "ref_loss": float(ref_loss),
               "loss_diff": float(loss) - float(ref_loss)}
    assert_loss_parity(loss, ref_loss, "pp×tp")
    worst = 0.0
    for k in ref_grads:
        err = (grads[k] - ref_grads[k]).abs()
        worst = max(worst, float(err.max()))
        _require(bool((err <= 1e-4 + 1e-4 * ref_grads[k].abs()).all()),
                 "pp×tp grad mismatch for %s" % k)
    rec["grad_max_abs_err"] = worst
    if keep:
        rec["grads"] = {k: v.cpu().numpy() for k, v in grads.items()}
    return rec


def run(n=None):
    """The JAX dryrun's legs on this world (n ranks) at its f32 size, each
    against the single-rank step; yields one record per leg."""
    n = n or _dist.world_size()
    device = _dist.device()
    toks = np.random.RandomState(0).randint(0, 128, (8, 16))
    tgts = np.roll(toks, -1, axis=1)
    model = model_for(device)
    params = numpy_params(model, 0)
    one = single_step(model, params, toks, tgts, grads=True)
    ref, grads = one["loss"], one["grads"]
    dp, sp, tp = axes_for(n)
    yield train_leg("dp/sp/tp", model, params, toks, tgts,
                    dict(dp=dp, sp=sp, tp=tp), ref=ref, ref_grads=grads,
                    grad_rel=GRAD_REL)
    fsdp = 2 if n % 2 == 0 else 1
    tp2 = 2 if (n // fsdp) % 2 == 0 else 1
    yield train_leg("dp/fsdp/tp", model, params, toks, tgts,
                    dict(dp=n // (fsdp * tp2), fsdp=fsdp, tp=tp2),
                    rules=default_rules(), ref=ref,
                    zero_factor=fsdp * tp2, ref_grads=grads,
                    grad_rel=GRAD_REL)
    pp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    ppm = model_for(device, n_layers=pp)
    yield pp_leg(ppm, numpy_params(ppm, 1), toks, tgts, 4, 2,
                 dict(pp=pp, dp=n // pp))
    if n % 4 == 0:
        yield pp_tp_leg(*pp_tp_params(), dict(pp=n // 2, tp=2))
    ep = 2 if n % 2 == 0 else 1
    moe = model_for(device, use_moe=True, n_experts=max(2, ep))
    moe_params = numpy_params(moe, 2)
    one = single_step(moe, moe_params, toks, tgts, grads=True)
    yield train_leg("ep", moe, moe_params, toks, tgts,
                    dict(ep=ep, dp=n // ep), ref=one["loss"],
                    ref_grads=one["grads"], grad_rel=GRAD_REL)


def main(argv=None):
    del argv
    _dist.ensure_initialized("cpu" if not torch.cuda.is_available()
                             else None)
    for rec in run():
        if _dist.rank() == 0:
            print(json.dumps(rec), flush=True)
    if _dist.rank() == 0:
        print("dryrun ok on %d rank(s)" % _dist.world_size(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
