"""Pipeline parallelism: the port of ``mxnet_tpu/parallel/pipeline.py``.

The stages are the ranks of mesh axis ``pp``; rank p runs stage p.  With P
stages and M microbatches, at step t stage p works on microbatch t − p
when 0 <= t − p < M, and activations move one hop down the pipeline each
step (:func:`.collectives.ppermute_shift`).  In per-rank code a stage
skips the steps on which it has no microbatch (the JAX program computes
them and masks the result); the sends still run every step.

Parameters come stacked on a leading stage dimension ``[P, ...]``, the
same full arrays on every rank; each rank uses its own stage's slice.  The
functions are regions in the sense of :func:`.collectives.region_in`: the
parameters' and the input's gradients sum over the mesh, the output's
cotangent is divided by its size, so ``autograd.grad`` of a loss of the
output gives every rank the whole gradient, as ``jax.grad`` of the
``shard_map``-ed function does.

Constraint: a stage maps activations to activations of the same shape and
dtype (transformer blocks do).
"""
from __future__ import annotations

import torch

from .collectives import (allgather, allreduce, axis_index, axis_size,
                          ppermute_shift, region_in, region_out)
from .mesh import current_mesh

__all__ = ["pipeline_spmd", "pipeline_train_1f1b", "bubble_fraction"]


def bubble_fraction(n_stages, num_microbatches, schedule="1f1b"):
    """Idle share of the schedule: GPipe (P-1)/(M+P-1) a wave; 1F1B
    (2P-2)/(M+2P-2)."""
    P, M = n_stages, num_microbatches
    if schedule == "gpipe":
        return (P - 1) / (M + P - 1)
    if schedule == "1f1b":
        return (2 * P - 2) / (M + 2 * P - 2)
    raise ValueError("unknown schedule %r" % (schedule,))


def _stage(params, i):
    return {k: v[i] for k, v in params.items()}


def _sequential(stage_fn, stacked_params, mb):
    h = mb
    for i in range(next(iter(stacked_params.values())).shape[0]):
        h = stage_fn(_stage(stacked_params, i), h)
    return h


def pipeline_spmd(stage_fn, stacked_params, x, num_microbatches, mesh=None,
                  pp_axis="pp"):
    """Run ``stage_fn(params, act) -> act`` as a P-stage GPipe pipeline.

    stacked_params: dict of tensors with leading dim P (stage i's at index
    i).  x: [M, mb, ...].  Returns the last stage's outputs [M, mb, ...]
    on every rank.  Without a ``pp`` axis the stages run in order on each
    microbatch: the same math."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.size(pp_axis) == 1:
        return torch.stack([_sequential(stage_fn, stacked_params, x[i])
                            for i in range(x.shape[0])])
    with mesh:
        axes = mesh.axis_names
        names = list(stacked_params)
        values = [region_in(stacked_params[k], axes) for k in names]
        out = _GPipe.apply(stage_fn, num_microbatches, pp_axis, names,
                           region_in(x, axes), *values)
        return region_out(out, axes)


class _GPipe(torch.autograd.Function):
    """The GPipe schedule with its backward written out: the backward runs
    the schedule in reverse, one reverse send per step on every rank (so
    every rank meets its neighbours in the same order), recomputing each
    stage's forward from its saved input.  The output is the last stage's,
    summed over ``pp`` (the JAX program's masked psum)."""

    @staticmethod
    def forward(ctx, stage_fn, M, pp_axis, names, x, *values):
        P, my = axis_size(pp_axis), axis_index(pp_axis)
        params = {k: v[my] for k, v in zip(names, values)}
        state = torch.zeros_like(x[0])
        outs = torch.zeros_like(x)
        inputs = {}
        with torch.no_grad():
            for t in range(M + P - 1):
                recv = ppermute_shift(state, pp_axis, 1)
                if 0 <= t - my < M:
                    inputs[t] = x[t] if my == 0 else recv
                    state = stage_fn(params, inputs[t])
                else:
                    state = torch.zeros_like(recv)
                if my == P - 1 and t >= P - 1:
                    outs[t - (P - 1)] = state
            out = allreduce(outs, pp_axis)
        ctx.stage_fn, ctx.M, ctx.pp_axis, ctx.names = stage_fn, M, pp_axis, names
        ctx.mesh = current_mesh()       # backward may run on another thread
        ctx.steps = sorted(inputs)
        ctx.save_for_backward(*[inputs[t] for t in ctx.steps], *values)
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return out

    @staticmethod
    def backward(ctx, g):
        with ctx.mesh:
            return _GPipe._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        pp_axis, M = ctx.pp_axis, ctx.M
        P, my = axis_size(pp_axis), axis_index(pp_axis)
        saved = ctx.saved_tensors
        inputs = dict(zip(ctx.steps, saved[:len(ctx.steps)]))
        values = saved[len(ctx.steps):]
        params = {k: v[my].detach().requires_grad_(True)
                  for k, v in zip(ctx.names, values)}
        g = allreduce(g, pp_axis)       # the transpose of the output's psum
        shape, dtype, device = ctx.x_meta
        gx = torch.zeros(shape, dtype=dtype, device=device)
        gp = {k: torch.zeros_like(v) for k, v in params.items()}
        g_next = torch.zeros_like(gx[0])
        for t in reversed(range(M + P - 1)):
            g_state = g_next
            if my == P - 1 and t >= P - 1:
                g_state = g_state + g[t - (P - 1)]
            g_recv = torch.zeros_like(g_next)
            if t in inputs:
                cur = inputs[t].detach().requires_grad_(True)
                with torch.enable_grad():
                    y = ctx.stage_fn(params, cur)
                    d = torch.autograd.grad(y, list(params.values()) + [cur],
                                            g_state)
                for k, dk in zip(params, d[:-1]):
                    gp[k] += dk
                if my == 0:
                    gx[t] = d[-1]
                else:
                    g_recv = d[-1]
            g_next = ppermute_shift(g_recv, pp_axis, -1)
        grads = []
        for k, v in zip(ctx.names, values):
            full = torch.zeros_like(v)
            full[my] = gp[k]
            grads.append(full)
        return (None, None, None, None, gx, *grads)


def pipeline_train_1f1b(stage_fn, loss_fn, stacked_params, x, targets,
                        num_microbatches, mesh=None, pp_axis="pp",
                        dp_axis=None):
    """Interleaved one-forward-one-backward pipeline training step.

    ``stage_fn(params, act) -> act``; ``loss_fn(final_act, target) ->
    scalar`` per microbatch at the last stage.  x, targets: [M, mb, ...].
    Returns ``(total_loss, outputs [M, mb, ...], dparams)`` with
    ``dparams`` stacked [P, ...] like ``stacked_params``, the same on
    every rank.  At step t stage p runs the forward of microbatch t − p
    and the backward of microbatch t − (2P − 2 − p), recomputing the
    stage's forward from its saved input (at most 2P − 1 kept).  With
    ``dp_axis`` each data-parallel rank takes its slice of every
    microbatch and loss and gradients sum over it (``loss_fn`` must add
    over the batch).  Without a ``pp`` axis: autograd through the
    sequential stages, the oracle."""
    mesh = mesh or current_mesh()
    P = 1 if mesh is None else mesh.size(pp_axis)
    if P == 1:
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in stacked_params.items()}
        with torch.enable_grad():
            losses, outs = [], []
            for i in range(x.shape[0]):
                h = _sequential(stage_fn, leaves, x[i])
                losses.append(loss_fn(h, targets[i]))
                outs.append(h)
            loss = torch.stack(losses).sum()
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return (loss.detach(), torch.stack(outs).detach(),
                dict(zip(leaves, grads)))
    with mesh:
        return _train_1f1b(stage_fn, loss_fn, stacked_params, x, targets,
                           num_microbatches, P, pp_axis,
                           dp_axis if dp_axis and mesh.size(dp_axis) > 1
                           else None)


def _train_1f1b(stage_fn, loss_fn, stacked, x, targets, M, P, pp_axis,
                dp_axis):
    my = axis_index(pp_axis)
    if dp_axis is not None:
        from .sharding import local_shard, PartitionSpec

        x = local_shard(x, PartitionSpec(None, dp_axis))
        targets = local_shard(targets, PartitionSpec(None, dp_axis))
    params = {k: v[my].detach().requires_grad_(True)
              for k, v in stacked.items()}
    Q = 2 * P - 1                       # saved-input slots
    queue = [None] * Q
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    loss_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    outs = torch.zeros_like(x)
    send_f = torch.zeros_like(x[0])
    send_b = torch.zeros_like(x[0])
    last = my == P - 1
    for t in range(M + 2 * P - 2):
        recv_f = ppermute_shift(send_f, pp_axis, 1)
        recv_b = ppermute_shift(send_b, pp_axis, -1)
        fm = t - my                     # the forward's microbatch
        send_f = torch.zeros_like(send_f)
        if 0 <= fm < M:
            x_in = x[fm] if my == 0 else recv_f
            queue[fm % Q] = x_in
            with torch.no_grad():
                send_f = stage_fn(params, x_in)
            if last:                    # the loss and its gradient, now
                y = send_f.detach().requires_grad_(True)
                with torch.enable_grad():
                    loss_m = loss_fn(y, targets[fm])
                    (dloss,) = torch.autograd.grad(loss_m, [y])
                loss_acc = loss_acc + loss_m.detach().float()
                outs[fm] = send_f
        bm = t - (2 * P - 2 - my)       # the backward's microbatch
        send_b = torch.zeros_like(send_b)
        if 0 <= bm < M:
            x_saved = queue[bm % Q].detach().requires_grad_(True)
            with torch.enable_grad():
                y = stage_fn(params, x_saved)
                d = torch.autograd.grad(y, list(params.values())
                                        + [x_saved],
                                        dloss if last else recv_b)
            for k, dk in zip(params, d[:-1]):
                grads[k] += dk
            send_b = d[-1]
    loss_total = allreduce(loss_acc if last else torch.zeros_like(loss_acc),
                           pp_axis)
    outs = allreduce(outs if last else torch.zeros_like(outs), pp_axis)
    if dp_axis is not None:
        loss_total = allreduce(loss_total, dp_axis)
        grads = {k: allreduce(g, dp_axis) for k, g in grads.items()}
        outs = allgather(outs, dp_axis, axis=1)
    dparams = {k: allgather(g[None], pp_axis, axis=0)
               for k, g in grads.items()}
    return loss_total, outs, dparams
