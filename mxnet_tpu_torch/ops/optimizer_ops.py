"""Optimizer-update operators.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (reference
``src/operator/optimizer_op.cc``): ``sgd_update``, ``sgd_mom_update``,
``adam_update``, the multi-precision ``mp_sgd_update`` /
``mp_sgd_mom_update`` (f16/bf16 weights with f32 master copies) and the
multi-tensor ``multi_sgd_update`` / ``multi_sgd_mom_update`` /
``multi_mp_sgd_update`` / ``multi_mp_sgd_mom_update``.  Where the JAX package returns new arrays that
its dispatcher writes back, these update the weight and state tensors in
place (their ``mutate`` outputs are those same tensors), which saves a copy
of every parameter per step.  The arithmetic is the JAX package's, in its
order, one f32 rounding per step of it:

* ``g = rescale_grad·grad``, then clipped to ``±clip_gradient`` when that
  is positive;
* SGD: ``w −= lr·(g + wd·w)``; with momentum ``mom = momentum·mom −
  lr·(g + wd·w)``, then ``w += mom``;
* multi-precision: the same on the f32 master ``w32`` with the gradient
  cast to f32, each multiply-add rounded once (``_mp_sgd``), then ``w =
  w32`` rounded to ``w``'s dtype;
* Adam: ``g += wd·w``, ``m = β1·m + (1 − β1)·g``, ``v = β2·v + (1 −
  β2)·g²``, ``w −= lr·m / (√v + ε)``.

The multi-tensor forms take ``(w, g[, mom])`` interleaved per weight, with
one ``lr`` and ``wd`` per weight, and run each step over the group with
``torch._foreach_*``: one launch per step for the whole group on the card.

Inside :func:`update_guard` (the numerical-health guard of a fused train
step) every op computes the same values out of place, and each buffer it
updates gets ``where(ok, new, old)`` when the scope closes, ``ok`` being
a bool tensor on the device: a step whose gradients were not finite
leaves the weights, masters and optimizer state bitwise unchanged, and a
finite one writes exactly the unguarded values — with no host round-trip,
as the JAX package's ``lax.cond`` does.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .registry import register

_GUARD = threading.local()


@contextlib.contextmanager
def update_guard(ok):
    """Scope: the update ops on this thread keep their old values where
    the 0-dim bool tensor ``ok`` is False (see the module docstring).  The
    ops compute their new values out of place; the writes are gathered
    and made when the scope closes, one :func:`select_where` per dtype,
    so the guard costs a few launches a step, not a few per parameter."""
    prev = getattr(_GUARD, "ok", None), getattr(_GUARD, "writes", None)
    _GUARD.ok, _GUARD.writes = ok, {}
    try:
        yield
        for (dsts, news) in _GUARD.writes.values():
            select_where(dsts, news, ok)
    finally:
        _GUARD.ok, _GUARD.writes = prev


def _guard_ok():
    return getattr(_GUARD, "ok", None)


def _guarded_write(dsts, news):
    """Queue ``dst = where(ok, new, dst)`` for the scope's close."""
    for dst, new in zip(dsts, news):
        key = (dst.dtype, new.dtype, dst.device)
        group = _GUARD.writes.setdefault(key, ([], []))
        group[0].append(dst)
        group[1].append(new)


def select_where(dsts, news, ok):
    """``dst = where(ok, new, dst)`` for each pair, in place, ``new`` cast
    to ``dst``'s dtype (``dsts`` share one dtype).  A group costs a few
    launches however many tensors it holds: one ``where`` over the
    concatenations, copied back with one multi-tensor copy (a launch per
    tensor would cost more host time than the step's device time saves)."""
    with torch.no_grad():
        if len(dsts) == 1:
            torch.where(ok, news[0].to(dsts[0].dtype), dsts[0], out=dsts[0])
            return
        flat = torch.cat([d.reshape(-1) for d in dsts])
        torch.where(ok, torch.cat([n.reshape(-1) for n in news]).to(
            flat.dtype), flat, out=flat)
        parts = flat.split([d.numel() for d in dsts])
        torch._foreach_copy_(list(dsts), [v.view(d.shape)
                                          for v, d in zip(parts, dsts)])


def _prep(grads, rescale_grad, clip_gradient):
    """New tensors ``rescale_grad·g``, clipped."""
    gs = torch._foreach_mul(list(grads), float(rescale_grad))
    if clip_gradient is not None and clip_gradient > 0:
        torch._foreach_clamp_min_(gs, -float(clip_gradient))
        torch._foreach_clamp_max_(gs, float(clip_gradient))
    return gs


def _sgd(ws, gs, moms, lrs, wds, momentum, rescale_grad, clip_gradient):
    """In place over the lists: ``w`` (and ``mom``) updated."""
    ok = _guard_ok()
    with torch.no_grad():
        d = _prep(gs, rescale_grad, clip_gradient)
        torch._foreach_add_(d, torch._foreach_mul(ws, wds))   # g + wd·w
        torch._foreach_mul_(d, lrs)                            # lr·(...)
        if ok is not None:
            if moms is not None:
                new_moms = torch._foreach_mul(moms, float(momentum))
                torch._foreach_sub_(new_moms, d)
                new_ws = torch._foreach_add(ws, new_moms)
                _guarded_write(moms, new_moms)
            else:
                new_ws = torch._foreach_sub(ws, d)
            _guarded_write(ws, new_ws)
            return
        if moms is None:
            torch._foreach_sub_(ws, d)
            return
        torch._foreach_mul_(moms, float(momentum))
        torch._foreach_sub_(moms, d)
        torch._foreach_add_(ws, moms)


def _f32(v):
    """A Python scalar rounded to f32, as the update ops receive it."""
    return float(np.float32(v))


def _fma(s, x, y):
    """``s·x + y`` rounded once to f32 (``s`` an f32 scalar, ``x`` and
    ``y`` f32 tensors; the f64 product is exact)."""
    return (x.double() * s + y.double()).float()


def _mp_sgd(ws, gs, moms, w32s, lrs, wds, momentum, rescale_grad,
            clip_gradient):
    """The multi-precision update, in place: the f32 master weights (and
    momenta) from the gradients cast to f32, then each weight is its
    master rounded to the weight's dtype.  The two multiply-adds of each
    step round once, as the reference's compiled update does (XLA fuses
    them): ``t = wd·w32 + g``; without momentum ``w32 = −lr·t + w32``;
    with it ``mom = momentum·mom − lr·t`` (``lr·t`` rounded first), then
    ``w32 += mom``."""
    ok = _guard_ok()
    new32s, new_moms = [], []
    with torch.no_grad():
        gs = _prep([g.float() for g in gs], rescale_grad, clip_gradient)
        for i, (w, g, w32) in enumerate(zip(ws, gs, w32s)):
            t = _fma(_f32(wds[i]), w32, g)
            if ok is not None:
                if moms is None:
                    new32s.append(_fma(-_f32(lrs[i]), t, w32))
                else:
                    new_moms.append(_fma(_f32(momentum), moms[i],
                                         -(t * _f32(lrs[i]))))
                    new32s.append(w32 + new_moms[-1])
                continue
            if moms is None:
                w32.copy_(_fma(-_f32(lrs[i]), t, w32))
            else:
                moms[i].copy_(_fma(_f32(momentum), moms[i],
                                   -(t * _f32(lrs[i]))))
                w32.add_(moms[i])
            w.copy_(w32)
        if ok is not None:
            if moms is not None:
                _guarded_write(moms, new_moms)
            _guarded_write(ws, new32s)          # rounded to w's dtype
            _guarded_write(w32s, new32s)


@register("sgd_update", input_names=("weight", "grad"), mutate={0: 0},
          no_grad=True)
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True):
    _sgd([weight], [grad], None, [float(lr)], [float(wd)], 0.0,
         rescale_grad, clip_gradient)
    return weight


@register("sgd_mom_update", input_names=("weight", "grad", "mom"),
          mutate={0: 0, 1: 2}, no_grad=True)
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    _sgd([weight], [grad], [mom], [float(lr)], [float(wd)], momentum,
         rescale_grad, clip_gradient)
    return weight, mom


@register("adam_update", input_names=("weight", "grad", "mean", "var"),
          mutate={0: 0, 1: 2, 2: 3}, no_grad=True)
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=True):
    ok = _guard_ok()
    with torch.no_grad():
        (g,) = _prep([grad], rescale_grad, clip_gradient)
        g.add_(weight * wd)
        if ok is not None:
            m = mean.mul(beta1).add_(g * (1 - beta1))
            v = var.mul(beta2).add_(g.square().mul_(1 - beta2))
            _guarded_write([weight, mean, var],
                           [weight - m * lr / (v.sqrt().add_(epsilon)), m, v])
            return weight, mean, var
        mean.mul_(beta1).add_(g * (1 - beta1))
        var.mul_(beta2).add_(g.square().mul_(1 - beta2))
        weight.sub_(mean * lr / (var.sqrt().add_(epsilon)))
    return weight, mean, var


@register("mp_sgd_update", input_names=("weight", "grad", "weight32"),
          mutate={0: 0, 1: 2}, no_grad=True)
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    """f16/bf16 weights with an f32 master copy (reference
    mp_sgd_update)."""
    _mp_sgd([weight], [grad], None, [weight32], [lr], [wd], 0.0,
            rescale_grad, clip_gradient)
    return weight, weight32


@register("mp_sgd_mom_update",
          input_names=("weight", "grad", "mom", "weight32"),
          mutate={0: 0, 1: 2, 2: 3}, no_grad=True)
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True):
    _mp_sgd([weight], [grad], [mom], [weight32], [lr], [wd], momentum,
            rescale_grad, clip_gradient)
    return weight, mom, weight32


def _multi_mutate(stride, state_slots):
    def mut(params, n_inputs):
        n = int(params.get("num_weights", n_inputs // stride))
        m = {i: stride * i for i in range(n)}
        for si, slot in enumerate(state_slots):
            for i in range(n):
                m[(si + 1) * n + i] = stride * i + slot
        return m
    return mut


def _multi_visible(attrs):
    # only the updated weights are visible outputs (reference parity)
    return list(range(int(attrs.get("num_weights", 1))))


def _groups(tensors, stride, num_weights, lrs, wds):
    n = int(num_weights)
    if len(tensors) != n * stride:
        raise ValueError("multi-update expects %d interleaved tensors for "
                         "num_weights=%d, got %d" % (n * stride, n,
                                                     len(tensors)))
    if len(lrs) != n or len(wds) != n:
        raise ValueError("multi-update: %d lrs and %d wds for num_weights="
                         "%d" % (len(lrs), len(wds), n))
    return [list(tensors[i::stride]) for i in range(stride)]


@register("multi_sgd_update", mutate=_multi_mutate(2, ()), no_grad=True,
          visible_out=_multi_visible)
def _multi_sgd_update(*tensors, lrs=(), wds=(), rescale_grad=1.0,
                      clip_gradient=-1.0, num_weights=1):
    ws, gs = _groups(tensors, 2, num_weights, lrs, wds)
    _sgd(ws, gs, None, [float(x) for x in lrs], [float(x) for x in wds],
         0.0, rescale_grad, clip_gradient)
    return tuple(ws)


@register("multi_sgd_mom_update", mutate=_multi_mutate(3, (2,)),
          no_grad=True, visible_out=_multi_visible)
def _multi_sgd_mom_update(*tensors, lrs=(), wds=(), momentum=0.0,
                          rescale_grad=1.0, clip_gradient=-1.0,
                          num_weights=1):
    ws, gs, moms = _groups(tensors, 3, num_weights, lrs, wds)
    _sgd(ws, gs, moms, [float(x) for x in lrs], [float(x) for x in wds],
         momentum, rescale_grad, clip_gradient)
    return tuple(ws) + tuple(moms)


@register("multi_mp_sgd_update", mutate=_multi_mutate(3, (2,)),
          no_grad=True, visible_out=_multi_visible)
def _multi_mp_sgd_update(*tensors, lrs=(), wds=(), rescale_grad=1.0,
                         clip_gradient=-1.0, num_weights=1):
    ws, gs, w32s = _groups(tensors, 3, num_weights, lrs, wds)
    _mp_sgd(ws, gs, None, w32s, lrs, wds, 0.0, rescale_grad, clip_gradient)
    return tuple(ws) + tuple(w32s)


@register("multi_mp_sgd_mom_update", mutate=_multi_mutate(4, (2, 3)),
          no_grad=True, visible_out=_multi_visible)
def _multi_mp_sgd_mom_update(*tensors, lrs=(), wds=(), momentum=0.0,
                             rescale_grad=1.0, clip_gradient=-1.0,
                             num_weights=1):
    ws, gs, moms, w32s = _groups(tensors, 4, num_weights, lrs, wds)
    _mp_sgd(ws, gs, moms, w32s, lrs, wds, momentum, rescale_grad,
            clip_gradient)
    return tuple(ws) + tuple(moms) + tuple(w32s)
