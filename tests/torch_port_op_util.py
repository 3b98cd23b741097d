"""Run one registered op through both packages from the same numpy inputs:
the JAX package's function (and ``jax.vjp`` for its gradients) and the
port's (``torch.autograd.grad``), on the CPU.  Shared by the op-parity
files ``test_torch_port_{spatial,contrib_ops,detection}.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import mxnet_tpu  # noqa: F401  (fills the JAX registry)
import mxnet_tpu_torch  # noqa: F401  (fills the port's registry)
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

F32 = dict(rtol=1e-5, atol=1e-5)


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def jax_run(name, inputs, params, cot=None, wrt=()):
    """The JAX op's outputs (numpy), and with ``cot`` the gradients of
    ``sum(out_k · cot_k)`` with respect to the inputs at ``wrt``."""
    fn = jreg.get_op(name).fn
    arrs = [jnp.asarray(a) for a in inputs]
    if cot is None:
        if not jreg.get_op(name).cacheable:     # a data-dependent shape
            return [np.asarray(o) for o in _tuple(fn(*arrs, **params))], None
        run = jax.jit(lambda *xs: _tuple(fn(*xs, **params)))
        return [np.asarray(o) for o in run(*arrs)], None

    def f(*diff):
        full = list(arrs)
        for i, d in zip(wrt, diff):
            full[i] = d
        return _tuple(fn(*full, **params))

    def both(diff, cots):
        out, vjp = jax.vjp(f, *diff)
        return out, vjp(cots)

    out, grads = jax.jit(both)([arrs[i] for i in wrt],
                               tuple(jnp.asarray(c) for c in cot))
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


def port_run(name, inputs, params, cot=None, wrt=()):
    """The port's op on CPU tensors, as :func:`jax_run`."""
    fn = treg.get_op(name).fn
    ts = [torch.from_numpy(np.array(a)) for a in inputs]
    for i in wrt:
        ts[i].requires_grad_(True)
    with torch.set_grad_enabled(cot is not None):
        out = _tuple(fn(*ts, **params))
    outs = [o.detach().numpy() for o in out]
    if cot is None:
        return outs, None
    used = [(o, torch.from_numpy(np.array(c))) for o, c in zip(out, cot)
            if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in used], [ts[i] for i in wrt],
                                [c for _, c in used], allow_unused=True)
    return outs, [np.zeros(ts[i].shape, np.float32) if g is None
                  else g.numpy() for i, g in zip(wrt, grads)]


def compare(name, inputs, params=None, wrt=(), tol=F32, grad_tol=F32,
            exact=(), seed=0):
    """Run ``name`` in both packages and hold the port to the JAX package:
    the outputs at ``tol`` (those at indices ``exact`` bit for bit), and
    with ``wrt`` the gradients, for a seeded random cotangent, at
    ``grad_tol``.  Returns the port's outputs."""
    params = dict(params or {})
    cot = None
    if wrt:
        ref, _ = jax_run(name, inputs, params)
        rng = np.random.RandomState(seed + 1)
        cot = [rng.standard_normal(o.shape).astype(o.dtype) for o in ref]
    jo, jg = jax_run(name, inputs, params, cot, wrt)
    to, tg = port_run(name, inputs, params, cot, wrt)
    assert len(jo) == len(to), name
    for k, (a, b) in enumerate(zip(to, jo)):
        assert a.shape == b.shape, (name, k, a.shape, b.shape)
        if k in exact:
            np.testing.assert_array_equal(a, b, err_msg="%s out %d" % (name,
                                                                       k))
        else:
            np.testing.assert_allclose(a, b.astype(a.dtype), err_msg="%s out "
                                       "%d" % (name, k), **tol)
    for k, (a, b) in enumerate(zip(tg or (), jg or ())):
        np.testing.assert_allclose(a, b, err_msg="%s grad %d" % (name, k),
                                   **grad_tol)
    return to
