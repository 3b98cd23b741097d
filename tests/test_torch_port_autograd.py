"""The port's imperative autograd against the JAX package's, on the CPU.

Each case runs the same code through ``mxnet_tpu`` and through
``mxnet_tpu_torch`` (inside ``with mt.cpu():``) on the same numpy inputs
and compares what comes out.  Cases that mirror one of
``tests/test_autograd.py`` carry its name.  Beside them: the verify
recipe's imperative drive (``FullyConnected`` and ``sgd_update``, 50
steps), ``grad_req="add"`` over two backwards, a second derivative through
``autograd.grad(create_graph=True)``, BatchNorm inside ``record()``
(batch statistics, moving statistics updated) against ``pause()``, and the
port's own rules: no graph outside ``record()``, in-place updates of a leaf
outside the graph, ``retain_graph=False`` freeing the graph.

Tolerances: the 50-step drive's losses within 1e-5 relative (f32 in both,
another summation order); single ops within 1e-6; exact small-integer
gradients equal.
"""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt

PKGS = {"jax": jmx, "torch": mt}


@contextlib.contextmanager
def _on_cpu(mx):
    if mx is mt:
        with mt.cpu():
            yield
    else:
        yield


def _both(fn):
    """``fn(mx)`` in each package, on the CPU: ``{name: result}``."""
    out = {}
    for name, mx in PKGS.items():
        with _on_cpu(mx):
            out[name] = fn(mx)
    return out


def _close(res, rtol=1e-6, atol=1e-6):
    a, b = res["jax"], res["torch"]
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(np.asarray(y, np.float64),
                                       np.asarray(x, np.float64),
                                       rtol=rtol, atol=atol)
    else:
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64),
                                   rtol=rtol, atol=atol)


def test_imperative_drive_50_steps():
    """The verify recipe: a linear model by FullyConnected and sgd_update,
    50 steps from the same numbers; every loss within 1e-5."""
    rng = np.random.RandomState(0)
    X = rng.randn(64, 10).astype(np.float32)
    w0 = (rng.randn(1, 10) * 0.1).astype(np.float32)

    def run(mx):
        x = mx.nd.array(X)
        y = (x * 2).sum(axis=1, keepdims=True)
        w = mx.nd.array(w0)
        w.attach_grad()
        b = mx.nd.zeros((1,))
        b.attach_grad()
        losses = []
        for _ in range(50):
            with mx.autograd.record():
                loss = ((mx.nd.FullyConnected(x, w, b, num_hidden=1)
                         - y) ** 2).mean()
            loss.backward()
            for p in (w, b):
                mx.nd.sgd_update(p, p.grad, lr=0.1)
            losses.append(float(loss.asnumpy()))
        return losses

    res = _both(run)
    assert res["torch"][-1] < 1e-2 * res["torch"][0]
    _close(res, rtol=1e-5, atol=1e-7)


def test_basic_backward():
    def run(mx):
        x = mx.nd.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * x + 2 * x
        y.backward()
        return x.grad.asnumpy()

    res = _both(run)
    np.testing.assert_array_equal(res["torch"], [4.0, 6.0, 8.0])
    _close(res)


def test_chain_multiple_vars():
    def run(mx):
        a = mx.nd.array([2.0])
        b = mx.nd.array([3.0])
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            y = a * b + a
        y.backward()
        return [a.grad.asnumpy(), b.grad.asnumpy()]

    res = _both(run)
    assert [float(g[0]) for g in res["torch"]] == [4.0, 2.0]
    _close(res)


def test_head_gradient():
    def run(mx):
        x = mx.nd.array([1.0, 2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * 3
        y.backward(mx.nd.array([10.0, 100.0]))
        return x.grad.asnumpy()

    _close(_both(run))


def test_grad_req_add_and_null():
    """``add`` accumulates over repeated backwards (here two, then a
    third); a head reaching only ``null`` arrays raises."""
    def run(mx):
        x = mx.nd.ones((2,))
        x.attach_grad(grad_req="add")
        seen = []
        for _ in range(3):
            with mx.autograd.record():
                y = (x * 2).sum()
            y.backward()
            seen.append(x.grad.asnumpy())
        z = mx.nd.ones((2,))
        z.attach_grad(grad_req="null")
        with mx.autograd.record():
            w = (z * 2).sum()
        with pytest.raises(ValueError):
            w.backward()
        return seen

    res = _both(run)
    np.testing.assert_array_equal(res["torch"][1], [4.0, 4.0])
    np.testing.assert_array_equal(res["torch"][2], [6.0, 6.0])
    _close(res)


def test_grad_req_write_overwrites():
    """``write`` replaces the gradient each backward; an array the heads
    do not reach keeps its gradient."""
    def run(mx):
        x = mx.nd.array([1.0, 2.0])
        u = mx.nd.array([5.0])
        x.attach_grad()
        u.attach_grad()
        with mx.autograd.record():
            y = (x * u).sum()
        y.backward()
        first_u = u.grad.asnumpy()
        with mx.autograd.record():
            y = (x * 3).sum()
        y.backward()
        return [x.grad.asnumpy(), u.grad.asnumpy(), first_u]

    res = _both(run)
    np.testing.assert_array_equal(res["torch"][0], [3.0, 3.0])
    np.testing.assert_array_equal(res["torch"][1], [3.0])
    _close(res)


def test_is_recording_is_training():
    ag = mt.autograd
    assert not ag.is_recording()
    with ag.record():
        assert ag.is_recording()
        assert ag.is_training()
        with ag.pause():
            assert not ag.is_recording()
            assert not ag.is_training()
        with ag.predict_mode():
            assert not ag.is_training()
    with ag.train_mode():
        assert ag.is_training()
        assert not ag.is_recording()
    with ag.record(train_mode=False):
        assert ag.is_recording() and not ag.is_training()


def test_pause_excludes_from_tape():
    def run(mx):
        x = mx.nd.array([2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
            with mx.autograd.pause():
                c = x * 10
            z = y + c.detach()
        z.backward()
        return x.grad.asnumpy()

    res = _both(run)
    assert float(res["torch"][0]) == 4.0
    _close(res)


def test_no_graph_outside_record():
    """Outside ``record()`` an op on an array with a gradient builds no
    graph, and it cannot be a head."""
    x = mt.nd.array([1.0, 2.0], ctx=mt.cpu())
    x.attach_grad()
    y = x * x + 1
    assert not y.data.requires_grad and y.data.grad_fn is None
    with pytest.raises(ValueError):
        y.backward()
    with mt.autograd.record():
        z = x * x
    assert z.data.grad_fn is not None


def test_detach():
    def run(mx):
        x = mx.nd.array([3.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
            z = y.detach() * x
        z.backward()
        return x.grad.asnumpy()

    res = _both(run)
    assert float(res["torch"][0]) == 9.0
    _close(res)


def test_grad_function_api():
    def run(mx):
        x = mx.nd.array([1.0, 2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = (x ** 2).sum()
        (gx,) = mx.autograd.grad(y, [x])
        return gx.asnumpy()

    res = _both(run)
    np.testing.assert_array_equal(res["torch"], [2.0, 4.0])
    _close(res)


def test_grad_create_graph_second_derivative():
    """``grad(create_graph=True)`` is itself differentiable: d/dx of
    sum(dy/dx) for y = x³ is 6x."""
    xs = np.array([0.5, -1.5, 2.0], np.float32)

    def run(mx):
        x = mx.nd.array(xs)
        x.attach_grad()
        with mx.autograd.record():
            y = (x * x * x).sum()
            gx = mx.autograd.grad(y, [x], create_graph=True)[0]
            z = gx.sum()
        z.backward()
        return [gx.asnumpy(), x.grad.asnumpy()]

    res = _both(run)
    np.testing.assert_allclose(res["torch"][0], 3 * xs ** 2, rtol=1e-6)
    np.testing.assert_allclose(res["torch"][1], 6 * xs, rtol=1e-6)
    _close(res)


def test_nondiff_op_on_tape():
    def run(mx):
        x = mx.nd.array([1.0, 5.0, 3.0])
        x.attach_grad()
        with mx.autograd.record():
            i = mx.nd.argmax(x, axis=0)
            y = (x * 2).sum()
        y.backward()
        return [x.grad.asnumpy(), i.asnumpy()]

    _close(_both(run))


def test_through_reshape_transpose():
    def run(mx):
        x = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        x.attach_grad()
        with mx.autograd.record():
            y = (x.reshape((3, 2)).T * mx.nd.array(
                np.arange(6, dtype=np.float32).reshape(2, 3))).sum()
        y.backward()
        return x.grad.asnumpy()

    _close(_both(run))


def test_backward_twice_with_retain():
    def run(mx):
        x = mx.nd.array([2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
        y.backward(retain_graph=True)
        g1 = x.grad.asnumpy()
        y.backward()
        return [g1, x.grad.asnumpy()]

    res = _both(run)
    assert [float(g[0]) for g in res["torch"]] == [4.0, 4.0]
    _close(res)


def test_backward_without_retain_frees_the_graph():
    x = mt.nd.array([2.0], ctx=mt.cpu())
    x.attach_grad()
    with mt.autograd.record():
        y = mt.nd.exp(x * x)
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()


def test_custom_function():
    def run(mx):
        class Square(mx.autograd.Function):
            def forward(self, x):
                self.save_for_backward(x)
                return x * x

            def backward(self, dy):
                (x,) = self.saved_tensors
                return dy * 2 * x

        x = mx.nd.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with mx.autograd.record():
            y = Square()(x)
            z = (y * 3).sum()
        z.backward()
        return [y.asnumpy(), x.grad.asnumpy()]

    res = _both(run)
    np.testing.assert_array_equal(res["torch"][1], [6.0, 12.0, 18.0])
    _close(res)


def test_custom_function_two_inputs():
    """A Function of two inputs with its own (deliberately scaled)
    gradient: the user's backward, not autograd's, reaches the leaves."""
    def run(mx):
        class ScaledMul(mx.autograd.Function):
            def forward(self, a, b):
                self.save_for_backward(a, b)
                return a * b

            def backward(self, dy):
                a, b = self.saved_tensors
                return dy * b * 10, dy * a

        a = mx.nd.array([1.0, 2.0])
        b = mx.nd.array([3.0, 4.0])
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            y = ScaledMul()(a, b).sum()
        y.backward()
        return [a.grad.asnumpy(), b.grad.asnumpy()]

    res = _both(run)
    np.testing.assert_array_equal(res["torch"][0], [30.0, 40.0])
    _close(res)


def test_mutated_leaf_sees_new_value():
    def run(mx):
        x = mx.nd.array([1.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
        y.backward()
        g1 = x.grad.asnumpy()
        x[:] = 5.0                 # in place, outside the graph
        with mx.autograd.record():
            y = x * x
        y.backward()
        return [g1, x.grad.asnumpy()]

    res = _both(run)
    assert [float(g[0]) for g in res["torch"]] == [2.0, 10.0]
    _close(res)


def test_optimizer_update_keeps_the_leaf():
    """An update op writes the leaf in place outside the graph; it stays a
    leaf that requires grad, and the next step's gradient is right."""
    x = mt.nd.array([1.0, -2.0], ctx=mt.cpu())
    x.attach_grad()
    for _ in range(2):
        with mt.autograd.record():
            y = (x * x).sum()
        y.backward()
        mt.nd.sgd_update(x, x.grad, lr=0.25)
    assert x.data.is_leaf and x.data.requires_grad
    np.testing.assert_allclose(x.asnumpy(), [0.25, -0.5])
    np.testing.assert_allclose(x.grad.asnumpy(), [1.0, -2.0])


def test_astype_records():
    def run(mx):
        x = mx.nd.array([1.5, -2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = (x.astype("float64") * 3).astype("float32").sum()
        y.backward()
        return x.grad.asnumpy()

    res = _both(run)
    np.testing.assert_array_equal(res["torch"], [3.0, 3.0])


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batchnorm_train_inside_record_vs_pause(fix_gamma):
    """Inside ``record()`` BatchNorm normalizes with the batch statistics
    and updates its moving statistics; inside ``pause()`` it uses and keeps
    them.  Outputs, moving statistics and gradients against the JAX
    package."""
    rng = np.random.RandomState(1)
    xs = (rng.randn(4, 3, 5, 5) * 2 + 1).astype(np.float32)
    gs = (rng.rand(3) + 0.5).astype(np.float32)
    bs = rng.randn(3).astype(np.float32)
    mm = rng.randn(3).astype(np.float32) * 0.1
    mv = (rng.rand(3) + 0.5).astype(np.float32)

    def run(mx):
        x, gamma, beta = mx.nd.array(xs), mx.nd.array(gs), mx.nd.array(bs)
        mean, var = mx.nd.array(mm), mx.nd.array(mv)
        for a in (x, gamma, beta):
            a.attach_grad()
        with mx.autograd.record():
            y = mx.nd.BatchNorm(x, gamma, beta, mean, var, eps=1e-5,
                                momentum=0.9, fix_gamma=fix_gamma)[0]
            loss = (y * y * mx.nd.array(np.arange(3, dtype=np.float32)
                                        .reshape(1, 3, 1, 1))).sum()
        loss.backward()
        out = [y.asnumpy(), mean.asnumpy(), var.asnumpy(),
               x.grad.asnumpy(), gamma.grad.asnumpy(), beta.grad.asnumpy()]
        with mx.autograd.pause():
            y2 = mx.nd.BatchNorm(x, gamma, beta, mean, var, eps=1e-5,
                                 momentum=0.9, fix_gamma=fix_gamma)[0]
        out += [y2.asnumpy(), mean.asnumpy(), var.asnumpy()]
        return out

    res = _both(run)
    t = res["torch"]
    np.testing.assert_allclose(t[1], 0.9 * mm + 0.1 * xs.mean(axis=(0, 2, 3)),
                               rtol=1e-5)
    np.testing.assert_array_equal(t[1], t[7])      # pause: unchanged
    np.testing.assert_array_equal(t[2], t[8])
    ref = (xs - t[1].reshape(1, 3, 1, 1)) / np.sqrt(
        t[2].reshape(1, 3, 1, 1) + 1e-5)
    ref = ref * (1.0 if fix_gamma else gs.reshape(1, 3, 1, 1)) \
        + bs.reshape(1, 3, 1, 1)
    np.testing.assert_allclose(t[6], ref, rtol=1e-5, atol=1e-5)
    _close(res, rtol=1e-5, atol=1e-5)


def test_torch_grad_mode_restored():
    """The port's scopes leave torch's own grad mode as they found it."""
    before = torch.is_grad_enabled()
    x = mt.nd.array([1.0], ctx=mt.cpu())
    x.attach_grad()
    with mt.autograd.record():
        (x * 2).sum()
    (x * 2).sum()
    assert torch.is_grad_enabled() == before
