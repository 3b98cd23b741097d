"""User operators and runtime kernels of the port, on the CPU.

* ``numpy_softmax`` — ``example/numpy-ops/custom_softmax.py``'s user op,
  carried over as user code (the same class body over the port) — trains
  the example's network through ``Module.fit`` in both packages from the
  same parameters on the same batches: the parameters after one epoch
  agree within 1e-5 relative L2 (the same numpy softmax and gradient; the
  two FullyConnected layers in f32, summed in another order);
* ``mx.nd.Custom`` imperatively, and a ``Custom`` op with an auxiliary
  state, imperatively in both packages (the state written back) and in a
  port Symbol (the state listed as auxiliary, written back by a training
  forward, unchanged by an inference one);
* ``mx.rtc`` without a card: ``CudaModule`` raises ``RuntimeError``, the
  port's ``PallasModule`` raises ``NotImplementedError``; the signature
  parser; and the checks a launch makes of its arguments before anything
  reaches libcuda.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import rtc

CPU = mt.cpu()
FIT_REL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _define_numpy_softmax(mx):
    """The example's user op over package ``mx`` (its class body as it
    is), registered as ``numpy_softmax``."""

    class NumpySoftmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0], mx.nd.array(
                e / e.sum(axis=1, keepdims=True)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            # fused softmax+CE gradient: (p - onehot(y)) / batch
            p = out_data[0].asnumpy()
            y = in_data[1].asnumpy().astype(int)
            g = p.copy()
            g[np.arange(len(y)), y] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(g / len(y)))
            self.assign(in_grad[1], req[1], mx.nd.zeros_like(in_data[1]))

    @mx.operator.register("numpy_softmax")
    class NumpySoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return NumpySoftmax()


def _define_running_sum(mx):
    """A user op with an auxiliary state: ``y = 2·x`` and, in training,
    ``total += sum(x)``."""

    class RunningSum(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2.0)
            if is_train:
                s = float(in_data[0].asnumpy().sum())
                aux[0][:] = aux[0] + s

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 2.0)

    @mx.operator.register("running_sum")
    class RunningSumProp(mx.operator.CustomOpProp):
        def list_auxiliary_states(self):
            return ["total"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], [(1,)]

        def create_operator(self, ctx, shapes, dtypes):
            return RunningSum()


for _pkg in (jmx, mt):
    _define_numpy_softmax(_pkg)
    _define_running_sum(_pkg)


def _example_data():
    rng = np.random.RandomState(0)
    n, n_cls = 512, 4
    X = rng.uniform(0, 1, (n, 16)).astype(np.float32)
    Y = rng.randint(0, n_cls, (n,)).astype(np.float32)
    X[np.arange(n), Y.astype(int)] += 2.0   # separable
    return X, Y


def _example_net(mx):
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return mx.sym.Custom(net, label, op_type="numpy_softmax",
                         name="softmax")


def test_numpy_softmax_module_fit_matches():
    X, Y = _example_data()
    rng = np.random.RandomState(1)
    params = {"fc1_weight": rng.uniform(-0.5, 0.5, (16, 16)),
              "fc1_bias": np.zeros(16), "fc2_weight":
              rng.uniform(-0.5, 0.5, (4, 16)), "fc2_bias": np.zeros(4)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    got = {}
    for pkg in (jmx, mt):
        kw = {"ctx": CPU} if pkg is mt else {}
        net = _example_net(pkg)
        assert net.list_outputs() == ["softmax_output"]
        it = pkg.io.NDArrayIter(X, Y, batch_size=64, shuffle=False)
        mod = pkg.mod.Module(net, context=pkg.cpu())
        arg = {k: pkg.nd.array(v, **kw) for k, v in params.items()}
        mod.fit(it, num_epoch=1, optimizer="adam",
                optimizer_params={"learning_rate": 5e-3}, arg_params=arg,
                eval_metric="acc")
        got[pkg] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        it.reset()
        got[pkg, "score"] = dict(mod.score(it, "acc"))["accuracy"]
        got[pkg, "predict"] = mod.predict(it).asnumpy()
    for k in params:
        assert _rel(got[mt][k], got[jmx][k]) <= FIT_REL, k
        assert not np.array_equal(got[mt][k], params[k])
    assert got[mt, "score"] == pytest.approx(got[jmx, "score"], abs=1e-9)
    assert got[mt, "predict"].shape == (512, 4)
    np.testing.assert_allclose(got[mt, "predict"], got[jmx, "predict"],
                               rtol=1e-4, atol=1e-6)


def test_nd_custom_forward_matches():
    x = np.random.RandomState(2).randn(5, 4).astype(np.float32)
    y = np.array([0, 3, 1, 2, 0], np.float32)
    outs = [pkg.nd.Custom(pkg.nd.array(x, **kw), pkg.nd.array(y, **kw),
                          op_type="numpy_softmax").asnumpy()
            for pkg, kw in ((jmx, {}), (mt, {"ctx": CPU}))]
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(outs[1].sum(1), 1.0, rtol=1e-6)


def test_custom_with_aux_state_imperative_matches():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    res = []
    for pkg, kw in ((jmx, {}), (mt, {"ctx": CPU})):
        total = pkg.nd.zeros((1,), **kw)
        out = pkg.nd.Custom(pkg.nd.array(x, **kw), total,
                            op_type="running_sum")
        res.append((out.asnumpy(), total.asnumpy()))
    np.testing.assert_array_equal(res[1][0], res[0][0])
    np.testing.assert_array_equal(res[1][0], 2 * x)
    # imperative calls run in inference mode: the state stays
    np.testing.assert_array_equal(res[1][1], res[0][1])


def test_custom_with_aux_state_in_a_symbol():
    net = mt.sym.Custom(mt.sym.Variable("data"), mt.sym.Variable("total"),
                        op_type="running_sum", name="rs")
    assert net.list_arguments() == ["data"]
    assert net.list_auxiliary_states() == ["total"]
    assert net.infer_shape(data=(2, 3)) == ([(2, 3)], [(2, 3)], [(1,)])
    ex = net.simple_bind(ctx=CPU, data=(2, 3))
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    ex.forward(is_train=False, data=x)
    assert ex.aux_dict["total"].asnumpy()[0] == 0.0
    out = ex.forward(is_train=True, data=x)[0]
    np.testing.assert_array_equal(out.asnumpy(), 2 * x)
    assert ex.aux_dict["total"].asnumpy()[0] == x.sum()
    ex.backward(mt.nd.ones((2, 3), ctx=CPU))
    np.testing.assert_array_equal(ex.grad_dict["data"].asnumpy(),
                                  np.full((2, 3), 2.0))
    # the backward used that forward: the state moved once
    assert ex.aux_dict["total"].asnumpy()[0] == x.sum()
    ex.backward(data=x + 1)          # new inputs: a forward of its own
    assert ex.aux_dict["total"].asnumpy()[0] == x.sum() + (x + 1).sum()


def test_custom_op_context_and_registry():
    seen = {}

    class Probe(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen["is_train"] = is_train
            seen["made_on"] = mt.nd.array([1.0]).context
            self.assign(out_data[0], req[0], in_data[0])

    @mt.operator.register("probe")
    class ProbeProp(mt.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            seen["ctx"] = ctx
            return Probe()

    assert "probe" in mt.operator.get_all_registered()
    mt.nd.Custom(mt.nd.zeros((2,), ctx=CPU), op_type="probe")
    # create_operator gets the real Context, and the user's forward runs
    # in it: arrays it makes land on the op's device
    assert seen == {"ctx": CPU, "is_train": False, "made_on": CPU}
    with pytest.raises(KeyError, match="not registered"):
        mt.nd.Custom(mt.nd.zeros((2,), ctx=CPU), op_type="no_such_op")
    with pytest.raises(TypeError):
        mt.operator.register("bad")(object)


# ---------------------------------------------------------------------------
# mx.rtc without a card
# ---------------------------------------------------------------------------
def test_rtc_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mt.rtc.CudaModule('extern "C" __global__ void k() {}')
    with pytest.raises(NotImplementedError, match="CudaModule"):
        mt.rtc.PallasModule("def k(x_ref, o_ref): pass")
    # the JAX package's rtc is the mirror image
    with pytest.raises(NotImplementedError, match="PallasModule"):
        jmx.rtc.CudaModule('__global__ void k() {}')


@pytest.mark.parametrize("ctype,dtype", sorted(rtc._DTYPES.items()))
def test_signature_parser_types(ctype, dtype):
    sig = "const %s *x, %s *y, %s alpha" % (ctype, ctype, ctype)
    assert rtc.parse_signature(sig) == [
        (True, np.dtype(dtype), True), (True, np.dtype(dtype), False),
        (False, np.dtype(dtype), False)]


def test_signature_parser_layout_and_errors():
    assert rtc.parse_signature(
        "const float*x,\n  float  * y , float alpha,int n") == [
        (True, np.dtype(np.float32), True),
        (True, np.dtype(np.float32), False),
        (False, np.dtype(np.float32), False),
        (False, np.dtype(np.int32), False)]
    assert rtc.parse_signature("int64_t n") == [
        (False, np.dtype(np.int64), False)]
    with pytest.raises(TypeError, match="unsupported"):
        rtc.parse_signature("float2 *x")
    with pytest.raises(ValueError, match="invalid"):
        rtc.parse_signature("float **x")
    with pytest.raises(ValueError, match="invalid"):
        rtc.parse_signature("const *x")


def test_launch_argument_validation():
    params = rtc.parse_signature("const float *x, double *y, float a, int n")
    cpu = torch.device("cpu")
    x = mt.nd.zeros((4,), ctx=CPU)
    y = mt.nd.zeros((4,), ctx=CPU, dtype=np.float64)
    values = rtc.marshal(params, [x, y, 2.5, 4], cpu)
    assert [type(v).__name__ for v in values] == [
        "c_void_p", "c_void_p", "c_float", "c_int"]
    assert values[0].value == x.data.data_ptr()
    assert values[2].value == 2.5 and values[3].value == 4
    with pytest.raises(ValueError, match="takes 4 arguments"):
        rtc.marshal(params, [x, y, 2.5], cpu)
    with pytest.raises(TypeError, match="the signature says float64"):
        rtc.marshal(params, [x, x, 2.5, 4], cpu)           # dtype mismatch
    with pytest.raises(TypeError, match="pass an NDArray"):
        rtc.marshal(params, [x.asnumpy(), y, 2.5, 4], cpu)
    with pytest.raises(TypeError, match="pass a number"):
        rtc.marshal(params, [x, y, x, 4], cpu)
    with pytest.raises(ValueError, match="lies on cpu"):
        rtc.marshal(params, [x, y, 2.5, 4], torch.device("cuda", 0))
    strided = mt.nd.NDArray(torch.zeros(8)[::2])
    with pytest.raises(ValueError, match="not contiguous"):
        rtc.marshal(params, [strided, y, 2.5, 4], cpu)
    half = rtc.marshal(rtc.parse_signature("half h"), [1.5], cpu)[0]
    assert half.value == int(np.float16(1.5).view(np.uint16))
    kernel = rtc.CudaKernel(None, "k", params)
    with pytest.raises(ValueError, match="gpu Context"):
        kernel.launch([x, y, 2.5, 4], CPU, (1, 1, 1), (4, 1, 1))
