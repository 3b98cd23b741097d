"""The port's fused ``RNN`` op, sequence ops and the tensor ops of the RNN
path against the JAX package's, on the CPU.

Inputs are seeded numpy arrays fed to both packages.  The JAX side is the
op's own function (``mxnet_tpu.ops.rnn._rnn``) under one ``jax.jit`` of
its ``jax.vjp`` per configuration; the port's is its registered op under
``torch.autograd.grad`` with the same cotangents.

* ``RNN`` for lstm, gru, rnn_tanh and rnn_relu × 1 or 2 layers × uni- or
  bidirectional: the output, ``hy`` and ``cy`` within ``FWD_REL`` of each
  tensor's largest entry, and the gradients of the data, the packed
  parameters and both states within ``GRAD_REL`` of each one's largest
  entry (f32, the same arithmetic summed in another order);
  ``rnn_param_size``; the outputs a symbol and ``nd.RNN`` show;
* inter-layer dropout (``p > 0``): the mask's rate and scaling in
  training, the layers it sits between, identity in inference;
* the reference's quirk: ``lstm_state_clip_*``, ``projection_size`` and
  ``use_sequence_length`` are accepted and ignored by both packages;
* ``SequenceMask`` / ``SequenceLast`` / ``SequenceReverse`` and ``split`` /
  ``SliceChannel`` / ``stack`` / ``expand_dims`` / ``squeeze`` /
  ``zeros_like`` / ``ones_like`` through ``nd`` in both packages, exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import rnn as jrnn
from mxnet_tpu_torch.ops import rnn as trnn

torch.set_num_threads(1)

CPU = mt.cpu()
FWD_REL = 1e-5
GRAD_REL = 1e-4
T, N, I, H = 5, 3, 4, 6
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, (what, err)


def _case(mode, layers, bidir, seed=0):
    dirs = 2 if bidir else 1
    rng = np.random.RandomState(seed)
    size = jrnn.rnn_param_size(mode, I, H, layers, bidir)
    return (rng.randn(T, N, I).astype(np.float32),
            (rng.randn(size) * 0.3).astype(np.float32),
            rng.randn(layers * dirs, N, H).astype(np.float32),
            rng.randn(layers * dirs, N, H).astype(np.float32))


def _jax_fwd_bwd(args, cts, **kw):
    def f(*a):
        return jrnn._rnn(jax.random.PRNGKey(0), *a, **kw)

    @jax.jit
    def run(args, cts):
        outs, vjp = jax.vjp(f, *args)
        return outs, vjp(cts)

    outs, grads = run(tuple(jnp.asarray(a) for a in args),
                      tuple(jnp.asarray(c) for c in cts))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


@pytest.mark.parametrize("bidir", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_matches_jax(mode, layers, bidir):
    args = _case(mode, layers, bidir)
    kw = dict(mode=mode, state_size=H, num_layers=layers,
              bidirectional=bidir)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    outs = trnn._rnn(*ts, **kw)
    assert len(outs) == (3 if mode == "lstm" else 2)
    rng = np.random.RandomState(1)
    cts = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    grads = torch.autograd.grad(outs, ts, [torch.tensor(c) for c in cts],
                                allow_unused=True)
    want_outs, want_grads = _jax_fwd_bwd(args, cts, **kw)
    for name, o, w in zip(("out", "hy", "cy"), outs, want_outs):
        _close(o.detach(), w, FWD_REL, name)
    for name, g, w, a in zip(("data", "parameters", "state", "state_cell"),
                             grads, want_grads, args):
        # the cell state is no input of gru / rnn_*: a zero gradient in JAX
        _close(np.zeros_like(a) if g is None else g, w, GRAD_REL, name)


@pytest.mark.parametrize("mode", MODES)
def test_rnn_param_size_matches_jax(mode):
    for inp, hid, layers, bidir in [(1, 1, 1, False), (4, 6, 2, True),
                                    (650, 650, 2, False), (32, 64, 3, True)]:
        assert trnn.rnn_param_size(mode, inp, hid, layers, bidir) == \
            jrnn.rnn_param_size(mode, inp, hid, layers, bidir)


def _rnn_sym(mx, mode, **extra):
    data = mx.sym.Variable("data")
    return mx.sym.RNN(data, state_size=H, num_layers=2, mode=mode,
                      name="rnn", **extra)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_visible_outputs_of_symbol_and_nd_match_jax(mode):
    for extra in ({}, {"state_outputs": True}, {"state_outputs": False}):
        got = _rnn_sym(mt, mode, **extra)
        want = _rnn_sym(jmx, mode, **extra)
        assert got.list_outputs() == want.list_outputs(), extra
        assert got.list_arguments() == want.list_arguments()
    args = _case(mode, 2, False)
    kw = dict(mode=mode, state_size=H, num_layers=2)
    for extra in ({}, {"state_outputs": False}):
        got = mt.nd.RNN(*(mt.nd.array(a, ctx=CPU) for a in args),
                        **kw, **extra)
        want = jmx.nd.RNN(*(jmx.nd.array(a) for a in args), **kw, **extra)
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g.asnumpy(), w.asnumpy(), FWD_REL, extra)


def test_inference_shapes_of_the_rnn_graph_match_jax():
    """simple_bind sizes the packed parameters and both states."""
    for mx in (mt, jmx):
        data = mx.sym.Variable("data")
        embed = mx.sym.Embedding(data, input_dim=11, output_dim=I,
                                 name="embed")
        rnn = mx.sym.RNN(embed, state_size=H, num_layers=2, mode="lstm",
                         bidirectional=True, name="lstm")
        shapes = rnn.infer_shape(data=(T, N))
        if mx is mt:
            got = shapes
        else:
            want = shapes
    assert got == want
    assert got[0][1] == (11, I)


def test_dropout_between_layers_rate_scale_and_inference_identity():
    x = torch.ones(400, 250)
    mt.random.seed(3)
    y = trnn._dropout(x, 0.3)
    zero = (y == 0).float().mean().item()
    assert abs(zero - 0.3) < 0.01, zero
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.7))

    args = [torch.tensor(a) for a in _case("lstm", 2, True)]
    kw = dict(mode="lstm", state_size=H, num_layers=2, bidirectional=True)
    plain = trnn._rnn(*args, **kw)
    # inference: p changes nothing (the JAX package's output)
    for g, w in zip(trnn._rnn(*args, p=0.5, **kw), plain):
        assert torch.equal(g, w)
    want, _ = _jax_fwd_bwd(
        [a.numpy() for a in args],
        [np.zeros(o.shape, np.float32) for o in plain], p=0.5, **kw)
    _close(plain[0], want[0], FWD_REL, "inference with p")
    # training: layer 1, the mask drawn from mx.random, then layer 2 on it
    mt.random.seed(5)
    out, hy, cy = trnn._rnn(*args, p=0.5, _train=True, **kw)
    mt.random.seed(5)
    x, p, h0, c0 = args
    w, b = trnn._unpack(p, "lstm", I, H, 2, True)
    flat1 = torch.cat([t.reshape(-1) for t in
                       [*w[0], *w[1], *b[0], *b[1]]])
    y1, hy1, cy1 = trnn.rnn_reference(x, flat1, h0[:2], c0[:2], mode="lstm",
                                      state_size=H, bidirectional=True)
    y1 = trnn._dropout(y1, 0.5)
    assert abs((y1 == 0).float().mean().item() - 0.5) < 0.1
    flat2 = torch.cat([t.reshape(-1) for t in
                       [*w[2], *w[3], *b[2], *b[3]]])
    y2, hy2, cy2 = trnn.rnn_reference(y1, flat2, h0[2:], c0[2:],
                                      mode="lstm", state_size=H,
                                      bidirectional=True)
    assert torch.allclose(out, y2, atol=1e-6)        # none after the last
    assert torch.allclose(hy, torch.cat([hy1, hy2]), atol=1e-6)
    assert torch.allclose(cy, torch.cat([cy1, cy2]), atol=1e-6)
    # nd.RNN takes its training flag from autograd
    nd_args = [mt.nd.array(a.numpy(), ctx=CPU) for a in args]
    with mt.autograd.train_mode():
        trained = mt.nd.RNN(*nd_args, p=0.5, **kw)[0].asnumpy()
    assert not np.allclose(trained, plain[0].numpy())
    assert np.array_equal(mt.nd.RNN(*nd_args, p=0.5, **kw)[0].asnumpy(),
                          plain[0].numpy())


def test_ignored_attributes_quirk_matches_jax():
    """The reference's quirk, kept: state clipping, projection and
    per-sequence lengths are accepted and ignored by both packages."""
    args = _case("lstm", 2, False, seed=4)
    kw = dict(mode="lstm", state_size=H, num_layers=2)
    quirk = dict(lstm_state_clip_min=-0.01, lstm_state_clip_max=0.01,
                 lstm_state_clip_nan=True, projection_size=2,
                 use_sequence_length=True)
    ts = [torch.tensor(a) for a in args]
    base = trnn._rnn(*ts, **kw)
    got = trnn._rnn(*ts, **kw, **quirk)
    cts = [np.zeros(o.shape, np.float32) for o in base]
    want, _ = _jax_fwd_bwd(args, cts, **kw, **quirk)
    for g, b, w in zip(got, base, want):
        assert torch.equal(g, b)
        _close(g, w, FWD_REL, "quirk")
    assert np.abs(np.asarray(base[2])).max() > 0.01    # no clip happened


def _nd_pair(a):
    return mt.nd.array(a, ctx=CPU), jmx.nd.array(a)


SEQ = np.random.RandomState(7).randn(5, 3, 2).astype(np.float32)
LENS = np.array([2, 5, 3], np.float32)
SEQ_CASES = [
    ("SequenceMask", {}),
    ("SequenceMask", {"use_sequence_length": True, "value": -1.5}),
    ("SequenceMask", {"use_sequence_length": True, "axis": 1}),
    ("SequenceLast", {}),
    ("SequenceLast", {"use_sequence_length": True}),
    ("SequenceLast", {"use_sequence_length": True, "axis": 1}),
    ("SequenceReverse", {}),
    ("SequenceReverse", {"use_sequence_length": True}),
]


@pytest.mark.parametrize("op,kw", SEQ_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(SEQ_CASES)])
def test_sequence_ops_match_jax(op, kw):
    seq = SEQ.transpose(1, 0, 2) if kw.get("axis") == 1 else SEQ
    got_x, want_x = _nd_pair(seq)
    inputs_t, inputs_j = [got_x], [want_x]
    if kw.get("use_sequence_length"):
        gl, wl = _nd_pair(LENS)
        inputs_t.append(gl)
        inputs_j.append(wl)
    got = getattr(mt.nd, op)(*inputs_t, **kw).asnumpy()
    want = getattr(jmx.nd, op)(*inputs_j, **kw).asnumpy()
    assert got.shape == want.shape and np.array_equal(got, want)


def _as_list(r):
    return r if isinstance(r, list) else [r]


TENSOR_CASES = [
    ("split", {"num_outputs": 3, "axis": 0}),
    ("split", {"num_outputs": 5, "axis": 0, "squeeze_axis": True}),
    ("SliceChannel", {"num_outputs": 2, "axis": 2}),
    ("split", {"num_outputs": 1, "axis": 1}),
    ("expand_dims", {"axis": 1}),
    ("squeeze", {}),
    ("squeeze", {"axis": 1}),
    ("zeros_like", {}),
    ("ones_like", {}),
]


@pytest.mark.parametrize("op,kw", TENSOR_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(TENSOR_CASES)])
def test_tensor_ops_match_jax(op, kw):
    x = SEQ[:, :1] if op == "squeeze" else SEQ
    if kw.get("num_outputs") == 3:
        x = np.random.RandomState(2).randn(6, 3, 2).astype(np.float32)
    gx, jx = _nd_pair(x)
    got = _as_list(getattr(mt.nd, op)(gx, **kw))
    want = _as_list(getattr(jmx.nd, op)(jx, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g.asnumpy(),
                                                     w.asnumpy())


def test_stack_and_method_forms_match_jax():
    a, b = SEQ, SEQ * 2
    for axis in (0, 1, 3):
        got = mt.nd.stack(*(mt.nd.array(v, ctx=CPU) for v in (a, b)),
                          axis=axis)
        want = jmx.nd.stack(*(jmx.nd.array(v) for v in (a, b)), axis=axis)
        assert np.array_equal(got.asnumpy(), want.asnumpy())
    gx, jx = _nd_pair(SEQ)
    for g, w in zip(gx.split(5, axis=0, squeeze_axis=True),
                    jx.split(5, axis=0, squeeze_axis=True)):
        assert np.array_equal(g.asnumpy(), w.asnumpy())
    assert gx.expand_dims(0).shape == jx.expand_dims(0).shape
    assert gx.expand_dims(0).squeeze(0).shape == SEQ.shape
    # symbols show one output per piece, named as in the JAX package
    for mx in (mt, jmx):
        s = mx.sym.split(mx.sym.Variable("x"), num_outputs=3, axis=1,
                         name="sp")
        names = s.list_outputs()
        if mx is mt:
            got_names = names
    assert got_names == names == ["sp_output0", "sp_output1", "sp_output2"]
