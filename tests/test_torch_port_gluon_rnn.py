"""The port's ``gluon.rnn`` against the JAX package's, on the CPU.

Each case builds the same block in both packages, initializes the JAX one
(Xavier, seeded), and loads its parameters, read out as numpy, into the
port's by name (``Block.load_dict(..., from_prefix=)``).  One recorded
forward on seeded inputs, then ``backward`` of ``sum(out * ct)`` plus the
same of every returned state: outputs and states within ``FWD_REL`` of each
tensor's largest entry, every parameter gradient and the input's gradient
within ``GRAD_REL`` of its largest entry (f32).

* The fused layers ``LSTM``, ``GRU`` and ``RNN`` (tanh, relu): 1 or 2
  layers, uni- or bidirectional, TNC and NTC, with given states and with
  ``begin_state``'s zeros; hybridized against eager (the same bits).
* The cells through ``unroll``: ``RNNCell`` / ``LSTMCell`` / ``GRUCell``
  merged and unmerged in both layouts, with ``valid_length`` (the JAX
  package's masking, which broadcasts the lengths against the hidden
  axis: it runs where hidden == batch, and raises otherwise in both),
  ``SequentialRNNCell`` (with a ``DropoutCell``), ``BidirectionalCell``,
  ``ResidualCell`` and ``ZoneoutCell`` at 0.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt

torch.set_num_threads(1)

CPU = mt.cpu()
FWD_REL = 1e-5
GRAD_REL = 1e-4
T, N, I, H = 4, 3, 5, 6


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, (what, err)


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _flat(v)]
    return [x]


def _arr(mx, a):
    return mx.nd.array(a, ctx=CPU) if mx is mt else mx.nd.array(a)


def _run(mx, block, x, call, states=None):
    """One recorded forward ``call(mx, block, x, states)`` and the backward of
    ``sum(out * ct)`` over every returned array: the arrays, the input's
    gradient and the parameters' gradients, as numpy."""
    xa = _arr(mx, x)
    xa.attach_grad()
    sa = None if states is None else [_arr(mx, s) for s in states]
    with mx.autograd.record():
        outs = _flat(call(mx, block, xa, sa))
        rng = np.random.RandomState(9)
        loss = None
        for o in outs:
            term = (o * _arr(mx, rng.randn(*o.shape).astype(
                np.float32))).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    k = len(block.prefix)                  # names under the block's prefix
    grads = {n[k:]: p.grad().asnumpy()
             for n, p in block.collect_params().items()}
    return [o.asnumpy() for o in outs], xa.grad.asnumpy(), grads


def _jax(make, x, call, states=None):
    """The JAX block, initialized, through ``_run``; and its weights."""
    jmx.random.seed(1)
    np.random.seed(1)
    jb = make(jmx)
    jb.initialize(jmx.init.Xavier())
    want = _run(jmx, jb, x, call, states)
    return want, ({n: p.data().asnumpy()
                   for n, p in jb.collect_params().items()}, jb.prefix)


def _port(make, x, call, weights, states=None, hybridize=False):
    """The port's block, the JAX block's weights loaded, through
    ``_run``."""
    tb = make(mt)
    tb.load_dict(weights[0], ctx=CPU, from_prefix=weights[1])
    if hybridize:
        tb.hybridize()
    return _run(mt, tb, x, call, states), tb


def _pair(make, x, call, states=None):
    want, weights = _jax(make, x, call, states)
    got, tb = _port(make, x, call, weights, states)
    return got, want, tb


def _assert_match(got, want):
    assert len(got[0]) == len(want[0])
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        _close(g, w, FWD_REL, "output %d" % i)
    _close(got[1], want[1], GRAD_REL, "input gradient")
    assert sorted(got[2]) == sorted(want[2])
    for name, w in want[2].items():
        _close(got[2][name], w, GRAD_REL, name)


LAYERS = [
    ("LSTM", {"num_layers": 2, "bidirectional": True, "layout": "NTC"}),
    ("LSTM", {"num_layers": 1, "layout": "TNC"}),
    ("GRU", {"num_layers": 2, "bidirectional": True, "layout": "TNC"}),
    ("GRU", {"num_layers": 1, "layout": "NTC"}),
    ("RNN", {"num_layers": 2, "activation": "tanh", "layout": "NTC"}),
    ("RNN", {"num_layers": 1, "activation": "relu", "bidirectional": True,
             "layout": "TNC"}),
]


def _layer_input(kw, seed=0):
    shape = (N, T, I) if kw["layout"] == "NTC" else (T, N, I)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("with_states", [True, False],
                         ids=["states", "zeros"])
@pytest.mark.parametrize("kind,kw", LAYERS,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(LAYERS)])
def test_fused_layer_matches_jax(kind, kw, with_states):
    x = _layer_input(kw)
    layer = getattr(mt.gluon.rnn, kind)(H, **kw)
    n_states = len(layer.state_info(N))
    states = None
    if with_states:
        dirs = 2 if kw.get("bidirectional") else 1
        rng = np.random.RandomState(3)
        states = [rng.randn(kw["num_layers"] * dirs, N, H).astype(
            np.float32) for _ in range(n_states)]

    def make(mx):
        return getattr(mx.gluon.rnn, kind)(H, **kw)

    def call(mx, block, xa, sa):
        return block(xa) if sa is None else block(xa, sa)

    got, want, tb = _pair(make, x, call, states)
    _assert_match(got, want)
    assert got[0][0].shape == (x.shape[0], x.shape[1],
                               H * (2 if kw.get("bidirectional") else 1))
    assert len(got[0]) == (1 if states is None else 1 + n_states)
    assert set(got[2]) == {
        "%s%d_%s_%s" % (d, i, m, w)
        for i in range(kw["num_layers"])
        for d in ("lr" if kw.get("bidirectional") else "l")
        for m in ("i2h", "h2h") for w in ("weight", "bias")}


@pytest.mark.parametrize("kind,kw", LAYERS[:3],
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(LAYERS[:3])])
def test_hybridized_layer_equals_eager_and_jax(kind, kw):
    x = _layer_input(kw, seed=4)

    def make(mx):
        return getattr(mx.gluon.rnn, kind)(H, **kw)

    def call(mx, block, xa, sa):
        return block(xa, block.begin_state(N, ctx=xa.context))

    want, weights = _jax(make, x, call)
    got, _ = _port(make, x, call, weights, hybridize=True)
    _assert_match(got, want)
    eager, _ = _port(make, x, call, weights)
    for a, b in zip(got[0], eager[0]):
        assert np.array_equal(a, b)
    for n in got[2]:
        assert np.array_equal(got[2][n], eager[2][n])


CELLS = ("RNNCell", "LSTMCell", "GRUCell")


@pytest.mark.parametrize("merge", [True, False], ids=["merged", "steps"])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_unroll_matches_jax(cell, layout, merge):
    x = _layer_input({"layout": layout}, seed=5)

    def make(mx):
        return getattr(mx.gluon.rnn, cell)(H, prefix="c_")

    def call(mx, block, xa, sa):
        return block.unroll(T, xa, layout=layout, merge_outputs=merge)

    got, want, _ = _pair(make, x, call)
    _assert_match(got, want)
    n_states = 2 if cell == "LSTMCell" else 1
    assert len(got[0]) == (1 if merge else T) + n_states


def test_unroll_with_valid_length_matches_jax():
    """The JAX package masks with ``where(valid_length > t, out, 0)``,
    whose (N,) condition broadcasts along the hidden axis: at hidden ==
    batch both packages give the same (column-masked) outputs and the
    last valid states, and at hidden != batch both raise."""
    lens = np.array([2, 4, 3], np.float32)
    x = np.random.RandomState(6).randn(N, T, I).astype(np.float32)

    def call(mx, block, xa, sa):
        return block.unroll(T, xa, layout="NTC", merge_outputs=True,
                            valid_length=_arr(mx, lens))

    for cell in ("LSTMCell", "GRUCell"):
        def make(mx, cell=cell):
            return getattr(mx.gluon.rnn, cell)(N, prefix="v_")

        got, want, _ = _pair(make, x, call)
        _assert_match(got, want)
        assert np.all(got[0][0][:, 3, 0] == 0)      # column 0: length 2
    for mx in (jmx, mt):
        c = mx.gluon.rnn.LSTMCell(H, prefix="w_")
        c.initialize(**({"ctx": CPU} if mx is mt else {}))
        with pytest.raises(Exception):
            c.unroll(T, _arr(mx, x), layout="NTC", merge_outputs=True,
                     valid_length=_arr(mx, lens))


def _sequential(mx):
    seq = mx.gluon.rnn.SequentialRNNCell(prefix="s_")
    with seq.name_scope():
        seq.add(mx.gluon.rnn.LSTMCell(H, prefix="a_"))
        seq.add(mx.gluon.rnn.DropoutCell(0.0))
        seq.add(mx.gluon.rnn.GRUCell(H, prefix="b_"))
    return seq


def _bidirectional(mx):
    return mx.gluon.rnn.BidirectionalCell(
        mx.gluon.rnn.LSTMCell(H, prefix="bl_"),
        mx.gluon.rnn.GRUCell(H, prefix="br_"))


def _residual(mx):
    return mx.gluon.rnn.ResidualCell(mx.gluon.rnn.GRUCell(I, prefix="r_"))


def _zoneout(mx):
    return mx.gluon.rnn.ZoneoutCell(mx.gluon.rnn.LSTMCell(H, prefix="z_"),
                                    zoneout_outputs=0.0, zoneout_states=0.0)


COMPOSITES = {"sequential": _sequential, "bidirectional": _bidirectional,
              "residual": _residual, "zoneout": _zoneout}


@pytest.mark.parametrize("merge", [True, False], ids=["merged", "steps"])
@pytest.mark.parametrize("name", sorted(COMPOSITES))
def test_composite_cells_match_jax(name, merge):
    x = np.random.RandomState(7).randn(N, T, I).astype(np.float32)

    def call(mx, block, xa, sa):
        with mx.autograd.train_mode():
            return block.unroll(T, xa, layout="NTC", merge_outputs=merge)

    got, want, tb = _pair(COMPOSITES[name], x, call)
    _assert_match(got, want)
    width = {"sequential": H, "bidirectional": 2 * H, "residual": I,
             "zoneout": H}[name]
    assert got[0][0].shape == ((N, T, width) if merge else (N, width))
    if name == "zoneout":
        # stepping the modified cell directly is refused, as in JAX
        with pytest.raises(RuntimeError):
            tb.base_cell.begin_state(batch_size=N)
