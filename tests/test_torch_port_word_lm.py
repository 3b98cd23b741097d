"""The LSTM language model's symbolic path in the port against the JAX
package's, on the CPU.

* ``example/rnn/word_lm.py``'s graph (Embedding -> fused 2-layer LSTM
  ``sym.RNN`` -> FullyConnected -> SoftmaxOutput) at a small size, bound
  by ``Module`` in both packages from the JAX package's Xavier-initialized
  parameters, trained 3 steps with the example's SGD (lr 1.0, momentum
  0.9) on seeded tokens: each step's output within ``FWD_REL`` of its
  largest entry, every parameter after each step within ``PARAM_REL`` of
  its largest entry, the perplexity of the 3 batches within ``FWD_REL``.
* ``example/rnn/bucketing.py``'s ``sym_gen`` under ``BucketingModule``
  over 3 buckets and 6 batches (with ``bucket_key`` and ``provide_data``
  on each): every bucket binds once, a switch hands the next bucket the
  current one's updated parameters, and the outputs and final parameters
  match the JAX package's as above.
* ``Perplexity`` with and without ``ignore_label`` against the JAX
  package's, exact up to f64 rounding.

Parameters come from the JAX side through numpy (``jax.random`` cannot be
replayed in torch); the graphs are written once here, as the examples
write them, for both packages.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.model import params_from_numpy

torch.set_num_threads(1)

CPU = mt.cpu()
FWD_REL = 1e-5
PARAM_REL = 1e-4
VOCAB, EMSIZE, NHID, NLAYERS, BPTT, BATCH = 40, 8, 12, 2, 6, 4
SGD = {"learning_rate": 1.0, "momentum": 0.9}
BUCKETS = (5, 9, 13)           # sequence lengths (padded length - 1)


def _word_lm(mx, nlayers=NLAYERS):
    """word_lm.py's graph (and bucketing.py's sym_gen with 1 layer)."""
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    embed = mx.sym.Embedding(data, input_dim=VOCAB, output_dim=EMSIZE,
                             name="embed")
    rnn_params = mx.sym.Variable("lstm_parameters",
                                 init=mx.init.Normal(0.05))
    state = mx.sym.Variable("lstm_state", init=mx.init.Zero())
    state_cell = mx.sym.Variable("lstm_state_cell", init=mx.init.Zero())
    rnn = mx.sym.RNN(embed, parameters=rnn_params, state=state,
                     state_cell=state_cell, state_size=NHID,
                     num_layers=nlayers, mode="lstm", name="lstm")
    pred = mx.sym.reshape(rnn, shape=(-1, NHID))
    pred = mx.sym.FullyConnected(pred, num_hidden=VOCAB, name="decoder")
    return mx.sym.SoftmaxOutput(pred, mx.sym.reshape(label, shape=(-1,)),
                                name="softmax")


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, (what, err)


def _np(d):
    return {k: v.asnumpy() for k, v in d.items()}


def _batches(n, seq, seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, VOCAB, (n, seq + 1, BATCH)).astype(np.float32)
    return [(t[:-1], t[1:]) for t in toks]


def _batch(mx, x, y, key=None):
    ctx = {"ctx": CPU} if mx is mt else {}
    kw = {}
    if key is not None:
        kw = dict(bucket_key=key,
                  provide_data=[mx.io.DataDesc("data", x.shape)],
                  provide_label=[mx.io.DataDesc("softmax_label", y.shape)])
    return mx.io.DataBatch([mx.nd.array(x, **ctx)], [mx.nd.array(y, **ctx)],
                           **kw)


def _jax_init(mod):
    jmx.random.seed(0)
    np.random.seed(0)
    mod.init_params(jmx.init.Xavier())
    args, auxs = mod.get_params()
    return _np(args), _np(auxs)


def _train(mx, mod, batches, keys=None):
    """Per step the output and the parameters after the update; the
    perplexity over all batches."""
    metric = mx.metric.Perplexity(ignore_label=None)
    outs, params = [], []
    for i, (x, y) in enumerate(batches):
        batch = _batch(mx, x, y, None if keys is None else keys[i])
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(metric, batch.label)
        outs.append(mod.get_outputs()[0].asnumpy())
        params.append(_np(mod.get_params()[0]))
    return outs, params, metric.get()[1]


def _assert_runs_match(got, want):
    for step, (g, w) in enumerate(zip(got[0], want[0])):
        _close(g, w, FWD_REL, "output of step %d" % step)
    for step, (g, w) in enumerate(zip(got[1], want[1])):
        assert sorted(g) == sorted(w)
        for name in w:
            _close(g[name], w[name], PARAM_REL, (step, name))
    _close(got[2], want[2], FWD_REL, "perplexity")


def _module(mx, **ctx):
    mod = mx.mod.Module(_word_lm(mx), data_names=["data"],
                        label_names=["softmax_label"], **ctx)
    mod.bind(data_shapes=[("data", (BPTT, BATCH))],
             label_shapes=[("softmax_label", (BPTT, BATCH))],
             for_training=True)
    return mod


def test_word_lm_module_sgd_steps_match_jax():
    jmod = _module(jmx)
    args, auxs = _jax_init(jmod)
    assert args["lstm_parameters"].shape == (
        4 * NHID * (EMSIZE + NHID) + 4 * NHID * 2 * NHID + 2 * 8 * NHID,)
    jmod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    tmod = _module(mt, context=CPU)
    a, b = params_from_numpy(args, auxs, ctx=CPU)
    tmod.init_params(arg_params=a, aux_params=b)
    tmod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    batches = _batches(3, BPTT, seed=1)
    want = _train(jmx, jmod, batches)
    got = _train(mt, tmod, batches)
    _assert_runs_match(got, want)
    assert np.isfinite(got[2]) and got[2] > 1.0


def test_fixed_param_names_are_not_trained():
    mod = mt.mod.Module(_word_lm(mt), context=CPU,
                        fixed_param_names=["embed_weight"])
    mod.bind(data_shapes=[("data", (BPTT, BATCH))],
             label_shapes=[("softmax_label", (BPTT, BATCH))])
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    before = _np(mod.get_params()[0])
    _train(mt, mod, _batches(1, BPTT, seed=2))
    after = _np(mod.get_params()[0])
    assert mod._exec.grad_dict["embed_weight"] is None
    assert np.array_equal(after["embed_weight"], before["embed_weight"])
    assert not np.array_equal(after["decoder_weight"],
                              before["decoder_weight"])


def _sym_gen(mx):
    def sym_gen(bucket_key):
        return _word_lm(mx, nlayers=1), ("data",), ("softmax_label",)
    return sym_gen


def _bucketing(mx, **ctx):
    mod = mx.mod.BucketingModule(_sym_gen(mx),
                                 default_bucket_key=max(BUCKETS), **ctx)
    shape = (max(BUCKETS), BATCH)
    mod.bind(data_shapes=[mx.io.DataDesc("data", shape)],
             label_shapes=[mx.io.DataDesc("softmax_label", shape)])
    return mod


def test_bucketing_module_matches_jax_and_carries_parameters():
    keys = [9, 5, 9, 13, 5, 13]
    batches = []
    for i, key in enumerate(keys):
        batches += _batches(1, key, seed=10 + i)
    jmod = _bucketing(jmx)
    args, auxs = _jax_init(jmod)
    jmod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    tmod = _bucketing(mt, context=CPU)
    a, b = params_from_numpy(args, auxs, ctx=CPU)
    tmod.init_params(arg_params=a, aux_params=b)
    tmod.init_optimizer(optimizer="sgd", optimizer_params=SGD)

    bound = []
    orig = mt.mod.Module.bind

    def counting_bind(self, data_shapes, *a, **kw):
        bound.append(tuple(dict(data_shapes)["data"]))
        return orig(self, data_shapes, *a, **kw)

    want = _train(jmx, jmod, batches, keys)
    mt.mod.Module.bind = counting_bind
    try:
        got = _train(mt, tmod, batches, keys)
    finally:
        mt.mod.Module.bind = orig
    _assert_runs_match(got, want)
    # each new bucket bound once (the default bucket before the run)
    assert sorted(tmod._buckets) == sorted(BUCKETS)
    assert bound == [(9, BATCH), (5, BATCH)]
    # every bucket shares the one optimizer: its count is the run's steps
    assert all(m._updater is tmod._curr_module._updater
               for m in tmod._buckets.values())
    assert tmod._curr_module._optimizer.num_update == len(keys)
    # a switch hands over the updated parameters
    x, y = batches[0]
    last = got[1][-1]
    tmod.forward(_batch(mt, x, y, key=9), is_train=False)
    assert tmod._curr_bucket_key == 9
    for name, v in _np(tmod.get_params()[0]).items():
        assert np.array_equal(v, last[name]), name


@pytest.mark.parametrize("ignore_label", [None, 0, 3])
def test_perplexity_matches_jax(ignore_label):
    rng = np.random.RandomState(5)
    preds = [rng.dirichlet(np.ones(7), size=12).astype(np.float32)
             for _ in range(2)]
    labels = [rng.randint(0, 7, (3, 4)).astype(np.float32) for _ in range(2)]
    preds[0][0] = 0.0                       # the 1e-10 floor
    vals = []
    for mx, kw in ((mt, {"ctx": CPU}), (jmx, {})):
        m = mx.metric.create("perplexity", ignore_label=ignore_label)
        for p, lab in zip(preds, labels):
            m.update([mx.nd.array(lab, **kw)], [mx.nd.array(p, **kw)])
        vals.append(m.get())
    assert vals[0][0] == vals[1][0] == "perplexity"
    assert abs(vals[0][1] - vals[1][1]) <= 1e-12 * vals[1][1]
    empty = mt.metric.Perplexity(ignore_label=None)
    assert np.isnan(empty.get()[1])
    with pytest.raises(ValueError, match="shape mismatch"):
        empty.update([mt.nd.array(labels[0][:2], ctx=CPU)],
                     [mt.nd.array(preds[0], ctx=CPU)])
