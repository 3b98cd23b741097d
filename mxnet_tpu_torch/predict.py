"""Standalone predict (serving) API.

Counterpart of ``mxnet_tpu/predict.py`` (reference ``src/c_api/
c_predict_api.cc`` / ``include/mxnet/c_predict_api.h``): load a
``prefix-symbol.json`` + ``prefix-####.params`` pair (a path, the bytes, or
a ``{name: NDArray}`` dict) in a fresh process, bind it for fixed input
shapes with ``grad_req='null'``, and run batched forwards.  Both the
pythonic :class:`Predictor` and the C-shaped ``MXPred*`` functions
(handle-based, one for one with the reference ABI) are here.

Where the JAX package compiles the graph into one XLA module, the port's
executor runs it node by node on the bound device (cuDNN / cuBLAS through
PyTorch on the card), so ``aot=True`` is one warm forward on the zero
inputs, and :meth:`Predictor.warm` runs one per batch size.  A
:class:`~mxnet_tpu_torch.dispatch.ShapeTracker` counts each new input
signature as a ``recompile``, as the JAX package's jit cache does.

The default context is ``gpu(0)`` (the JAX package's is ``cpu()``):
without a card the Predictor raises unless given ``ctx=cpu()``.  The
sharded mode (``mesh=`` / ``rules=``) is not ported and raises.
"""
from __future__ import annotations

import numpy as np

from . import dispatch as _dispatch
from . import ndarray as nd
from .context import Context, gpu
from .symbol import Group, Symbol, load as _sym_load, load_json

__all__ = ["Predictor", "MXPredCreate", "MXPredCreatePartialOut",
           "MXPredReshape", "MXPredGetOutputShape", "MXPredSetInput",
           "MXPredForward", "MXPredGetOutput", "MXPredFree"]


def _load_params(source, ctx=None):
    """``(arg_params, aux_params)`` of a params file path, its bytes or a
    ``{name: NDArray}`` dict, the ``arg:`` / ``aux:`` prefixes stripped."""
    if isinstance(source, dict):
        loaded = source
    elif isinstance(source, (bytes, bytearray, memoryview)):
        loaded = nd.load_frombuffer(bytes(source), ctx=ctx)
    else:
        loaded = nd.load(source, ctx=ctx)
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


class Predictor:
    """Inference-only executor over an exported symbol and its parameters
    (reference ``MXPredCreate`` -> ``PredictorObj``)."""

    def __init__(self, symbol, params, ctx=None, input_shapes=None,
                 input_dtypes=None, output_names=None, aot=True,
                 mesh=None, rules=None):
        if mesh is not None or rules is not None:
            raise NotImplementedError(
                "mxnet_tpu_torch: the sharded Predictor (mesh= / rules=) "
                "is not ported (ROADMAP Queue 1 item 9)")
        if isinstance(symbol, Symbol):
            sym = symbol
        elif isinstance(symbol, str) and symbol.lstrip().startswith("{"):
            sym = load_json(symbol)
        else:
            sym = _sym_load(symbol)
        if output_names is not None:
            outs = sym.list_outputs()
            picked = []
            for name in output_names:
                if name not in outs:
                    raise ValueError("output %r not found in %s"
                                     % (name, outs))
                picked.append(sym[outs.index(name)])
            sym = Group(picked)
        self._symbol = sym
        self._ctx = ctx or gpu(0)
        self._ctx.torch_device()                 # raises without a card
        arg_params, aux_params = _load_params(params, self._ctx)
        input_shapes = dict(input_shapes or {})
        self._input_names = [n for n in sym.list_arguments()
                             if n not in arg_params]
        missing = [n for n in self._input_names if n not in input_shapes]
        if missing:
            # label inputs of training heads (SoftmaxOutput etc.) are
            # inert at inference: infer their shapes from the data inputs
            # and bind zeros (the reference's c_predict_api binds them too)
            try:
                inferred, _, _ = sym.infer_shape(**input_shapes)
                by_name = dict(zip(sym.list_arguments(), inferred))
            except Exception:
                by_name = {}
            still = []
            for n in missing:
                shp = by_name.get(n)
                if shp is not None and n.endswith("label"):
                    input_shapes[n] = shp
                else:
                    still.append(n)
            if still:
                raise ValueError("input_shapes must cover the data "
                                 "inputs; missing %s" % still)
        args = {}
        for name in sym.list_arguments():
            if name in arg_params:
                args[name] = arg_params[name].as_in_context(self._ctx)
            else:
                dt = (input_dtypes or {}).get(name, np.float32)
                args[name] = nd.zeros(input_shapes[name], dtype=dt,
                                      ctx=self._ctx)
        auxs = {}
        for name in sym.list_auxiliary_states():
            if name not in aux_params:
                raise ValueError("missing auxiliary state %r in params"
                                 % name)
            auxs[name] = aux_params[name].as_in_context(self._ctx)
        self._input_dtypes = dict(input_dtypes or {})
        self._executor = sym.bind(ctx=self._ctx, args=args, grad_req="null",
                                  aux_states=auxs)
        self._tracker = _dispatch.ShapeTracker("Predictor")
        self.outputs = None
        if aot:
            # the first request pays no first-call cost (cuDNN algorithm
            # choice, allocator growth): one forward on the zero inputs
            self.forward()

    # -- c_predict_api surface ------------------------------------------
    def set_input(self, key, data):
        if key not in self._input_names:
            raise ValueError("unknown input %r (inputs: %s)"
                             % (key, self._input_names))
        self._executor._stage({key: data})

    def forward(self, **inputs):
        for k, v in inputs.items():
            self.set_input(k, v)
        self._tracker.note(*(self._executor.arg_dict[n].data
                             for n in self._input_names))
        self.outputs = self._executor.forward(is_train=False)
        return self.outputs

    def get_output(self, index=0):
        if self.outputs is None:
            raise RuntimeError("call forward() before get_output()")
        return self.outputs[index]

    def get_output_shape(self, index=0):
        if self.outputs is not None:
            return tuple(self.outputs[index].shape)
        feed = {n: self._executor.arg_dict[n].shape
                for n in self._input_names}
        _, out_shapes, _ = self._symbol.infer_shape(**feed)
        return tuple(out_shapes[index])

    def reshape(self, input_shapes):
        """A new predictor bound to other input shapes (reference
        MXPredReshape), over the same parameter arrays."""
        return Predictor(self._symbol, self._shared_params(), ctx=self._ctx,
                         input_shapes=input_shapes,
                         input_dtypes=self._input_dtypes)

    # -- serving hooks (mxnet_tpu_torch.serving) --------------------------
    def _shared_params(self):
        """The bound weights and auxiliary states as a prefixed dict of the
        same NDArrays (no copy): what reshape() and clone() share."""
        params = {}
        for name, arr in self._executor.arg_dict.items():
            if name not in self._input_names:
                params["arg:" + name] = arr
        for name, arr in self._executor.aux_dict.items():
            params["aux:" + name] = arr
        return params

    def clone(self, ctx=None):
        """A new replica over the SAME parameter arrays (no device copy on
        the same device); its executor stages inputs on its own, so two
        clones can serve at once."""
        shapes = {n: tuple(self._executor.arg_dict[n].shape)
                  for n in self._input_names}
        return Predictor(self._symbol, self._shared_params(),
                         ctx=ctx or self._ctx, input_shapes=shapes,
                         input_dtypes=self._input_dtypes)

    def warm(self, batch_sizes):
        """One zeros forward per leading-dim size, so no request is the
        first at its shape.  Returns the batch sizes warmed."""
        base = {n: tuple(self._executor.arg_dict[n].shape)
                for n in self._input_names}
        dtypes = {n: self._executor.arg_dict[n].dtype
                  for n in self._input_names}
        warmed = []
        for b in sorted(set(int(b) for b in batch_sizes)):
            feed = {n: nd.zeros((b,) + base[n][1:], dtype=dtypes[n],
                                ctx=self._ctx)
                    for n in base}
            self.forward(**feed)
            warmed.append(b)
        return warmed

    def health_check(self):
        """Liveness probe: one forward on zeros at the bound shapes;
        healthy iff it completes and every output is finite (the serving
        circuit breaker's half-open probe, ``Replica.probe``)."""
        try:
            feed = {n: nd.zeros(tuple(self._executor.arg_dict[n].shape),
                                dtype=self._executor.arg_dict[n].dtype,
                                ctx=self._ctx)
                    for n in self._input_names}
            outs = self.forward(**feed)
            return all(bool(np.isfinite(np.asarray(
                o.asnumpy(), np.float32)).all()) for o in outs)
        except Exception:
            return False


# ---------------------------------------------------------------------------
# C-shaped ABI (handle-based; reference include/mxnet/c_predict_api.h)
# ---------------------------------------------------------------------------
_handles: dict = {}
_next_handle = [1]


def _dev_ctx(dev_type, dev_id):
    """``dev_type`` 1 is the CPU, 2 the card (the reference's kCPU /
    kGPU)."""
    return Context("cpu" if dev_type == 1 else "gpu", dev_id)


def _register(pred):
    h = _next_handle[0]
    _next_handle[0] += 1
    _handles[h] = pred
    return h


def MXPredCreate(symbol_json_str, param_bytes, dev_type=2, dev_id=0,
                 num_input_nodes=None, input_keys=(), input_shapes=()):
    """reference c_predict_api.h:78."""
    shapes = dict(zip(input_keys, [tuple(s) for s in input_shapes]))
    return _register(Predictor(symbol_json_str, param_bytes,
                               ctx=_dev_ctx(dev_type, dev_id),
                               input_shapes=shapes))


def MXPredCreatePartialOut(symbol_json_str, param_bytes, dev_type, dev_id,
                           input_keys, input_shapes, output_keys):
    """reference c_predict_api.h:111: only the named outputs."""
    shapes = dict(zip(input_keys, [tuple(s) for s in input_shapes]))
    return _register(Predictor(symbol_json_str, param_bytes,
                               ctx=_dev_ctx(dev_type, dev_id),
                               input_shapes=shapes,
                               output_names=list(output_keys)))


def MXPredReshape(handle, input_keys, input_shapes):
    """reference c_predict_api.h:170."""
    shapes = dict(zip(input_keys, [tuple(s) for s in input_shapes]))
    return _register(_handles[handle].reshape(shapes))


def MXPredGetOutputShape(handle, index=0):
    return _handles[handle].get_output_shape(index)


def MXPredSetInput(handle, key, data):
    _handles[handle].set_input(key, data)


def MXPredForward(handle):
    _handles[handle].forward()


def MXPredGetOutput(handle, index=0):
    return _handles[handle].get_output(index).asnumpy()


def MXPredFree(handle):
    _handles.pop(handle, None)
