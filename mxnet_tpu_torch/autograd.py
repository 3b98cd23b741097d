"""Autograd: imperative recording and backward, over ``torch.autograd``.

Counterpart of ``mxnet_tpu/autograd.py`` (reference ``python/mxnet/
autograd.py``).  Where the JAX package keeps its own tape and replays it
under ``jax.vjp``, the port lets PyTorch's autograd record, and keeps
MXNet's rules on top of it:

* only ops run inside :func:`record` build a graph: every imperative op
  (``ops.registry.invoke``, NDArray arithmetic and ``astype``) runs with
  ``torch.set_grad_enabled(is_recording())``, so outside ``record()`` no
  graph is built, even on arrays that have a gradient;
* :func:`mark_variables` / ``NDArray.attach_grad`` turn an array into a
  leaf that requires grad; in-place writes to it (optimizer updates,
  ``x[:] = ...``) run outside the graph, and a write leaves it a fresh
  leaf;
* :func:`backward` writes (``grad_req="write"``) or adds (``"add"``) the
  gradient of every marked array the heads reach into its ``grad``; an
  array it does not reach keeps its gradient; ``retain_graph=False`` frees
  the graph, so a second backward through it raises;
* :func:`grad` returns the gradients instead, differentiable themselves
  with ``create_graph=True``;
* :class:`Function` is a user op with its own NDArray ``forward`` and
  ``backward``, a :class:`torch.autograd.Function` underneath.

``is_training()`` is what ops that behave differently in training read
(BatchNorm's batch statistics, Dropout): ``record()`` sets it unless told
otherwise, ``pause()`` clears it.
"""
from __future__ import annotations

import threading
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    """Whether imperative ops are being recorded for a backward."""
    return _st().recording


def is_training():
    """Whether ops run in training mode (batch statistics, dropout)."""
    return _st().training


def set_recording(is_record):
    """Set the recording flag; returns the previous one."""
    prev = _st().recording
    _state.recording = bool(is_record)
    return prev


def set_training(train_mode_):
    """Set the training flag; returns the previous one."""
    prev = _st().training
    _state.training = bool(train_mode_)
    return prev


class _Scope:
    def __init__(self, recording, training):
        self._r, self._t = recording, training

    def __enter__(self):
        s = _st()
        self._pr, self._pt = s.recording, s.training
        if self._r is not None:
            s.recording = self._r
        if self._t is not None:
            s.training = self._t
        return self

    def __exit__(self, *a):
        s = _st()
        s.recording, s.training = self._pr, self._pt


def record(train_mode=True):  # pylint: disable=redefined-outer-name
    """Scope: record imperative ops for a backward (and, by default, run
    them in training mode)."""
    return _Scope(True, train_mode)


def pause(train_mode=False):  # pylint: disable=redefined-outer-name
    """Scope: stop recording (and, by default, leave training mode)."""
    return _Scope(False, train_mode)


def train_mode():
    """Scope: training mode, recording unchanged."""
    return _Scope(None, True)


def predict_mode():
    """Scope: inference mode, recording unchanged."""
    return _Scope(None, False)


def grad_scope():
    """The torch grad mode an imperative op runs under: enabled exactly
    while recording."""
    return torch.set_grad_enabled(is_recording())


# ---------------------------------------------------------------------------
# variables
# ---------------------------------------------------------------------------
# every array marked with a gradient buffer, so that backward finds the
# leaves torch accumulated into (the reference walks its tape instead)
_MARKED: "weakref.WeakSet" = weakref.WeakSet()


def _as_leaf(t, req):
    """``t`` as a leaf of the graph: detached, requiring grad unless
    ``req`` is ``null``."""
    t = t.detach()
    if req != "null" and t.is_floating_point():
        t.requires_grad_(True)
    return t


def mark_variables(variables, gradients=None, grad_reqs="write"):
    """Make arrays gradient leaves with ``gradients`` as their buffers
    (reference: autograd.mark_variables)."""
    from .ndarray.ndarray import NDArray

    if isinstance(variables, NDArray):
        variables = [variables]
        gradients = [gradients] if gradients is not None else None
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for i, v in enumerate(variables):
        req = grad_reqs[i]
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be 'write', 'add' or 'null', "
                             "not %r" % (req,))
        v._grad_req = req
        v._grad = gradients[i] if gradients is not None else None
        v._data = _as_leaf(v._data, req)
        if req == "null":
            _MARKED.discard(v)
        else:
            _MARKED.add(v)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------
def _head_tensors(heads, head_grads):
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    hs, gs = [], []
    for i, h in enumerate(heads):
        t = h.data
        if not t.requires_grad:
            raise ValueError(
                "cannot differentiate a head that was not computed while "
                "recording from an array with a gradient (reference: 'this "
                "array is not a head of a recorded graph')")
        g = head_grads[i] if head_grads is not None else None
        if g is None:
            g = torch.ones_like(t)
        else:
            g = (g.data if isinstance(g, NDArray) else torch.as_tensor(g)) \
                .to(device=t.device, dtype=t.dtype)
        hs.append(t)
        gs.append(g)
    return hs, gs


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):  # pylint: disable=redefined-outer-name
    """Compute the gradients of ``heads`` with respect to every marked
    array they reach and write (or, under ``grad_req="add"``, add) them
    into its ``grad``.  ``head_grads`` defaults to ones."""
    from .ndarray.ndarray import NDArray

    hs, gs = _head_tensors(heads, head_grads)
    marked = [v for v in list(_MARKED) if v._data.grad is not None]
    for v in marked:                 # stale torch buffers from elsewhere
        v._data.grad = None
    torch.autograd.backward(hs, gs, retain_graph=retain_graph)
    reached = False
    for v in list(_MARKED):
        t = v._data
        g = t.grad
        if g is None:
            continue
        t.grad = None
        reached = True
        if v._grad is None:
            v._grad = NDArray(g)
        elif v._grad_req == "add":
            with torch.no_grad():
                v._grad.data.add_(g)
        else:
            v._grad._set_data(g)
    if not reached:
        raise ValueError("no marked variables reachable from heads")


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):  # pylint: disable=redefined-outer-name
    """The gradients of ``heads`` with respect to ``variables`` (marked
    arrays), returned rather than written into their buffers; with
    ``create_graph=True`` they are themselves recorded, so a second
    backward differentiates through them (reference: mx.autograd.grad)."""
    from .ndarray.ndarray import NDArray

    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    for v in variables:
        if not v._data.requires_grad:
            raise ValueError("variables must be marked (attach_grad) "
                             "before grad()")
    hs, gs = _head_tensors(heads, head_grads)
    if retain_graph is None:
        retain_graph = create_graph
    with torch.set_grad_enabled(create_graph):
        res = torch.autograd.grad(hs, [v.data for v in variables], gs,
                                  retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
    out = [NDArray(g if g is not None else torch.zeros_like(v.data))
           for g, v in zip(res, variables)]
    return out[0] if single else out


# ---------------------------------------------------------------------------
# Function
# ---------------------------------------------------------------------------
class _UserFunction(torch.autograd.Function):
    """The torch side of :class:`Function`: its NDArray ``forward`` and
    ``backward`` on wrapped tensors, unrecorded."""

    @staticmethod
    def forward(ctx, fn, n_in, *tensors):  # pylint: disable=arguments-differ
        from .ndarray.ndarray import NDArray

        ctx.fn = fn
        with pause():
            outs = fn.forward(*[NDArray(t) for t in tensors[:n_in]])
        single = isinstance(outs, NDArray)
        fn._single = single
        outs = [outs] if single else list(outs)
        # an output that is an input as it stands must be a new tensor
        return tuple(o.data.clone() if any(o.data is t for t in tensors)
                     else o.data for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray

        with pause():
            gins = ctx.fn.backward(*[NDArray(g) for g in grads])
        gins = [gins] if isinstance(gins, NDArray) else list(gins)
        return (None, None) + tuple(
            g.data if isinstance(g, NDArray) else g for g in gins)


class Function:
    """A differentiable function with a custom gradient (reference:
    autograd.Function, ``python/mxnet/autograd.py:385``).  Subclass it,
    implement ``forward`` and ``backward`` on NDArrays, and call an
    instance on NDArrays; inside :func:`record` the call is one node of the
    graph whose backward runs yours."""

    def __init__(self):
        self._saved = ()
        self._single = True

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        if not is_recording():
            with pause():
                return self.forward(*inputs)
        with torch.enable_grad():
            outs = _UserFunction.apply(self, len(inputs),
                                       *[x.data for x in inputs])
        outs = [NDArray(o) for o in outs]
        return outs[0] if self._single else outs
