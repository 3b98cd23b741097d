"""Gluon Parameter / Constant / ParameterDict.

Counterpart of ``mxnet_tpu/gluon/parameter.py`` (reference
``python/mxnet/gluon/parameter.py``: Parameter with deferred init,
``grad_req``, ``lr_mult`` / ``wd_mult``; ParameterDict with prefix
namespacing and sharing).  A Parameter holds one ``_Replica`` (its data
NDArray and gradient buffer) per context; the data is a gradient leaf
(``autograd.mark_variables``) unless ``grad_req`` is ``null``.  The
default context is ``current_context()``, ``gpu(0)`` unless a ``with
mx.cpu():`` scope or ``ctx=`` says otherwise; initializers fill an f32
copy on the host, which then moves to each context.

Files: ``save_dict`` / ``load_dict`` carry ``{name: numpy array}`` (the
JAX package's ``collect_params()`` read out as numpy goes straight into
the port's), and ``save`` / ``load`` write and read such a dict with
``numpy.savez``.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .. import autograd, initializer, ndarray as nd
from ..context import Context, cpu, current_context
from ..ndarray.ndarray import from_numpy

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


class DeferredInitializationError(Exception):
    """Error for unfinished deferred initialization."""


class _PendingInit:
    """A deferred initialization request: everything needed to realize
    the parameter once its shape is known (first forward pass)."""

    __slots__ = ("init", "ctx_list", "default_init", "data")

    def __init__(self, init, ctx_list, default_init, data=None):
        self.init = init
        self.ctx_list = list(ctx_list)
        self.default_init = default_init
        self.data = data


class _Replica:
    """One per-context copy of a parameter: data plus its grad buffer."""

    __slots__ = ("ctx", "data", "grad")

    def __init__(self, ctx, data, grad=None):
        self.ctx = ctx
        self.data = data
        self.grad = grad


def _as_ctx_list(ctx):
    if ctx is None:
        return [current_context()]
    if isinstance(ctx, Context):
        return [ctx]
    return list(ctx)


class Parameter:
    """A Container holding parameters (weights) of Blocks
    (reference: gluon/parameter.py:43)."""

    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None, allow_deferred_init=False,
                 differentiable=True, stype="default", grad_stype="default"):
        if stype not in ("default", "row_sparse", "csr"):
            raise ValueError("invalid stype %s" % stype)
        if stype != "default" or grad_stype != "default":
            raise NotImplementedError("mxnet_tpu_torch: sparse Parameters "
                                      "are not ported")
        if isinstance(shape, int):
            shape = (shape,)
        self.name, self.dtype, self.init = name, dtype, init
        self.lr_mult, self.wd_mult = lr_mult, wd_mult
        self.allow_deferred_init = allow_deferred_init
        self._replicas = None        # list[_Replica] once initialized
        self._pending = None         # _PendingInit while deferred
        self._cached_data = None     # set by a running CachedOp
        self._shape = tuple(shape) if shape is not None else None
        self._stype, self._grad_stype = stype, grad_stype
        self._differentiable = differentiable
        self._grad_req = None
        self.grad_req = grad_req

    def __repr__(self):
        return "Parameter {} (shape={}, dtype={})".format(
            self.name, self.shape, self.dtype)

    # -- properties -------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        assert req in ("write", "add", "null"), \
            "grad_req must be one of 'write', 'add', or 'null', but got %s" % req
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if self._replicas is None:
            return
        if req == "null":
            for r in self._replicas:
                r.grad = None
                autograd.mark_variables([r.data], [None], "null")
        else:
            self._attach_grads()

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is not None:
            ok = len(self._shape) == len(new_shape) and all(
                known in (0, given)
                for given, known in zip(new_shape, self._shape))
            assert ok, \
                "Expected shape %s is incompatible with given shape %s." % (
                    str(new_shape), str(self._shape))
        self._shape = tuple(new_shape)

    @property
    def stype(self):
        return self._stype

    def _shape_is_known(self):
        return self._shape is not None and np.prod(self._shape) > 0

    # -- init -------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if default_init is None:
            default_init = initializer.Uniform()
        if self._replicas is not None and not force_reinit:
            return
        if init is None:
            init = self.init if self.init is not None else default_init
        self._pending = _PendingInit(init, _as_ctx_list(ctx), default_init)
        if self._shape_is_known():
            self._finish_deferred_init()
        elif not self.allow_deferred_init:
            self._pending = None
            raise ValueError(
                "Cannot initialize Parameter '%s' because it has invalid "
                "shape: %s." % (self.name, str(self._shape)))

    def _finish_deferred_init(self):
        pending, self._pending = self._pending, None
        if pending is None:
            return
        assert self._shape_is_known(), \
            "Cannot initialize Parameter '%s' because it has invalid shape: " \
            "%s. Please specify in_units, in_channels, etc for `Block`s." % (
                self.name, str(self._shape))
        with autograd.pause():
            data = pending.data
            if data is None:
                data = nd.zeros(self._shape, dtype=self.dtype, ctx=cpu())
                # reference semantics (_finish_deferred_init): a
                # param-specific init goes into the InitDesc and bypasses
                # name dispatch; the global/default init dispatches by
                # name pattern
                specific = (pending.init is not None
                            and pending.init is not pending.default_init)
                desc = initializer.InitDesc(
                    self.name, {"__init__": pending.init} if specific else {})
                pending.default_init(desc, data)
            self._place(data, pending.ctx_list)

    def _place(self, data, ctx_list):
        """Materialize replicas of ``data`` on each context.  On the card,
        f32 convolutions and products stay f32 (no TF32), as the executor
        keeps them and the JAX package's "highest" precision does."""
        if any(c.device_type == "gpu" for c in ctx_list):
            import torch

            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._replicas = [_Replica(c, data.as_in_context(c))
                          for c in ctx_list]
        self._attach_grads()

    def _attach_grads(self):
        if self.grad_req == "null":
            for r in self._replicas:
                r.grad = None
            return
        for r in self._replicas:
            r.grad = nd.zeros(r.data.shape, ctx=r.ctx, dtype=r.data.dtype)
            autograd.mark_variables([r.data], [r.grad], self.grad_req)

    def _reduce(self):
        """Average data across contexts (for save)."""
        replicas = self.list_data()
        acc = replicas[0].copyto(cpu())
        for extra in replicas[1:]:
            acc += extra.as_in_context(cpu())
        return acc / len(replicas) if len(replicas) > 1 else acc

    # -- data access ------------------------------------------------------
    def _require_init(self):
        if self._replicas is not None:
            return
        if self._pending is not None:
            raise DeferredInitializationError(
                "Parameter '%s' has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass. Please pass one batch of "
                "data through the network before accessing Parameters." %
                self.name)
        raise RuntimeError(
            "Parameter '%s' has not been initialized. Note that you should "
            "initialize parameters and create Trainer with Block.collect_params() "
            "instead of Block.params because the later does not include "
            "Parameters of nested child Blocks" % self.name)

    def _replica_for(self, ctx):
        self._require_init()
        if ctx is None:
            if len(self._replicas) == 1:
                return self._replicas[0]
            ctx = current_context()
        for r in self._replicas:
            if r.ctx == ctx:
                return r
        raise RuntimeError(
            "Parameter '%s' was not initialized on context %s. It was "
            "only initialized on %s." % (self.name, str(ctx),
                                         str([r.ctx for r in self._replicas])))

    def data(self, ctx=None):
        if self._cached_data is not None:
            return self._cached_data
        return self._replica_for(ctx).data

    def list_data(self):
        if self._cached_data is not None:
            return [self._cached_data]
        self._require_init()
        return [r.data for r in self._replicas]

    def _require_grad(self):
        if self._replicas is not None and self.grad_req == "null":
            raise RuntimeError(
                "Cannot get gradient array for Parameter '%s' because "
                "grad_req='null'" % self.name)

    def grad(self, ctx=None):
        self._require_grad()
        return self._replica_for(ctx).grad

    def list_grad(self):
        self._require_grad()
        self._require_init()
        return [r.grad for r in self._replicas]

    def list_ctx(self):
        if self._replicas is not None:
            return [r.ctx for r in self._replicas]
        if self._pending is not None:
            return self._pending.ctx_list
        raise RuntimeError("Parameter '%s' has not been initialized"
                           % self.name)

    def zero_grad(self):
        if self._replicas is None:
            return
        for r in self._replicas:
            if r.grad is not None:
                r.grad[:] = 0

    def set_data(self, data):
        self.shape = data.shape
        if not isinstance(data, nd.NDArray):
            data = _from_host(data)
        if self._replicas is None:
            assert self._pending is not None, \
                "Parameter '%s' has not been initialized" % self.name
            self._pending.data = data.copy()    # not the caller's array
            self._finish_deferred_init()
            return
        if not isinstance(data, nd.NDArray):
            data = _from_host(data)
        with autograd.pause():
            for r in self._replicas:
                r.data._set_data(
                    data.as_in_context(r.ctx).astype(r.data.dtype).data)

    def reset_ctx(self, ctx):
        ctx = _as_ctx_list(ctx)
        if self._replicas is not None:
            data = self._reduce()
            with autograd.pause():
                self._place(data, ctx)
        elif self._pending is not None:
            self._pending.ctx_list = ctx
        else:
            raise ValueError("Cannot reset context for Parameter '%s' because "
                             "it has not been initialized." % self.name)

    def cast(self, dtype):
        self.dtype = dtype
        if self._replicas is None:
            return
        with autograd.pause():
            for r in self._replicas:
                r.data = r.data.astype(dtype)
            if self.grad_req != "null":
                self._attach_grads()

    def _load_init_data(self, data, ctx):
        """Install loaded data (ParameterDict.load / Block load path)."""
        if not isinstance(data, nd.NDArray):
            data = _from_host(data)
        if self._shape is not None:
            known = all(s != 0 for s in self._shape)
            if known and tuple(self._shape) != tuple(data.shape):
                raise ValueError(
                    "Failed loading Parameter '%s' from saved params: shape "
                    "incompatible expected %s vs saved %s" % (
                        self.name, str(self._shape), str(data.shape)))
        if self._replicas is not None:
            self.set_data(data)
            return
        self._shape = tuple(data.shape)
        with autograd.pause():
            self._place(data.astype(self.dtype), _as_ctx_list(ctx))
        self._pending = None


class Constant(Parameter):
    """A constant parameter (grad_req='null')
    (reference: gluon/parameter.py Constant)."""

    def __init__(self, name, value):
        # the value stays on the host until initialize places it
        if not isinstance(value, nd.NDArray):
            value = nd.array(value, ctx=cpu())
        self.value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype,
                         init=initializer.Constant(value))


def _merge_shapes(requested, stored):
    """Unify a requested shape with a stored one, treating 0 as unknown.
    Returns the merged tuple or None when they conflict."""
    if requested is None or len(requested) != len(stored):
        return None
    merged = []
    for want, have in zip(requested, stored):
        if want == have or have == 0:
            merged.append(want)
        elif want == 0:
            merged.append(have)
        else:
            return None
    return tuple(merged)


class ParameterDict:
    """A dictionary managing a set of Parameters with prefix namespacing
    (reference: gluon/parameter.py:632)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __getitem__(self, key):
        return self._params[key]

    def __repr__(self):
        name = self._prefix + " " if self._prefix else ""
        return "{}(\n{}\n)".format(name, "\n".join(
            "  " + repr(v) for v in self.values()))

    def __iter__(self):
        return iter(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _find(self, name):
        """Look up ``name`` here, then in the shared dict (adopting a
        shared hit into this dict, reference sharing semantics)."""
        hit = self._params.get(name)
        if hit is None and self._shared is not None:
            hit = self._shared._params.get(name)
            if hit is not None:
                self._params[name] = hit
        return hit

    def _reconcile(self, param, kwargs):
        """Check requested attributes against an existing Parameter,
        filling in attributes it does not have yet."""
        for k, v in kwargs.items():
            stored = getattr(param, k, None)
            if stored is None:
                setattr(param, k, v)
                continue
            if k == "shape" and v is not None:
                merged = _merge_shapes(tuple(v), tuple(stored))
                if merged is not None:
                    param._shape = merged
                    continue
            assert v is None or str(v) == str(stored), \
                "Cannot retrieve Parameter '%s' because desired " \
                "attribute does not match with stored for attribute " \
                "'%s': desired '%s' vs stored '%s'." % (
                    param.name, k, str(v), str(stored))

    def get(self, name, **kwargs):
        """Get or create a Parameter named prefix+name."""
        name = self._prefix + name
        param = self._find(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        else:
            self._reconcile(param, kwargs)
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._find(name)
        if param is None:
            if value is None:
                raise KeyError("No constant named '{}'. Please specify value "
                               "if you want to create a new constant.".format(name))
            param = Constant(name, value)
            self._params[name] = param
        elif value is not None:
            assert isinstance(param, Constant), \
                "Parameter '{}' already exists but it is not a constant.".format(name)
        return param

    def update(self, other):
        for k, v in other.items():
            mine = self._params.get(k)
            assert mine is None or mine is v, \
                "Cannot update self with other because they have different " \
                "Parameters with the same name '%s'" % k
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = initializer.Uniform()
        for _, v in self.items():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    # -- serialization ----------------------------------------------------
    def save_dict(self, strip_prefix=""):
        """``{name: numpy array}`` of every Parameter (averaged over its
        contexts), names without ``strip_prefix``."""
        out = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    "Prefix '%s' is to be striped before saving, but "
                    "Parameter's name '%s' does not start with '%s'." % (
                        strip_prefix, param.name, strip_prefix))
            out[param.name[len(strip_prefix):]] = param._reduce().asnumpy()
        return out

    def load_dict(self, arg_dict, ctx=None, allow_missing=False,
                  ignore_extra=False, restore_prefix=""):
        """Set (or, if not yet initialized, initialize on ``ctx``) each
        Parameter from ``arg_dict`` (``{name: numpy array or NDArray}``,
        names without ``restore_prefix``; ``arg:`` / ``aux:`` prefixes are
        dropped).  Values are cast to each Parameter's dtype."""
        if restore_prefix:
            for name in self.keys():
                assert name.startswith(restore_prefix), \
                    "restore_prefix is '%s' but Parameter name '%s' does " \
                    "not start with '%s'" % (restore_prefix, name,
                                             restore_prefix)
        lprefix = len(restore_prefix)
        arg_dict = {restore_prefix + k.split(":", 1)[-1]: v
                    for k, v in arg_dict.items()}
        if not allow_missing:
            for name in self.keys():
                assert name in arg_dict, \
                    "Parameter '%s' is missing" % name[lprefix:]
        for name, data in arg_dict.items():
            if name not in self._params:
                assert ignore_extra, \
                    "Parameter '%s' is not present in ParameterDict" % (
                        name[lprefix:])
                continue
            self[name]._load_init_data(data, ctx)

    def save(self, filename, strip_prefix=""):
        """:meth:`save_dict` into a ``numpy.savez`` file."""
        with open(filename, "wb") as f:
            np.savez(f, **self.save_dict(strip_prefix))

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """:meth:`load_dict` from a file :meth:`save` wrote."""
        with np.load(filename) as f:
            arrays = {k: f[k] for k in f.files}
        self.load_dict(arrays, ctx, allow_missing, ignore_extra,
                       restore_prefix)


def _from_host(data):
    """A host array (numpy, ``ml_dtypes`` bfloat16 included) as an NDArray
    on the CPU, in its own dtype."""
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        return nd.NDArray(from_numpy(arr, "cpu"))
    return nd.array(arr, ctx=cpu())
