"""Gluon Block / HybridBlock.

Counterpart of ``mxnet_tpu/gluon/block.py`` (reference ``python/mxnet/
gluon/block.py``: Block:127, HybridBlock:671, ``_BlockScope`` naming,
``hybridize`` into a CachedOp).

The JAX package's ``_CachedOp`` traces ``hybrid_forward`` into one
``jax.jit``.  The port's runs the same ``forward`` eagerly on the card,
op by op, and keeps the CachedOp's contract:

* every Parameter of the block (and of its children) is fetched once per
  call and is what ``Parameter.data()`` returns while the forward runs;
  hybridized children run inside it, not as CachedOps of their own;
* the output format (one array, a flat list, or nested lists) is learned
  on the first call and cached;
* BatchNorm's running statistics (Parameters with ``grad_req="null"``)
  are written back through the op registry's ``mutate`` outputs;
* ``static_alloc`` / ``static_shape`` (and other flags) are accepted and
  kept;
* a hybridized block computes what the same block computes imperatively.

Capturing the call as a CUDA graph is later work; ``export`` and
``SymbolBlock`` are not ported.
"""
from __future__ import annotations

import re
import threading

import numpy as np

from .. import autograd, ndarray as nd
from ..context import current_context
from ..ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


class _BlockScope:
    """Name-scope manager for Blocks (reference: block.py:35)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _name_counter(hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, tb):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


_NAME_COUNTERS = {}


def _name_counter(hint):
    count = _NAME_COUNTERS.get(hint, 0)
    _NAME_COUNTERS[hint] = count + 1
    return "%s%d" % (hint, count)


def _flatten_arrays(args):
    """Flatten nested lists/tuples of NDArrays; returns (flat, fmt)."""
    if isinstance(args, NDArray):
        return [args], 0
    if args is None:
        return [], -1
    assert isinstance(args, (list, tuple)), \
        "HybridBlock inputs must be (nested) NDArrays, got %s" % type(args)
    flat, fmts = [], []
    for a in args:
        f, fmt = _flatten_arrays(a)
        flat.extend(f)
        fmts.append(fmt)
    return flat, fmts


def _regroup_arrays(flat, fmt):
    if fmt == 0:
        return flat[0], flat[1:]
    if fmt == -1:
        return None, flat
    ret = []
    for f in fmt:
        res, flat = _regroup_arrays(flat, f)
        ret.append(res)
    return ret, flat


class Block:
    """Base class for all neural network layers and models
    (reference: gluon/block.py:127)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = {}
        self._reg_params = {}
        self._forward_hooks = {}
        self._forward_pre_hooks = {}
        self._hook_counter = 0

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join(
            "  ({key}): {block}".format(
                key=key, block=_indent(str(block), 2))
            for key, block in self.__dict__.items()
            if isinstance(block, Block))
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __setattr__(self, name, value):
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)):
                raise TypeError(
                    "Changing attribute type for {name} from {type1} to "
                    "{type2} is not allowed.".format(
                        name=name, type1=type(existing), type2=type(value)))
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            assert name not in self._reg_params, \
                "Overriding Parameter attribute %s is not allowed. If you " \
                "want to share parameters between blocks, please set " \
                "'params' at Block construction instead." % name
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    # -- naming -----------------------------------------------------------
    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    # -- params -----------------------------------------------------------
    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """Return a ParameterDict of this block's and children's Parameters,
        optionally filtered by regex ``select`` (reference: block.py
        collect_params)."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for cld in self._children.values():
            ret.update(cld.collect_params(select=select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    # -- serialization ----------------------------------------------------
    def save_parameters(self, filename, deduplicate=False):
        """Save the parameters under their structural names
        (``features.0.weight``) in a ``numpy.savez`` file (reference:
        block.py:315; load back with :meth:`load_parameters`)."""
        params = self._collect_params_with_prefix()
        if deduplicate:
            # keep one key per shared Parameter object
            seen = {}
            params = {k: v for k, v in params.items()
                      if seen.setdefault(id(v), k) == k}
        with open(filename, "wb") as f:
            np.savez(f, **{key: val._reduce().asnumpy()
                           for key, val in params.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a file :meth:`save_parameters` wrote (reference:
        block.py:356)."""
        with np.load(filename) as f:
            loaded = {k: f[k] for k in f.files}
        params = self._collect_params_with_prefix()
        if not allow_missing:
            for name in params.keys():
                assert name in loaded, \
                    "Parameter '%s' is missing in file '%s', which contains " \
                    "parameters: %s. Set allow_missing=True to ignore missing "\
                    "parameters." % (name, filename,
                                     _brief_print_list(loaded.keys()))
        for name in loaded:
            if not ignore_extra and name not in params:
                raise ValueError(
                    "Parameter '%s' loaded from file '%s' is not present in "
                    "this block's ParameterDict, which contains parameters %s."
                    " Set ignore_extra=True to ignore." % (
                        name, filename, _brief_print_list(params.keys())))
            if name in params:
                param = params[name]
                if cast_dtype and dtype_source == "saved":
                    param.cast(loaded[name].dtype)
                param._load_init_data(loaded[name], ctx)

    def load_dict(self, arg_dict, ctx=None, allow_missing=False,
                  ignore_extra=False):
        """Set this block's parameters from ``{full name: array}``, e.g.
        the JAX package's ``net.collect_params()`` read out as numpy
        (:meth:`ParameterDict.load_dict`)."""
        self.collect_params().load_dict(arg_dict, ctx, allow_missing,
                                        ignore_extra)

    # alias (deprecated reference names)
    save_params = save_parameters
    load_params = load_parameters

    # -- structure --------------------------------------------------------
    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def register_forward_pre_hook(self, hook):
        self._hook_counter += 1
        handle = _HookHandle(self._forward_pre_hooks, self._hook_counter)
        self._forward_pre_hooks[self._hook_counter] = hook
        return handle

    def register_forward_hook(self, hook):
        self._hook_counter += 1
        handle = _HookHandle(self._forward_hooks, self._hook_counter)
        self._forward_hooks[self._hook_counter] = hook
        return handle

    def apply(self, fn):
        for cld in self._children.values():
            cld.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            from .. import initializer
            init = initializer.Uniform()
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for cld in self._children.values():
            cld.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def summary(self, *inputs):
        """Print a summary of the Block (reference: block.py summary)."""
        rows = []

        def count(block, indent):
            n = sum(int(np.prod(p.shape)) for p in block._reg_params.values()
                    if p.shape)
            rows.append(("  " * indent + block.__class__.__name__, n))
            for c in block._children.values():
                count(c, indent + 1)

        count(self, 0)
        total = sum(r[1] for r in rows)
        print("%-40s %s" % ("Layer", "Params"))
        print("-" * 52)
        for name_, n in rows:
            print("%-40s %d" % (name_, n))
        print("-" * 52)
        print("Total params: %d" % total)

    # -- execution --------------------------------------------------------
    def __call__(self, *args):
        for hook in self._forward_pre_hooks.values():
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError


class _HookHandle:
    def __init__(self, hooks_dict, key):
        self._hooks_dict = hooks_dict
        self._key = key

    def detach(self):
        self._hooks_dict.pop(self._key, None)


def _indent(s_, num_spaces):
    lines = s_.split("\n")
    if len(lines) == 1:
        return s_
    first = lines.pop(0)
    return first + "\n" + "\n".join(" " * num_spaces + line for line in lines)


def _brief_print_list(lst, limit=7):
    lst = list(lst)
    if len(lst) > limit:
        return _brief_print_list(lst[:limit // 2], limit) + ", ..., " + \
            _brief_print_list(lst[-limit // 2:], limit)
    return ", ".join("'%s'" % str(i) for i in lst)


# ---------------------------------------------------------------------------
# HybridBlock + CachedOp
# ---------------------------------------------------------------------------
_cached_state = threading.local()


def _in_cached_op():
    return getattr(_cached_state, "active", 0) > 0


class _CachedOp:
    """The callable behind a hybridized block (reference:
    ``src/imperative/cached_op.cc``; see the module docstring)."""

    def __init__(self, block):
        self._block = block
        self._params = list(block.collect_params().values())
        self._out_fmt = None

    def __call__(self, flat, fmt):
        block = self._block
        ctx = flat[0].context if flat else current_context()
        for p in self._params:          # fetched once, then substituted
            p._cached_data = p.data(ctx)
        args, rest = _regroup_arrays(list(flat), fmt)
        assert not rest
        _cached_state.active = getattr(_cached_state, "active", 0) + 1
        try:
            out = block.forward(*args) if isinstance(args, list) \
                else block.forward(args)
        finally:
            _cached_state.active -= 1
            for p in self._params:
                p._cached_data = None
        flat_out, out_fmt = _flatten_arrays(out)
        if self._out_fmt is None:
            self._out_fmt = out_fmt
        elif out_fmt != self._out_fmt:
            raise ValueError("%s: the output format changed between calls "
                             "(%s, then %s)" % (block.name, self._out_fmt,
                                                out_fmt))
        if self._out_fmt == 0:
            return flat_out[0]
        res, _ = _regroup_arrays(flat_out, self._out_fmt)
        return res


class HybridBlock(Block):
    """A Block whose ``hybrid_forward`` takes ``F`` (here always the
    ``nd`` namespace) and its Parameters as keyword arrays, and which can
    be hybridized (reference: gluon/block.py:671)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None
        self._flags = {}

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, HybridBlock):
            self._clear_cached_op()

    def register_child(self, block, name=None):
        super().register_child(block, name)
        self._clear_cached_op()

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Run through a CachedOp from the next call; ``static_alloc`` /
        ``static_shape`` are accepted and kept (``_flags``)."""
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        self._clear_cached_op()
        for cld in self._children.values():
            cld.hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def _clear_cached_op(self):
        self._cached_op = None

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def infer_shape(self, *args):
        """Finish deferred initialization from inputs ``args`` by one
        unrecorded imperative forward."""
        try:
            with autograd.pause():
                self.forward(*args)
        except DeferredInitializationError as e:
            raise RuntimeError(
                "Deferred initialization failed because shape cannot be "
                "inferred: %s" % e) from e

    def _infer_shape_from_input(self, *args):
        return None

    def forward(self, x, *args):
        """``hybrid_forward(nd, x, *args, **params)``, or, hybridized, the
        CachedOp (reference: block.py:901)."""
        ctx = x.context if isinstance(x, NDArray) else current_context()
        if self._active and not _in_cached_op():
            if self._cached_op is None:
                self._ensure_init(ctx, x, *args)
                self._cached_op = _CachedOp(self)
            if not args and isinstance(x, NDArray):
                return self._cached_op([x], 0)
            flat, fmt = _flatten_arrays(list((x,) + args) if args else x)
            return self._cached_op(flat, fmt)
        try:
            params = {k: v.data(ctx) for k, v in self._reg_params.items()}
        except DeferredInitializationError:
            self._finish_deferred(ctx, x, *args)
            params = {k: v.data(ctx) for k, v in self._reg_params.items()}
        return self.hybrid_forward(nd, x, *args, **params)

    def _ensure_init(self, ctx, x, *args):
        try:
            for v in self.collect_params().values():
                v._require_init()
        except DeferredInitializationError:
            # one unrecorded imperative run resolves every deferred param
            tree = self._hybrid_tree()
            saved = [b._active for b in tree]
            try:
                for b in tree:
                    b._active = False
                with autograd.pause():
                    self.forward(x, *args)
            finally:
                for b, active in zip(tree, saved):
                    b._active = active

    def _hybrid_tree(self):
        out = [self]
        for c in self._children.values():
            if isinstance(c, HybridBlock):
                out += c._hybrid_tree()
        return out

    def _finish_deferred(self, ctx, x, *args):
        shape = self._infer_shape_from_input(x, *args)
        if shape is None:
            raise DeferredInitializationError(
                "%s has deferred-initialized parameters but does not "
                "implement _infer_shape_from_input" % self.name)
        for name, dims in shape.items():
            p = self._reg_params[name]
            p.shape = dims
            p._finish_deferred_init()

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
