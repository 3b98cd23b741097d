"""Basic Gluon layers.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py`` (reference
``python/mxnet/gluon/nn/basic_layers.py``): Sequential, HybridSequential,
Dense, Dropout, BatchNorm, InstanceNorm, LayerNorm, Embedding, Flatten,
Lambda, HybridLambda.  ``BatchNorm.cast`` keeps the layer's Parameters in
f32 when the net goes to float16 / bfloat16, and the BatchNorm op
normalizes such data in f32 and returns it in its own dtype, as the
reference does."""
from __future__ import annotations

import numpy as np

from ... import ndarray as nd
from ..block import Block, HybridBlock
from .activations import Activation

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "InstanceNorm", "LayerNorm", "Embedding", "Flatten", "Lambda",
           "HybridLambda"]


class Sequential(Block):
    """Stacks Blocks sequentially (reference: Sequential)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join("  ({key}): {block}".format(
            key=key, block=str(block)) for key, block in self._children.items())
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)

    def hybridize(self, active=True, **kwargs):
        if self._children and all(isinstance(c, HybridBlock)
                                  for c in self._children.values()):
            import warnings
            warnings.warn(
                "All children of this Sequential layer '%s' are HybridBlocks. "
                "Consider using HybridSequential for the best performance."
                % self.prefix, stacklevel=2)
        super().hybridize(active, **kwargs)


class HybridSequential(HybridBlock):
    """Stacks HybridBlocks sequentially; hybridizable (reference:
    HybridSequential)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join("  ({key}): {block}".format(
            key=key, block=str(block)) for key, block in self._children.items())
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)


class Dense(HybridBlock):
    """Fully-connected layer: ``activation(dot(x, W^T) + b)``
    (reference: basic_layers.py Dense over FullyConnected op)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        self._units = units
        self._in_units = in_units
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=_init_by_name(bias_initializer),
                    dtype=dtype, allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _infer_shape_from_input(self, x, *args):
        if self._flatten:
            in_units = int(np.prod(x.shape[1:]))
        else:
            in_units = x.shape[-1]
        shapes = {"weight": (self._units, in_units)}
        if self.bias is not None:
            shapes["bias"] = (self._units,)
        return shapes

    def hybrid_forward(self, F, x, weight, bias=None):
        act = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten)
        if self.act is not None:
            act = self.act(act)
        return act

    def __repr__(self):
        shape = self.weight.shape
        return "{name}({layout}, {act})".format(
            name=self.__class__.__name__,
            act=self.act if self.act else "linear",
            layout="{0} -> {1}".format(
                shape[1] if shape[1] else None, shape[0]))


class Dropout(HybridBlock):
    """Dropout (reference: basic_layers.py Dropout over Dropout op)."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes)
        return F.identity(x)

    def __repr__(self):
        return "{name}(p = {_rate}, axes={_axes})".format(
            name=self.__class__.__name__, **self.__dict__)


class BatchNorm(HybridBlock):
    """Batch normalization with running stats (reference: basic_layers.py
    BatchNorm over the BatchNorm op; running stats are aux state mutated
    in-place during training)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        self._in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=_init_by_name(gamma_initializer),
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=_init_by_name(beta_initializer),
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=_init_by_name(running_mean_initializer),
                allow_deferred_init=True, differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=_init_by_name(running_variance_initializer),
                allow_deferred_init=True, differentiable=False)

    def _infer_shape_from_input(self, x, *args):
        channels = x.shape[self._axis]
        return {"gamma": (channels,), "beta": (channels,),
                "running_mean": (channels,), "running_var": (channels,)}

    def cast(self, dtype):
        from ...base import dtype_name
        if dtype_name(dtype) in ("float16", "bfloat16"):
            dtype = "float32"  # BN statistics stay fp32 (reference behavior)
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        out = F.BatchNorm(x, gamma, beta, running_mean, running_var,
                          **self._kwargs)
        # the op returns (out, batch_mean, batch_var, new_mean, new_var);
        # running stats are written back by the dispatcher's mutate hook
        return out[0] if isinstance(out, (list, tuple)) else out

    def __repr__(self):
        in_channels = self.gamma.shape[0]
        return "{name}({content}, in_channels={in_channels})".format(
            name=self.__class__.__name__, in_channels=in_channels,
            content=", ".join(
                "=".join([k, v.__repr__()]) for k, v in self._kwargs.items()))


class InstanceNorm(HybridBlock):
    """Instance normalization (reference: basic_layers.py InstanceNorm)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"eps": epsilon}
        self._axis = axis
        self._epsilon = epsilon
        self._in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=_init_by_name(gamma_initializer),
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=_init_by_name(beta_initializer),
                allow_deferred_init=True)

    def _infer_shape_from_input(self, x, *args):
        channels = x.shape[self._axis]
        return {"gamma": (channels,), "beta": (channels,)}

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)
        x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta,
                              eps=self._epsilon).swapaxes(1, self._axis)


class LayerNorm(HybridBlock):
    """Layer normalization (reference: basic_layers.py LayerNorm)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kwargs = {"eps": epsilon, "axis": axis}
        self._axis = axis
        self._epsilon = epsilon
        self._in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=_init_by_name(gamma_initializer),
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=_init_by_name(beta_initializer),
                allow_deferred_init=True)

    def _infer_shape_from_input(self, x, *args):
        channels = x.shape[self._axis]
        return {"gamma": (channels,), "beta": (channels,)}

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


class Embedding(HybridBlock):
    """Index -> dense vector lookup (reference: basic_layers.py Embedding)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)

    def __repr__(self):
        return "{block_name}({input_dim} -> {output_dim}, {dtype})".format(
            block_name=self.__class__.__name__, **self._kwargs)


class Flatten(HybridBlock):
    """Flatten to (batch, -1) (reference: basic_layers.py Flatten)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return self.__class__.__name__


class Lambda(Block):
    """Wrap a function as a Block (reference: basic_layers.py Lambda)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            assert hasattr(nd, function), \
                "Function name %s is not found in ndarray." % function
            self._func_impl = getattr(nd, function)
        elif callable(function):
            self._func_impl = function
        else:
            raise ValueError("Unrecognized function in lambda: {} of type {}"
                             .format(function, type(function)))
        self._func_name = getattr(self._func_impl, "__name__", "custom")

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return "{name}({function})".format(
            name=self.__class__.__name__, function=self._func_name)


class HybridLambda(HybridBlock):
    """Wrap a function as a HybridBlock (reference: HybridLambda)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            assert hasattr(nd, function), \
                "Function name %s is not found in ndarray." % function
            self._func = lambda F, *args: getattr(F, function)(*args)
            self._func_name = function
        elif callable(function):
            self._func = function
            self._func_name = getattr(function, "__name__", "custom")
        else:
            raise ValueError("Unrecognized function in lambda: {} of type {}"
                             .format(function, type(function)))

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return "{name}({function})".format(
            name=self.__class__.__name__, function=self._func_name)


def _init_by_name(init):
    """'zeros'/'ones' string -> Initializer, pass through otherwise."""
    if isinstance(init, str):
        from ... import initializer
        return {"zeros": initializer.Zero(), "ones": initializer.One()}.get(
            init.lower(), init)
    return init
