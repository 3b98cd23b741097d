"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (reference
``python/mxnet/initializer.py``): ``InitDesc``, the name-suffix dispatch
(``*weight`` → the initializer's rule, ``*bias`` → 0, ``*gamma`` → 1,
``*beta`` → 0, ``*moving_mean`` → 0, ``*moving_var`` → 1), with a
variable's ``__init__`` attribute taking precedence, and ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal``, ``Xavier``, ``MSRAPrelu``, ``Mixed``
and ``create``.  Random draws come from the array's device generator in
``mx.random``, on the device itself, where the JAX package draws on the
host with numpy.
"""
from __future__ import annotations

import json
import math
import re

import torch

from . import random as _random

__all__ = ["InitDesc", "Initializer", "register", "Zero", "One", "Constant",
           "Uniform", "Normal", "Xavier", "MSRAPrelu", "Mixed", "create"]

_INIT_REGISTRY = {}


def register(klass):
    """Register an initializer under its lowercase class name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class InitDesc(str):
    """A parameter's name, with its attributes (``__init__``, ...)."""

    def __new__(cls, name, attrs=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        return ret


def _random_fill(arr, dist, a, b):
    """Fill ``arr`` in place from its device's generator: uniform on [a, b)
    or normal with mean a and deviation b."""
    t = arr.data
    gen = _random.generator(t.device)
    with torch.no_grad():
        if dist == "uniform":
            t.uniform_(a, b, generator=gen)
        else:
            t.normal_(a, b, generator=gen)


class Initializer:
    """Base initializer, callable on ``(InitDesc or name, NDArray)``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``[name, kwargs]`` as JSON: the ``__init__`` attribute form."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(desc)
        init = desc.attrs.get("__init__", "")
        if init:
            if isinstance(init, Initializer):
                init._init_weight(desc, arr)
            elif init.lower() in _INIT_REGISTRY:
                _INIT_REGISTRY[init.lower()]()._init_weight(desc, arr)
            else:
                klass, kwargs = json.loads(init)
                _INIT_REGISTRY[klass.lower()](**kwargs)._init_weight(desc,
                                                                     arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith(("running_mean", "moving_mean")):
            self._init_zero(desc, arr)
        elif name.endswith(("running_var", "moving_var")):
            self._init_one(desc, arr)
        elif name.endswith(("moving_inv_var", "moving_avg")):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    _init_bias = _init_zero
    _init_gamma = _init_one
    _init_beta = _init_zero

    def _init_weight(self, name, arr):
        raise NotImplementedError("virtual _init_weight")

    def _init_default(self, name, arr):
        raise ValueError(
            "Unknown initialization pattern for %s. Default initialization "
            "is now limited to *weight/*bias/*gamma/*beta. Use "
            "mx.sym.Variable(init=mx.init.*) for other names" % name)

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self._kwargs)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    """Uniform on [-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        _random_fill(arr, "uniform", -self.scale, self.scale)


@register
class Normal(Initializer):
    """Normal with mean 0 and deviation ``sigma``."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        _random_fill(arr, "normal", 0.0, self.sigma)


@register
class Xavier(Initializer):
    """Xavier / Glorot: scale ``sqrt(magnitude / factor)``, ``factor`` the
    fan in, the fan out or their average (``factor_type``), each fan times
    the kernel's spatial size; uniform on [-scale, scale) or normal with
    deviation scale (``rnd_type``)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def scale(self, shape):
        """The scale for a weight of ``shape``."""
        if len(shape) < 2:
            raise ValueError("Xavier initializer cannot be applied to a "
                             "vector of shape %s; it needs at least 2-D"
                             % (shape,))
        hw_scale = math.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        return math.sqrt(self.magnitude / factor)

    def _init_weight(self, name, arr):
        scale = self.scale(arr.shape)
        if self.rnd_type == "uniform":
            _random_fill(arr, "uniform", -scale, scale)
        elif self.rnd_type == "gaussian":
            _random_fill(arr, "normal", 0.0, scale)
        else:
            raise ValueError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """He / MSRA initialization for PReLU nets: Gaussian Xavier with
    magnitude ``2 / (1 + slope²)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Mixed(Initializer):
    """The first initializer whose regex pattern matches the name."""

    def __init__(self, patterns, initializers):
        super().__init__()
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must match in length")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError(
            "Parameter name %s did not match any pattern. Consider adding a "
            '".*" pattern at the end with default Initializer.' % name)


def create(name, **kwargs):
    """An initializer from a registered name (an Initializer passes)."""
    if isinstance(name, Initializer):
        return name
    return _INIT_REGISTRY[name.lower()](**kwargs)

