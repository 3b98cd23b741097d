"""Activation layers.

Counterpart of ``mxnet_tpu/gluon/nn/activations.py`` (reference
``python/mxnet/gluon/nn/activations.py``), over the ``Activation`` and
``LeakyReLU`` ops."""
from __future__ import annotations

from ... import initializer
from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU"]


class Activation(HybridBlock):
    """Applies an activation function (relu/sigmoid/tanh/softrelu/softsign)."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return "{name}({_act_type})".format(
            name=self.__class__.__name__, **self.__dict__)


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        assert alpha >= 0, "Slope coefficient for LeakyReLU must be no less than 0."
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return "{name}({alpha})".format(
            name=self.__class__.__name__, alpha=self._alpha)


class PReLU(HybridBlock):
    def __init__(self, alpha_initializer=None, **kwargs):
        super().__init__(**kwargs)
        if alpha_initializer is None:
            alpha_initializer = initializer.Constant(0.25)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(1,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class GELU(HybridBlock):
    """Gaussian error linear unit (the JAX package's addition; the
    reference has no GELU layer)."""

    def __init__(self, approximate=True, **kwargs):
        super().__init__(**kwargs)
        self._approximate = approximate

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")
