"""Fused recurrent layers ``RNN``, ``LSTM`` and ``GRU``.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py`` (reference
``python/mxnet/gluon/rnn/rnn_layer.py``): each layer packs its
``{l,r}{i}_{i2h,h2h}_{weight,bias}`` Parameters in the fused op's order
and calls ``F.RNN`` (``ops/rnn.py``: cuDNN on the card), in the TNC or
NTC layout.
"""
from __future__ import annotations

from ... import ndarray as nd
from ..block import HybridBlock
from ..nn.basic_layers import _init_by_name

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """Base fused RNN layer."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None, **kwargs):
        self._mode = mode          # before super(): _alias() names the prefix
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise ValueError("Invalid layout %s; must be one of ['TNC' or "
                             "'NTC']" % layout)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]

        for name, shape, init in self._param_specs(input_size):
            self._register_param(name, shape, init)

    def _param_specs(self, input_size):
        """``(name, shape, initializer)`` of every Parameter, in order."""
        ng, ni, nh = self._gates, input_size, self._hidden_size
        specs = []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                specs += [
                    ("%s%d_i2h_weight" % (j, i), (ng * nh, ni),
                     self._i2h_weight_initializer),
                    ("%s%d_h2h_weight" % (j, i), (ng * nh, nh),
                     self._h2h_weight_initializer),
                    ("%s%d_i2h_bias" % (j, i), (ng * nh,),
                     _init_by_name(self._i2h_bias_initializer)),
                    ("%s%d_h2h_bias" % (j, i), (ng * nh,),
                     _init_by_name(self._h2h_bias_initializer))]
            ni = nh * self._dir
        return specs

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        self._reg_params[name] = p
        object.__setattr__(self, name, p)  # attribute access, no re-register
        return p

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = "{0} -> {1}".format(
            shape[1] if shape[1] else None, shape[0] // self._gates)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def _alias(self):
        return getattr(self, "_mode", "rnn")

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        """The initial states, ``func(shape=..., **kwargs)`` each."""
        states = []
        for info in self.state_info(batch_size):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            info.pop("__layout__", None)
            states.append(func(**info))
        return states

    def _infer_shape_from_input(self, x, *args):
        ni = x.shape[2] if self._layout == "TNC" else x.shape[-1]
        return {name: shape for name, shape, _ in self._param_specs(ni)}

    def forward(self, inputs, states=None):
        """``output`` (``states`` not given: zeros, and only the output
        comes back) or ``(output, states)``."""
        batch_size = inputs.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context)
        if isinstance(states, nd.NDArray):
            states = [states]
        for state, info in zip(states, self.state_info(batch_size)):
            if state.shape != info["shape"]:
                raise ValueError(
                    "Invalid recurrent state shape. Expecting %s, got %s." % (
                        str(info["shape"]), str(state.shape)))
        out = super().forward(inputs, states)
        return out[0] if skip_states else out

    def hybrid_forward(self, F, inputs, states, **params):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        # the fused op's packing: every weight, then every bias
        ws, bs = [], []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                ws.append(params["%s%d_i2h_weight" % (j, i)].reshape((-1,)))
                ws.append(params["%s%d_h2h_weight" % (j, i)].reshape((-1,)))
                bs.append(params["%s%d_i2h_bias" % (j, i)])
                bs.append(params["%s%d_h2h_bias" % (j, i)])
        packed = F.concat(*(ws + bs), dim=0)
        rnn_out = F.RNN(inputs, packed, *states[:2 if self._mode == "lstm"
                                               else 1],
                        state_size=self._hidden_size,
                        num_layers=self._num_layers,
                        bidirectional=self._dir == 2, p=self._dropout,
                        state_outputs=True, mode=self._mode)
        outputs, states = rnn_out[0], list(rnn_out[1:])
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        return outputs, states


class RNN(_RNNLayer):
    """Multi-layer Elman RNN with tanh or relu."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 projection_size=None, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", projection_size,
                         **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
