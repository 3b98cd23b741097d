"""Unfused recurrent cells and their ``unroll``.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py`` (reference
``python/mxnet/gluon/rnn/rnn_cell.py``): ``RNNCell``, ``LSTMCell`` and
``GRUCell`` (one step of ``FullyConnected`` products and activations),
``SequentialRNNCell``, ``DropoutCell``, the modifier cells
(``ZoneoutCell``, ``ResidualCell``) and ``BidirectionalCell``.

``unroll(valid_length=)`` masks each step's output with ``where(
valid_length > t, out, 0)`` as the JAX package does: the (N,) condition
broadcasts against the (N, H) output from the right, so it runs only
where H == N (or N == 1), and then masks by column.  The port keeps that
behaviour, as it keeps the JAX package's results.
"""
from __future__ import annotations

from ... import ndarray as nd
from ..block import Block, HybridBlock
from ..parameter import DeferredInitializationError
from ..nn.basic_layers import _init_by_name

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _get_begin_state(cell, F, begin_state, inputs, batch_size):
    if begin_state is None:
        ctx = inputs.context if isinstance(inputs, nd.NDArray) \
            else inputs[0].context
        with ctx:
            begin_state = cell.begin_state(func=F.zeros,
                                           batch_size=batch_size)
    return begin_state


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """``(inputs, time axis, batch size)``: one array (``merge`` True) or
    a list of per-step arrays (``merge`` False), as given otherwise."""
    if inputs is None:
        raise ValueError("unroll(inputs=None) is not supported. Please "
                         "initialize the cell and provide the inputs")
    axis = layout.find("T")
    batch_axis = layout.find("N")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, nd.NDArray):
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            if length is not None and length != inputs.shape[in_axis]:
                raise ValueError("unroll: length %d, but the inputs have "
                                 "%d steps" % (length, inputs.shape[in_axis]))
            inputs = inputs.split(num_outputs=inputs.shape[in_axis],
                                  axis=in_axis, squeeze_axis=True)
            if not isinstance(inputs, (list, tuple)):
                inputs = [inputs]
    else:
        if length is not None and len(inputs) != length:
            raise ValueError("unroll: length %d, but %d inputs"
                             % (length, len(inputs)))
        batch_size = inputs[0].shape[batch_axis]
        if merge is True:
            inputs = nd.stack(*inputs, axis=axis)
    if isinstance(inputs, nd.NDArray) and axis != in_axis:
        inputs = inputs.swapaxes(in_axis, axis)
    return inputs, axis, batch_size


def _mask_sequence_variable_length(F, outputs, valid_length):
    """Each step's output where ``valid_length > t``, else zeros (see the
    module docstring for how the condition broadcasts)."""
    return [F.where(valid_length > i, x, F.zeros_like(x))
            for i, x in enumerate(outputs)]


class RecurrentCell(Block):
    """Abstract recurrent cell."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        """Initial states, ``func(shape=..., **kwargs)`` each."""
        if self._modified:
            raise RuntimeError("After applying modifier cells the base cell "
                               "cannot be called directly. Call the "
                               "modifier cell instead.")
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            info.pop("__layout__", None)
            states.append(func(**info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run the cell over ``length`` steps: ``(outputs, states)``,
        the outputs one array along the time axis under
        ``merge_outputs``, else a list."""
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        states = _get_begin_state(self, nd, begin_state, inputs, batch_size)
        outputs, all_states = [], []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [nd.SequenceLast(nd.stack(*ele_list, axis=0),
                                      sequence_length=valid_length,
                                      use_sequence_length=True, axis=0)
                      for ele_list in zip(*all_states)]
            outputs = _mask_sequence_variable_length(nd, outputs,
                                                     valid_length)
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def forward(self, inputs, states):
        raise NotImplementedError()


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """A RecurrentCell whose step is a ``hybrid_forward``."""

    def forward(self, inputs, states):
        ctx = inputs.context
        try:
            params = {k: v.data(ctx) for k, v in self._reg_params.items()}
        except DeferredInitializationError:   # shapes from the first input
            self._finish_deferred_cell(inputs)
            params = {k: v.data(ctx) for k, v in self._reg_params.items()}
        return self.hybrid_forward(nd, inputs, states, **params)

    def _finish_deferred_cell(self, inputs):
        for name, dims in (self._infer_shape_from_input(inputs)
                           or {}).items():
            p = self._reg_params[name]
            p.shape = dims
            p._finish_deferred_init()

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError()


class _GatedCell(HybridRecurrentCell):
    """A cell of ``gates`` gates over i2h / h2h ``FullyConnected``
    products."""

    _gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        ng = self._gates * hidden_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(ng, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(ng, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(ng,), init=_init_by_name(i2h_bias_initializer),
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(ng,), init=_init_by_name(h2h_bias_initializer),
            allow_deferred_init=True)

    def _infer_shape_from_input(self, x, *args):
        ng = self._gates * self._hidden_size
        return {"i2h_weight": (ng, x.shape[-1]),
                "h2h_weight": (ng, self._hidden_size),
                "i2h_bias": (ng,), "h2h_bias": (ng,)}

    def _products(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                  h2h_bias):
        ng = self._gates * self._hidden_size
        return (F.FullyConnected(inputs, i2h_weight, i2h_bias,
                                 num_hidden=ng),
                F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=ng))


class RNNCell(_GatedCell):
    """Elman RNN cell."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._products(F, inputs, states[0], **params)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """LSTM cell (gate order i, f, g, o)."""

    _gates = 4

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._products(F, inputs, states[0], **params)
        slice_gates = F.split(i2h + h2h, num_outputs=4, axis=1)
        in_gate = F.Activation(slice_gates[0], act_type="sigmoid")
        forget_gate = F.Activation(slice_gates[1], act_type="sigmoid")
        in_transform = F.Activation(slice_gates[2], act_type="tanh")
        out_gate = F.Activation(slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU cell (gate order r, z, n; the reset gate on the h-side "new"
    term)."""

    _gates = 3

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, **params):
        prev_state_h = states[0]
        i2h, h2h = self._products(F, inputs, prev_state_h, **params)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=1)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h_n + reset_gate * h2h_n,
                                  act_type="tanh")
        next_h = (1. - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each one's output is the next one's input."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        if self._modified:
            raise RuntimeError("After applying modifier cells the base cell "
                               "cannot be called directly.")
        return _cells_begin_state(self._children.values(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            if isinstance(cell, BidirectionalCell):
                raise TypeError("a BidirectionalCell cannot be stepped in a "
                                "SequentialRNNCell; unroll it")
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        num_cells = len(self._children)
        inputs, _, batch_size = _format_sequence(length, inputs, layout,
                                                 None)
        begin_state = _get_begin_state(self, nd, begin_state, inputs,
                                       batch_size)
        p = 0
        next_states = []
        for i, cell in enumerate(self._children.values()):
            n = len(cell.state_info())
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs,
                valid_length=valid_length)
            next_states.extend(states)
        return inputs, next_states

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)

    def forward(self, *args, **kwargs):
        raise NotImplementedError()


class DropoutCell(HybridRecurrentCell):
    """Dropout on the cell's input."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        if not isinstance(rate, (int, float)):
            raise TypeError("rate must be a number")
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        inputs, _, _ = _format_sequence(length, inputs, layout, True)
        if isinstance(inputs, nd.NDArray):
            return self.hybrid_forward(nd, inputs,
                                       begin_state if begin_state else [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs,
                              valid_length=valid_length)


class ModifierCell(HybridRecurrentCell):
    """Base of the cells that modify another cell."""

    def __init__(self, base_cell):
        if base_cell._modified:
            raise ValueError("Cell %s is already modified. One cell cannot "
                             "be modified twice" % base_cell.name)
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=nd.zeros, **kwargs):
        if self._modified:
            raise RuntimeError("After applying modifier cells the base cell "
                               "cannot be called directly.")
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout: each output and state keeps its previous value with
    probability ``zoneout_outputs`` / ``zoneout_states`` in training."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        if isinstance(base_cell, BidirectionalCell):
            raise TypeError("BidirectionalCell doesn't support zoneout "
                            "since it doesn't support step. Please add "
                            "ZoneoutCell to the cells underneath instead.")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)

        prev_output = self._prev_output if self._prev_output is not None \
            else F.zeros_like(next_output)
        output = F.where(mask(p_outputs, next_output), next_output,
                         prev_output) if p_outputs != 0. else next_output
        new_states = [F.where(mask(p_states, new_s), new_s, old_s)
                      for new_s, old_s in zip(next_states, states)] \
            if p_states != 0. else next_states
        # the residual output carries across calls, as the reference's
        # ZoneoutCell keeps it (which is why it is not hybridizable there)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Adds the input to the base cell's output."""

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    def _alias(self):
        return "residual"

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)
        self.base_cell._modified = True
        merge_outputs = isinstance(outputs, nd.NDArray) if merge_outputs \
            is None else merge_outputs
        inputs, _, _ = _format_sequence(length, inputs, layout,
                                        merge_outputs)
        if merge_outputs:
            outputs = outputs + inputs
        else:
            outputs = [i + j for i, j in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Two cells over the sequence in opposite directions, their outputs
    joined along the features."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        if self._modified:
            raise RuntimeError("After applying modifier cells the base cell "
                               "cannot be called directly.")
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        reversed_inputs = list(reversed(inputs))
        states = _get_begin_state(self, nd, begin_state, inputs, batch_size)
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info())
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=reversed_inputs, begin_state=states[n_l:],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        outputs = [nd.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, reversed(r_outputs))]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
