"""Recurrent layers and cells (counterpart of ``mxnet_tpu/gluon/rnn``;
reference ``python/mxnet/gluon/rnn/``)."""
from .rnn_cell import (BidirectionalCell, DropoutCell,  # noqa: F401
                       GRUCell, HybridRecurrentCell, LSTMCell, ModifierCell,
                       RecurrentCell, ResidualCell, RNNCell,
                       SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN  # noqa: F401
