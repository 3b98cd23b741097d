"""Data iterators: ``DataDesc``, ``DataBatch`` and ``NDArrayIter``.

Counterpart of those classes in ``mxnet_tpu/io/io.py`` (reference
``python/mxnet/io/io.py``).  Batches are built on the host, as NDArrays on
``cpu()``; an executor copies what it is fed onto its own device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ndarray as nd
from .. import random as _random
from ..context import cpu
from ..ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc:
    """Name and shape (and dtype, layout) of one data field."""

    def __init__(self, name, shape, dtype=np.float32, layout="NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = dtype
        self.layout = layout

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    def __eq__(self, other):
        if isinstance(other, DataDesc):
            return self.name == other.name and self.shape == other.shape
        if isinstance(other, tuple):
            return (self.name, self.shape) == other
        return NotImplemented

    def __iter__(self):           # name, shape = desc
        yield self.name
        yield self.shape


class DataBatch:
    """One minibatch."""

    def __init__(self, data, label=None, pad=None, index=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index


class DataIter:
    """Base data iterator."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Input data as a list of ``(name, numpy array)``."""
    if data is None:
        if not allow_empty:
            raise ValueError("%s cannot be None" % default_name)
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise ValueError("%s cannot be empty" % default_name)
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    return [(k, np.ascontiguousarray(v.asnumpy() if isinstance(v, NDArray)
                                     else v)) for k, v in data.items()]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays in batches of ``batch_size``.

    ``last_batch_handle``: ``'pad'`` (the last batch wraps around to the
    start) or ``'discard'`` (a short last batch is dropped).  With
    ``shuffle`` every ``reset`` permutes the order, drawing from the host's
    generator in ``mx.random`` (or, given ``seed``, from a generator of the
    iterator's own)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard"):
            raise ValueError("last_batch_handle must be 'pad' or 'discard', "
                             "not %r" % (last_batch_handle,))
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        for _, v in self.data + self.label:
            if v.shape[0] != self.num_data:
                raise ValueError("all data/label must have the same number "
                                 "of samples")
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self._gen = (torch.Generator().manual_seed(int(seed))
                     if seed is not None else None)
        self.idx = np.arange(self.num_data)
        self.cursor = -batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            gen = self._gen or _random.generator("cpu")
            self.idx = self.idx[torch.randperm(self.num_data,
                                               generator=gen).numpy()]
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _take(self, arrays):
        lo, hi = self.cursor, self.cursor + self.batch_size
        if hi <= self.num_data:
            sel = self.idx[lo:hi]
        else:                               # pad: wrap around
            sel = np.concatenate([self.idx[lo:],
                                  self.idx[:hi - self.num_data]])
        return [nd.array(v[sel], ctx=cpu()) for _, v in arrays]

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0
