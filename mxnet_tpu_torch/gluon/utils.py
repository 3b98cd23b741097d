"""Gluon utilities.

Counterpart of ``mxnet_tpu/gluon/utils.py`` (reference ``python/mxnet/
gluon/utils.py``): ``split_data``, ``split_and_load``,
``clip_global_norm`` and ``check_sha1``; ``download`` is not ported (the
port fetches nothing)."""
from __future__ import annotations

import hashlib

import numpy as np

from .. import ndarray as nd

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split an NDArray along batch_axis into num_slice slices
    (reference: utils.py split_data)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data." % (
                str(data.shape), num_slice, batch_axis, num_slice))
    if num_slice == 1:
        return [data]
    step = size // num_slice
    if even_split:
        slices = [
            data.slice_axis(batch_axis, i * step, (i + 1) * step)
            for i in range(num_slice)]
    else:
        slices = [
            data.slice_axis(batch_axis, i * step,
                            (i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split data into len(ctx_list) slices and load each onto a context
    (reference: utils.py split_and_load)."""
    if not isinstance(data, nd.NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [i.as_in_context(ctx) for i, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale arrays so that the sum of their 2-norms is at most max_norm
    (reference: utils.py clip_global_norm)."""
    def _norm(array):
        x = array.reshape((-1,))
        return nd.dot(x, x)

    assert len(arrays) > 0
    ctx = arrays[0].context
    total_norm = nd.add_n(*[_norm(arr).as_in_context(ctx) for arr in arrays])
    total_norm = total_norm.sqrt()
    if check_isfinite:
        total = total_norm.asscalar()
        if not np.isfinite(total):
            import warnings
            warnings.warn(UserWarning("nan or inf is detected. Clipping "
                                      "results will be undefined."),
                          stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    scale = nd.minimum(scale, nd.ones(1, ctx=ctx))
    for arr in arrays:
        arr *= scale.as_in_context(arr.context)
    if check_isfinite:
        return total
    return total_norm


def check_sha1(filename, sha1_hash):
    """Check a file against its expected sha1 hash."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash
