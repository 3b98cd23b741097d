"""NDArray serialization: ``save`` / ``load`` / ``load_frombuffer``.

Counterpart of ``mxnet_tpu/ndarray/utils.py`` (reference ``mx.nd.save`` /
``mx.nd.load``).  Both of the JAX package's formats, written byte for byte
as it writes them, and each package reads the other's files:

* ``format="npz"`` (the default): a numpy ``.npz`` container (``np.savez``'s
  layout) with ``name:<key>`` or ``idx:%09d`` members and a
  ``__mxnet_tpu_format__`` member carrying the format version;
* ``format="mxnet"``: the reference's dmlc binary NDArray list
  (:mod:`.dmlc_serde`), which reference installations read.

bfloat16 goes into an npz member as its raw 2-byte words under the numpy
descr ``'<V2'`` (the header ``ml_dtypes``' bfloat16 gets, so the bytes are
the JAX package's), and ``load`` reads any 2-byte void member back as
bfloat16: ``ml_dtypes`` stays optional.  The dmlc format has no bfloat16
type flag, so there it is saved as float32 with a warning, as in the JAX
package.

``load`` and ``load_frombuffer`` take ``ctx=`` (default
:func:`~mxnet_tpu_torch.context.current_context`, the card).
"""
from __future__ import annotations

import io
import os
import warnings
import zipfile

import numpy as np
import torch

from . import dmlc_serde
from .ndarray import NDArray, array

__all__ = ["save", "load", "load_frombuffer"]

_MAGIC_KEY = "__mxnet_tpu_format__"
_FORMAT_VERSION = "1"
_BF16_DESCR = "<V2"


def _host(val):
    """``(numpy array, is_bfloat16)`` of an NDArray or numpy value; a
    bfloat16 NDArray comes back as its raw words (int16)."""
    if isinstance(val, NDArray):
        t = val.data.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().copy(), True
        return val.asnumpy(), False
    if not isinstance(val, np.ndarray):
        raise ValueError("save only accepts dict str->NDArray or list of "
                         "NDArray")
    if val.dtype.name == "bfloat16":
        return np.ascontiguousarray(val).view(np.int16), True
    return val, False


def _write_member(zipf, key, host, bf16):
    """One ``np.savez`` member; bfloat16 words under the ``'<V2'``
    header."""
    with zipf.open(key + ".npy", "w", force_zip64=True) as fid:
        if not bf16:
            np.lib.format.write_array(fid, np.asanyarray(host),
                                      allow_pickle=True)
            return
        host = np.ascontiguousarray(host)
        np.lib.format.write_array_header_1_0(
            fid, {"descr": _BF16_DESCR, "fortran_order": False,
                  "shape": host.shape})
        fid.write(host.astype("<i2", copy=False).tobytes())


def _entries(data):
    """``[(npz key, name or None, value)]`` of what ``save`` accepts."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        for key, val in data.items():
            if not isinstance(key, str) or not isinstance(
                    val, (NDArray, np.ndarray)):
                raise ValueError("save only accepts dict str->NDArray or "
                                 "list of NDArray")
        return [("name:" + k, k, v) for k, v in data.items()]
    if isinstance(data, (list, tuple)):
        for val in data:
            if not isinstance(val, (NDArray, np.ndarray)):
                raise ValueError("save only accepts dict str->NDArray or "
                                 "list of NDArray")
        return [("idx:%09d" % i, None, v) for i, v in enumerate(data)]
    raise ValueError("data needs to either be a NDArray, dict of str to "
                     "NDArray or a list of NDArray")


def _replace(fname, write):
    tmp = fname + ".tmp%d" % os.getpid()
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, fname)


def save(fname, data, format="npz"):
    """Save an NDArray, a list of them or a str->NDArray dict (numpy arrays
    are accepted beside NDArrays) to ``fname`` in ``format`` ``"npz"`` or
    ``"mxnet"``; the file is written beside and moved into place."""
    if format not in ("npz", "mxnet"):
        raise ValueError("unknown save format %r" % (format,))
    entries = _entries(data)
    if format == "mxnet":
        arrays = []
        for _, _, val in entries:
            host, bf16 = _host(val)
            if bf16:
                warnings.warn(
                    "dtype bfloat16 has no reference NDArray type flag; "
                    "saving as float32 (round-trip will not restore the "
                    "original dtype)", stacklevel=2)
                host = (host.astype(np.int32) << 16).astype(
                    np.uint32).view(np.float32)
            arrays.append(host)
        names = [n for _, n, _ in entries if n is not None]
        blob = dmlc_serde.dumps(arrays, names)
        _replace(fname, lambda f: f.write(blob))
        return

    def write(f):
        with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zipf:
            for key, _, val in entries:
                _write_member(zipf, key, *_host(val))
            _write_member(zipf, _MAGIC_KEY,
                          np.array(int(_FORMAT_VERSION)), False)

    _replace(fname, write)


def _wrap(a, ctx):
    """An NDArray on ``ctx`` of a loaded numpy array (a 2-byte void array
    is bfloat16 words)."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        from ..context import current_context

        words = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return NDArray(words.view(torch.bfloat16).to(
            (ctx or current_context()).torch_device()))
    return array(a, ctx=ctx, dtype=a.dtype)


def _load_dmlc(buf, ctx):
    arrays, names, _stypes = dmlc_serde.loads(buf)
    if names:
        return {n: _wrap(a, ctx) for n, a in zip(names, arrays)}
    return [_wrap(a, ctx) for a in arrays]


def _load_npz(src, ctx):
    with np.load(src, allow_pickle=False) as z:
        keys = [k for k in z.files if k != _MAGIC_KEY]
        if all(k.startswith("idx:") for k in keys):
            return [_wrap(z[k], ctx) for k in sorted(keys)]
        return {(k[5:] if k.startswith("name:") else k): _wrap(z[k], ctx)
                for k in keys}


def load(fname, ctx=None):
    """A list or dict, as saved, of NDArrays on ``ctx``; reads both formats
    (the dmlc one in its V0, V1 and V2 layouts)."""
    with open(fname, "rb") as f:
        head = f.read(8)
    if dmlc_serde.is_dmlc_format(head):
        with open(fname, "rb") as f:
            return _load_dmlc(f.read(), ctx)
    return _load_npz(fname, ctx)


def load_frombuffer(buf, ctx=None):
    """:func:`load` of bytes in either format."""
    if dmlc_serde.is_dmlc_format(bytes(buf[:8])):
        return _load_dmlc(bytes(buf), ctx)
    return _load_npz(io.BytesIO(bytes(buf)), ctx)
