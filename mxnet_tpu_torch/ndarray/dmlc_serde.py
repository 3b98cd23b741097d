"""Reference binary NDArray-file codec (dmlc serialization).

Counterpart of ``mxnet_tpu/ndarray/dmlc_serde.py``, byte for byte: a file
either package writes is the file the other writes.

Reads and writes the exact on-disk format of the reference's
``mx.nd.save``/``mx.nd.load`` (``src/ndarray/ndarray.cc:1576-1820``):

    uint64  kMXAPINDArrayListMagic = 0x112
    uint64  reserved = 0
    uint64  n_arrays                      # dmlc vector<NDArray> header
    n_arrays x NDArray                    # per-array record, below
    uint64  n_names                       # dmlc vector<string> header
    n_names x { uint64 len; char[len] }

Per-array record (``NDArray::Save``/``Load``):

    uint32  magic
      - 0xF993fac9 (V2): int32 stype; [storage TShape if sparse];
        TShape shape; int32 dev_type; int32 dev_id; int32 type_flag;
        [per-aux: int32 aux_type, TShape aux_shape];
        raw data; [raw aux data...]
      - 0xF993fac8 (V1): TShape shape; ctx; type_flag; raw data
      - anything else (legacy/V0): magic IS ndim; uint32 dims follow
        (``LegacyTShapeLoad``), then ctx; type_flag; raw data

TShape (nnvm::Tuple<int64_t>): uint32 ndim + int64 dims.  All little-endian.
Sparse: row_sparse has one aux (indices, int64), csr has two
(indptr, indices, int64); V2 stores data as the *storage* shape (only
present rows / nnz values).

This module is pure layout code over numpy; arrays round-trip as numpy and
are wrapped by the caller.  bfloat16 has no type flag: as in the JAX
package it is saved as float32, with a warning.
"""
from __future__ import annotations

import struct
import warnings

import numpy as np

LIST_MAGIC = 0x112
V1_MAGIC = 0xF993FAC8
V2_MAGIC = 0xF993FAC9

# mshadow type flags (mshadow/base.h TypeFlag)
_FLAG_TO_DTYPE = {
    0: np.dtype(np.float32),
    1: np.dtype(np.float64),
    2: np.dtype(np.float16),
    3: np.dtype(np.uint8),
    4: np.dtype(np.int32),
    5: np.dtype(np.int8),
    6: np.dtype(np.int64),
}
_DTYPE_TO_FLAG = {v: k for k, v in _FLAG_TO_DTYPE.items()}

# NDArrayStorageType
STYPE_DEFAULT = 0
STYPE_ROW_SPARSE = 1
STYPE_CSR = 2
_NUM_AUX = {STYPE_DEFAULT: 0, STYPE_ROW_SPARSE: 1, STYPE_CSR: 2}
_STYPE_NAME = {STYPE_DEFAULT: "default", STYPE_ROW_SPARSE: "row_sparse",
               STYPE_CSR: "csr"}


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("invalid NDArray file format: truncated "
                             "(wanted %d bytes at offset %d, have %d)"
                             % (n, self.pos, len(self.buf)))
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self):
        return struct.unpack("<I", self.read(4))[0]

    def i32(self):
        return struct.unpack("<i", self.read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.read(8))[0]

    def shape(self):
        """nnvm TShape: uint32 ndim + int64 dims."""
        ndim = self.u32()
        if ndim > 32:
            raise ValueError("invalid NDArray file format: ndim=%d" % ndim)
        return tuple(struct.unpack("<%dq" % ndim, self.read(8 * ndim)))

    def raw(self, dtype, shape):
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        arr = np.frombuffer(self.read(dtype.itemsize * n),
                            dtype=dtype.newbyteorder("<")).astype(dtype)
        return arr.reshape(shape)


def _read_one(r):
    """One NDArray record -> (numpy_data, stype, aux_list) where aux_list
    is [] for dense, [indices] for row_sparse, [indptr, indices] for csr."""
    magic = r.u32()
    stype = STYPE_DEFAULT
    sshape = None
    if magic == V2_MAGIC:
        stype = r.i32()
        if stype not in _NUM_AUX:
            raise ValueError("invalid NDArray file format: stype=%d" % stype)
        if _NUM_AUX[stype] > 0:
            sshape = r.shape()
        shape = r.shape()
    elif magic == V1_MAGIC:
        shape = r.shape()
    else:
        # legacy V0: the magic word is ndim, dims are uint32
        ndim = magic
        if ndim > 32:
            raise ValueError("invalid NDArray file format: bad magic "
                             "0x%x" % magic)
        shape = tuple(struct.unpack("<%dI" % ndim, r.read(4 * ndim)))
    if len(shape) == 0:
        return np.zeros((0,), np.float32), STYPE_DEFAULT, []
    r.i32()  # dev_type — device placement is the loader's choice
    r.i32()  # dev_id
    type_flag = r.i32()
    if type_flag not in _FLAG_TO_DTYPE:
        raise ValueError("invalid NDArray file format: dtype flag %d"
                         % type_flag)
    dtype = _FLAG_TO_DTYPE[type_flag]
    aux_meta = []
    for _ in range(_NUM_AUX[stype]):
        aux_flag = r.i32()
        if aux_flag not in _FLAG_TO_DTYPE:
            raise ValueError("invalid NDArray file format: aux dtype "
                             "flag %d" % aux_flag)
        aux_meta.append((_FLAG_TO_DTYPE[aux_flag], r.shape()))
    data = r.raw(dtype, sshape if sshape is not None else shape)
    aux = [r.raw(adt, ashape) for adt, ashape in aux_meta]
    if stype == STYPE_ROW_SPARSE:
        # densify: storage rows scatter into the logical shape
        dense = np.zeros(shape, dtype)
        if aux[0].size:
            dense[aux[0].astype(np.int64)] = data
        return dense, STYPE_ROW_SPARSE, aux
    if stype == STYPE_CSR:
        indptr, indices = aux[0].astype(np.int64), aux[1].astype(np.int64)
        dense = np.zeros(shape, dtype)
        for row in range(shape[0]):
            lo, hi = indptr[row], indptr[row + 1]
            dense[row, indices[lo:hi]] = data[lo:hi]
        return dense, STYPE_CSR, aux
    return data, STYPE_DEFAULT, []


def loads(buf):
    """Parse a reference-format NDArray file.

    Returns ``(arrays, names, stypes)``: numpy arrays, the saved name list
    (empty for list-saves), and the storage-type name per array.
    """
    r = _Reader(buf)
    header = r.u64()
    if header != LIST_MAGIC:
        raise ValueError("invalid NDArray file format: bad list magic "
                         "0x%x" % header)
    r.u64()  # reserved
    n = r.u64()
    arrays, stypes = [], []
    for _ in range(n):
        data, stype, _aux = _read_one(r)
        arrays.append(data)
        stypes.append(_STYPE_NAME[stype])
    n_names = r.u64()
    if n_names not in (0, n):
        raise ValueError("invalid NDArray file format: %d names for %d "
                         "arrays" % (n_names, n))
    names = []
    for _ in range(n_names):
        ln = r.u64()
        names.append(r.read(ln).decode("utf-8"))
    return arrays, names, stypes


def is_dmlc_format(head):
    """True if ``head`` (>= 8 bytes) starts with the NDArray-list magic."""
    return len(head) >= 8 and \
        struct.unpack("<Q", head[:8])[0] == LIST_MAGIC


def _write_shape(out, shape):
    out.append(struct.pack("<I", len(shape)))
    out.append(struct.pack("<%dq" % len(shape), *shape))


def _write_one(out, arr):
    """Write one dense numpy array as a V2 record."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _DTYPE_TO_FLAG:
        # bfloat16 etc. have no reference type flag; the round-trip
        # changes dtype, so make that visible instead of silent
        warnings.warn("dtype %s has no reference NDArray type flag; "
                      "saving as float32 (round-trip will not restore "
                      "the original dtype)" % arr.dtype, stacklevel=3)
        arr = arr.astype(np.float32)
    if arr.ndim == 0:
        # a 0-dim shape means "none" in the reference format; a scalar
        # round-trips as shape (1,)
        arr = arr.reshape(1)
    out.append(struct.pack("<I", V2_MAGIC))
    out.append(struct.pack("<i", STYPE_DEFAULT))
    _write_shape(out, arr.shape)
    out.append(struct.pack("<ii", 1, 0))  # ctx: cpu(0)
    out.append(struct.pack("<i", _DTYPE_TO_FLAG[arr.dtype]))
    out.append(arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes())


def dumps(arrays, names=()):
    """Serialize numpy arrays (+ optional names) in the reference format."""
    names = list(names)
    if names and len(names) != len(arrays):
        raise ValueError("names/arrays length mismatch")
    out = [struct.pack("<QQ", LIST_MAGIC, 0),
           struct.pack("<Q", len(arrays))]
    for a in arrays:
        _write_one(out, np.asarray(a))
    out.append(struct.pack("<Q", len(names)))
    for s in names:
        b = s.encode("utf-8")
        out.append(struct.pack("<Q", len(b)))
        out.append(b)
    return b"".join(out)
