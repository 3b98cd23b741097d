"""The port's ``nd.save`` / ``nd.load`` / ``nd.load_frombuffer`` against the
JAX package's, on the CPU.

Both formats (``npz``, the default, and the reference's dmlc ``mxnet``
binary), both directions, on f32, int32, uint8, f16 and bf16 arrays, as
dicts and as lists (not int64: the JAX package holds it as int32, JAX's
64-bit types being off).  A dmlc file either package writes is
byte-identical to the other's.  An npz file is a zip archive whose members
carry the time of writing, so the two are held member by member: the same
names in the same order, byte-identical contents (bf16 as its raw 2-byte
words under the ``'<V2'`` header ``ml_dtypes`` gives), stored
uncompressed; and whole files are byte-identical when both are written
within one second.  Each package loads the other's files to the same
values and dtypes, except that the JAX package cannot load a bf16 npz
member at all (``jax.device_put`` refuses numpy's void dtype) — its own
files included — which a test pins; the dmlc format has no bf16 type
flag, so both packages write bf16 there as float32 with the same warning.
"""
import time
import warnings
import zipfile

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt

CPU = mt.cpu()


def _arrays():
    rng = np.random.RandomState(0)
    return {
        "f32": rng.randn(3, 4).astype(np.float32),
        "i32": rng.randint(-9, 9, (5,)).astype(np.int32),
        "u8": rng.randint(0, 255, (7,)).astype(np.uint8),
        "f16": rng.randn(2, 2).astype(np.float16),
        "bf16": rng.randn(4, 3).astype(np.float32),
    }


def _jax_nd(name, a):
    if name == "bf16":
        return jmx.nd.array(a).astype("bfloat16")
    return jmx.nd.array(a, dtype=a.dtype)


def _port_nd(name, a):
    if name == "bf16":
        return mt.nd.array(a, ctx=CPU, dtype="bfloat16")
    return mt.nd.array(a, ctx=CPU, dtype=a.dtype)


def _both(names, as_list=False):
    arrs = _arrays()
    j = {n: _jax_nd(n, arrs[n]) for n in names}
    t = {n: _port_nd(n, arrs[n]) for n in names}
    if as_list:
        return [j[n] for n in names], [t[n] for n in names]
    return j, t


def _save_pair(tmp_path, fmt, j, t):
    jp, tp = str(tmp_path / ("j." + fmt)), str(tmp_path / ("t." + fmt))
    for _ in range(3):              # npz stamps the second: retry across one
        t0 = int(time.time())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jmx.nd.save(jp, j, format=fmt)
            mt.nd.save(tp, t, format=fmt)
        if int(time.time()) == t0:
            break
    return jp, tp


def _bits(x):
    """Raw bytes of an NDArray of either package (bf16 as its words)."""
    if isinstance(x, mt.nd.NDArray):
        d = x.data
        if d.dtype == torch.bfloat16:
            d = d.view(torch.int16)
        return d.numpy().tobytes(), str(x.data.dtype)
    a = np.asarray(x.asnumpy())
    return a.tobytes(), str(a.dtype)


NAMES = ["f32", "i32", "u8", "f16"]


@pytest.mark.parametrize("as_list", [False, True])
def test_mxnet_format_byte_identical_both_ways(tmp_path, as_list):
    j, t = _both(NAMES + ["bf16"], as_list)
    jp, tp = _save_pair(tmp_path, "mxnet", j, t)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    # each package reads the other's file: same values, same dtypes
    got_t = mt.nd.load(jp, ctx=CPU)
    got_j = jmx.nd.load(tp)
    keys = range(len(j)) if as_list else list(j)
    for k in keys:
        a = np.asarray(got_j[k].asnumpy())
        b = got_t[k].asnumpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=str(k))


def test_mxnet_format_bf16_is_float32_with_a_warning(tmp_path):
    j, t = _both(["bf16"])
    with pytest.warns(UserWarning, match="no reference NDArray type flag"):
        mt.nd.save(str(tmp_path / "t.params"), t, format="mxnet")
    with pytest.warns(UserWarning, match="no reference NDArray type flag"):
        jmx.nd.save(str(tmp_path / "j.params"), j, format="mxnet")
    got = mt.nd.load(str(tmp_path / "t.params"), ctx=CPU)["bf16"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got.asnumpy(), t["bf16"].data.float().numpy())


@pytest.mark.parametrize("as_list", [False, True])
def test_npz_members_byte_identical_both_ways(tmp_path, as_list):
    j, t = _both(NAMES + ["bf16"], as_list)
    jp, tp = _save_pair(tmp_path, "npz", j, t)
    zj, zt = zipfile.ZipFile(jp), zipfile.ZipFile(tp)
    assert zj.namelist() == zt.namelist()
    for a, b in zip(zj.infolist(), zt.infolist()):
        assert zj.read(a) == zt.read(b), a.filename
        assert a.compress_type == b.compress_type == zipfile.ZIP_STORED
        if a.date_time == b.date_time:
            assert open(jp, "rb").read() == open(tp, "rb").read()
    # the port reads the JAX package's file, bf16 included
    got_t = mt.nd.load(jp, ctx=CPU)
    keys = range(len(t)) if as_list else list(t)
    for k in keys:
        assert _bits(got_t[k]) == _bits(t[k]), k


def test_npz_jax_reads_the_ports_file(tmp_path):
    j, t = _both(NAMES)
    jp, tp = _save_pair(tmp_path, "npz", j, t)
    got_j = jmx.nd.load(tp)
    for k in NAMES:
        a = np.asarray(got_j[k].asnumpy())
        np.testing.assert_array_equal(a, j[k].asnumpy(), err_msg=k)
        assert a.dtype == np.asarray(j[k].asnumpy()).dtype, k


def test_npz_bf16_the_jax_package_cannot_load_either_file(tmp_path):
    """The JAX package's quirk, pinned: its loader hands numpy's 2-byte
    void dtype to jax.device_put, which refuses it, whichever package
    wrote the file; the port reads both as bfloat16."""
    j, t = _both(["bf16"])
    jp, tp = _save_pair(tmp_path, "npz", j, t)
    for path in (jp, tp):
        with pytest.raises(TypeError, match="V2"):
            jmx.nd.load(path)
        got = mt.nd.load(path, ctx=CPU)["bf16"]
        assert got.data.dtype == torch.bfloat16
        assert _bits(got) == _bits(t["bf16"])


@pytest.mark.parametrize("fmt", ["npz", "mxnet"])
def test_load_frombuffer_both_packages(tmp_path, fmt):
    j, t = _both(NAMES)
    jp, tp = _save_pair(tmp_path, fmt, j, t)
    for path in (jp, tp):
        blob = open(path, "rb").read()
        got_t = mt.nd.load_frombuffer(blob, ctx=CPU)
        got_j = jmx.nd.load_frombuffer(blob)
        for k in NAMES:
            np.testing.assert_array_equal(got_t[k].asnumpy(),
                                          np.asarray(got_j[k].asnumpy()))
        # bytearray / memoryview take the same path
        got_m = mt.nd.load_frombuffer(memoryview(bytearray(blob)), ctx=CPU)
        assert _bits(got_m["f32"]) == _bits(got_t["f32"])


def test_single_ndarray_and_numpy_values_and_errors(tmp_path):
    a = _arrays()["f32"]
    mt.nd.save(str(tmp_path / "one.npz"), mt.nd.array(a, ctx=CPU))
    jmx.nd.save(str(tmp_path / "jone.npz"), jmx.nd.array(a))
    for p in ("one.npz", "jone.npz"):
        got = mt.nd.load(str(tmp_path / p), ctx=CPU)
        assert isinstance(got, list) and len(got) == 1
        np.testing.assert_array_equal(got[0].asnumpy(), a)
    # host numpy values sit beside NDArrays, as in the JAX package
    mt.nd.save(str(tmp_path / "mix.npz"), {"w": a,
                                            "b": mt.nd.array(a, ctx=CPU)})
    jmx.nd.save(str(tmp_path / "jmix.npz"), {"w": a, "b": jmx.nd.array(a)})
    zt = zipfile.ZipFile(str(tmp_path / "mix.npz"))
    zj = zipfile.ZipFile(str(tmp_path / "jmix.npz"))
    assert [zt.read(n) for n in zt.namelist()] == \
        [zj.read(n) for n in zj.namelist()]
    for bad in ({1: mt.nd.array(a, ctx=CPU)}, [a.tolist()], 3.0):
        with pytest.raises(ValueError):
            mt.nd.save(str(tmp_path / "bad.npz"), bad)
    with pytest.raises(ValueError, match="unknown save format"):
        mt.nd.save(str(tmp_path / "x"), [mt.nd.array(a, ctx=CPU)],
                   format="hdf5")


def test_default_context_is_the_card():
    """Without ctx= the loaded arrays go to the current context (the
    card); inside ``with mt.cpu():`` to the CPU."""
    import io

    buf = io.BytesIO()
    np.savez(buf, **{"name:w": np.ones(2, np.float32)})
    with mt.cpu():
        got = mt.nd.load_frombuffer(buf.getvalue())
    assert got["w"].context == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mt.nd.load_frombuffer(buf.getvalue())
