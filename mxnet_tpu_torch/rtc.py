"""Runtime compilation of user CUDA kernels: ``mx.rtc``.

Counterpart of ``mxnet_tpu/rtc.py``, which compiles user Pallas source at
runtime (``PallasModule``, launched by ``PallasKernel.launch`` through
``pl.pallas_call``).  The port restores the reference's own surface over
NVRTC (``python/mxnet/rtc.py``: ``CudaModule`` / ``CudaKernel``;
``src/common/rtc.cc``): CUDA C++ source is the port's kernel language, as
Pallas source is the TPU's.

* :class:`CudaModule` compiles source with NVRTC (loaded with ``ctypes``
  from ``$CUDA_HOME/lib64``, ``/usr/local/cuda/lib64``, then the copy
  PyTorch ships) for the card's own architecture (``sm_90a`` on an H100),
  taking SASS with ``nvrtcGetCUBIN`` — nothing is JIT-compiled from PTX at
  load.  ``exports`` are name expressions (``"axpy<float>"``) resolved to
  their mangled names with ``nvrtcAddNameExpression`` /
  ``nvrtcGetLoweredName``.  A compile error raises with NVRTC's log.
  Cubins are cached under ``mxnet_tpu_torch/_build/rtc/``, keyed by a hash
  of the source, the options, the exports, the architecture and the NVRTC
  version; :func:`compile_count` counts real compilations.
* ``get_kernel(name, signature)`` parses the C signature (``"const float
  *x, float *y, float alpha, int n"``) into pointer or scalar, dtype and
  const, and raises :class:`ValueError` for a kernel the module does not
  have.
* :meth:`CudaKernel.launch` loads the module on the context's device
  through libcuda (``cuModuleLoadData`` / ``cuModuleGetFunction``,
  once per device), checks each argument against the signature (an
  NDArray of the signature's dtype, contiguous, on that device, for a
  pointer; a number for a scalar), and calls ``cuLaunchKernel`` on
  PyTorch's current stream of that device.  Kernels write their outputs in
  place, as in the reference.  Each launch bumps
  ``kernels.launch.rtc.<name>`` in ``ops/kernels/common.py``.

There is no CPU path and no fallback: without a CUDA device, or without
NVRTC, :class:`CudaModule` raises :class:`RuntimeError`.  ``PallasModule``
raises :class:`NotImplementedError`, naming ``CudaModule``, as the JAX
package's ``CudaModule`` names ``PallasModule``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import re
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .context import Context
from .ndarray.ndarray import NDArray
from .ops.kernels._build import BUILD_DIR
from .ops.kernels.common import count_launch

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "compile_count",
           "parse_signature"]

RTC_DIR = BUILD_DIR / "rtc"
_CUDA_ERROR_NOT_FOUND = 500
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

# the reference's C++ -> numpy dtype table (python/mxnet/rtc.py)
_DTYPES = {"float": np.float32, "double": np.float64, "__half": np.float16,
           "half": np.float16, "uint8_t": np.uint8, "int": np.int32,
           "int32_t": np.int32, "int8_t": np.int8, "char": np.int8,
           "int64_t": np.int64}
_SCALAR_CTYPES = {np.dtype(np.float32): ctypes.c_float,
                  np.dtype(np.float64): ctypes.c_double,
                  np.dtype(np.int32): ctypes.c_int32,
                  np.dtype(np.int64): ctypes.c_int64,
                  np.dtype(np.int8): ctypes.c_int8,
                  np.dtype(np.uint8): ctypes.c_uint8}
_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")

_LOCK = threading.RLock()
_LIBS = {}
_PRIMARY = {}                 # CUDA device index -> its primary CUcontext
_COMPILES = [0]


def compile_count():
    """NVRTC compilations in this process (cache hits not counted)."""
    return _COMPILES[0]


class PallasModule:
    """The JAX package's runtime-kernel surface: not in the port."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "mxnet_tpu_torch.rtc: PallasModule compiles Pallas kernels for "
            "the TPU; on the GPU write the kernel in CUDA C++ and use "
            "mx.rtc.CudaModule (same get_kernel / launch surface)")


# ---------------------------------------------------------------------------
# the libraries
# ---------------------------------------------------------------------------
def _nvrtc_candidates():
    dirs = []
    if os.environ.get("CUDA_HOME"):
        dirs.append(Path(os.environ["CUDA_HOME"]) / "lib64")
    dirs.append(Path("/usr/local/cuda/lib64"))
    torch_dir = Path(torch.__file__).resolve().parent
    dirs += [torch_dir / "lib",
             torch_dir.parent / "nvidia" / "cuda_nvrtc" / "lib"]
    for d in dirs:
        yield from sorted(glob.glob(str(d / "libnvrtc.so*")))
        yield from sorted(glob.glob(str(d / "libnvrtc-*.so*")))


def _nvrtc():
    """The NVRTC library, loaded once; RuntimeError when there is none."""
    with _LOCK:
        if "nvrtc" not in _LIBS:
            lib, tried = None, []
            for path in _nvrtc_candidates():
                if "builtins" in os.path.basename(path):
                    continue
                try:
                    lib = ctypes.CDLL(path)
                    break
                except OSError as e:
                    tried.append("%s (%s)" % (path, e))
            if lib is None:
                raise RuntimeError(
                    "mxnet_tpu_torch.rtc: NVRTC (libnvrtc.so) not found in "
                    "$CUDA_HOME/lib64, /usr/local/cuda/lib64 or PyTorch's "
                    "libraries%s" % ("; tried " + ", ".join(tried)
                                     if tried else ""))
            vp, cp = ctypes.c_void_p, ctypes.c_char_p
            pp = ctypes.POINTER
            for name, args in (
                    ("nvrtcVersion", [pp(ctypes.c_int), pp(ctypes.c_int)]),
                    ("nvrtcCreateProgram", [pp(vp), cp, cp, ctypes.c_int,
                                            vp, vp]),
                    ("nvrtcAddNameExpression", [vp, cp]),
                    ("nvrtcCompileProgram", [vp, ctypes.c_int, pp(cp)]),
                    ("nvrtcGetProgramLogSize", [vp, pp(ctypes.c_size_t)]),
                    ("nvrtcGetProgramLog", [vp, cp]),
                    ("nvrtcGetCUBINSize", [vp, pp(ctypes.c_size_t)]),
                    ("nvrtcGetCUBIN", [vp, cp]),
                    ("nvrtcGetLoweredName", [vp, cp, pp(cp)]),
                    ("nvrtcDestroyProgram", [pp(vp)])):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, ctypes.c_int
            lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
            lib.nvrtcGetErrorString.restype = cp
            _LIBS["nvrtc"] = lib
        return _LIBS["nvrtc"]


def _cuda():
    """``libcuda.so.1``, loaded once."""
    with _LOCK:
        if "cuda" not in _LIBS:
            try:
                lib = ctypes.CDLL("libcuda.so.1")
            except OSError as e:
                raise RuntimeError("mxnet_tpu_torch.rtc: libcuda.so.1 "
                                   "cannot be loaded: %s" % e)
            vp, pp, ui = ctypes.c_void_p, ctypes.POINTER, ctypes.c_uint
            for name, args in (
                    ("cuInit", [ui]),
                    ("cuDeviceGet", [pp(ctypes.c_int), ctypes.c_int]),
                    ("cuCtxGetCurrent", [pp(vp)]),
                    ("cuCtxGetDevice", [pp(ctypes.c_int)]),
                    ("cuDevicePrimaryCtxRetain", [pp(vp), ctypes.c_int]),
                    ("cuCtxSetCurrent", [vp]),
                    ("cuModuleLoadData", [pp(vp), vp]),
                    ("cuModuleGetFunction", [pp(vp), vp, ctypes.c_char_p]),
                    ("cuFuncSetAttribute", [vp, ctypes.c_int, ctypes.c_int]),
                    ("cuLaunchKernel", [vp, ui, ui, ui, ui, ui, ui, ui, vp,
                                        pp(vp), pp(vp)]),
                    ("cuGetErrorString", [ctypes.c_int,
                                          pp(ctypes.c_char_p)])):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, ctypes.c_int
            _LIBS["cuda"] = lib
        return _LIBS["cuda"]


def _nvrtc_check(lib, rc, what, log=""):
    if rc != 0:
        raise RuntimeError("mxnet_tpu_torch.rtc: %s failed: %s%s" % (
            what, lib.nvrtcGetErrorString(rc).decode(),
            ("\n" + log) if log else ""))


def _cu_check(rc, what):
    if rc != 0:
        msg = ctypes.c_char_p()
        _cuda().cuGetErrorString(rc, ctypes.byref(msg))
        raise RuntimeError("mxnet_tpu_torch.rtc: %s failed: CUDA error %d "
                           "(%s)" % (what, rc, (msg.value or b"?").decode()))


def _make_current(index):
    """Make the primary context of CUDA device ``index`` (PyTorch's)
    current on this thread, as ``cuModuleLoadData`` and ``cuLaunchKernel``
    need."""
    torch.cuda.init()
    cu = _cuda()
    cur, dev = ctypes.c_void_p(), ctypes.c_int(-1)
    _cu_check(cu.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value:
        _cu_check(cu.cuCtxGetDevice(ctypes.byref(dev)), "cuCtxGetDevice")
        if dev.value == index:
            return
    _cu_check(cu.cuInit(0), "cuInit")
    cudev, ctx = ctypes.c_int(), ctypes.c_void_p()
    _cu_check(cu.cuDeviceGet(ctypes.byref(cudev), index), "cuDeviceGet")
    with _LOCK:
        # retained once per device and never released: PyTorch keeps the
        # primary context alive for the life of the process anyway
        if index not in _PRIMARY:
            _cu_check(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), cudev),
                      "cuDevicePrimaryCtxRetain")
            _PRIMARY[index] = ctx.value
    _cu_check(cu.cuCtxSetCurrent(_PRIMARY[index]), "cuCtxSetCurrent")


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------
def parse_signature(signature):
    """``[(is_pointer, numpy dtype, is_const), ...]`` of a C parameter
    list such as ``"const float *x, float *y, float alpha, int n"``."""
    params = []
    for arg in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG.match(arg)
        if m is None or m.group(2) == "const":
            raise ValueError("invalid kernel signature argument %r" % arg)
        const, ctype, star = m.group(1), m.group(2), m.group(3)
        if ctype not in _DTYPES:
            raise TypeError("unsupported kernel argument type %r; supported "
                            "types are %s" % (ctype, sorted(_DTYPES)))
        params.append((bool(star), np.dtype(_DTYPES[ctype]), bool(const)))
    return params


def marshal(params, args, device):
    """The ctypes value of each argument of a launch on ``device``, checked
    against the parsed signature ``params``."""
    if len(args) != len(params):
        raise ValueError("the kernel takes %d arguments, got %d"
                         % (len(params), len(args)))
    values = []
    for i, ((is_ptr, dtype, _), arg) in enumerate(zip(params, args)):
        if is_ptr:
            if not isinstance(arg, NDArray):
                raise TypeError("argument %d is a pointer: pass an NDArray, "
                                "not %s" % (i, type(arg).__name__))
            if arg.dtype != dtype:
                raise TypeError("argument %d: the signature says %s, the "
                                "NDArray holds %s" % (i, dtype, arg.dtype))
            t = arg.data
            if t.device != device:
                raise ValueError("argument %d lies on %s, the launch is on "
                                 "%s" % (i, t.device, device))
            if not t.is_contiguous():
                raise ValueError("argument %d is not contiguous" % i)
            values.append(ctypes.c_void_p(t.data_ptr()))
        else:
            if isinstance(arg, NDArray) or not isinstance(
                    arg, (int, float, np.number)):
                raise TypeError("argument %d is a %s scalar: pass a number, "
                                "not %s" % (i, dtype, type(arg).__name__))
            if dtype == np.float16:
                values.append(ctypes.c_uint16(
                    int(np.float16(arg).view(np.uint16))))
            else:
                values.append(_SCALAR_CTYPES[dtype](
                    dtype.type(arg).item()))
    return values


# ---------------------------------------------------------------------------
# modules and kernels
# ---------------------------------------------------------------------------
def _arch():
    major, minor = torch.cuda.get_device_capability()
    # the 'a' target has Hopper's wgmma and setmaxnreg
    return "sm_%d%d%s" % (major, minor, "a" if major == 9 else "")


class CudaModule:
    """CUDA C++ ``source`` compiled at runtime (reference rtc.py:42).

    ``options`` are extra NVRTC options (``-std=c++17`` and
    ``-default-device`` come first); ``exports`` the name expressions of
    kernels that are templated or not ``extern "C"``."""

    def __init__(self, source, options=(), exports=()):
        if not torch.cuda.is_available():
            raise RuntimeError("mxnet_tpu_torch.rtc: CudaModule compiles and "
                               "launches CUDA kernels and needs a CUDA "
                               "device; there is none")
        nvrtc = _nvrtc()
        if isinstance(options, str):
            options = [options]
        if isinstance(exports, str):
            exports = [exports]
        self.source = source
        self.exports = list(exports)
        self.options = (["-std=c++17", "-default-device",
                         "--gpu-architecture=" + _arch()] + list(options))
        major, minor = ctypes.c_int(), ctypes.c_int()
        _nvrtc_check(nvrtc, nvrtc.nvrtcVersion(ctypes.byref(major),
                                               ctypes.byref(minor)),
                     "nvrtcVersion")
        h = hashlib.sha256()
        for part in [source, "nvrtc %d.%d" % (major.value, minor.value)] \
                + self.options + ["exports"] + self.exports:
            h.update(part.encode())
            h.update(b"\0")
        key = h.hexdigest()[:24]
        cubin_path = RTC_DIR / (key + ".cubin")
        names_path = RTC_DIR / (key + ".json")
        self.compile_ms = None
        if cubin_path.is_file() and names_path.is_file():
            self._cubin = cubin_path.read_bytes()
            self._lowered = json.loads(names_path.read_text())
        else:
            t0 = time.perf_counter()
            self._cubin, self._lowered = self._compile(nvrtc)
            self.compile_ms = (time.perf_counter() - t0) * 1e3
            RTC_DIR.mkdir(parents=True, exist_ok=True)
            for path, data in ((cubin_path, self._cubin),
                               (names_path,
                                json.dumps(self._lowered).encode())):
                tmp = path.with_name("%s.tmp%d" % (path.name, os.getpid()))
                tmp.write_bytes(data)
                os.replace(tmp, path)
        self._loaded = {}             # device index -> CUmodule

    def _compile(self, nvrtc):
        prog = ctypes.c_void_p()
        _nvrtc_check(nvrtc, nvrtc.nvrtcCreateProgram(
            ctypes.byref(prog), self.source.encode(), b"mxnet_rtc.cu", 0,
            None, None), "nvrtcCreateProgram")
        try:
            for e in self.exports:
                _nvrtc_check(nvrtc, nvrtc.nvrtcAddNameExpression(
                    prog, e.encode()), "nvrtcAddNameExpression(%s)" % e)
            opts = (ctypes.c_char_p * len(self.options))(
                *[o.encode() for o in self.options])
            rc = nvrtc.nvrtcCompileProgram(prog, len(self.options), opts)
            size = ctypes.c_size_t()
            nvrtc.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            log = ctypes.create_string_buffer(size.value)
            nvrtc.nvrtcGetProgramLog(prog, log)
            _nvrtc_check(nvrtc, rc, "nvrtcCompileProgram",
                         log.value.decode(errors="replace"))
            _COMPILES[0] += 1
            _nvrtc_check(nvrtc, nvrtc.nvrtcGetCUBINSize(
                prog, ctypes.byref(size)), "nvrtcGetCUBINSize")
            cubin = ctypes.create_string_buffer(size.value)
            _nvrtc_check(nvrtc, nvrtc.nvrtcGetCUBIN(prog, cubin),
                         "nvrtcGetCUBIN")
            lowered = {}
            for e in self.exports:
                name = ctypes.c_char_p()
                _nvrtc_check(nvrtc, nvrtc.nvrtcGetLoweredName(
                    prog, e.encode(), ctypes.byref(name)),
                    "nvrtcGetLoweredName(%s)" % e)
                lowered[e] = name.value.decode()
            return cubin.raw, lowered
        finally:
            nvrtc.nvrtcDestroyProgram(ctypes.byref(prog))

    def _module(self, index):
        """The CUmodule on CUDA device ``index``, loaded on first use."""
        mod = self._loaded.get(index)
        if mod is None:
            _make_current(index)
            handle = ctypes.c_void_p()
            _cu_check(_cuda().cuModuleLoadData(ctypes.byref(handle),
                                               self._cubin),
                      "cuModuleLoadData")
            mod = self._loaded[index] = handle.value
        return mod

    def _function(self, index, name):
        symbol = self._lowered.get(name, name)
        fn = ctypes.c_void_p()
        rc = _cuda().cuModuleGetFunction(ctypes.byref(fn),
                                         self._module(index),
                                         symbol.encode())
        if rc == _CUDA_ERROR_NOT_FOUND:
            raise ValueError(
                "kernel %r is not in the module: export templated and "
                "non-extern \"C\" kernels by name expression (exports=%s)"
                % (name, self.exports))
        _cu_check(rc, "cuModuleGetFunction(%s)" % name)
        return fn.value

    def get_kernel(self, name, signature):
        """The kernel ``name`` (an export, or an ``extern "C"`` kernel's
        name) with C parameter list ``signature``."""
        params = parse_signature(signature)
        self._function(torch.cuda.current_device(), name)   # it exists
        return CudaKernel(self, name, params)


class CudaKernel:
    """A kernel of a :class:`CudaModule` (reference rtc.py:101)."""

    def __init__(self, module, name, params):
        self._module = module
        self.name = name
        self.params = params
        self._functions = {}          # device index -> CUfunction

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (a gpu Context) with ``grid_dims`` and
        ``block_dims`` (up to three each) and ``shared_mem`` bytes of
        dynamic shared memory, on PyTorch's current stream of that
        device.  Pointer arguments are NDArrays, written in place."""
        if not isinstance(ctx, Context) or ctx.device_type != "gpu":
            raise ValueError("CudaKernel.launch needs a gpu Context, not "
                             "%r" % (ctx,))
        device = ctx.torch_device()
        values = marshal(self.params, list(args), device)
        grid = (tuple(grid_dims) + (1, 1, 1))[:3]
        block = (tuple(block_dims) + (1, 1, 1))[:3]
        index = device.index
        fn = self._functions.get(index)
        if fn is None:
            fn = self._functions[index] = self._module._function(index,
                                                                 self.name)
        if shared_mem > 48 * 1024:
            _cu_check(_cuda().cuFuncSetAttribute(
                fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                int(shared_mem)), "cuFuncSetAttribute")
        _make_current(index)
        # kernelParams: the address of each argument's value; ``values``
        # keeps the ctypes objects alive across the call
        ptrs = (ctypes.c_void_p * len(values))(
            *[ctypes.addressof(v) for v in values])
        stream = torch.cuda.current_stream(device).cuda_stream
        count_launch("rtc." + self.name)
        _cu_check(_cuda().cuLaunchKernel(
            fn, *[int(g) for g in grid], *[int(b) for b in block],
            int(shared_mem), ctypes.c_void_p(stream), ptrs, None),
            "cuLaunchKernel(%s)" % self.name)
