"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), for ``sm_90a``.  Libraries land in ``mxnet_tpu_torch/_build/``
(listed in ``.gitignore``) under a name keyed by a hash of the source, the
``csrc/*.cuh`` headers, the flags and ``nvcc --version``, so an edited
source or header or another toolkit builds anew and an unchanged one is
reused.  Nothing is built at import: the first
launch of a kernel builds its library, and :func:`build` builds several at
once, one ``nvcc`` process per source, all started together.

The wrappers load a library with :mod:`ctypes` and pass raw device pointers,
sizes and PyTorch's current ``cudaStream_t``.  Each C entry point returns
the ``cudaError_t`` of its launch, and the wrapper raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build", "load", "nvcc"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE.parents[1] / "_build"
SOURCES = ("rmsnorm", "flash_attention", "flash_attention_wgmma",
           "flash_attention_bwd", "flash_attention_bwd_wgmma",
           "flash_attention_wide", "softmax_xent", "int8_matmul")
# no --use_fast_math: its approximate expf would break the stated tolerances
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS = {}
_NVCC_VERSION = {}


def nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then
    ``PATH``.  Raises :class:`RuntimeError` when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("mxnet_tpu_torch: nvcc not found (set CUDA_HOME); "
                           "the CUDA kernels are built from source at first "
                           "use")
    return found


def _nvcc_version(exe):
    if exe not in _NVCC_VERSION:
        out = subprocess.run([exe, "--version"], check=True,
                             capture_output=True, text=True).stdout
        _NVCC_VERSION[exe] = out
    return _NVCC_VERSION[exe]


def library_path(name, exe=None):
    """Where the library for source ``name`` lives once built."""
    exe = exe or nvcc()
    h = hashlib.sha256()
    h.update((CSRC / (name + ".cu")).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # shared by several sources
        h.update(header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    h.update(_nvcc_version(exe).encode())
    return BUILD_DIR / ("%s-%s.so" % (name, h.hexdigest()[:16]))


def build(names=SOURCES):
    """Build the libraries of ``names`` that are not built yet, all in
    parallel.  Returns ``{name: {"path", "seconds", "cached", "log"}}``,
    where ``log`` is what ``nvcc``/``ptxas`` printed (registers, shared
    memory and spills per kernel).  Raises on a failed build."""
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        so = library_path(name, exe)
        log = so.with_suffix(".log")
        if so.is_file():
            out[name] = {"path": so, "seconds": 0.0, "cached": True,
                         "log": log.read_text() if log.is_file() else ""}
            continue
        tmp = so.with_name("%s.tmp%d" % (so.name, os.getpid()))
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / (name + ".cu"))]
        procs[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (so, tmp, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("%s (rc %d):\n%s" % (name, proc.returncode, text))
            continue
        os.replace(tmp, so)                   # atomic: no half-written .so
        so.with_suffix(".log").write_text(text)
        out[name] = {"path": so, "seconds": time.perf_counter() - t0,
                     "cached": False, "log": text}
    if failed:
        raise RuntimeError("mxnet_tpu_torch: nvcc failed for "
                           + "\n".join(failed))
    return out


def load(name, configure):
    """The loaded :class:`ctypes.CDLL` for source ``name``, building it
    first if needed.  ``configure(lib)`` runs once, on first load, to
    declare ``argtypes`` / ``restype``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build([name])[name]["path"]
            lib = ctypes.CDLL(str(path))
            configure(lib)
            _LIBS[name] = lib
        return lib


def check(lib, prefix, rc):
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if rc != 0:
        msg = getattr(lib, prefix + "_error_string")(rc).decode()
        raise RuntimeError("%s: CUDA error %d (%s)" % (prefix, rc, msg))
