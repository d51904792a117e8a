"""Build, load and launch the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` call, all
started together, and the objects are linked into one shared library
with a plain C interface (no PyTorch headers: a build takes seconds, not
minutes), at first use, into ``_build/`` under a name keyed by a hash of
the sources and flags — so a fresh checkout builds itself, and an edited
source never loads a stale library.  The library is loaded with
``ctypes``; every pointer and the stream are ``c_void_p``.

Each C entry point launches one kernel on the caller's stream and
returns ``cudaGetLastError()``; :func:`launch` raises if that is not 0
(a refused launch never runs, and a later synchronize would not say
so).  Nothing here runs at import time: the CPU-only test host imports
every module of the port.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_L = ctypes.c_longlong
#: C entry points -> argument types (the stream is always last)
_SIGNATURES = {
    "scalce_core_rank": [_P, _P, _P, _I, _I, _I, _U, _P, _P],
    "scalce_core_rank_lut": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "scalce_hist_ctx": [_P, _P, _P] + [_I] * 5 + [_P] * 4,
    "scalce_rans_encode": [_P, _P, _P] + [_I] * 6 + [_P] * 4,
    "scalce_divmod_recip": [_P, _P, _I, _P, _P, _P],
    "scalce_rans_decode": [_P] * 4 + [_I] * 7 + [_P, _P],
    "scalce_histogram": [_P, _L, _I, _P, _P],
    "scalce_histogram_grids": [_P, _P, _I, _L, _I, _I, _P, _P],
    "scalce_rans_encode_flat": [_P] * 3 + [_I, _I, _L, _I, _I] + [_P] * 4,
    "scalce_delta_match": [_P] * 4 + [_I] * 5 + [_L] + [_P] * 7,
    "scalce_delta_place": [_P] * 5 + [_I] * 4 + [_P, _P],
    "scalce_compact": [_P, _P, _I, _I, _P, _P, _P],
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (sm_90a)")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    name = f"libscalce_kernels_{h.hexdigest()[:16]}.so"
    return os.path.join(BUILD_DIR, name)


def build() -> str:
    """Compile the kernels unless a library for these sources exists;
    returns its path.  One ``nvcc -c`` per source, all running at once,
    then one link; into a temp directory, then a rename, so a concurrent
    or interrupted build never leaves a torn library."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cus = [p for p in _sources() if p.endswith(".cu")]
        objs = [os.path.join(tmp, os.path.basename(p) + ".o") for p in cus]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, cu],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cu, obj in zip(cus, objs)]
        logs = [(cu, proc.communicate()[0], proc.returncode)
                for cu, proc in zip(cus, procs)]
        failed = [f"{cu}:\n{log}" for cu, log, rc in logs if rc]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", so,
                               *objs], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError("nvcc link failed:\n" + proc.stdout
                               + proc.stderr)
        os.replace(so, path)
    return path


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.scalce_error_string.argtypes = [ctypes.c_int]
    lib.scalce_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name`` on ``device``'s current stream; raise on a
    launch error."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args, stream)
    if err:
        msg = lib.scalce_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape=None, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape`` / ``device`` when given) — what a kernel may be handed."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
