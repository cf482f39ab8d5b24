"""Build and load the CUDA kernels of this package.

At first use, `nvcc` compiles `csrc/*.cu` into a shared library with a
plain C interface, in `csrc/build/`, named by a hash of the sources and
flags, and the library is loaded with ctypes (the same route as
`twilight_tpu/native/__init__.py` takes for its host kernels). A failed
build raises with nvcc's error output. Nothing builds at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(SRC_DIR, "build")
SOURCES = ("talco_xdrop.cu",)

# Float semantics are part of the result (bit-identical alignments): no
# fused multiply-add contraction, IEEE division and square root, no flush
# of denormals to zero, and never --use_fast_math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None
build_seconds = None     # wall time of this process's compile, if any


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        so = os.path.join(BUILD_DIR, f"libtwilight_cuda_{_digest()}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                   *(os.path.join(SRC_DIR, s) for s in SOURCES)]
            t0 = time.time()
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                    f"{r.stderr}{r.stdout}")
            os.replace(tmp, so)
            build_seconds = time.time() - t0
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn = lib.talco_xdrop_launch
        fn.restype = ci
        fn.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, ci, vp,
                       ctypes.c_longlong, vp, vp, ci, ci, ci, vp]
        lib.talco_xdrop_error_string.restype = ctypes.c_char_p
        lib.talco_xdrop_error_string.argtypes = [ci]
        _lib = lib
        return _lib


def error_string(code: int) -> str:
    return load().talco_xdrop_error_string(code).decode()
