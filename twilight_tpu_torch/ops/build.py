"""Build and load the CUDA kernels of this package.

At its first use, `nvcc` compiles a source of `csrc/` into a shared
library with a plain C interface, in `csrc/build/`, named by a hash of the
source and the flags, and the library is loaded with ctypes (the same
route as `native/__init__.py` takes for the host kernels). `load()` builds
and loads the TALCO kernel's library alone, which is all the batcher and
`talco_cuda` use; `load(PROBE)` the loop-cost probes'. A failed build
raises with nvcc's error output. Nothing builds at import.
`variant(*flags)` makes the wrappers use libraries built with extra nvcc
flags (the kernel's -DTALCO_PROFILE build) within a `with` block;
`prebuild(*flag_sets)` compiles the libraries of several flag sets in one
parallel round, ahead of their use. Both build every source, one nvcc a
source and flag set, started together.
"""
from __future__ import annotations

import contextlib
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
SOURCES = ("talco_xdrop.cu", "probe_loop_costs.cu")
TALCO, PROBE = SOURCES

# Float semantics are part of the result (bit-identical alignments): no
# fused multiply-add contraction, IEEE division and square root, no flush
# of denormals to zero, and never --use_fast_math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs = {}               # (source, extra nvcc flags) -> Kernels
_extra = ()              # the extra flags of the libraries load() returns
build_seconds = None     # wall time of this process's last compiles, if any


class Kernels:
    """The functions of one source's library, as a namespace."""

    def __init__(self, source: str, lib):
        vp, ci = ctypes.c_void_p, ctypes.c_int

        def bind(name, restype, argtypes):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
            setattr(self, name, fn)

        if source == TALCO:
            bind("talco_xdrop_launch", ci,
                 [ci, ci, vp, vp, vp, vp, vp, vp, ci, vp, ctypes.c_longlong,
                  vp, vp, ci, ci, ci, vp])
            bind("talco_xdrop_config", ci,
                 [ci, ci, ci, ctypes.POINTER(ctypes.c_longlong)])
            bind("talco_xdrop_attributes", ci,
                 [ci, ci, ctypes.POINTER(ctypes.c_int)])
            bind("talco_xdrop_error_string", ctypes.c_char_p, [ci])
        else:
            bind("probe_loop_launch", ci, [ci, ci, ci, ci, ci, vp, vp])
            bind("probe_loop_attributes", ci,
                 [ci, ci, ctypes.POINTER(ctypes.c_int)])


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")


def _digest(name: str, flags) -> str:
    h = hashlib.sha256()
    with open(os.path.join(SRC_DIR, name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def library_path(name: str, extra=()) -> str:
    stem = os.path.splitext(name)[0]
    digest = _digest(name, NVCC_FLAGS + tuple(extra))
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def _compile(flag_sets, sources=SOURCES) -> None:
    """Builds every missing library of the sources and flag sets (extra
    flags each), one nvcc a library, all started together; call with
    _lock held."""
    global build_seconds
    todo = [(name, extra, library_path(name, extra))
            for extra in flag_sets for name in sources]
    todo = [job for job in todo if not os.path.exists(job[2])]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()
    procs = []
    for name, extra, so in todo:
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", tmp,
               os.path.join(SRC_DIR, name)]
        procs.append((cmd, tmp, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    failed = []
    for cmd, tmp, so, proc in procs:
        out, errs = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{errs}{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    build_seconds = time.time() - t0


def prebuild(*flag_sets) -> None:
    """Builds the libraries of each set of extra flags (() for the
    plain ones) in one parallel round, without loading them."""
    with _lock:
        _compile([tuple(f) for f in flag_sets])


def load(source: str = TALCO) -> Kernels:
    """The library of `source` (of the `variant` in force), built on first
    use."""
    extra = _extra
    key = (source, extra)
    with _lock:
        if key not in _libs:
            _compile([extra], [source])
            _libs[key] = Kernels(source, ctypes.CDLL(
                library_path(source, extra)))
        return _libs[key]


@contextlib.contextmanager
def variant(*flags):
    """Within the block, `load()`, and so every wrapper's launch, uses the
    libraries built with these nvcc flags added to NVCC_FLAGS (every
    source's, built on entry where missing and kept beside the plain
    ones). Yields the TALCO kernel's."""
    global _extra
    prev, _extra = _extra, tuple(flags)
    try:
        prebuild(_extra)
        yield load()
    finally:
        _extra = prev


def error_string(code: int) -> str:
    return load().talco_xdrop_error_string(code).decode()
