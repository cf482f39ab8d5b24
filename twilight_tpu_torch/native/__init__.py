"""Native host-side modules, compiled on demand via g++ and bound with ctypes.

Each library builds into `build/` beside the sources, named by a hash of
its source, its g++ flags and the host's CPU model (`model name` in
/proc/cpuinfo): a library built with -march=native on one host is never
loaded on another, and a checkout copied between hosts rebuilds there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional, Sequence

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")
# NOTE: float semantics are load-bearing (bit-exact parity with the
# reference build): keep IEEE ordering — no -ffast-math, explicit
# -ffp-contract=off (no FMA fusing). -pthread: hostops runs a level's
# prep on std::thread workers.
HOST_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared",
              "-fPIC", "-std=c++17", "-pthread")
_LOCK = threading.Lock()
_LIBS = {}


def cpu_model() -> str:
    """The host CPU's model name (/proc/cpuinfo), or the platform's
    processor string where there is no /proc/cpuinfo."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path(name: str, flags: Sequence[str]) -> str:
    """Path of lib<name>.so built from <name>.cpp with `flags` on this
    host's CPU model."""
    h = hashlib.sha256()
    with open(os.path.join(_DIR, name + ".cpp"), "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    h.update(cpu_model().encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str, flags: Sequence[str]) -> Optional[str]:
    """Compile <name>.cpp with `flags` unless this host already has the
    library; returns its path, or None if no toolchain is available."""
    so = library_path(name, flags)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", *flags, os.path.join(_DIR, name + ".cpp"),
                        "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, so)
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return so


def load(name: str):
    """Compile (if needed) and load lib<name> built with HOST_FLAGS.
    Returns the ctypes CDLL, or None if no toolchain is available."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        so = build(name, HOST_FLAGS)
        try:
            _LIBS[name] = ctypes.CDLL(so) if so else None
        except OSError:
            _LIBS[name] = None
        return _LIBS[name]
