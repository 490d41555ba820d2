"""Build-and-load for the port's native C++ components, the port's own
copy of ``paddle_tpu/core/native_build.py``.

Compiles ``core/native/<src>`` with ``g++`` to a content-addressed
``.so`` under ``core/native/build/`` (pruning stale hashes), then CDLLs
it. Called at first use, never at import, so every module imports where
no compiler is. Thread-safe and idempotent per source file.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading

__all__ = ["load_native_lib", "native_dir"]

_CACHE: dict = {}
_LOCK = threading.Lock()


def native_dir():
    return os.path.join(os.path.dirname(__file__), "native")


def load_native_lib(src_name, lib_prefix, extra_flags=()):
    """Build (if needed) and load core/native/<src_name>; returns the
    ctypes.CDLL. The caller declares argtypes/restypes."""
    with _LOCK:
        cached = _CACHE.get(src_name)
        if cached is not None:
            return cached
        src = os.path.join(native_dir(), src_name)
        build_dir = os.path.join(native_dir(), "build")
        os.makedirs(build_dir, exist_ok=True)
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(build_dir, f"{lib_prefix}-{digest}.so")
        if not os.path.exists(so):
            for old in glob.glob(os.path.join(build_dir,
                                              f"{lib_prefix}-*.so")):
                try:
                    os.unlink(old)
                except OSError:
                    pass
            tmp = so + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o",
                 tmp, src, "-lpthread", *extra_flags],
                check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _CACHE[src_name] = lib
        return lib
