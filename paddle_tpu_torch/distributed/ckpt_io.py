"""ctypes binding for the native async checkpoint IO worker pool, the
port's copy of ``paddle_tpu/distributed/ckpt_io.py``.

Reference: the async-save capability around
distributed/checkpoint/save_state_dict.py (training continues while the
previous snapshot streams to disk). Built at first use from
``core/native/ckpt_io.cpp`` (a copy of the JAX package's source) by the
port's ``core/native_build.py``.
"""
from __future__ import annotations

import ctypes
import threading
import weakref

from ..core.native_build import load_native_lib

__all__ = ["AsyncCheckpointWriter"]

_LIB = None
_LIB_LOCK = threading.Lock()


def _load_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = load_native_lib("ckpt_io.cpp", "libpd_ckptio")
        lib.pd_ckpt_create.restype = ctypes.c_void_p
        lib.pd_ckpt_create.argtypes = [ctypes.c_uint64]
        lib.pd_ckpt_submit.restype = ctypes.c_int64
        lib.pd_ckpt_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_char),
                                       ctypes.c_uint64]
        lib.pd_ckpt_pending.restype = ctypes.c_int64
        lib.pd_ckpt_pending.argtypes = [ctypes.c_void_p]
        lib.pd_ckpt_wait.restype = ctypes.c_int
        lib.pd_ckpt_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.pd_ckpt_errors.restype = ctypes.c_uint64
        lib.pd_ckpt_errors.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_char),
                                       ctypes.c_uint64, ctypes.c_int]
        lib.pd_ckpt_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class AsyncCheckpointWriter:
    """Fixed worker pool streaming shard files to disk off the training
    thread; every file is fsynced and atomically renamed (no torn shard
    FILES on crash — cross-file ordering is the submitter's concern, see
    checkpoint.save_state_dict). Buffers are copied at submit, so the
    caller's buffer may be reused immediately after. The pool is
    destroyed on close() or garbage collection (no thread leak)."""

    def __init__(self, n_threads=2):
        self._lib = _load_lib()
        self._pool = self._lib.pd_ckpt_create(n_threads)
        self._finalizer = weakref.finalize(
            self, AsyncCheckpointWriter._destroy, self._lib, self._pool)

    @staticmethod
    def _destroy(lib, pool):
        lib.pd_ckpt_destroy(pool)

    def _require_open(self):
        if self._pool is None:
            raise RuntimeError("AsyncCheckpointWriter is closed")
        return self._pool

    def submit(self, path, data) -> int:
        """Queue one shard (bytes or a writable buffer — memoryview is
        accepted without an extra python-side copy); returns a job id."""
        from .fault import maybe_inject
        maybe_inject("ckpt_io")  # chaos site: slow_io delays the submit
        pool = self._require_open()
        if isinstance(data, (bytes, bytearray)):
            buf = (ctypes.c_char * len(data)).from_buffer_copy(data)
            n = len(data)
        else:
            mv = memoryview(data)
            n = mv.nbytes
            buf = (ctypes.c_char * n).from_buffer(mv)
        return self._lib.pd_ckpt_submit(pool, str(path).encode(), buf, n)

    def pending(self) -> int:
        return int(self._lib.pd_ckpt_pending(self._require_open()))

    def wait(self, timeout=None) -> bool:
        """Block until every submitted shard is durable. True on drain
        (raising if any job failed — the error set clears so the writer
        stays usable), False on timeout."""
        pool = self._require_open()
        ms = -1 if timeout is None else int(timeout * 1000)
        rc = self._lib.pd_ckpt_wait(pool, ms)
        if rc == 0:
            errs = self._read_errors(clear=True)
            if errs:
                raise IOError(
                    f"async checkpoint writer failed for: {errs}")
            return True
        return False

    def errors(self):
        self._require_open()
        return self._read_errors(clear=False)

    def _read_errors(self, clear):
        pool = self._pool
        n = self._lib.pd_ckpt_errors(pool, None, 0, 0)
        if n == 0:
            return []
        buf = ctypes.create_string_buffer(int(n) + 1)
        self._lib.pd_ckpt_errors(pool, buf, n + 1, 1 if clear else 0)
        return [p for p in buf.value.decode().splitlines() if p]

    def close(self):
        if self._pool is not None:
            self._finalizer.detach()
            self._lib.pd_ckpt_destroy(self._pool)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
