"""ctypes binding for the native C++ blocking queue, after
``paddle_tpu/io/blocking_queue.py``.

Reference: the C++ BlockingQueue under DataLoader's
``use_buffer_reader=True`` (operators/reader/lod_tensor_blocking_queue.h).
Built with g++ at first use (never at import) from the port's own
``core/native/blocking_queue.cpp``, cached by content hash under
``core/native/build/``.
"""
from __future__ import annotations

import ctypes
import pickle
import threading

__all__ = ["NativeBlockingQueue"]

_LIB = None
_LIB_LOCK = threading.Lock()


def _load_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        from ..core.native_build import load_native_lib
        lib = load_native_lib("blocking_queue.cpp", "libpd_bqueue")
        lib.pd_bq_create.restype = ctypes.c_void_p
        lib.pd_bq_create.argtypes = [ctypes.c_uint64]
        lib.pd_bq_destroy.argtypes = [ctypes.c_void_p]
        lib.pd_bq_push.restype = ctypes.c_int
        lib.pd_bq_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint64, ctypes.c_int64]
        lib.pd_bq_pop.restype = ctypes.c_int
        lib.pd_bq_pop.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.POINTER(ctypes.c_uint64),
                                  ctypes.c_int64]
        lib.pd_bq_free.argtypes = [ctypes.c_void_p]
        lib.pd_bq_close.argtypes = [ctypes.c_void_p]
        lib.pd_bq_size.restype = ctypes.c_uint64
        lib.pd_bq_size.argtypes = [ctypes.c_void_p]
        lib.pd_bq_capacity.restype = ctypes.c_uint64
        lib.pd_bq_capacity.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class NativeBlockingQueue:
    """Bounded MPMC queue of python objects (pickled blobs) backed by the
    native library; push/pop release the GIL while blocked."""

    def __init__(self, capacity=2):
        self._lib = _load_lib()
        self._h = self._lib.pd_bq_create(capacity)
        self._destroyed = False

    def push(self, obj, timeout_ms=-1):
        blob = pickle.dumps(obj, protocol=4)
        rc = self._lib.pd_bq_push(self._h, blob, len(blob), timeout_ms)
        if rc == -1:
            raise TimeoutError("NativeBlockingQueue.push timed out")
        if rc == -2:
            raise RuntimeError("NativeBlockingQueue is closed")
        return True

    def pop(self, timeout_ms=-1):
        out = ctypes.c_void_p()
        n = ctypes.c_uint64()
        rc = self._lib.pd_bq_pop(self._h, ctypes.byref(out),
                                 ctypes.byref(n), timeout_ms)
        if rc == -1:
            raise TimeoutError("NativeBlockingQueue.pop timed out")
        if rc == -2:
            raise StopIteration
        raw = ctypes.string_at(out, n.value)
        self._lib.pd_bq_free(out)
        return pickle.loads(raw)

    def close(self):
        if not self._destroyed:
            self._lib.pd_bq_close(self._h)

    def __len__(self):
        return int(self._lib.pd_bq_size(self._h))

    @property
    def capacity(self):
        return int(self._lib.pd_bq_capacity(self._h))

    def __del__(self):
        try:
            if not self._destroyed:
                self._lib.pd_bq_close(self._h)
                self._lib.pd_bq_destroy(self._h)
                self._destroyed = True
        except Exception:
            pass
