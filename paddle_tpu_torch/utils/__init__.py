"""paddle.utils — the install check and small helpers
(``paddle_tpu/utils/__init__.py``; reference: python/paddle/utils/):
``run_check``, ``deprecated``, ``unique_name``, ``try_import``, and
``cpp_extension`` with ``custom_op``."""
from __future__ import annotations

import contextlib

from . import cpp_extension  # noqa: F401

__all__ = ["run_check", "deprecated", "unique_name", "try_import",
           "cpp_extension"]


def run_check(verbose=True):
    """Check every visible device (the CUDA devices, else the CPU): a
    matmul round trip and a backward; on a card also one hand kernel
    (RMSNorm) against its plain version. Prints a summary, raises on a
    failure, returns True."""
    import torch

    from ..device import get_all_devices
    from ..ops.kernels import rms_norm, rms_norm_reference

    def log(msg):
        if verbose:
            print(msg)

    devs = get_all_devices()
    kind = torch.cuda.get_device_name(devs[0]) if devs[0].type == "cuda" \
        else "cpu"
    log(f"paddle_tpu_torch is checking {len(devs)} device(s): {kind}")
    def check(ok, what):
        if not ok:
            raise RuntimeError(f"run_check: {what}")

    for d in devs:
        a = torch.eye(4, device=d)
        check(torch.allclose((a @ a).cpu(), torch.eye(4)),
              f"matmul round-trip failed on {d}")
        x = torch.ones(3, device=d, requires_grad=True)
        (x * x).sum().backward()
        check(torch.allclose(x.grad.cpu(), torch.full((3,), 2.0)),
              f"autograd check failed on {d}")
        if d.type == "cuda":
            g = torch.Generator(device=d).manual_seed(0)
            xs = torch.randn(64, 256, device=d, generator=g)
            w = torch.randn(256, device=d, generator=g)
            got, want = rms_norm(xs, w), rms_norm_reference(xs, w)
            check(torch.allclose(got, want, rtol=1e-4, atol=1e-5),
                  f"the rms_norm kernel disagrees with its plain version "
                  f"on {d}")
    log(f"paddle_tpu_torch works on {len(devs)} device(s)"
        + (" (the rms_norm kernel checked)" if devs[0].type == "cuda"
           else ""))
    log("paddle_tpu_torch is installed successfully!")
    return True


def deprecated(update_to="", since="", reason="", level=0):
    """Reference: utils/deprecated.py — a decorator that warns on use."""
    import functools
    import warnings

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            msg = f"{fn.__name__} is deprecated since {since or 'now'}"
            if update_to:
                msg += f"; use {update_to} instead"
            if reason:
                msg += f" ({reason})"
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)
        return inner
    return wrap


class _UniqueName:
    def __init__(self):
        self._counters = {}

    def generate(self, key="tmp"):
        n = self._counters.get(key, 0)
        self._counters[key] = n + 1
        return f"{key}_{n}"

    @contextlib.contextmanager
    def guard(self, new_generator=None):
        saved = self._counters
        self._counters = {}
        try:
            yield
        finally:
            self._counters = saved


unique_name = _UniqueName()


def try_import(module_name, err_msg=None):
    import importlib
    try:
        return importlib.import_module(module_name)
    except ImportError:
        raise ImportError(err_msg or
                          f"{module_name} is required but not installed")
