"""Runtime flags — ``set_flags`` / ``get_flags`` and the ``FLAGS_*``
environment variables (``paddle_tpu/framework/flags.py``; reference:
paddle/phi/core/flags.cc).

The same registry, the same flags and the same errors: an unknown name
raises ``ValueError``, and a ``FLAGS_*`` variable in the environment
sets its flag at import. Where a flag has a torch counterpart it acts on
it:

* ``FLAGS_default_dtype`` -> :func:`~..core.dtype.set_default_dtype`;
* ``FLAGS_check_nan_inf`` and ``FLAGS_check_nan_inf_window`` -> the op
  seam of :mod:`~..core.op_hook`;
* ``FLAGS_cudnn_deterministic`` -> ``torch.backends.cudnn.deterministic``;
* ``FLAGS_use_flash_attention`` is read by
  ``nn.functional.scaled_dot_product_attention``. Set to False, the JAX
  package takes its jnp chain; the port keeps no plain version on the
  card's path, so attention that would run the flash kernels on a CUDA
  tensor raises instead and names the flag (CPU tensors run their plain
  chain either way).

Every other flag is held and has no effect.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict

__all__ = ["set_flags", "get_flags", "register_flag"]


class _Flag:
    def __init__(self, name, default, doc="", on_set: Callable | None = None):
        self.name = name
        self.value = default
        self.default = default
        self.doc = doc
        self.on_set = on_set


_registry: Dict[str, _Flag] = {}


def register_flag(name, default, doc="", on_set=None):
    _registry[name] = _Flag(name, default, doc, on_set)


def _set_default_dtype_flag(v):
    from ..core.dtype import set_default_dtype
    set_default_dtype(v)


def _set_check_nan_inf(v):
    from ..core import op_hook
    op_hook.set_check_nan_inf(v)


def _set_check_nan_inf_window(v):
    from ..core import op_hook
    op_hook.set_nan_window(v)


def _set_cudnn_deterministic(v):
    import torch
    torch.backends.cudnn.deterministic = bool(v)


register_flag("FLAGS_check_nan_inf", False,
              "check every op's floating outputs for NaN/Inf "
              "(reference: eager/nan_inf_utils.h)", _set_check_nan_inf)
register_flag("FLAGS_check_nan_inf_window", 1,
              "results batched per blocking NaN-check host read (1 = "
              "raise at the op; >1 the error may surface up to N-1 ops "
              "late)", _set_check_nan_inf_window)
register_flag("FLAGS_default_dtype", "float32",
              "default floating dtype for tensor creation",
              _set_default_dtype_flag)
register_flag("FLAGS_benchmark", False, "held; no effect")
register_flag("FLAGS_allocator_strategy", "auto_growth",
              "held; torch's caching allocator owns device memory")
register_flag("FLAGS_fraction_of_gpu_memory_to_use", 0.92,
              "held; no effect")
register_flag("FLAGS_cudnn_deterministic", False,
              "torch.backends.cudnn.deterministic",
              _set_cudnn_deterministic)
register_flag("FLAGS_embedding_deterministic", False, "held; no effect")
register_flag("FLAGS_use_autotune", True, "held; no effect")
register_flag("FLAGS_use_flash_attention", True,
              "route scaled_dot_product_attention through the flash "
              "kernels; False refuses eligible attention on a CUDA tensor")


def set_flags(flags: dict):
    """``paddle.set_flags`` (reference: python/paddle/base/framework.py)."""
    for name, value in flags.items():
        flag = _registry.get(name)
        if flag is None:
            raise ValueError(
                f"unknown flag {name!r}; known flags: "
                f"{sorted(_registry)}")
        flag.value = value
        if flag.on_set is not None:
            flag.on_set(value)


def get_flags(names):
    """``paddle.get_flags``."""
    if isinstance(names, str):
        names = [names]
    out = {}
    for name in names:
        flag = _registry.get(name)
        if flag is None:
            raise ValueError(f"unknown flag {name!r}")
        out[name] = flag.value
    return out


def flag(name):
    """The value of one flag (the port's own readers)."""
    return _registry[name].value


def reset_flags():
    """Every flag back to its default, through its effect: for tests that
    must leave no process state behind."""
    set_flags({name: f.default for name, f in _registry.items()})


def _load_env_flags():
    """``FLAGS_*`` environment variables override the defaults at import
    (reference: flags parsed at core init, pybind/pybind.cc)."""
    for name, f in _registry.items():
        if name in os.environ:
            raw = os.environ[name]
            cur = f.value
            if isinstance(cur, bool):
                value: Any = raw.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                value = int(raw)
            elif isinstance(cur, float):
                value = float(raw)
            else:
                value = raw
            set_flags({name: value})


_load_env_flags()
