"""paddle_tpu_torch.hapi — the high-level Model API, after
``paddle_tpu/hapi/__init__.py`` (reference: python/paddle/hapi/model.py:1054
Model, fit at :1756). ``fit`` stages the whole train step with
``jit.to_static``, so the Keras-style loop replays one CUDA graph a step.
"""
from . import callbacks  # noqa: F401
from .dynamic_flops import flops  # noqa: F401
from .model import Model  # noqa: F401
from .summary import summary  # noqa: F401

__all__ = ["Model", "callbacks", "summary", "flops"]
