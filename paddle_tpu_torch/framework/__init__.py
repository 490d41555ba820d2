"""paddle_tpu_torch.framework — ``save`` / ``load`` (``paddle_tpu/
framework/io.py``); the flags and ``ParamAttr`` are not ported yet."""
from .io import load, save  # noqa: F401

__all__ = ["save", "load"]
