"""paddle_tpu_torch.framework — ``save`` / ``load`` (``paddle_tpu/
framework/io.py``) and ``dtype_info`` (``finfo``, ``iinfo``, the dtype
predicates); the flags and ``ParamAttr`` are not ported yet."""
from .io import load, save  # noqa: F401

__all__ = ["save", "load"]
