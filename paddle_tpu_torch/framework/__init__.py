"""paddle_tpu_torch.framework — ``save`` / ``load`` (``paddle_tpu/
framework/io.py``), ``seed``, ``ParamAttr`` (``param_attr.py``), the
helpers of ``compat.py`` (``create_parameter``, ``LazyGuard``, ``batch``,
``check_shape``), ``dtype_info`` (``finfo``, ``iinfo``, the dtype
predicates) and the runtime flags (``flags.py``: ``get_flags`` /
``set_flags``)."""
from ..core.random import seed  # noqa: F401
from . import flags  # noqa: F401
from .io import load, save  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401

__all__ = ["save", "load", "seed", "ParamAttr", "flags"]
