"""``paddle_tpu_torch.linalg`` — the linear-algebra namespace
(``paddle_tpu/linalg.py``): ``ops/linalg.py``'s functions and the
registry's ``generated_linalg`` (``lu``, ``lu_unpack``, ``cond``,
``matrix_exp``, ``householder_product``, ``cross``, ``dot``). A module of
its own, apart from ``ops/linalg.py``, as in the JAX package."""
from .ops.generated_linalg import *  # noqa: F401,F403
from .ops.generated_linalg import __all__ as _gen_all
from .ops.linalg import *  # noqa: F401,F403
from .ops.linalg import __all__ as _ops_all

__all__ = sorted(set(_ops_all) | set(_gen_all))
