"""paddle_tpu_torch.jit — functions staged as CUDA graphs, after
``paddle_tpu/jit/__init__.py`` (reference namespace:
python/paddle/jit/__init__.py). ``save``/``load`` and the control-flow
ops are not ported yet."""
from .api import (  # noqa: F401
    GraphBreak, InputSpec, StaticFunction, ignore_module, not_to_static,
    to_static,
)

__all__ = ["to_static", "not_to_static", "ignore_module", "InputSpec",
           "StaticFunction", "GraphBreak"]
