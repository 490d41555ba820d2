"""paddle_tpu_torch.jit — functions staged as CUDA graphs, exported
programs and tensor control flow, after ``paddle_tpu/jit/__init__.py``
(reference namespace: python/paddle/jit/__init__.py)."""
from .api import (  # noqa: F401
    GraphBreak, InputSpec, StaticFunction, ignore_module, not_to_static,
    to_static,
)
from .control_flow import (  # noqa: F401
    case, cond, scan_loop, switch_case, while_loop,
)
from .save_load import TranslatedLayer, load, save  # noqa: F401

__all__ = ["to_static", "not_to_static", "ignore_module", "InputSpec",
           "StaticFunction", "GraphBreak", "cond", "while_loop", "scan_loop",
           "case", "switch_case", "save", "load", "TranslatedLayer"]
