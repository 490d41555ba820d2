"""``paddle_tpu_torch.vision`` (``paddle_tpu/vision``): ``models``."""
from . import models

__all__ = ["models"]
