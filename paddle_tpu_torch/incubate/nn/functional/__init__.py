"""incubate.nn.functional — aliases of the fused entry points in
:mod:`paddle_tpu_torch.incubate` (``paddle_tpu/incubate/nn/functional/
__init__.py``)."""
from __future__ import annotations

__all__ = ["fused_rms_norm"]


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1):
    """:func:`paddle_tpu_torch.incubate.fused_rms_norm` (``:120``)."""
    from ... import fused_rms_norm as _top
    return _top(x, norm_weight, norm_bias, epsilon, begin_norm_axis)
