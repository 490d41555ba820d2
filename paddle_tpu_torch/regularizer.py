"""Weight-decay regularizers, after ``paddle_tpu/regularizer.py``
(reference: python/paddle/regularizer.py). An optimizer takes one as
``weight_decay``: :class:`L2Decay` adds ``coeff * w`` to the gradient,
:class:`L1Decay` adds ``coeff * sign(w)``; AdamW reads ``coeff`` as its
decoupled decay."""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"L1Decay({self.coeff})"


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"L2Decay({self.coeff})"
