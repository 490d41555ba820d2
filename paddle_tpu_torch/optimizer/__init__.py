"""Optimizers of the port (the training slices' subset) and their LR
schedulers (``optimizer.lr``)."""
from . import lr
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Optimizer", "Adam", "AdamW", "lr"]
