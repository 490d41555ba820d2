"""Optimizers of the port (the training slices' subset) and their LR
schedulers (``optimizer.lr``)."""
from . import lr
from .optimizer import Optimizer
from .optimizers import SGD, Adam, AdamW, Momentum

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "lr"]
