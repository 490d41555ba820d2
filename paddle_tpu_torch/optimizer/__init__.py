"""Optimizers of the port (``paddle_tpu/optimizer``) and their LR
schedulers (``optimizer.lr``)."""
from . import lr
from .optimizer import Optimizer
from .optimizers import (LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                         Lamb, Momentum, RMSProp, Rprop)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb", "Rprop", "LBFGS", "lr"]
