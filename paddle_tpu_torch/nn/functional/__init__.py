"""Functional ops of the port, laid out as ``paddle_tpu/nn/functional/``:
``common`` (dropout, attention, cross-entropy), ``activation``, ``conv``,
``pooling`` and ``norm``.

Every functional casts its inputs under ``auto_cast`` through this
package's ``amp_cast``, looked up when it runs (``common._amp_cast``), so
the package attribute is the one hook all of them share.
"""
from ...amp import amp_cast  # noqa: F401  (the casting hook, see above)
from .activation import gelu, relu, relu6, sigmoid, silu, tanh
from .common import (NEG_INF, cross_entropy, dropout,
                     scaled_dot_product_attention)
from .conv import conv2d
from .norm import batch_norm, rms_norm
from .pooling import adaptive_avg_pool2d, avg_pool2d, max_pool2d

__all__ = ["gelu", "relu", "relu6", "sigmoid", "silu", "tanh", "dropout",
           "scaled_dot_product_attention", "cross_entropy", "conv2d",
           "batch_norm", "rms_norm", "max_pool2d", "avg_pool2d",
           "adaptive_avg_pool2d", "NEG_INF"]
