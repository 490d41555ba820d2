"""Functional ops of the port, laid out as ``paddle_tpu/nn/functional/``:
``common`` (linear, embedding, dropout, attention), ``activation``,
``loss``, ``extra`` (``channel_shuffle``), ``conv``, ``pooling`` and
``norm``.

Every functional casts its inputs under ``auto_cast`` through this
package's ``amp_cast``, looked up when it runs (``common._amp_cast``), so
the package attribute is the one hook all of them share.
"""
from ...amp import amp_cast  # noqa: F401  (the casting hook, see above)
from .activation import (celu, elu, gelu, glu, hardshrink, hardsigmoid,
                         hardswish, hardtanh, leaky_relu, log_sigmoid,
                         log_softmax, mish, prelu, relu, relu6, relu_,
                         selu, sigmoid, silu, softmax, softplus, softshrink,
                         softsign, swish, tanh, tanhshrink)
from .common import (NEG_INF, dropout, embedding, linear,
                     scaled_dot_product_attention)
from .conv import conv2d
from .extra import channel_shuffle
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   cross_entropy, kl_div, l1_loss, margin_ranking_loss,
                   mse_loss, nll_loss, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost)
from .norm import batch_norm, rms_norm
from .pooling import adaptive_avg_pool2d, avg_pool2d, max_pool2d

__all__ = ["relu", "relu_", "relu6", "gelu", "sigmoid", "silu", "swish",
           "tanh", "leaky_relu", "elu", "selu", "celu", "hardtanh",
           "hardsigmoid", "hardswish", "hardshrink", "softshrink",
           "tanhshrink", "softplus", "softsign", "mish", "log_sigmoid",
           "prelu", "glu", "softmax", "log_softmax", "linear", "embedding",
           "dropout",
           "scaled_dot_product_attention", "cross_entropy",
           "softmax_with_cross_entropy", "mse_loss", "l1_loss", "nll_loss",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "smooth_l1_loss", "kl_div", "margin_ranking_loss",
           "square_error_cost", "channel_shuffle", "conv2d", "batch_norm",
           "rms_norm", "max_pool2d", "avg_pool2d", "adaptive_avg_pool2d",
           "NEG_INF"]
