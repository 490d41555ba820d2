"""Layers of the port, laid out as ``paddle_tpu/nn/layer/``: ``common``
(Linear, Embedding, Dropout, Identity, Flatten), ``norm`` (LayerNorm,
RMSNorm, the BatchNorms), ``conv``, ``pooling``, ``activation``, ``loss``,
``extra`` (ChannelShuffle), ``container`` and ``transformer``.

Parameters keep the JAX package's names and layouts so weights carry over
one to one (``convert.params_from_paddle_tpu``), and are trainable
(``requires_grad=True``). Every layer with parameters takes ``device``,
``dtype`` and ``generator``: random initialisation draws from the
generator, and ``generator=None`` leaves the storage uninitialised for a
load. Every layer casts its inputs under ``auto_cast`` through this
package's ``amp_cast``, looked up when it runs (``common._amp_cast``).
"""
from ...amp import amp_cast  # noqa: F401  (the casting hook, see above)
from .activation import (CELU, ELU, GELU, GLU, SELU, Hardshrink,
                         Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                         LogSigmoid, LogSoftmax, Mish, PReLU, ReLU, ReLU6,
                         Sigmoid, Silu, Softmax, Softplus, Softshrink,
                         Softsign, Swish, Tanh, Tanhshrink)
from .common import INIT_STD, Dropout, Embedding, Flatten, Identity, Linear
from .container import LayerList, Sequential
from .conv import Conv2D
from .extra import ChannelShuffle
from .loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss, KLDivLoss,
                   L1Loss, MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss)
from .norm import BatchNorm, BatchNorm1D, BatchNorm2D, LayerNorm, RMSNorm
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer,
                          generate_square_subsequent_mask)

__all__ = ["Linear", "Embedding", "Dropout", "Identity", "Flatten",
           "LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "Conv2D", "MaxPool2D", "AvgPool2D",
           "AdaptiveAvgPool2D", "ReLU", "ReLU6", "Tanh", "Sigmoid", "GELU",
           "Silu", "Swish", "Softmax", "LogSoftmax", "LeakyReLU", "ELU",
           "SELU", "CELU", "Hardtanh", "Hardsigmoid", "Hardswish",
           "Hardshrink", "Softshrink", "Tanhshrink", "Softplus", "Softsign",
           "Mish", "LogSigmoid", "GLU", "PReLU", "ChannelShuffle",
           "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss",
           "MarginRankingLoss", "Sequential", "LayerList",
           "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
           "generate_square_subsequent_mask", "INIT_STD"]
