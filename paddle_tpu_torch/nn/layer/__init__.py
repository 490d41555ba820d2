"""Layers of the port, laid out as ``paddle_tpu/nn/layer/``: ``layers``
(:class:`Layer`, the base of them all), ``common`` (Linear, Embedding,
Dropout, Identity, Flatten), ``norm`` (LayerNorm, RMSNorm, the
BatchNorms), ``conv``, ``pooling``, ``activation``, ``loss``, ``extra``
(ChannelShuffle), ``container`` and ``transformer``.

Every layer takes the JAX package's arguments in its order; a layer with
parameters also takes ``device``, ``dtype`` and ``generator``,
keyword-only. Parameters keep the JAX package's names, layouts and
default initialisers, so weights carry over one to one
(``convert.params_from_paddle_tpu``), and are
:class:`~...core.tensor.Parameter` objects made by
``Layer.create_parameter`` on the layer's device (the card unless the
CPU was asked for). Every layer casts its inputs under ``auto_cast``
through this package's ``amp_cast``, looked up when it runs
(``common._amp_cast``).
"""
from ...amp import amp_cast  # noqa: F401  (the casting hook, see above)
from .activation import (CELU, ELU, GELU, GLU, SELU, Hardshrink,
                         Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                         LogSigmoid, LogSoftmax, Mish, PReLU, ReLU, ReLU6,
                         Sigmoid, Silu, Softmax, Softplus, Softshrink,
                         Softsign, Swish, Tanh, Tanhshrink)
from .common import Dropout, Embedding, Flatten, Identity, Linear
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import Conv2D
from .extra import ChannelShuffle
from .layers import Layer
from .loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss, KLDivLoss,
                   L1Loss, MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss)
from .norm import BatchNorm, BatchNorm1D, BatchNorm2D, LayerNorm, RMSNorm
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer,
                          generate_square_subsequent_mask)

__all__ = ["Layer", "Linear", "Embedding", "Dropout", "Identity", "Flatten",
           "LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "Conv2D", "MaxPool2D", "AvgPool2D",
           "AdaptiveAvgPool2D", "ReLU", "ReLU6", "Tanh", "Sigmoid", "GELU",
           "Silu", "Swish", "Softmax", "LogSoftmax", "LeakyReLU", "ELU",
           "SELU", "CELU", "Hardtanh", "Hardsigmoid", "Hardswish",
           "Hardshrink", "Softshrink", "Tanhshrink", "Softplus", "Softsign",
           "Mish", "LogSigmoid", "GLU", "PReLU", "ChannelShuffle",
           "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss",
           "MarginRankingLoss", "Sequential", "LayerList", "LayerDict",
           "ParameterList",
           "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
           "generate_square_subsequent_mask"]
