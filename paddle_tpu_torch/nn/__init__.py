"""Neural-network layers and functionals of the port, and gradient
clipping (``paddle_tpu/nn``)."""
from . import functional, layer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layer import (GELU, AdaptiveAvgPool2D, AvgPool2D, BatchNorm,
                    BatchNorm1D, BatchNorm2D, Conv2D, Dropout, Embedding,
                    Flatten, Identity, LayerList, LayerNorm, Linear,
                    MaxPool2D, MultiHeadAttention, ReLU, ReLU6, RMSNorm,
                    Sequential, Sigmoid, Silu, Tanh, Transformer,
                    TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Linear", "Embedding", "LayerNorm", "RMSNorm", "Dropout",
           "Identity", "Flatten", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "Conv2D", "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D", "ReLU",
           "ReLU6", "Tanh", "Sigmoid", "GELU", "Silu", "Sequential",
           "LayerList", "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", "functional", "layer",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_"]
