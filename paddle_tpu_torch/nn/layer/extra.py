"""``ChannelShuffle`` of ``paddle_tpu/nn/layer/extra.py`` over
:func:`..functional.channel_shuffle`; the rest of the JAX file is not
ported yet."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["ChannelShuffle"]


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)
