"""``ChannelShuffle`` of ``paddle_tpu/nn/layer/extra.py`` over
:func:`..functional.channel_shuffle`; the rest of the JAX file is not
ported yet."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["ChannelShuffle"]


class ChannelShuffle(nn.Module):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)
