"""``channel_shuffle`` of ``paddle_tpu/nn/functional/extra.py:42``
(reference: python/paddle/nn/functional/vision.py channel_shuffle):
``groups`` interleaved, in ``NCHW`` or ``NHWC``, cast as the JAX op
``channel_shuffle`` (on neither list). The rest of the JAX file is not
ported yet."""
from __future__ import annotations

from .common import _amp_cast

__all__ = ["channel_shuffle"]


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    (x,) = _amp_cast("channel_shuffle", x)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
            .reshape(n, c, h, w)
    if data_format == "NHWC":
        n, h, w, c = x.shape
        return x.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
            .reshape(n, h, w, c)
    raise ValueError(f"data_format {data_format!r}: NCHW or NHWC")
