"""2-D convolution (``paddle_tpu/nn/functional/conv.py``). The JAX package
leaves convolutions to XLA (``lax.conv_general_dilated``), outside any
Pallas kernel, so the port leaves them to ``torch.nn.functional.conv2d``
(cuDNN on the card). The weight is ``[out_c, in_c / groups, kh, kw]``,
paddle's layout and torch's."""
from __future__ import annotations

import torch

from .common import _amp_cast, _pair

__all__ = ["conv2d"]


def _padding(padding, size, kernel, stride, dilation):
    """Paddle's padding forms (an int, ``[ph, pw]``, ``[top, bottom, left,
    right]``, ``[[lo, hi], ...]`` with or without the batch and channel
    pairs, ``"SAME"`` or ``"VALID"``; ``_norm_padding``, ``conv.py:30``)
    -> ``[(lo, hi), (lo, hi)]`` for H and W."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0), (0, 0)]
        if mode != "SAME":
            raise ValueError(f"padding {padding!r}: SAME or VALID")
        pads = []
        for n, k, s, d in zip(size, kernel, stride, dilation):
            out = -(-n // s)
            total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if isinstance(padding, int):
        return [(padding, padding)] * 2
    padding = list(padding)
    if all(isinstance(p, int) for p in padding):
        if len(padding) == 2:
            return [(p, p) for p in padding]
        if len(padding) == 4:
            return [(padding[0], padding[1]), (padding[2], padding[3])]
    pairs = [tuple(p) for p in padding]
    if len(pairs) == 4:
        pairs = pairs[2:]
    if len(pairs) != 2:
        raise ValueError(f"padding {padding!r} does not give H and W")
    return pairs


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """``x`` [N, C, H, W] (``data_format="NHWC"``: [N, H, W, C]) conv
    ``weight`` [O, C / groups, kh, kw] (+ ``bias`` [O]) in x's layout, on
    the AMP white list (``conv2d``)."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format {data_format!r}: NCHW or NHWC")
    x, weight, bias = _amp_cast("conv2d", x, weight, bias)
    channel_last = data_format == "NHWC"
    if channel_last:
        x = x.permute(0, 3, 1, 2)
    stride, dilation = _pair(stride), _pair(dilation)
    pads = _padding(padding, x.shape[2:], weight.shape[2:], stride,
                    dilation)
    if all(lo == hi for lo, hi in pads):
        pad = tuple(lo for lo, _ in pads)
    else:
        (top, bottom), (left, right) = pads
        x = torch.nn.functional.pad(x, (left, right, top, bottom))
        pad = 0
    out = torch.nn.functional.conv2d(x, weight, bias, stride, pad, dilation,
                                     groups)
    return out.permute(0, 2, 3, 1) if channel_last else out
