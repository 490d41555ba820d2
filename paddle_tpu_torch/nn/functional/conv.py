"""Convolutions (``paddle_tpu/nn/functional/conv.py``). The JAX package
leaves them to XLA (``lax.conv_general_dilated``), outside any Pallas
kernel, so the port leaves them to ``torch.nn.functional.conv{1,2,3}d``
and ``conv_transpose{1,2,3}d`` (cuDNN on the card). The weights are
paddle's layouts, which are torch's: ``[out_c, in_c / groups, k...]`` for
a convolution, ``[in_c, out_c / groups, k...]`` for a transposed one.

Every form of ``padding`` that ``_norm_padding`` (``conv.py:30``) takes
is read: an int, one int a spatial axis, ``[lo0, hi0, lo1, hi1, ...]``,
``[[lo, hi], ...]`` with or without the batch and channel pairs, and
``"SAME"`` / ``"VALID"`` (a convolution only, as in JAX). Unequal sides
are padded with zeros first. A transposed convolution is computed as
JAX's input-dilated convolution computes it (``conv.py:114-161``): the
full transposed output, ``output_padding`` zeros on the high side, then
``lo`` cut from the low side and ``hi`` from the high side; where the
sides are equal and ``output_padding`` is within torch's limit, torch's
own ``padding`` and ``output_padding`` give the same values in one call.
All six are on the AMP white list.
"""
from __future__ import annotations

import torch

from .common import _amp_cast, _ntuple

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_F = torch.nn.functional
_CONV = {1: _F.conv1d, 2: _F.conv2d, 3: _F.conv3d}
_CONV_T = {1: _F.conv_transpose1d, 2: _F.conv_transpose2d,
           3: _F.conv_transpose3d}
_FORMATS = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}


def _padding(padding, size, kernel, stride, dilation):
    """Paddle's padding forms (the module's doc) -> a ``(lo, hi)`` pair a
    spatial axis of sizes ``size``."""
    n = len(size)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * n
        if mode != "SAME":
            raise ValueError(f"padding {padding!r}: SAME or VALID")
        pads = []
        for m, k, s, d in zip(size, kernel, stride, dilation):
            out = -(-m // s)
            total = max((out - 1) * s + (k - 1) * d + 1 - m, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if all(isinstance(p, int) for p in padding):
        if len(padding) == n:
            return [(p, p) for p in padding]
        if len(padding) == 2 * n:
            return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    pairs = [tuple(int(v) for v in p) for p in padding]
    if len(pairs) == n + 2:
        pairs = pairs[2:]
    if len(pairs) != n:
        raise ValueError(f"padding {padding!r} does not give {n} axes")
    return pairs


def _channels_first(x, data_format, nd):
    if data_format not in _FORMATS[nd]:
        raise ValueError(f"data_format {data_format!r}: one of "
                         f"{_FORMATS[nd]}")
    last = data_format[-1] == "C"
    return (x.movedim(-1, 1) if last else x), last


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format,
          nd):
    x, weight, bias = _amp_cast(f"conv{nd}d", x, weight, bias)
    x, last = _channels_first(x, data_format, nd)
    stride, dilation = _ntuple(stride, nd), _ntuple(dilation, nd)
    pads = _padding(padding, x.shape[2:], weight.shape[2:], stride,
                    dilation)
    if all(lo == hi for lo, hi in pads):
        pad = tuple(lo for lo, _ in pads)
    else:
        x = _F.pad(x, [v for lo_hi in reversed(pads) for v in lo_hi])
        pad = 0
    out = _CONV[nd](x, weight, bias, stride, pad, dilation, groups)
    return out.movedim(1, -1) if last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """``x`` [N, C, H, W] (``data_format="NHWC"``: [N, H, W, C]) conv
    ``weight`` [O, C / groups, kh, kw] (+ ``bias`` [O]) in x's layout, on
    the AMP white list (``conv2d``)."""
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 3)


def _conv_transpose(x, weight, bias, stride, padding, output_padding, groups,
                    dilation, data_format, nd, output_size):
    if isinstance(padding, str):
        raise NotImplementedError(
            "string padding for conv_transpose is not supported; pass ints")
    x, weight, bias = _amp_cast(f"conv{nd}d_transpose", x, weight, bias)
    x, last = _channels_first(x, data_format, nd)
    stride, dilation = _ntuple(stride, nd), _ntuple(dilation, nd)
    pads = _padding(padding, x.shape[2:], weight.shape[2:], stride,
                    dilation)
    out_pad = _ntuple(output_padding, nd) if output_padding else (0,) * nd
    if all(lo == hi for lo, hi in pads) and all(
            op < max(s, d) for op, s, d in zip(out_pad, stride, dilation)):
        out = _CONV_T[nd](x, weight, bias, stride,
                          tuple(lo for lo, _ in pads), out_pad, groups,
                          dilation)
    else:
        out = _CONV_T[nd](x, weight, None, stride, 0, 0, groups, dilation)
        if any(out_pad):
            out = _F.pad(out, [v for op in reversed(out_pad)
                               for v in (0, op)])
        index = (slice(None), slice(None)) + tuple(
            slice(lo, out.shape[2 + i] - hi) for i, (lo, hi) in
            enumerate(pads))
        out = out[index]
        if bias is not None:
            out = out + bias.reshape([1, -1] + [1] * nd)
    if output_size is not None:
        want = _ntuple(output_size, nd)
        if tuple(out.shape[2:]) != want:
            raise ValueError(
                f"conv_transpose produced spatial shape "
                f"{tuple(out.shape[2:])}, but output_size={want}; adjust "
                f"output_padding")
    return out.movedim(1, -1) if last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, data_format, 1, output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, data_format="NCHW",
                     output_size=None, name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, data_format, 2, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW", output_size=None, name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, data_format, 3, output_size)
