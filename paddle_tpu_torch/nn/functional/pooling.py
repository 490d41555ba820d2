"""2-D pooling (``paddle_tpu/nn/functional/pooling.py``), with the JAX
package's windows: padding (and ``ceil_mode``'s extension of the high
side, ``pooling.py:41-47``) is applied first, max pooling pads with
``-inf``, and average pooling sums in f32 over zero padding and divides
by the window size or, when ``exclusive`` and any side is padded, by the
count of real elements in each window (Paddle's count-pad rule). These
are XLA ``reduce_window`` ops in the JAX package, so the port runs them
as torch pools."""
from __future__ import annotations

import math

import torch

from .common import _amp_cast, _pair

__all__ = ["max_pool2d", "avg_pool2d", "adaptive_avg_pool2d"]

_F = torch.nn.functional


def _window(x, kernel_size, stride, padding, ceil_mode):
    """-> (kernel, stride, torch pad tuple (left, right, top, bottom)) of
    an NCHW ``x``."""
    ks = _pair(kernel_size)
    st = _pair(stride if stride is not None else kernel_size)
    pd = _pair(padding)
    pads = []
    for size, k, s, p in zip(x.shape[2:], ks, st, pd):
        hi = p
        if ceil_mode:
            out = -(-(size + 2 * p - k) // s) + 1
            hi = max(hi, (out - 1) * s + k - size - p)
        pads.append((p, hi))
    (top, bottom), (left, right) = pads
    return ks, st, (left, right, top, bottom)


def _nchw(x, data_format):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format {data_format!r}: NCHW or NHWC")
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _back(y, data_format):
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Max over each window; padding never wins (``-inf``)."""
    if return_mask:
        raise NotImplementedError("return_mask is not ported (the JAX "
                                  "package refuses it too)")
    (x,) = _amp_cast("max_pool2d", x)
    xc = _nchw(x, data_format)
    ks, st, pad = _window(xc, kernel_size, stride, padding, ceil_mode)
    if any(pad):
        xc = _F.pad(xc, pad, value=float("-inf"))
    return _back(_F.max_pool2d(xc, ks, st), data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """Mean over each window, summed in f32 and returned in x's type."""
    if divisor_override is not None:
        raise NotImplementedError("divisor_override is not ported (the "
                                  "JAX package refuses it too)")
    (x,) = _amp_cast("avg_pool2d", x)
    xc = _nchw(x, data_format)
    ks, st, pad = _window(xc, kernel_size, stride, padding, ceil_mode)
    xf = _F.pad(xc.float(), pad) if any(pad) else xc.float()
    total = _F.avg_pool2d(xf, ks, st, divisor_override=1)
    if exclusive and any(pad):
        ones = torch.ones((1, 1) + tuple(xc.shape[2:]), device=x.device)
        count = _F.avg_pool2d(_F.pad(ones, pad), ks, st, divisor_override=1)
        out = total / count
    else:
        out = total / float(math.prod(ks))
    return _back(out.to(x.dtype), data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over ``output_size`` cells, cell ``i`` of an axis of ``n``
    covering ``[floor(i n / out), ceil((i + 1) n / out))``
    (``pooling.py:146``), in x's type."""
    (x,) = _amp_cast("adaptive_avg_pool2d", x)
    out = _F.adaptive_avg_pool2d(_nchw(x, data_format), _pair(output_size))
    return _back(out, data_format)
