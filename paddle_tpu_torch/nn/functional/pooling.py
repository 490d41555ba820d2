"""Pooling over 1, 2 and 3 spatial axes (``paddle_tpu/nn/functional/
pooling.py``), with the JAX package's windows: padding (and
``ceil_mode``'s extension of the high side, ``pooling.py:41-47``) is
applied first, max pooling pads with ``-inf``, and average pooling sums
in f32 over zero padding and divides by the window size or, when
``exclusive`` and any side is padded, by the count of real elements in
each window (Paddle's count-pad rule). These are XLA ``reduce_window``
ops in the JAX package, so the port runs them as torch pools.

Adaptive pools take cell ``i`` of an axis of ``n`` over ``[floor(i n /
out), ceil((i + 1) n / out))`` (``pooling.py:146``), torch's cells too.

``return_mask=True``, which the JAX functions refuse, is the port's
extension: the max pools then also return, for each output, the flat
index of its maximum over the input's spatial axes (padding removed),
the layout :func:`~.extra.max_unpool2d` scatters by.
"""
from __future__ import annotations

import math

import torch

from .common import _amp_cast, _ntuple

__all__ = [
    "max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
    "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_max_pool1d", "adaptive_max_pool2d",
]

_F = torch.nn.functional
_MAX = {1: _F.max_pool1d, 2: _F.max_pool2d, 3: _F.max_pool3d}
_AVG = {1: _F.avg_pool1d, 2: _F.avg_pool2d, 3: _F.avg_pool3d}
_ADAPTIVE = {("avg", 1): _F.adaptive_avg_pool1d,
             ("avg", 2): _F.adaptive_avg_pool2d,
             ("avg", 3): _F.adaptive_avg_pool3d,
             ("max", 1): _F.adaptive_max_pool1d,
             ("max", 2): _F.adaptive_max_pool2d,
             ("max", 3): _F.adaptive_max_pool3d}


def _window(x, nd, kernel_size, stride, padding, ceil_mode):
    """-> (kernel, stride, [(lo, hi)] a spatial axis) of a channels-first
    ``x``."""
    ks = _ntuple(kernel_size, nd)
    st = _ntuple(stride if stride is not None else kernel_size, nd)
    pd = _ntuple(padding, nd)
    pads = []
    for size, k, s, p in zip(x.shape[2:], ks, st, pd):
        hi = p
        if ceil_mode:
            out = -(-(size + 2 * p - k) // s) + 1
            hi = max(hi, (out - 1) * s + k - size - p)
        pads.append((p, hi))
    return ks, st, pads


def _flat(pads):
    return [v for lo_hi in reversed(pads) for v in lo_hi]


def _channels_first(x, data_format):
    return x.movedim(-1, 1) if data_format[-1] == "C" else x


def _back(y, data_format):
    return y.movedim(1, -1) if data_format[-1] == "C" else y


def _unpadded_index(idx, padded, pads):
    """Flat indices over the ``padded`` spatial sizes -> flat indices over
    the sizes without ``pads``."""
    sizes = [p - lo - hi for p, (lo, hi) in zip(padded, pads)]
    out = torch.zeros_like(idx)
    rest = idx
    coords = []
    for p in reversed(padded):
        coords.append(rest % p)
        rest = rest // p
    for c, n, (lo, _) in zip(reversed(coords), sizes, pads):
        out = out * n + (c - lo).clamp(0, n - 1)
    return out


def _max_pool(x, nd, kernel_size, stride, padding, return_mask, ceil_mode,
              data_format):
    (x,) = _amp_cast(f"max_pool{nd}d", x)
    xc = _channels_first(x, data_format)
    ks, st, pads = _window(xc, nd, kernel_size, stride, padding, ceil_mode)
    if any(_flat(pads)):
        xc = _F.pad(xc, _flat(pads), value=float("-inf"))
    if not return_mask:
        return _back(_MAX[nd](xc, ks, st), data_format)
    out, idx = _MAX[nd](xc, ks, st, return_indices=True)
    if any(_flat(pads)):
        idx = _unpadded_index(idx, xc.shape[2:], pads)
    return _back(out, data_format), _back(idx, data_format)


def _avg_pool(x, nd, kernel_size, stride, padding, ceil_mode, exclusive,
              divisor_override, data_format):
    if divisor_override is not None:
        raise NotImplementedError("divisor_override is not ported (the "
                                  "JAX package refuses it too)")
    (x,) = _amp_cast(f"avg_pool{nd}d", x)
    xc = _channels_first(x, data_format)
    ks, st, pads = _window(xc, nd, kernel_size, stride, padding, ceil_mode)
    flat = _flat(pads)
    xf = _F.pad(xc.float(), flat) if any(flat) else xc.float()
    pool = _AVG[nd]
    kw = {"divisor_override": 1} if nd > 1 else {}
    total = pool(xf, ks, st, **kw)
    if nd == 1:
        total = total * ks[0]
    if exclusive and any(flat):
        ones = torch.ones((1, 1) + tuple(xc.shape[2:]), device=x.device)
        count = pool(_F.pad(ones, flat), ks, st, **kw)
        if nd == 1:
            count = count * ks[0]
        out = total / count
    else:
        out = total / float(math.prod(ks))
    return _back(out.to(x.dtype), data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool(x, 1, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Max over each window; padding never wins (``-inf``)."""
    return _max_pool(x, 2, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, 3, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(x, 1, kernel_size, stride, padding, ceil_mode,
                     exclusive, None, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """Mean over each window, summed in f32 and returned in x's type."""
    return _avg_pool(x, 2, kernel_size, stride, padding, ceil_mode,
                     exclusive, divisor_override, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, 3, kernel_size, stride, padding, ceil_mode,
                     exclusive, divisor_override, data_format)


def _adaptive(x, output_size, nd, kind, data_format="NCHW",
              return_mask=False):
    (x,) = _amp_cast(f"adaptive_{kind}_pool{nd}d", x)
    xc = _channels_first(x, data_format)
    fn = _ADAPTIVE[(kind, nd)]
    size = _ntuple(output_size, nd)
    if kind == "max" and return_mask:
        out, idx = fn(xc, size, return_indices=True)
        return _back(out, data_format), _back(idx, data_format)
    return _back(fn(xc, size), data_format)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg", "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over ``output_size`` cells, in x's type."""
    return _adaptive(x, output_size, 2, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "max", "NCL", return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "max", "NCHW", return_mask)
