"""Normalisation (``paddle_tpu/nn/functional/norm.py``): RMSNorm through
its kernel, batch norm as torch code (XLA in the JAX package)."""
from __future__ import annotations

import torch

from ...ops.kernels import RMSNormFunction
from .common import _amp_cast

__all__ = ["rms_norm", "batch_norm"]


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last axis (``nn/functional/norm.py:42``): f32
    statistics, output in x's type, in f32 under ``auto_cast``
    (``rms_norm`` is on the black list). Runs
    :class:`~...ops.kernels.RMSNormFunction`: the ``rms_norm`` kernel on a
    CUDA tensor, its plain version on a CPU tensor."""
    x, weight = _amp_cast("rms_norm", x, weight)
    return RMSNormFunction.apply(x, weight, None, float(epsilon))


def _channel_axis(data_format, ndim):
    """The channel axis of ``data_format`` (``norm.py:63-66``)."""
    ch = 1 if data_format[1] == "C" or data_format in ("NC", "NCL") else -1
    if data_format[-1] == "C" and len(data_format) > 2:
        ch = -1
    return ch % ndim


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm over every axis but the channel's, to
    ``norm.py:56-110``: statistics and output in f32, returned in x's
    type (f32 under ``auto_cast``: ``batch_norm`` is on the black list).

    In training (unless ``use_global_stats``) x is normalised by its batch
    mean and biased variance, and the running statistics are updated in
    place, outside autograd, by Paddle's convention ``running = momentum *
    running + (1 - momentum) * batch`` with the **biased** batch variance,
    in f32 and stored back in the buffers' type. Otherwise the running
    statistics normalise x.

    ``torch.nn.functional.batch_norm`` does the normalisation and its
    backward. Its own running update would weight the other way and take
    the unbiased variance, so it is handed zeroed f32 scratch with
    momentum 1, which it fills with the batch mean and unbiased variance;
    the biased variance is that times ``(n - 1) / n``."""
    ch = _channel_axis(data_format, x.dim())
    use_batch = training and not use_global_stats
    x, weight, bias = _amp_cast("batch_norm", x, weight, bias)
    xf = x.float().movedim(ch, 1)
    w = weight.float() if weight is not None else None
    b = bias.float() if bias is not None else None
    F = torch.nn.functional
    if not use_batch:
        out = F.batch_norm(xf, running_mean.float(), running_var.float(), w,
                           b, False, 0.0, epsilon)
        return out.movedim(1, ch).to(x.dtype)
    c = xf.shape[1]
    n = xf.numel() // max(c, 1)
    if n > 1:
        mean = torch.zeros(c, dtype=torch.float32, device=x.device)
        var = torch.zeros_like(mean)
        out = F.batch_norm(xf, mean, var, w, b, True, 1.0, epsilon)
        var = var * ((n - 1) / n)
    else:
        # one value a channel: torch refuses to normalise it; its biased
        # variance is 0
        red = [i for i in range(xf.dim()) if i != 1]
        shape = [1, c] + [1] * (xf.dim() - 2)
        mean = xf.detach().mean(red)
        var = torch.zeros_like(mean)
        out = (xf - xf.mean(red, keepdim=True)) / torch.sqrt(
            torch.tensor(epsilon, device=x.device))
        if w is not None:
            out = out * w.reshape(shape)
        if b is not None:
            out = out + b.reshape(shape)
    with torch.no_grad():
        for buf, stat in ((running_mean, mean), (running_var, var)):
            buf.copy_((momentum * buf.float()
                       + (1 - momentum) * stat).to(buf.dtype))
    return out.movedim(1, ch).to(x.dtype)
