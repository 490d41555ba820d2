"""Normalisation (``paddle_tpu/nn/functional/norm.py``): LayerNorm and
RMSNorm through their kernels; batch, group and instance norm and
``normalize`` as torch code (XLA in the JAX package), with f32
statistics (biased variance) and the output in x's type, as JAX
computes them. ``layer_norm``, ``batch_norm``, ``group_norm``,
``instance_norm`` and ``rms_norm`` are on the AMP black list (f32 under
``auto_cast``); ``normalize`` is on neither."""
from __future__ import annotations

import math

import torch

from ...ops.kernels.library import layer_norm_fn, rms_norm_fn
from .common import _amp_cast

__all__ = ["layer_norm", "batch_norm", "group_norm", "instance_norm",
           "rms_norm", "normalize"]


def layer_norm_rows(x, normalized_shape, weight, bias, epsilon):
    """LayerNorm of ``x`` over its trailing ``normalized_shape`` axes by
    :class:`~...ops.kernels.LayerNormFunction` (the Triton kernel on a
    CUDA tensor, the plain version on a CPU one), or, in a traced program,
    the ``layer_norm`` op: the trailing axes are contiguous, so they are
    viewed as one row of their product."""
    k = len(normalized_shape)
    if k == 1:
        return layer_norm_fn(x, weight, bias, epsilon)
    n = math.prod(normalized_shape)
    y = layer_norm_fn(
        x.reshape(*x.shape[:-k], n),
        None if weight is None else weight.reshape(n),
        None if bias is None else bias.reshape(n), epsilon)
    return y.reshape(x.shape)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the trailing ``normalized_shape`` axes (an int or a
    list; ``norm.py:18``), with or without ``weight`` and ``bias`` of
    that shape: f32 statistics, output in x's type, f32 under
    ``auto_cast``. Runs the ``layer_norm`` kernel (:func:`layer_norm_rows`)."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    shape = [int(x.shape[i]) for i in range(-len(normalized_shape), 0)]
    x, weight, bias = _amp_cast("layer_norm", x, weight, bias)
    return layer_norm_rows(x, shape, weight, bias, float(epsilon))


def _affine(out, weight, bias):
    """``out * weight + bias`` along axis 1, in f32."""
    shape = [1, -1] + [1] * (out.dim() - 2)
    if weight is not None:
        out = out * weight.float().reshape(shape)
    if bias is not None:
        out = out + bias.float().reshape(shape)
    return out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Normalise each of ``num_groups`` channel groups of a
    channels-first ``x`` over its channels and spatial axes
    (``norm.py:110-134``)."""
    if data_format != "NCHW":
        raise ValueError("group_norm supports NCHW")
    C = x.shape[1]
    if C % num_groups:
        raise ValueError(f"{C} channels do not divide into {num_groups} "
                         f"groups")
    x, weight, bias = _amp_cast("group_norm", x, weight, bias)
    af = x.float().reshape(x.shape[0], num_groups, -1)
    mean = af.mean(-1, keepdim=True)
    var = ((af - mean) ** 2).mean(-1, keepdim=True)
    out = ((af - mean) / torch.sqrt(var + epsilon)).reshape(x.shape)
    return _affine(out, weight, bias).to(x.dtype)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Normalise each (sample, channel) over its spatial axes by its own
    statistics (``norm.py:137-158``: the running statistics and
    ``use_input_stats`` are accepted and unused, as in JAX)."""
    if data_format != "NCHW":
        raise ValueError("instance_norm supports NCHW")
    x, weight, bias = _amp_cast("instance_norm", x, weight, bias)
    axes = tuple(range(2, x.dim()))
    af = x.float()
    mean = af.mean(axes, keepdim=True)
    var = ((af - mean) ** 2).mean(axes, keepdim=True)
    out = (af - mean) / torch.sqrt(var + eps)
    return _affine(out, weight, bias).to(x.dtype)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis`` (``norm.py:161``)."""
    (x,) = _amp_cast("normalize", x)
    if p == 2:
        norm = torch.sqrt((x * x).sum(axis, keepdim=True))
    else:
        norm = (x.abs() ** p).sum(axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(norm, epsilon)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last axis (``nn/functional/norm.py:42``): f32
    statistics, output in x's type, in f32 under ``auto_cast``
    (``rms_norm`` is on the black list). Runs
    :class:`~...ops.kernels.RMSNormFunction`: the ``rms_norm`` kernel on a
    CUDA tensor, its plain version on a CPU tensor; the ``rms_norm`` op in
    a traced program."""
    x, weight = _amp_cast("rms_norm", x, weight)
    return rms_norm_fn(x, weight, None, epsilon)


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
        out = (xf - xf.mean(red, keepdim=True)) / torch.full(
            (), epsilon, device=x.device).sqrt()
        if w is not None:
            out = out * w.reshape(shape)
        if b is not None:
            out = out + b.reshape(shape)
    with torch.no_grad():
        for buf, stat in ((running_mean, mean), (running_var, var)):
            buf.copy_((momentum * buf.float()
                       + (1 - momentum) * stat).to(buf.dtype))
    return out.movedim(1, ch).to(x.dtype)
