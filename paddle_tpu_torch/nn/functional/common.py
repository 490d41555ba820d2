"""Linear, embedding, dropout, attention, padding, resizing and the
other common functionals (``paddle_tpu/nn/functional/common.py``); the
losses are in :mod:`.loss`.

* :func:`linear` keeps Paddle's ``[in, out]`` weight layout, ``x @ W +
  b``: a plain ``torch.addmm`` / ``torch.matmul`` (the JAX package leaves
  these products to XLA outside any Pallas kernel); under ``auto_cast``
  O1 it computes in the AMP dtype (``linear`` is on the white list).
* :func:`embedding` is a row gather of the ``[num, dim]`` table (cast as
  ``embedding`` says under ``auto_cast``); ids equal to ``padding_idx``
  give zero rows, so the padding row gets no gradient.
* :func:`dropout` keeps each element (or, with ``axis``, each slice along
  those axes, its mask shared along the others) with probability ``1 -
  p``; its mask draws from ``generator``, a keyword-only extra of the
  port (the default generator when None, which ``paddle.seed`` seeds);
  :func:`dropout2d`, :func:`dropout3d` and :func:`alpha_dropout` draw the
  same way.
* :func:`pad` reads ``pad`` as the JAX function does
  (``common.py:91-119``): a pair per dimension, first to last, when it
  has two entries a dimension; otherwise pairs for the spatial axes of
  ``data_format``, the last spatial axis first. ``reflect`` is numpy's
  (the edge not repeated), ``replicate`` the edge, ``circular`` a wrap.
* :func:`interpolate` is ``jax.image.resize`` (``common.py:146-165``):
  half-pixel sampling whatever ``align_corners`` says, a triangle kernel
  for the linear modes and ``area``, Keys' cubic (a = -0.5) for
  ``bicubic``, both widened by the scale when shrinking (antialiasing),
  applied one axis at a time as a ``[out, in]`` weight matrix; nearest
  takes ``floor((i + 0.5) * in / out)``.
* :func:`grid_sample`, :func:`affine_grid`, :func:`pixel_shuffle`,
  :func:`temporal_shift`, :func:`unfold` and :func:`fold` follow their
  JAX expressions with torch ops (the last two are torch's im2col and
  col2im, the same function).
"""
from __future__ import annotations

import math
import sys

import torch

from ...core.dtype import float_of
from ...framework.flags import flag
from ...ops.kernels import flash_attention_bshd
from ...ops.kernels import library as _library

__all__ = [
    "linear", "dropout", "dropout2d", "dropout3d", "pad", "embedding",
    "cosine_similarity", "interpolate", "upsample", "unfold", "fold",
    "scaled_dot_product_attention", "alpha_dropout", "label_smooth",
    "pixel_shuffle", "pixel_unshuffle", "affine_grid", "grid_sample",
    "temporal_shift", "NEG_INF",
]

NEG_INF = -1e30


def _ntuple(v, n):
    """An int or a 1- or n-sequence -> an n-tuple of ints."""
    if isinstance(v, (list, tuple)):
        v = tuple(int(x) for x in v)
        if len(v) == 1:
            return v * n
        if len(v) != n:
            raise ValueError(f"expected {n} values, got {v}")
        return v
    return (int(v),) * n


def _pair(v):
    """An int or a 1- or 2-sequence -> an (H, W) pair of ints."""
    return _ntuple(v, 2)


def _amp_cast(op_name, *tensors):
    """The package's ``amp_cast`` (``paddle_tpu_torch.nn.functional.
    amp_cast``), read when called: every functional casts through it."""
    return sys.modules[__package__].amp_cast(op_name, *tensors)


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]``
    (``common.py:27``)."""
    x, w, b = _amp_cast("linear", x, weight, bias)
    x2 = x.reshape(-1, x.shape[-1])
    y = torch.addmm(b, x2, w) if b is not None else torch.matmul(x2, w)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """The rows of ``weight`` at the ids ``x`` (``common.py:122-131``);
    where an id equals ``padding_idx`` the row is zero and passes no
    gradient. ``sparse`` is accepted, as in JAX: the gradient is dense."""
    (w,) = _amp_cast("embedding", weight)
    out = w[x.long()]
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx).unsqueeze(-1), 0.0)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """Dropout as ``common.py:42-63``: in training each element is kept
    with probability ``1 - p``, and scaled by ``1 / (1 - p)`` under
    ``mode="upscale_in_train"``; with ``axis`` (an int or a list) the keep
    mask has the input's size on those axes and 1 on the others, so it is
    shared along them. Outside training ``upscale_in_train`` is the
    identity and ``downscale_in_infer`` scales by ``1 - p``."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r}: upscale_in_train or "
                         f"downscale_in_infer")
    if p == 0.0 or (not training and mode == "upscale_in_train"):
        return x
    if not training:
        return x * (1.0 - p)
    if p == 1.0:
        return x * 0
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        if min(axes) < 0 or max(axes) >= x.dim():
            raise ValueError(f"dropout axis {axis} out of range for a "
                             f"{x.dim()}-d input")
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, device=x.device, generator=generator) < 1.0 - p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, 0.0)


def _flash_eligible(query, attn_mask, dropout_p, training):
    """The configurations the flash kernels take (``_flash_eligible``,
    ``nn/functional/common.py:204-226``, without its TPU test and A/B
    gate): a CUDA tensor, no mask, no dropout while training, 4-D input
    and a head dim of at most 128 — and, the kernels' own limits, a head
    dim that is a multiple of 16 and f32, bf16 or f16 inputs. While a
    program is traced (``ops/kernels/library.py`` ``recording``) the
    device does not count: the program holds the ``flash_fwd`` op, which
    launches the kernel wherever the program runs."""
    return ((query.device.type == "cuda" or _library.recording(query))
            and attn_mask is None
            and not (dropout_p > 0 and training) and query.dim() == 4
            and query.shape[-1] <= 128 and query.shape[-1] % 16 == 0
            and query.dtype in (torch.float32, torch.bfloat16,
                                torch.float16))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, *,
                                 generator=None):
    """Attention on ``[B, S, H, D]`` tensors (paddle's layout; ``Sq`` and
    ``Sk`` may differ). Eligible configurations run the flash kernels
    (:func:`flash_attention_bshd`); the others the plain chain of
    ``common.py:244-268`` in f32 (causal ``-1e30`` fill, a boolean mask
    filled or an additive mask added, softmax, dropout on the
    probabilities from ``generator``), returned in the query's type. A
    floating mask is cast with q, k and v under ``auto_cast``, as the JAX
    op's fourth input is. With ``FLAGS_use_flash_attention`` False an
    eligible configuration raises (JAX takes its jnp chain then; the port
    runs no plain version on the card's path)."""
    query, key, value, attn_mask = _amp_cast(
        "scaled_dot_product_attention", query, key, value, attn_mask)
    if _flash_eligible(query, attn_mask, dropout_p, training):
        if not flag("FLAGS_use_flash_attention"):
            raise RuntimeError(
                "FLAGS_use_flash_attention is False: the JAX package then "
                "takes its jnp chain, but the port runs no plain version on "
                "the card; set the flag back to True (CPU tensors take the "
                "plain chain either way)")
        return flash_attention_bshd(query, key, value, causal=is_causal)
    qt, kt, vt = (t.float().transpose(1, 2) for t in (query, key, value))
    scores = qt @ kt.transpose(-1, -2) * (1.0 / math.sqrt(query.shape[-1]))
    if is_causal:
        s, t = scores.shape[-2:]
        causal = torch.ones(s, t, dtype=torch.bool,
                            device=scores.device).tril()
        scores = scores.masked_fill(~causal, NEG_INF)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = scores.masked_fill(~attn_mask, NEG_INF)
        else:
            scores = scores + attn_mask.float()
    probs = torch.softmax(scores, dim=-1)
    probs = dropout(probs, dropout_p, training=training,
                    generator=generator)
    return (probs @ vt).transpose(1, 2).to(query.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None, *,
              generator=None):
    """:func:`dropout` of whole channels: the mask spans the batch and
    channel axes (``common.py:66-68``)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training,
                   generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None, *,
              generator=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training,
                   generator=generator)


def alpha_dropout(x, p=0.5, training=True, name=None, *, generator=None):
    """SELU-preserving dropout (``common.py:76-88``): a dropped element
    takes ``alpha = -1.7581``, then ``a * x + b`` restores the mean and
    variance."""
    if not training or p == 0:
        return x
    alpha = -1.7580993408473766
    keep = torch.rand(x.shape, device=x.device, generator=generator) < 1 - p
    q = 1 - p
    a_scale = (q + alpha ** 2 * q * p) ** -0.5
    b_shift = -a_scale * alpha * p
    return (a_scale * torch.where(keep, x, alpha) + b_shift).to(x.dtype)


def _pad_pairs(nd, pad, data_format):
    """``pad`` -> a ``(lo, hi)`` pair per dimension of an ``nd``-d input
    (``build_pairs``, ``common.py:96-108``)."""
    p = [int(v) for v in (pad.tolist() if torch.is_tensor(pad) else pad)]
    if len(p) == 2 * nd:
        return [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
    n_sp = len(p) // 2
    pairs = [(0, 0)] * nd
    sp_axes = list(range(1, 1 + n_sp)) if data_format[-1] == "C" else \
        list(range(nd - n_sp, nd))
    for i, ax in enumerate(reversed(sp_axes)):
        pairs[ax] = (p[2 * i], p[2 * i + 1])
    return pairs


def _pad_index(n, lo, hi, mode, device):
    """Source indices of a padded axis of length ``n`` (numpy's
    ``reflect``, ``edge`` and ``wrap``), made on ``device`` so that a
    staged step copies nothing from the host."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i.remainder(n)
    period = 2 * (n - 1)
    if not period:
        return torch.zeros_like(i)
    i = i.abs().remainder(period)
    return torch.where(i >= n, period - i, i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):  # noqa: A002
    """``jnp.pad`` of ``x`` by :func:`_pad_pairs`; cast as the JAX op
    ``pad`` (on neither list)."""
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"pad mode {mode!r}: constant, reflect, "
                         f"replicate or circular")
    (x,) = _amp_cast("pad", x)
    pairs = _pad_pairs(x.dim(), pad, data_format)
    if mode == "constant":
        flat = [v for lo_hi in reversed(pairs) for v in lo_hi]
        return torch.nn.functional.pad(x, flat, value=value) \
            if any(flat) else x
    for ax, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = x.index_select(ax, _pad_index(x.shape[ax], lo, hi, mode,
                                              x.device))
    return x


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """``sum(a b) / max(|a| |b|, eps)`` over ``axis`` (``common.py:
    135-141``), in f32 under ``auto_cast`` (black list)."""
    x1, x2 = _amp_cast("cosine_similarity", x1, x2)
    num = (x1 * x2).sum(axis)
    na = torch.sqrt((x1 * x1).sum(axis))
    nb = torch.sqrt((x2 * x2).sum(axis))
    return num / torch.clamp_min(na * nb, eps)


def _resize_weights(n_in, n_out, cubic, device):
    """``jax.image``'s ``compute_weight_mat`` (antialiased, no
    translation), in float64 on ``device`` -> ``[n_in, n_out]``."""
    f64 = dict(dtype=torch.float64, device=device)
    inv = n_in / n_out
    kscale = max(inv, 1.0)
    sample = (torch.arange(n_out, **f64) + 0.5) * inv - 0.5
    d = (sample[None, :] - torch.arange(n_in, **f64)[:, None]).abs() / kscale
    if cubic:
        w = ((1.5 * d - 2.5) * d) * d + 1.0
        w = torch.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, w)
        w = torch.where(d >= 2.0, 0.0, w)
    else:
        w = torch.clamp_min(1.0 - d, 0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """``jax.image.resize`` of the spatial axes to ``size`` (or
    ``int(in * scale_factor)``), as in the module's doc; ``align_corners``
    and ``align_mode`` are accepted and, as in JAX, change nothing."""
    if data_format not in ("NCHW", "NCL", "NCDHW"):
        raise ValueError(f"data_format {data_format!r}: NCL, NCHW or "
                         f"NCDHW")
    kinds = {"nearest": None, "bilinear": False, "linear": False,
             "trilinear": False, "bicubic": True, "area": False}
    if mode not in kinds:
        raise ValueError(f"interpolate mode {mode!r}")
    (x,) = _amp_cast("interpolate", x)
    n_sp = x.dim() - 2
    in_sp = x.shape[2:]
    if size is None:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else \
            [scale_factor] * n_sp
        size = [int(s * f) for s, f in zip(in_sp, sf)]
    elif isinstance(size, int):
        size = [size] * n_sp
    size = [int(s) for s in size]
    for i, (n_in, n_out) in enumerate(zip(in_sp, size)):
        if n_in == n_out:
            continue
        ax = 2 + i
        if kinds[mode] is None:
            src = torch.floor(
                (torch.arange(n_out, dtype=torch.float32, device=x.device)
                 + 0.5) * float(n_in) / float(n_out))
            x = x.index_select(ax, src.long())
            continue
        x = float_of(x)
        w = _resize_weights(n_in, n_out, kinds[mode], x.device).to(x.dtype)
        x = torch.tensordot(x, w, dims=([ax], [0])).movedim(-1, ax)
    return x


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners, align_mode,
                       data_format, name)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C, H, W]`` -> ``[N, C * kh * kw, L]``, the channel
    slowest (``common.py:175-195``)."""
    (x,) = _amp_cast("unfold", x)
    return torch.nn.functional.unfold(x, _pair(kernel_sizes),
                                      _pair(dilations), _pair(paddings),
                                      _pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, :func:`unfold`'s adjoint: overlapping patches add
    (``common.py:375-416``)."""
    (x,) = _amp_cast("fold", x)
    oh, ow = _pair(output_sizes)
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    ph, pw = _pair(paddings)
    dh, dw = _pair(dilations)
    nh = (oh + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    nw = (ow + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    if nh * nw != x.shape[-1]:
        raise ValueError(f"L={x.shape[-1]} inconsistent with output_sizes "
                         f"({nh}x{nw} patches expected)")
    return torch.nn.functional.fold(x, (oh, ow), (kh, kw), (dh, dw),
                                    (ph, pw), (sh, sw))


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) * label + epsilon * prior`` (uniform ``1 / k``
    without ``prior_dist``)."""
    label, prior_dist = _amp_cast("label_smooth", label, prior_dist)
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """``[N, C r^2, H, W]`` -> ``[N, C, H r, W r]`` (``common.py:271-290``)."""
    (x,) = _amp_cast("pixel_shuffle", x)
    r = int(upscale_factor)
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3) \
        .reshape(n, c // (r * r), h * r, w * r)
    return x.permute(0, 2, 3, 1) if data_format == "NHWC" else x


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    (x,) = _amp_cast("pixel_unshuffle", x)
    r = int(downscale_factor)
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4) \
        .reshape(n, c * r * r, h // r, w // r)
    return x.permute(0, 2, 3, 1) if data_format == "NHWC" else x


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """theta ``[N, 2, 3]`` -> the sampling grid ``[N, H, W, 2]`` of
    ``out_shape`` ``[N, C, H, W]`` (``common.py:313-329``)."""
    (theta,) = _amp_cast("affine_grid", theta)
    _, _, H, W = [int(d) for d in (out_shape.tolist()
                                   if torch.is_tensor(out_shape)
                                   else out_shape)]
    dev = theta.device
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, W, device=dev)
        ys = torch.linspace(-1.0, 1.0, H, device=dev)
    else:
        xs = (torch.arange(W, device=dev) * 2 + 1) / W - 1.0
        ys = (torch.arange(H, device=dev) * 2 + 1) / H - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).to(theta.dtype)
    return torch.einsum("hwk,nck->nhwc", base, theta)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Bilinear or nearest samples of ``x`` [N, C, H, W] at ``grid`` [N,
    Ho, Wo, 2] (x, y in [-1, 1]) -> [N, C, Ho, Wo], with zero or border
    padding (``common.py:332-372``; nearest rounds half to even)."""
    if mode not in ("bilinear", "nearest"):
        raise NotImplementedError(f"grid_sample mode {mode!r} "
                                  "(bilinear/nearest supported)")
    if padding_mode not in ("zeros", "border"):
        raise NotImplementedError(
            f"grid_sample padding_mode {padding_mode!r} "
            "(zeros/border supported)")
    x, grid = _amp_cast("grid_sample", x, grid)
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx, fy = (gx + 1.0) * (w - 1) / 2.0, (gy + 1.0) * (h - 1) / 2.0
    else:
        fx, fy = ((gx + 1.0) * w - 1.0) / 2.0, ((gy + 1.0) * h - 1.0) / 2.0
    batch = torch.arange(n, device=x.device)[:, None, None]
    xl = x.permute(0, 2, 3, 1)                     # [N, H, W, C]

    def gather(yy, xx):
        vals = xl[batch, yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long()]
        if padding_mode == "zeros":
            inside = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
            vals = torch.where(inside[..., None], vals, 0.0)
        return vals

    if mode == "nearest":
        out = gather(torch.round(fy), torch.round(fx))
    else:
        x0, y0 = torch.floor(fx), torch.floor(fy)
        x1, y1 = x0 + 1, y0 + 1
        out = (gather(y0, x0) * ((x1 - fx) * (y1 - fy))[..., None]
               + gather(y0, x1) * ((fx - x0) * (y1 - fy))[..., None]
               + gather(y1, x0) * ((x1 - fx) * (fy - y0))[..., None]
               + gather(y1, x1) * ((fx - x0) * (fy - y0))[..., None])
    return out.permute(0, 3, 1, 2)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM's shift (``common.py:419-454``): the first ``shift_ratio`` of
    the channels one segment back, the next block one forward, the ends
    zero."""
    if shift_ratio > 0.5:
        raise ValueError(
            f"temporal_shift shift_ratio ({shift_ratio}) must be <= 0.5 "
            "(back + forward shifted blocks cannot exceed the channels)")
    (x,) = _amp_cast("temporal_shift", x)
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    a = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    back = torch.cat([a[:, 1:, :c1], torch.zeros_like(a[:, :1, :c1])], 1)
    fwd = torch.cat([torch.zeros_like(a[:, :1, c1:c2]), a[:, :-1, c1:c2]],
                    1)
    out = torch.cat([back, fwd, a[:, :, c2:]], 2).reshape(nt, c, h, w)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out
