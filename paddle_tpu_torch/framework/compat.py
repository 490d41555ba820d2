"""Small framework-level helpers (``paddle_tpu/framework/compat.py``;
reference: base/framework.py's ``LazyGuard`` and ``create_parameter``,
python/paddle/reader/decorator.py:62 ``batch``): a free parameter, the
lazy-init guard, the reader batcher and the shape check. The CUDA RNG
state accessors are :mod:`..core.random`'s."""
from __future__ import annotations

import torch

__all__ = ["LazyGuard", "create_parameter", "batch", "check_shape"]


class LazyGuard:
    """``paddle.LazyGuard``: a transparent context, as in the JAX package.
    Parameters are made when their layer is built; code that only needs
    them to exist after the guard exits runs unchanged."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None, *, device=None,
                     generator=None):
    """``paddle.create_parameter``: a free :class:`~..core.tensor.Parameter`
    outside any layer, made as ``Layer.create_parameter`` makes one, on
    ``device`` (the current device when None)."""
    from ..nn import Layer
    helper = Layer(device=device, generator=generator)
    return helper.create_parameter(shape, attr=attr, dtype=dtype,
                                   is_bias=is_bias,
                                   default_initializer=default_initializer)


def batch(reader, batch_size, drop_last=False):
    """``paddle.batch``: group a sample reader into a mini-batch reader."""
    def batched():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batched


def check_shape(shape):
    """``paddle.check_shape``: every entry an int of at least -1 or a
    tensor; a tensor shape passes."""
    if torch.is_tensor(shape):
        return
    for s in shape:
        if not isinstance(s, int) and not torch.is_tensor(s):
            raise TypeError(f"shape entries must be int/Tensor, got {s!r}")
        if isinstance(s, int) and s < -1:
            raise ValueError(f"invalid dim {s} in shape {shape}")
