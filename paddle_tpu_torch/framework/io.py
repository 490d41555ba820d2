"""paddle.save / paddle.load in the JAX package's pickle format, after
``paddle_tpu/framework/io.py:20-69`` (reference:
python/paddle/framework/io.py:721 save, :960 load).

A tensor travels as a numpy array under the ``__paddle_tpu_tensor__``
tag with its ``trainable`` flag; a bfloat16 tensor as its ``uint16``
bits under ``__paddle_tpu_bf16__`` (``torch.Tensor.view``, no
``ml_dtypes``). Dicts, lists and tuples nest as they are, so a file
written by either package loads in the other. :func:`save` publishes
atomically (``distributed.fault.atomic_write``). :func:`load` returns
tensors on ``device`` (``cuda`` unless the CPU is asked for), or numpy
arrays with ``return_numpy=True`` (bfloat16 ones as float32: numpy has no
bfloat16 without ``ml_dtypes``).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["save", "load"]

_TENSOR_TAG = "__paddle_tpu_tensor__"
_BF16_TAG = "__paddle_tpu_bf16__"


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {_BF16_TAG: True,
                    "data": t.view(torch.int16).numpy().view(np.uint16),
                    "trainable": obj.requires_grad}
        return {_TENSOR_TAG: True, "data": t.numpy(),
                "trainable": obj.requires_grad}
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _numpy(t):
    """A host numpy copy of ``t``: bfloat16 as float32 (numpy has no
    bfloat16 without ``ml_dtypes``); a non-tensor as ``np.asarray``."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _tensor(arr, trainable, device, bf16=False):
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if bf16:
        t = t.view(torch.int16).view(torch.bfloat16)
    t = t.to(device)
    if trainable and t.is_floating_point():
        t.requires_grad_(True)
    return t


def _unpack(obj, return_numpy, device):
    if isinstance(obj, dict):
        if obj.get(_BF16_TAG):
            bits = np.asarray(obj["data"]).view(np.int16)
            if return_numpy:
                return _tensor(bits, False, "cpu", bf16=True).float().numpy()
            return _tensor(bits, obj.get("trainable", False), device,
                           bf16=True)
        if obj.get(_TENSOR_TAG):
            arr = obj["data"]
            return arr if return_numpy else _tensor(
                arr, obj.get("trainable", False), device)
        return {k: _unpack(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy, device) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` (tensors packed as numpy) to ``path``, atomically."""
    path = str(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    packed = _pack(obj)
    from ..distributed.fault import atomic_write
    atomic_write(path, lambda f: pickle.dump(packed, f, protocol=protocol))


def load(path, return_numpy=False, device=None, **configs):
    """The object :func:`save` (of either package) wrote, its tensors on
    ``device``, or numpy arrays with ``return_numpy=True``."""
    dev = None if return_numpy else resolve_device(device)
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _unpack(obj, return_numpy, dev)
