"""paddle.flops — per-layer FLOPs estimation, after
``paddle_tpu/hapi/dynamic_flops.py:14-109`` (reference:
python/paddle/hapi/dynamic_flops.py): forward hooks on the leaf modules
and a per-type table keyed on the port's layer class names, which are the
JAX package's."""
from __future__ import annotations

import math

import torch

from .summary import _device

__all__ = ["flops"]


def _numel(shape):
    return math.prod(int(d) for d in shape)


def _linear_flops(layer, x, y):
    return _numel(x.shape) * layer.weight.shape[-1]


def _conv_flops(layer, x, y):
    kernel_ops = _numel(layer.weight.shape[1:])  # Cin/g * k...
    bias_ops = 1 if getattr(layer, "bias", None) is not None else 0
    return _numel(y.shape) * (kernel_ops + bias_ops)


def _norm_flops(layer, x, y):
    return 2 * _numel(x.shape)


def _act_flops(layer, x, y):
    return _numel(x.shape)


def _pool_flops(layer, x, y):
    return _numel(y.shape)


def _emb_flops(layer, x, y):
    return _numel(y.shape)


_TABLE = {
    "Linear": _linear_flops,
    "Conv1D": _conv_flops, "Conv2D": _conv_flops, "Conv3D": _conv_flops,
    "BatchNorm1D": _norm_flops, "BatchNorm2D": _norm_flops,
    "BatchNorm3D": _norm_flops, "LayerNorm": _norm_flops,
    "GroupNorm": _norm_flops, "RMSNorm": _norm_flops,
    "ReLU": _act_flops, "ReLU6": _act_flops, "GELU": _act_flops,
    "Sigmoid": _act_flops, "Tanh": _act_flops, "Softmax": _act_flops,
    "MaxPool2D": _pool_flops, "AvgPool2D": _pool_flops,
    "AdaptiveAvgPool2D": _pool_flops, "MaxPool1D": _pool_flops,
    "MaxPool3D": _pool_flops,
    "Embedding": _emb_flops,
}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Total multiply-accumulate count for one forward pass at input_size
    (INCLUDING the batch dim; -1 means 1), on an f32 zero input on the
    network's device. Returns an int."""
    table = dict(_TABLE)
    if custom_ops:
        table.update({getattr(k, "__name__", str(k)): v
                      for k, v in custom_ops.items()})
    shape = [1 if d == -1 else int(d) for d in input_size]
    x = torch.zeros(shape, dtype=torch.float32, device=_device(net))

    rows = []
    hooks = []

    def mk(name, fn):
        def hook(lyr, ins, out):
            o = out[0] if isinstance(out, (tuple, list)) else out
            n = int(fn(lyr, ins[0], o))
            params = sum(p.numel() for p in lyr.parameters(recurse=False))
            rows.append((f"{type(lyr).__name__}-{name}", params, n))
        return hook

    for name, layer in net.named_modules():
        fn = table.get(type(layer).__name__)
        if name and fn is not None and not list(layer.children()):
            hooks.append(layer.register_forward_hook(mk(name, fn)))
    if not hooks:
        # bare-layer model: the net itself, when it is a leaf with a
        # table entry (a plain Linear as the whole network)
        fn = table.get(type(net).__name__)
        if fn is not None and not list(net.children()):
            hooks.append(net.register_forward_hook(mk("net", fn)))
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(x)
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()

    total = sum(r[2] for r in rows)
    if print_detail:
        print(f"{'Layer':<30}{'Params':>12}{'FLOPs':>16}")
        for name, params, n in rows:
            print(f"{name:<30}{params:>12,}{n:>16,}")
        print(f"Total GFLOPs: {total / 1e9:.4f}")
    return total
