"""paddle.summary — layer-by-layer model summary, after
``paddle_tpu/hapi/summary.py`` (reference:
python/paddle/hapi/model_summary.py): forward hooks on the leaf modules
print a table of output shapes and parameter counts."""
from __future__ import annotations

import torch

__all__ = ["summary"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64}


def _device(net):
    p = next(iter(net.parameters()), None)
    return p.device if p is not None else torch.device("cpu")


def summary(net, input_size=None, dtypes=None, input=None):
    """Print a per-layer table; returns {'total_params', 'trainable_params'}.

    input_size: tuple (or list of tuples) INCLUDING the batch dim, with -1
    meaning 1 (reference semantics); the inputs are zeros on the network's
    device."""
    if input is None:
        assert input_size is not None, "input_size or input required"
        sizes = [input_size] if isinstance(input_size[0], int) \
            else list(input_size)
        dts = dtypes if isinstance(dtypes, (list, tuple)) else \
            [dtypes or "float32"] * len(sizes)
        inputs = [torch.zeros([1 if d == -1 else d for d in s],
                              dtype=_DTYPES.get(str(dt), dt),
                              device=_device(net))
                  for s, dt in zip(sizes, dts)]
    else:
        inputs = [input] if isinstance(input, torch.Tensor) else list(input)

    rows = []
    hooks = []

    def mk_hook(name):
        def hook(lyr, ins, out):
            shape = list(out.shape) if isinstance(out, torch.Tensor) else \
                [list(o.shape) for o in out if isinstance(o, torch.Tensor)]
            n_params = sum(p.numel() for p in lyr.parameters(recurse=False))
            rows.append((f"{type(lyr).__name__}-{name}", shape, n_params))
        return hook

    for name, layer in net.named_modules():
        if name and not list(layer.children()):  # leaves only, reference
            hooks.append(layer.register_forward_hook(mk_hook(name)))
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()

    header = f"{'Layer (type)':<28}{'Output Shape':<26}{'Param #':>12}"
    sep = "=" * len(header)
    lines = [sep, header, sep]
    for name, shape, n in rows:
        lines.append(f"{name:<28}{str(shape):<26}{n:>12,}")
    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    lines += [sep, f"Total params: {total:,}",
              f"Trainable params: {trainable:,}",
              f"Non-trainable params: {total - trainable:,}", sep]
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
