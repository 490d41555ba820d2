"""Carry a JAX-package GPT's weights into the port.

``params_from_paddle_tpu(named_arrays, config, device, dtype)`` takes the
parameters of a ``paddle_tpu.models.GPTForCausalLM`` as numpy arrays keyed
by their structured names (``model.named_parameters()`` /
``state_dict()``: ``gpt.wte.weight``, ``gpt.h.0.attn.qkv_proj.weight``,
...) and returns the port's :class:`~.models.gpt.GPTForCausalLM` holding
them. The port keeps the JAX package's names and layouts — ``Linear``
weights stay ``[in, out]`` — so every array copies as it is; a missing,
unexpected or misshapen name raises. This module needs numpy arrays only,
never the JAX package itself.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.gpt import GPTForCausalLM

__all__ = ["params_from_paddle_tpu"]


def params_from_paddle_tpu(named_arrays, config, device=None,
                           dtype=torch.float32):
    """-> a port ``GPTForCausalLM`` on ``device`` (``cuda`` unless
    ``"cpu"``) in ``dtype``, filled from ``named_arrays`` (a mapping or an
    iterable of ``(name, array)`` pairs)."""
    arrays = dict(named_arrays.items() if hasattr(named_arrays, "items")
                  else named_arrays)
    model = GPTForCausalLM(config, device=device, dtype=dtype, seed=None)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    unexpected = sorted(set(arrays) - set(params))
    if missing or unexpected:
        raise KeyError(f"weight names disagree: missing {missing}, "
                       f"unexpected {unexpected}")
    with torch.no_grad():
        for name, p in params.items():
            a = np.asarray(arrays[name])
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: array {a.shape} vs parameter "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))
    return model
