"""Carry a JAX-package GPT's weights into the port.

``params_from_paddle_tpu(named_arrays, config, device, dtype)`` takes the
parameters of a ``paddle_tpu.models.GPTForCausalLM`` as numpy arrays keyed
by their structured names (``model.named_parameters()`` /
``state_dict()``: ``gpt.wte.weight``, ``gpt.h.0.attn.qkv_proj.weight``,
...) and returns the port's :class:`~.models.gpt.GPTForCausalLM` holding
them. The port keeps the JAX package's names and layouts — ``Linear``
weights stay ``[in, out]`` — so every array copies as it is; a missing,
unexpected or misshapen name raises. The parameters stay trainable.
``params_to_numpy(model)`` goes the other way, so trained weights can be
compared.

An optimizer's state crosses the same way.
``opt_state_from_paddle_tpu(state, name_map)`` turns a JAX optimizer's
``state_dict`` (``paddle_tpu/optimizer/optimizer.py:181-204``: numpy
arrays keyed ``f"{p.name}_{accumulator}"`` by the JAX parameters'
``name``, ``master_weights`` by name, ``LR_Scheduler``, ``global_step``)
into the port's, given the JAX model's ``{p.name: structured name}``
map; the port's ``Optimizer.set_state_dict`` loads it.
``opt_state_to_numpy(state, name_map)`` goes the other way. This module
needs numpy arrays only, never the JAX package itself.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.gpt import GPTForCausalLM

__all__ = ["params_from_paddle_tpu", "params_to_numpy",
           "opt_state_from_paddle_tpu", "opt_state_to_numpy"]


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


def params_to_numpy(model):
    """``{structured name: float32 numpy array}`` of ``model``'s
    parameters: copies on the host, which later in-place updates of the
    parameters leave alone."""
    return {name: p.detach().float().cpu().numpy().copy()
            for name, p in model.named_parameters()}


def _rename(state, name_map, convert):
    """``state`` with every parameter name ``name_map`` holds renamed (the
    accumulator keys by their longest matching name) and every array
    value passed through ``convert``."""
    out = {}
    for key, value in state.items():
        if key in ("LR_Scheduler", "global_step"):
            out[key] = value
        elif key == "master_weights":
            out[key] = {name_map[n]: convert(w) for n, w in value.items()
                        if n in name_map}
        else:
            names = [n for n in name_map if key.startswith(n + "_")]
            if names:
                name = max(names, key=len)
                acc = key[len(name) + 1:]
                out[f"{name_map[name]}_{acc}"] = (
                    float(np.asarray(value)) if acc == "beta_pow"
                    else convert(value))
    return out


def opt_state_from_paddle_tpu(state, name_map):
    """-> the port's optimizer ``state_dict`` from the JAX package's
    (numpy arrays), renamed by ``name_map`` (JAX ``p.name`` -> structured
    name); step counts become floats, arrays f32 CPU tensors."""
    return _rename(state, name_map, lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)))


def _to_numpy(t):
    return t.detach().float().cpu().numpy().copy()


def opt_state_to_numpy(state, name_map=None):
    """-> the port's optimizer ``state_dict`` with float32 numpy arrays in
    place of tensors, renamed to the JAX names when ``name_map`` (JAX
    ``p.name`` -> structured name, as for
    :func:`opt_state_from_paddle_tpu`) is given."""
    if name_map is not None:
        return _rename(state, {v: k for k, v in name_map.items()},
                       _to_numpy)
    return {k: {n: _to_numpy(w) for n, w in v.items()}
            if k == "master_weights" else
            _to_numpy(v) if torch.is_tensor(v) else v
            for k, v in state.items()}
