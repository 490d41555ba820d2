"""Activation recomputation (gradient checkpointing), after
``paddle_tpu/distributed/fleet/recompute.py`` (reference:
python/paddle/distributed/fleet/recompute/recompute.py:404).

The JAX package wraps the block in ``jax.checkpoint``; the port uses
PyTorch's own idiom, :func:`torch.utils.checkpoint.checkpoint` in its
non-reentrant form: the forward keeps only the block's inputs, and the
backward runs the block again to rebuild what its gradients need.

The replay runs in the backward, outside the forward's ``auto_cast``
block, so :func:`recompute` keeps the AMP settings the forward ran under
and replays under them: the replayed block casts as the forward did, as
the JAX package's ``jax.checkpoint`` replays what it traced.

Dropout masks must be the same in the replay as in the forward, or the
losses look right while the gradients are wrong. ``checkpoint``'s
``preserve_rng_state`` saves only the default CPU and CUDA generators,
and the port's dropouts draw from ``torch.Generator`` objects of their own
(``GPTForCausalLM`` seeds one for all its dropouts). So :func:`recompute`
also saves the state of every generator the wrapped modules hold, sets it
back for the replay, and restores the state the replay found when it
ends: the generators then run exactly as they would without recompute,
as the JAX package folds the same key in the forward and in the
rematerialised block.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...amp.auto_cast import amp_state, amp_state_scope

__all__ = ["recompute", "recompute_sequential"]


def _generators(function):
    """The distinct ``torch.Generator`` attributes of the modules that
    ``function`` (a module, or a bound method of one) holds."""
    owner = function if isinstance(function, nn.Module) else getattr(
        function, "__self__", None)
    if not isinstance(owner, nn.Module):
        return []
    found = {}
    for m in owner.modules():
        for value in vars(m).values():
            if isinstance(value, torch.Generator):
                found[id(value)] = value
    return list(found.values())


def recompute(function, *args, use_reentrant=True, preserve_rng_state=True,
              **kwargs):
    """``function(*args, **kwargs)`` whose activations are recomputed in
    the backward instead of kept. ``use_reentrant`` is accepted for the
    reference's signature; both of its values take PyTorch's non-reentrant
    checkpoint, which computes the same gradients."""
    gens = _generators(function) if preserve_rng_state else []
    saved = [g.get_state() for g in gens]
    amp = amp_state()
    calls = []

    def run(*a):
        if not calls:                  # the forward
            calls.append(1)
            return function(*a, **kwargs)
        found = [g.get_state() for g in gens]
        for g, s in zip(gens, saved):
            g.set_state(s)
        try:
            with amp_state_scope(amp):
                return function(*a, **kwargs)
        finally:
            for g, s in zip(gens, found):
                g.set_state(s)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state)


def recompute_sequential(ctx, functions, *args):
    """Recompute ``functions`` (a sequence of modules, applied in turn) in
    ``ctx.get("segments", 1)`` segments (reference: recompute.py:542)."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    size = max(1, len(layers) // segments)
    out = args[0] if len(args) == 1 else args
    for i in range(0, len(layers), size):
        out = recompute(nn.Sequential(*layers[i:i + size]), out)
    return out
