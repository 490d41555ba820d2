"""The framework RNG (``paddle_tpu/core/random.py``): one explicit
``torch.Generator`` per device, seeded by :func:`seed`. Every random op
of the port draws from ``generator(device)`` through ``generator=``, so
torch's global RNG is neither read nor advanced by them. :func:`seed`
also seeds torch's default generators, which dropout draws from where a
model holds no generator of its own: as in JAX, where dropout draws from
the default generator, ``seed(n)`` makes a run with dropout repeat.
``jit.to_static`` registers the framework generator of the device it
captures on with the CUDA graph, so a staged step's draws differ from
replay to replay.

JAX derives a key per call from (seed, counter); torch keeps a stateful
Philox / Mersenne state per device. The streams therefore differ bit for
bit from the JAX package's, but ``seed(n)`` makes a run repeat exactly,
as it does there.
"""
from __future__ import annotations

import torch

__all__ = ["seed", "generator", "get_rng_state", "set_rng_state",
           "get_cuda_rng_state", "set_cuda_rng_state"]

_seed = 0
_generators = {}


def _key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        return f"cuda:{idx}"
    return dev.type


def generator(device) -> torch.Generator:
    """The framework generator of ``device`` (made at first use, seeded
    with the last :func:`seed`)."""
    k = _key(device)
    g = _generators.get(k)
    if g is None:
        g = torch.Generator(device=k).manual_seed(_seed)
        _generators[k] = g
    return g


def seed(value: int):
    """``paddle.seed``: reseed every device's generator. Returns the
    current device's generator (the CPU's where CUDA is absent)."""
    global _seed
    _seed = int(value)
    for g in _generators.values():
        g.manual_seed(_seed)
    torch.manual_seed(_seed)
    from ..device import DEFAULT_DEVICE
    dev = torch.device(DEFAULT_DEVICE.replace("gpu", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        dev = torch.device("cpu")
    return generator(dev)


def get_rng_state(device=None):
    """The current device's generator state, as a one-element list (the
    shape of ``paddle.get_rng_state``'s result)."""
    from ..device import resolve_device
    return [generator(resolve_device(device)).get_state()]


def set_rng_state(state_list, device=None):
    from ..device import resolve_device
    generator(resolve_device(device)).set_state(state_list[0])


def get_cuda_rng_state():
    """One state per visible GPU (empty without CUDA)."""
    return [generator(f"cuda:{i}").get_state()
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state_list):
    for i, s in enumerate(state_list):
        generator(f"cuda:{i}").set_state(s)


def _reset_state():
    """Seed 0 and no generators: the state at import (for tests)."""
    global _seed
    _seed = 0
    _generators.clear()
