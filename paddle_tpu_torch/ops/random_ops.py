"""Random sampling (``paddle_tpu/ops/random_ops.py``). Every op draws
from the framework generator of its device (``core.random.generator``,
seeded by ``seed``) through ``generator=``; ``uniform`` and
``top_p_sampling`` given a nonzero ``seed`` draw from a generator of
their own seeded with it, so the same seed gives the same draw whatever
the framework state. ``multinomial`` without replacement takes the top
``num_samples`` of ``log p`` plus Gumbel noise, as JAX does.

JAX's counter-based keys and torch's Philox / Mersenne streams differ, so
no draw is bit-equal to the JAX package's; the distributions are the
same.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import random as prandom
from ..core.dtype import convert_dtype, get_default_dtype
from ..device import resolve_device
from ._common import shape_arg

__all__ = ["rand", "randn", "standard_normal", "normal", "uniform",
           "randint", "randint_like", "randperm", "bernoulli", "bernoulli_",
           "multinomial", "poisson", "rand_like", "randn_like", "binomial",
           "standard_gamma", "top_p_sampling"]


def _gen(device):
    return prandom.generator(device)


def _own_gen(seed, device):
    """A generator of its own for a nonzero ``seed``, else the framework's."""
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return _gen(device)


def _fdt(dtype):
    return convert_dtype(dtype) or get_default_dtype()


def rand(shape, dtype=None, name=None):
    dev = resolve_device()
    return torch.rand(shape_arg(shape), dtype=_fdt(dtype), device=dev,
                      generator=_gen(dev))


def randn(shape, dtype=None, name=None):
    dev = resolve_device()
    return torch.randn(shape_arg(shape), dtype=_fdt(dtype), device=dev,
                       generator=_gen(dev))


standard_normal = randn


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """``mean + std * N(0, 1)``: the shape of the tensors ``mean`` / ``std``
    broadcast, else ``shape``."""
    if torch.is_tensor(mean) or torch.is_tensor(std):
        dev = (mean if torch.is_tensor(mean) else std).device
        shp = torch.broadcast_shapes(
            tuple(mean.shape) if torch.is_tensor(mean) else (),
            tuple(std.shape) if torch.is_tensor(std) else ())
    else:
        dev = resolve_device()
        shp = shape_arg(shape) if shape is not None else ()
    z = torch.randn(shp, dtype=get_default_dtype(), device=dev,
                    generator=_gen(dev))
    return mean + std * z


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    dev = resolve_device()
    u = torch.rand(shape_arg(shape), dtype=_fdt(dtype), device=dev,
                   generator=_own_gen(seed, dev))
    return u * (max - min) + min


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = resolve_device()
    return torch.randint(low, high, shape_arg(shape), device=dev,
                         dtype=convert_dtype(dtype), generator=_gen(dev))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return torch.randint(low, high, tuple(x.shape), device=x.device,
                         dtype=convert_dtype(dtype) or x.dtype,
                         generator=_gen(x.device))


def randperm(n, dtype="int64", name=None):
    dev = resolve_device()
    return torch.randperm(n, device=dev, dtype=convert_dtype(dtype),
                          generator=_gen(dev))


def bernoulli(x, name=None):
    return torch.bernoulli(x, generator=_gen(x.device))


def bernoulli_(x, p=0.5, name=None):
    return x.bernoulli_(p, generator=_gen(x.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """int64 draws of category indices from the rows of ``x`` (weights);
    without replacement no index repeats within a row."""
    g = _gen(x.device)
    if replacement:
        return torch.multinomial(x, num_samples, True, generator=g)
    logits = torch.log(x / x.sum(-1, keepdim=True))
    u = torch.rand(logits.shape, dtype=logits.dtype, device=x.device,
                   generator=g)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.topk(logits + gumbel, num_samples).indices.to(torch.int64)


def poisson(x, name=None):
    return torch.poisson(x, generator=_gen(x.device))


def rand_like(x, dtype=None, name=None):
    return torch.rand(tuple(x.shape), dtype=convert_dtype(dtype) or x.dtype,
                      device=x.device, generator=_gen(x.device))


def randn_like(x, dtype=None, name=None):
    return torch.randn(tuple(x.shape), dtype=convert_dtype(dtype) or x.dtype,
                       device=x.device, generator=_gen(x.device))


def binomial(count, prob, name=None):
    """int64 draws of Binomial(count, prob), elementwise (broadcast)."""
    c = count if torch.is_tensor(count) else torch.as_tensor(
        np.asarray(count), device=prob.device)
    p = prob if torch.is_tensor(prob) else torch.as_tensor(
        np.asarray(prob), device=c.device)
    c, p = torch.broadcast_tensors(c.to(torch.float32), p.to(torch.float32))
    return torch.binomial(c.contiguous(), p.contiguous(),
                          generator=_gen(c.device)).to(torch.int64)


def standard_gamma(alpha, name=None):
    """float64 draws of Gamma(alpha, 1) (the JAX package's dtype), computed
    in f32. torch's sampler reads the device's
    global generator, so it runs under ``fork_rng`` seeded from the
    framework generator: repeatable under ``seed``, and torch's own state
    is left as it was."""
    a = alpha.to(torch.float32)
    dev = a.device
    s = int(torch.randint(0, 2 ** 62, (), device="cpu",
                          generator=_gen("cpu")))
    devices = [dev.index or 0] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(s)
        return torch._standard_gamma(a).to(torch.float64)


def top_p_sampling(x, ps, threshold=None, seed=None, name=None):
    """Nucleus sampling over the rows of ``x`` ([B, V] probabilities):
    keep the smallest prefix of each row, sorted by probability, whose
    mass before the last kept token is below ``ps`` (the first token is
    always kept), renormalise and draw one token. -> (scores [B, 1], int64
    ids [B, 1])."""
    pa = ps if torch.is_tensor(ps) else torch.full(
        (), float(ps), device=x.device) if np.ndim(ps) == 0 else \
        torch.as_tensor(np.asarray(ps, np.float32), device=x.device)
    order = torch.argsort(-x, dim=-1, stable=True)
    sorted_p = torch.gather(x, -1, order)
    cum = torch.cumsum(sorted_p, dim=-1)
    keep = (cum - sorted_p) < pa.to(x.dtype)[..., None]
    keep[..., 0] = True
    masked = torch.where(keep, sorted_p, torch.zeros_like(sorted_p))
    probs = masked / masked.sum(-1, keepdim=True).clamp_min(1e-12)
    pick = torch.multinomial(probs.float(), 1,
                             generator=_own_gen(seed if seed not in (None, -1)
                                                else 0, x.device))
    ids = torch.gather(order, -1, pick)
    return torch.gather(x, -1, ids), ids.to(torch.int64)
