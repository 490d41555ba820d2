"""Paged attention for the bucketed serving fallback: the fixed-slot decode
step and the chunk step's partial-prefix attention — and the A/B backend
gate of both serving engines.

The port of ``paddle_tpu/serving/decode.py``. On a CUDA tensor the decode
step runs the hand-written paged decode kernel, always; on a CPU tensor
its plain version (``ops/kernels/paged_attention.py``). The chunk step has
no Pallas kernel in the JAX package and stays torch code.

**The A/B gate measures and reports; it never demotes.** The JAX gate
(``_common.ab_gate``) serves the Pallas kernel only where it beats the
XLA reference. Here a hand kernel on the main path always runs on the
card, so the gate keeps the JAX names and the JAX row
(``{"backend", "xla_ms", "pallas_ms", "reason"}``: ``xla`` is the plain
version, ``pallas`` the hand kernel) but only records what it measured:

* ``auto`` on a CUDA engine times the plain version and the kernel at the
  engine's own launch shape (CUDA events) and keeps the kernel
  (``backend`` ``"pallas"``) whatever the times say. On a CPU engine it
  times nothing, as the JAX gate skips the Pallas leg off the TPU, and
  reports the plain version, which is what CPU tensors run;
* ``pallas`` runs the kernel (its plain version for CPU tensors);
* ``xla`` is refused on a CUDA engine (:func:`check_backend`): the plain
  version serves CPU tensors and tests only.

:func:`resolve_backend` keeps the JAX precedence: the explicit choice,
then ``PADDLE_TPU_SERVING_ATTN``, then ``PADDLE_TPU_KERNELS``, then
``auto``.

Multi-rank serving shards along **KV heads** over a mesh axis (``model``
by default): :func:`sharded_paged_attention` and
:func:`sharded_paged_prefill` run the decode kernel (the chunk step's
attention) on this rank's head slice; block tables, positions and lengths
are every rank's whole. Called with JAX's full-head signature they cut
each rank's contiguous heads, run, and all-gather the output; their
``local`` call takes the rank's own slices, as a tensor-parallel
:class:`~.engine.ServingEngine` holds them
(``distributed/_mesh_shard.py``).
"""
from __future__ import annotations

import os

import torch

from ..ops.kernels import (paged_attention, paged_attention_reference,
                           paged_prefill_reference)

__all__ = ["paged_decode_attention", "paged_prefill_attention",
           "sharded_paged_attention", "sharded_paged_prefill", "BACKENDS",
           "resolve_backend", "check_backend", "measure", "ab_compare"]

BACKENDS = ("xla", "pallas", "auto")


def paged_decode_attention(q, k_pool, v_pool, block_tables, context_lens,
                           scale=None):
    """One decode step. ``q`` [B, H, Dh]; pools [P, page, KVH, Dh];
    ``block_tables`` [B, max_pages] int32; ``context_lens`` [B] int32.
    Returns [B, H, Dh]."""
    return paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                           scale=scale)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, q_start,
                            q_lens, scale=None):
    """Partial-prefix attention for one chunk step: ``q`` [B, S, H, Dh]
    chunk tokens starting at absolute position ``q_start[b]`` per row,
    attending causally over the row's pages (which already hold the prefix
    and this chunk). Returns [B, S, H, Dh]."""
    return paged_prefill_reference(q, k_pool, v_pool, block_tables, q_start,
                                   q_lens, scale=scale)


def sharded_paged_prefill(mesh, axis_name="model", scale=None):
    """Chunked-prefill attention sharded along KV heads over
    ``mesh[axis_name]``: query heads ride with their KV-head group;
    tables, starts and lengths are whole on every rank. -> a
    :class:`~..distributed._mesh_shard.MeshSharded` (the plain function
    at degree 1)."""
    from ..distributed._mesh_shard import MeshSharded

    def _impl(q, kp, vp, bt, start, lens):
        return paged_prefill_attention(q, kp, vp, bt, start, lens,
                                       scale=scale)

    return MeshSharded(_impl, mesh, [(axis_name, {0: 2, 1: 2, 2: 2}, 2)],
                       dense=(1, 2))


def sharded_paged_attention(mesh, axis_name="model", scale=None):
    """Decode attention sharded along KV heads over ``mesh[axis_name]``:
    each rank runs the paged decode kernel on its head slice against its
    head slice of every page; tables and lengths are whole on every rank,
    and the step makes no collective of its own (the ``local`` call).
    ``scratch=`` passes through to the kernel."""
    from ..distributed._mesh_shard import MeshSharded

    def _impl(q, kp, vp, bt, lens, scratch=None):
        return paged_attention(q, kp, vp, bt, lens, scale=scale,
                               scratch=scratch)

    return MeshSharded(_impl, mesh, [(axis_name, {0: 1, 1: 2, 2: 2}, 1)],
                       dense=(1, 2))


def resolve_backend(requested=None):
    """Normalize the backend choice: explicit arg wins, then the
    ``PADDLE_TPU_SERVING_ATTN`` env knob, then ``PADDLE_TPU_KERNELS``,
    default ``auto``."""
    b = requested or os.environ.get("PADDLE_TPU_SERVING_ATTN") \
        or os.environ.get("PADDLE_TPU_KERNELS") or "auto"
    b = str(b).lower()
    if b not in BACKENDS:
        raise ValueError(
            f"unknown serving attention backend {b!r}; pick from "
            f"{BACKENDS}")
    return b


def check_backend(backend, device):
    """Refuse the plain version as the backend of an engine on the card:
    a hand kernel on the main path never falls back to it."""
    if backend == "xla" and torch.device(device).type == "cuda":
        raise ValueError(
            "attn_backend='xla' asks for the plain PyTorch version, which "
            "serves CPU tensors and tests only; on CUDA the hand kernel "
            "runs (use 'pallas' or 'auto')")


def _event_ms(fn, repeats, warmup=3):
    """Mean ms a call of ``fn`` by CUDA events around ``repeats`` calls."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(repeats):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / repeats


def measure(kernel_fn, plain_fn, args, repeats=20):
    """The measure-only gate over ``args`` (the leading one a tensor) ->
    ``{"backend", "xla_ms", "pallas_ms", "reason"}``: on CUDA both timed,
    the kernel kept; elsewhere nothing timed, the plain version
    reported."""
    if args[0].device.type != "cuda":
        return {"backend": "xla", "xla_ms": None, "pallas_ms": None,
                "reason": "plain version: the kernel runs on CUDA tensors "
                          "only (nothing timed)"}
    plain_ms = _event_ms(lambda: plain_fn(*args), repeats)
    kernel_ms = _event_ms(lambda: kernel_fn(*args), repeats)
    verdict = "faster" if kernel_ms < plain_ms else "not faster"
    return {"backend": "pallas", "xla_ms": round(plain_ms, 4),
            "pallas_ms": round(kernel_ms, 4),
            "reason": f"measure-only gate: the hand kernel stays on the "
                      f"path ({verdict} than the plain version here)"}


def _int32(x, device):
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def ab_compare(q, k_pool, v_pool, block_tables, context_lens, scale=None,
               repeats=20, scratch=None):
    """Time the plain version against the paged decode kernel at this
    decode shape (:func:`measure`). ``scratch``: the engine's split
    scratch, so the gate's launches use what its graphs use."""
    args = (q, k_pool, v_pool, _int32(block_tables, q.device),
            _int32(context_lens, q.device))
    return measure(
        lambda *a: paged_attention(*a, scale=scale, scratch=scratch),
        lambda *a: paged_attention_reference(*a, scale=scale),
        args, repeats=repeats)
