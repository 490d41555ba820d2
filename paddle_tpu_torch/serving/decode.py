"""Paged attention for the bucketed serving fallback: the fixed-slot decode
step and the chunk step's partial-prefix attention.

The port of ``paddle_tpu/serving/decode.py`` (``paged_decode_attention``
and ``paged_prefill_attention``). There is no backend choice and no A/B
gate: on a CUDA tensor the decode step runs the hand-written paged decode
kernel, always; on a CPU tensor its plain version
(``ops/kernels/paged_attention.py``). The chunk step has no Pallas kernel
in the JAX package and stays torch code. Mesh sharding is not ported.
"""
from __future__ import annotations

from ..ops.kernels import paged_attention, paged_prefill_reference

__all__ = ["paged_decode_attention", "paged_prefill_attention"]


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
