"""Ragged paged attention for serving — one launch per scheduler round.

The port of ``paddle_tpu/serving/ragged_attention.py``: the engine's whole
round (one-token decode rows, budgeted prefill chunks, prompt tails behind
prefix-cache hits) rides one flattened ``[total_tokens, H, Dh]`` launch
described by per-row metadata. Only ``total_tokens`` is padded, up the
power-of-two schedule of :func:`pad_total_tokens`.

There is no backend knob: on a CUDA tensor the hand-written kernel runs,
on a CPU tensor its plain version (``ops/kernels/ragged_attention.py``).
"""
from __future__ import annotations

from ..ops.kernels import ragged_paged_attention as _kernel

__all__ = ["ragged_paged_attention", "pad_total_tokens", "PAD_FLOOR"]

# smallest padded launch: decode-only rounds of small engines all share
# one shape instead of one per active-row count
PAD_FLOOR = 8


def pad_total_tokens(n, floor=PAD_FLOOR):
    """The power-of-two token-pad schedule: the only shape axis a round
    varies on, so distinct round shapes over a serving lifetime are
    bounded by ``log2(max_round_tokens / floor) + 1``."""
    n = max(int(n), int(floor))
    p = 1
    while p < n:
        p *= 2
    return p


def ragged_paged_attention(q, k_pool, v_pool, row_starts, row_lens,
                           kv_lens, block_tables, scale=None):
    """One ragged launch: ``q`` [T, H, Dh] flat tokens; pools
    [P, page, KVH, Dh]; per-row metadata as in the ops module. Returns
    [T, H, Dh]; pad tokens come back zeroed and the caller discards them."""
    return _kernel(q, k_pool, v_pool, row_starts, row_lens, kv_lens,
                   block_tables, scale=scale)
