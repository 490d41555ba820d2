"""Ragged paged attention for serving — one launch per scheduler round.

The port of ``paddle_tpu/serving/ragged_attention.py``: the engine's whole
round (one-token decode rows, budgeted prefill chunks, prompt tails behind
prefix-cache hits) rides one flattened ``[total_tokens, H, Dh]`` launch
described by per-row metadata. Only ``total_tokens`` is padded, up the
power-of-two schedule of :func:`pad_total_tokens`.

On a CUDA tensor the hand-written kernel runs, on a CPU tensor its plain
version (``ops/kernels/ragged_attention.py``). :func:`ab_compare_ragged`
is the engine's measure-only A/B gate at its ragged launch shape
(:func:`.decode.measure`): it reports the plain version's time beside the
kernel's and never demotes the kernel. :func:`sharded_ragged_attention`
runs the kernel on this rank's KV heads over a mesh axis, as
:mod:`.decode`'s sharded wrappers do.
"""
from __future__ import annotations

from ..ops.kernels import ragged_paged_attention as _kernel
from ..ops.kernels import ragged_paged_attention_reference as _plain
from .decode import _int32, measure

__all__ = ["ragged_paged_attention", "sharded_ragged_attention",
           "pad_total_tokens", "PAD_FLOOR", "ab_compare_ragged"]

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


def sharded_ragged_attention(mesh, axis_name="model", scale=None):
    """Ragged attention sharded along KV heads over ``mesh[axis_name]``:
    each rank attends its query-head groups against its head slice of
    every page; row metadata and block tables are whole on every rank,
    and the launch makes no collective of its own (the ``local`` call;
    ``scratch=`` passes through). Called with whole tensors it cuts each
    rank's contiguous heads and all-gathers the output."""
    from ..distributed._mesh_shard import MeshSharded

    def _impl(q, kp, vp, rs, rl, kl, bt, scratch=None):
        return _kernel(q, kp, vp, rs, rl, kl, bt, scale=scale,
                       scratch=scratch)

    return MeshSharded(_impl, mesh, [(axis_name, {0: 1, 1: 2, 2: 2}, 1)],
                       dense=(1, 2))


def ab_compare_ragged(q, k_pool, v_pool, row_starts, row_lens, kv_lens,
                      block_tables, scale=None, repeats=20, scratch=None):
    """Time the plain version against the ragged kernel at this launch
    shape (:func:`.decode.measure`) -> ``{"backend", "xla_ms",
    "pallas_ms", "reason"}``. ``scratch``: the engine's split scratch."""
    dev = q.device
    args = (q, k_pool, v_pool, _int32(row_starts, dev),
            _int32(row_lens, dev), _int32(kv_lens, dev),
            _int32(block_tables, dev))
    return measure(lambda *a: _kernel(*a, scale=scale, scratch=scratch),
                   lambda *a: _plain(*a, scale=scale), args,
                   repeats=repeats)
