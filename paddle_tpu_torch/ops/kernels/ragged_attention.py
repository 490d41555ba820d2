"""Ragged paged attention — mixed prefill + decode rows in one launch.

The port of ``paddle_tpu/ops/pallas/ragged_attention.py``. Input is a
flattened token stream: every row of the continuous batch (a one-token
decode step, a chunked-prefill segment, a prompt tail behind a prefix-cache
hit) puts its tokens into one ``[T, H, D]`` query tensor, described per
row::

    q            [T, H, D]        flat query tokens, rows back to back
    k/v_cache    [num_pages, page_size, KVH, D]  (GQA pools, KVH <= H)
    row_starts   [R] int32        first flat index of each row (nondecreasing;
                                  unused rows carry T)
    row_lens     [R] int32        query tokens this launch (0 = unused row)
    kv_lens      [R] int32        KV tokens per row AFTER this launch's writes
    block_tables [R, max_pages]   physical page ids per row

Query token ``i`` of row ``r`` sits at absolute position
``kv_lens[r] - row_lens[r] + i`` and attends causally over its row's pages
(its own K/V was written first). Three things live here:

* :func:`ragged_row_index` — the per-token segment decomposition (row id,
  position, valid), shared by the plain version and the model's pool
  scatter.
* :func:`ragged_paged_attention_reference` — the plain PyTorch version:
  the gather formulation over each token's row pages.
* :func:`ragged_paged_attention` — the wrapper of the hand-written CUDA
  kernel ``csrc/ragged_paged_attention.cu`` (replaces
  ``paddle_tpu/ops/pallas/ragged_attention.py:108``). It is bound by the
  bytes of KV pages it reads; see the source for its design. On a CPU
  tensor the wrapper runs the plain version; on a CUDA tensor it launches
  the kernel or raises. :func:`launch_plan` sizes the launch from host
  integers alone (the engine's metadata stays on the device): tiles of
  ``64 // G`` tokens, and splits of the key range that fill the card on
  small rounds. The splits' scratch is the caller's where it passes one
  (:func:`reserve_scratch`, sized by :func:`scratch_sizes`; a serving
  engine owns one for its captured rounds), else a per-device cache.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .paged_attention import (_DTYPES, check_kernel_inputs,
                              owned_scratch, paged_attention_reference)

__all__ = ["ragged_row_index", "ragged_paged_attention_reference",
           "ragged_paged_attention", "launch_plan", "scratch_sizes",
           "reserve_scratch"]

# tokens per chunk of the plain version's page gather: bounds its memory
# at the serving shapes (a [chunk, max_pages * page, KVH, D] f32 copy)
_REF_CHUNK = 64


def ragged_row_index(row_starts, row_lens, kv_lens, total_tokens):
    """Per-token segment decomposition of the flat stream -> ``(row_ids,
    positions, valid)``, each ``[total_tokens]``: the row owning token
    ``t`` (``searchsorted(side="right")`` over the nondecreasing
    ``row_starts``, clipped), its absolute position in the row's KV stream,
    and False for pad tokens (whose position is set to 0)."""
    rs = row_starts.to(torch.int32)
    t = torch.arange(total_tokens, dtype=torch.int32, device=rs.device)
    rid = (torch.searchsorted(rs, t, right=True) - 1).clamp(0,
                                                            rs.shape[0] - 1)
    off = t - rs[rid]
    rl = row_lens.to(torch.int32)[rid]
    valid = (off >= 0) & (off < rl)
    pos = kv_lens.to(torch.int32)[rid] - rl + off
    pos = torch.where(valid, pos, torch.zeros_like(pos))
    return rid, pos, valid


def ragged_paged_attention_reference(q, k_cache, v_cache, row_starts,
                                     row_lens, kv_lens, block_tables,
                                     scale=None):
    """The plain version: every flat token becomes a one-token row with
    context ``position + 1`` over its row's pages (pad tokens get context
    0 and a zero output). Tokens are taken in chunks of 64 so the page
    gather stays bounded at serving shapes. Returns ``[T, H, D]``."""
    T = q.shape[0]
    rid, pos, valid = ragged_row_index(row_starts, row_lens, kv_lens, T)
    vbt = block_tables.to(torch.int32)[rid]                # [T, max_pages]
    ctx = torch.where(valid, pos + 1, torch.zeros_like(pos))
    outs = [paged_attention_reference(q[i:i + _REF_CHUNK], k_cache, v_cache,
                                      vbt[i:i + _REF_CHUNK],
                                      ctx[i:i + _REF_CHUNK], scale=scale)
            for i in range(0, T, _REF_CHUNK)]
    return torch.cat(outs) if outs else torch.empty_like(q)


# the kernel's tiling (csrc/ragged_paged_attention.cu): query rows a block,
# keys a tile
TILE_ROWS, KEY_TILE = 64, 64
# splits hold at least this many keys, and tokens x splits stay below
# SPLIT_TOKENS, which bounds the scratch at T * H * n_split * D f32
SPLIT_MIN_KEYS, SPLIT_TOKENS = 128, 4096


def launch_plan(T, H, KVH, R, max_pages, page_size):
    """The launch's shape from host integers -> dict: ``bq`` tokens a tile
    (``64 // G``), ``n_slots`` tile slots (``ceil(T / bq) + R``, enough
    for the (row, tile) pairs of any layout of T tokens over R rows), and
    ``n_split`` splits of ``split_keys`` keys (a multiple of 64) covering
    the ``max_pages * page_size`` keys a row can have. A tile uses
    ``ceil(its keys / split_keys)`` of them."""
    G = H // KVH
    if G > TILE_ROWS:
        raise ValueError(f"{G} query heads per KV head exceed the kernel's "
                         f"{TILE_ROWS} rows a block")
    bq = TILE_ROWS // G
    max_keys = max_pages * page_size
    n_split = max(1, min(-(-max_keys // SPLIT_MIN_KEYS),
                         SPLIT_TOKENS // max(T, 1)))
    split_keys = -(-max_keys // n_split)
    split_keys = -(-split_keys // KEY_TILE) * KEY_TILE
    return {"bq": bq, "n_slots": -(-T // bq) + R,
            "n_split": -(-max_keys // split_keys), "split_keys": split_keys}


def scratch_sizes(T, H, KVH, D, R, max_pages, page_size):
    """Elements of split scratch a launch of ``T`` tokens takes -> ``(f32
    partial accumulators, f32 partial max/sum pairs, int32 tickets)``,
    all 0 when the plan has one split."""
    plan = launch_plan(T, H, KVH, R, max_pages, page_size)
    if plan["n_split"] == 1 or T == 0:
        return (0, 0, 0)
    n = T * H * plan["n_split"]
    return (n * D, n * 2, plan["n_slots"] * KVH)


def reserve_scratch(sizes, device):
    """Split scratch that the caller owns, ``sizes`` as
    :func:`scratch_sizes` gives them -> ``[part_acc, part_ml, tickets]``
    on ``device``, tickets zeroed. The kernel leaves every ticket at zero
    when it ends, so the scratch needs no reset between launches, and a
    captured CUDA graph can replay over it as long as its owner keeps it."""
    return [torch.empty(max(int(sizes[0]), 1), device=device,
                        dtype=torch.float32),
            torch.empty(max(int(sizes[1]), 1), device=device,
                        dtype=torch.float32),
            torch.zeros(max(int(sizes[2]), 1), device=device,
                        dtype=torch.int32)]


_lib = None
# device -> [part_acc, part_ml, tickets]: the shared splits' scratch, grown
# (reallocated) to the largest launch seen; the kernel leaves the tickets
# at zero. A captured graph must not point into it: a later, larger launch
# frees it under the graph
_scratch: dict = {}


def _kernel():
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("ragged_paged_attention")
        fn = lib.ragged_paged_attention
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def _split_scratch(device, n_acc, n_ml, n_tickets):
    """-> pointers to at least ``n_acc`` and ``n_ml`` f32 elements of
    partials and ``n_tickets`` tickets (zeroed when allocated) on
    ``device``."""
    buf = _scratch.setdefault(device, [None, None, None])
    for i, (n, make) in enumerate(((n_acc, torch.empty), (n_ml, torch.empty),
                                   (n_tickets, torch.zeros))):
        if buf[i] is None or buf[i].numel() < n:
            buf[i] = make(n, device=device,
                          dtype=torch.int32 if i == 2 else torch.float32)
    return [t.data_ptr() for t in buf]


def ragged_paged_attention(q, k_cache, v_cache, row_starts, row_lens,
                           kv_lens, block_tables, scale=None, scratch=None):
    """One ragged launch -> ``[T, H, D]`` (pad tokens zeroed). CPU tensors
    take the plain version; CUDA tensors launch the kernel (f32 or bf16,
    D in {64, 128}) and every launch adds one to
    ``ragged_paged_attention.launches``; anything else raises.
    ``scratch``: the caller's split scratch (:func:`reserve_scratch`),
    checked against the launch's need and never reallocated; None takes
    the per-device cache."""
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_cache, v_cache, row_starts, row_lens, kv_lens, block_tables,
            scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda (kernel) or "
                         f"cpu (plain version), not {q.device}")
    meta = {"row_starts": row_starts, "row_lens": row_lens,
            "kv_lens": kv_lens, "block_tables": block_tables}
    check_kernel_inputs("ragged_paged_attention", q, k_cache, v_cache, meta)
    T, H, D = q.shape
    R = row_starts.shape[0]
    if row_lens.shape != (R,) or kv_lens.shape != (R,) \
            or block_tables.dim() != 2 or block_tables.shape[0] != R:
        raise ValueError("row metadata shapes disagree")
    P, page, KVH = k_cache.shape[:3]
    max_pages = block_tables.shape[1]
    plan = launch_plan(T, H, KVH, R, max_pages, page)
    ptrs = [None] * 3
    if plan["n_split"] > 1 and T > 0:
        need = scratch_sizes(T, H, KVH, D, R, max_pages, page)
        ptrs = _split_scratch(q.device, *need) if scratch is None \
            else owned_scratch(scratch, need, (torch.float32,
                                               torch.float32, torch.int32),
                               q.device)
    out = torch.empty_like(q)
    scale = float(scale if scale is not None else 1.0 / math.sqrt(D))
    rc = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                   row_starts.data_ptr(), row_lens.data_ptr(),
                   kv_lens.data_ptr(), block_tables.data_ptr(),
                   out.data_ptr(), *ptrs, T, H, KVH, D, P, page, R,
                   max_pages, plan["n_split"], plan["split_keys"], scale,
                   _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
