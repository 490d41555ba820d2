"""Paged decode attention — one query token per row over its KV pages.

The port of ``paddle_tpu/ops/pallas/paged_attention.py``::

    q            [B, H, D]          one decode token per row
    k/v_cache    [num_pages, page_size, KVH, D]   (GQA pools, KVH <= H:
                 query heads grouped G = H // KVH over shared KV heads)
    block_tables [B, max_pages]     physical page id per logical page
    context_lens [B]                valid KV length per row

Three things live here:

* :func:`paged_attention_reference` — the plain PyTorch version (the
  gather formulation of ``paged_attention.py:46``).
* :func:`paged_prefill_reference` — the chunked-prefill sibling
  (``paged_attention.py:78``): S query tokens per row with a ragged causal
  mask. It has no Pallas kernel and stays torch code.
* :func:`paged_attention` — the wrapper of the hand-written CUDA kernel
  ``csrc/paged_attention.cu`` (replaces
  ``paddle_tpu/ops/pallas/paged_attention.py:175``). It is bound by the
  bytes of KV pages it reads; see the source for its design. On a CPU
  tensor the wrapper runs the plain version; on a CUDA tensor it launches
  the kernel or raises. :func:`launch_plan` picks the split count from
  host integers alone (``context_lens`` stays on the device): each (row,
  KV head) pair takes ``n_split`` blocks that cut the row's own keys
  between them. The splits' scratch is the caller's where it passes one
  (:func:`reserve_scratch`; a serving engine owns one for its captured
  decode step), else a per-device cache.
  :func:`launch_kernel` launches with a split count the caller names
  (``paged_splits.py`` times them).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

__all__ = ["paged_attention_reference", "paged_prefill_reference",
           "paged_attention", "launch_kernel", "launch_plan",
           "reserve_scratch", "owned_scratch"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def grouped(H, KVH):
    """Query heads per KV head (``_grouped``); raises unless KVH divides H."""
    if H % KVH:
        raise ValueError(f"{H} query heads not divisible by {KVH} KV heads")
    return H // KVH


def _gather_pages(cache, block_tables):
    """A row's pages as one dense run: [B, max_pages * page, KVH, D] f32.
    Ids are clamped, so a sentinel -1 reads a page the mask then hides."""
    bt = block_tables.long().clamp(0, cache.shape[0] - 1)
    B = bt.shape[0]
    return cache[bt].reshape(B, -1, *cache.shape[2:]).float()


def paged_attention_reference(q, k_cache, v_cache, block_tables,
                              context_lens, scale=None):
    """One query token per row over its paged context: ``q`` [B, H, D],
    tables [B, max_pages], ``context_lens`` [B]. Keys past the context are
    masked to -1e30, rows with context 0 come out zeroed. GQA-grouped.
    Computes in f32, returns q's type."""
    B, H, D = q.shape
    KVH = k_cache.shape[2]
    G = grouped(H, KVH)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    k = _gather_pages(k_cache, block_tables)
    v = _gather_pages(v_cache, block_tables)
    S = k.shape[1]
    qg = q.reshape(B, KVH, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * scale
    valid = torch.arange(S, device=q.device)[None, :] < context_lens[:, None]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v).reshape(B, H, D)
    o = torch.where((context_lens > 0)[:, None, None], o,
                    torch.zeros_like(o))
    return o.to(q.dtype)


def paged_prefill_reference(q, k_cache, v_cache, block_tables, q_start,
                            q_lens, scale=None):
    """Partial-prefix attention for chunked prefill: a chunk of S query
    tokens per row (``q`` [B, S, H, D]; rows past ``q_lens[b]`` are
    padding) starts at absolute position ``q_start[b]`` and attends over
    the row's pages, which already hold the prefix and this chunk's own
    K/V. Query token ``i`` of row ``b`` sees pool positions
    ``<= q_start[b] + i``. Returns ``[B, S, H, D]``; padded query rows give
    values the caller discards."""
    B, S, H, D = q.shape
    KVH = k_cache.shape[2]
    G = grouped(H, KVH)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    k = _gather_pages(k_cache, block_tables)
    v = _gather_pages(v_cache, block_tables)
    T = k.shape[1]
    qg = q.reshape(B, S, KVH, G, D).float()
    s = torch.einsum("bskgd,btkd->bskgt", qg, k) * scale
    key_pos = torch.arange(T, device=q.device)[None, None, :]
    q_pos = (q_start.long()[:, None]
             + torch.arange(S, device=q.device)[None, :])[:, :, None]
    visible = key_pos <= q_pos                                  # [B, S, T]
    s = torch.where(visible[:, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bskgt,btkd->bskgd", p, v)
    return o.reshape(B, S, H, D).to(q.dtype)


# csrc/paged_attention.cu's keys a ring stage and query heads a block (a
# G > MAX_HEADS takes ceil(G / MAX_HEADS) head groups), and its largest
# split count; the kernel owns the rest of its geometry
KEY_TILE, MAX_HEADS, MAX_SPLIT = 16, 8, 1024
# the plan aims at SPLIT_BLOCKS_PER_SM blocks a streaming multiprocessor,
# with splits of at least SPLIT_MIN_TILES key tiles of the longest context
SPLIT_BLOCKS_PER_SM, SPLIT_MIN_TILES = 4, 4


def _scratch_sizes(B, H, KVH, D, n_split):
    """-> (partials f32, tickets int32) that ``n_split`` splits take."""
    if n_split == 1:
        return 0, 0
    return (B * H * n_split * (D + 2),
            B * KVH * -(-grouped(H, KVH) // MAX_HEADS))


@functools.lru_cache(maxsize=64)
def launch_plan(B, H, KVH, D, max_pages, page_size, sms):
    """The launch's split count and scratch from host integers -> dict:
    ``n_split`` blocks a (row, KV head, head group), aiming at
    ``SPLIT_BLOCKS_PER_SM * sms`` blocks in all with at least
    ``SPLIT_MIN_TILES`` key tiles a split at the full ``max_pages *
    page_size`` keys; ``partials`` f32 and ``tickets`` int32 of scratch
    (none with one split). A row uses ``min(n_split, ceil(context /
    KEY_TILE))`` of its splits."""
    n_hg = -(-grouped(H, KVH) // MAX_HEADS)
    max_tiles = -(-max_pages * page_size // KEY_TILE)
    pairs = max(B * KVH * n_hg, 1)
    n_split = max(1, min(-(-SPLIT_BLOCKS_PER_SM * sms // pairs),
                         max_tiles // SPLIT_MIN_TILES, MAX_SPLIT))
    partials, tickets = _scratch_sizes(B, H, KVH, D, n_split)
    return {"n_split": n_split, "partials": partials, "tickets": tickets}


def reserve_scratch(B, H, KVH, D, max_pages, page_size, device):
    """Split scratch that the caller owns for decode steps of this shape
    -> ``[partials, tickets]`` on ``device`` (tickets zeroed), sized by
    :func:`launch_plan`. The kernel leaves every ticket at zero when it
    ends, so a captured CUDA graph can replay over it with no reset as
    long as its owner keeps it."""
    plan = launch_plan(B, H, KVH, D, max_pages, page_size,
                       _sm_count(device))
    return [torch.zeros(max(plan["partials"], 1), device=device,
                        dtype=torch.float32),
            torch.zeros(max(plan["tickets"], 1), device=device,
                        dtype=torch.int32)]


def owned_scratch(scratch, need, dtypes, device):
    """Pointers of a caller's scratch tensors after checking that each
    holds its ``need`` elements of its type on ``device``; raises
    otherwise (a caller's scratch is never replaced or grown)."""
    ptrs = []
    for t, n, dt in zip(scratch, need, dtypes):
        if t.device != device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"split scratch must be contiguous {dt} on "
                             f"{device}, got {t.dtype} on {t.device}")
        if t.numel() < n:
            raise ValueError(f"split scratch holds {t.numel()} elements, "
                             f"the launch needs {n}")
        ptrs.append(t.data_ptr())
    return ptrs


_lib = None
# device -> [partials, tickets]: the shared splits' scratch, grown
# (reallocated) to the largest plan seen; the kernel leaves the tickets at
# zero. A captured graph must not point into it: a later, larger plan
# frees it under the graph
_scratch: dict = {}
_sms: dict = {}


def _kernel():
    global _lib
    if _lib is None:
        from . import _build
        fn = _build.load("paged_attention").paged_attention
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def _split_scratch(device, n_part, n_tickets):
    """-> pointers to at least ``n_part`` f32 partials and ``n_tickets``
    int32 tickets (zeroed when allocated) on ``device``; a plan no bigger
    than one seen before gets the same pointers."""
    buf = _scratch.setdefault(device, [None, None])
    for i, (n, dt) in enumerate(((n_part, torch.float32),
                                 (n_tickets, torch.int32))):
        if buf[i] is None or buf[i].numel() < n:
            buf[i] = torch.zeros(n, device=device, dtype=dt)
    return [t.data_ptr() for t in buf]


def _sm_count(device):
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device]


def check_kernel_inputs(name, q, k_cache, v_cache, meta):
    """What the paged kernels take: f32 or bf16 q and pools of one type,
    D in {64, 128}, pools ``[P, page, KVH, D]`` with KVH dividing H, every
    tensor contiguous on q's device, int32 metadata."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    for tname, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype != q.dtype:
            raise TypeError(f"{tname} is {x.dtype}, q is {q.dtype}")
    H, D = q.shape[-2:]
    if D not in (64, 128):
        raise ValueError(f"head dim {D} not supported (64 or 128)")
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[3] != D:
        raise ValueError(f"pools {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    grouped(H, k_cache.shape[2])
    for tname, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                     *meta.items()):
        if x.device != q.device:
            raise ValueError(f"{tname} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")
    for tname, x in meta.items():
        if x.dtype != torch.int32:
            raise TypeError(f"{tname} must be int32, got {x.dtype}")


def paged_attention(q, k_cache, v_cache, block_tables, context_lens,
                    scale=None, scratch=None):
    """One decode step -> ``[B, H, D]`` (rows with context 0 zeroed). CPU
    tensors take the plain version; CUDA tensors launch the kernel (f32 or
    bf16, D in {64, 128}) with :func:`launch_plan`'s split count;
    anything else raises. ``scratch``: the caller's split scratch
    (:func:`reserve_scratch`), else the per-device cache."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_cache, v_cache, block_tables,
                                         context_lens, scale=scale)
    return launch_kernel(q, k_cache, v_cache, block_tables, context_lens,
                         scale, scratch=scratch)


def launch_kernel(q, k_cache, v_cache, block_tables, context_lens,
                  scale=None, n_split=None, scratch=None):
    """The kernel on CUDA tensors with ``n_split`` blocks a (row, KV head,
    head group), by default :func:`launch_plan`'s, over the caller's
    ``scratch`` if given (checked, never grown) or the per-device cache;
    raises for anything it does not take. Every launch adds one to
    ``paged_attention.launches``."""
    if q.device.type != "cuda":
        raise ValueError(f"the paged_attention kernel runs on cuda "
                         f"tensors (cpu ones take the plain version), not "
                         f"{q.device}")
    check_kernel_inputs("paged_attention", q, k_cache, v_cache,
                        {"block_tables": block_tables,
                         "context_lens": context_lens})
    if q.dim() != 3 or block_tables.dim() != 2 \
            or block_tables.shape[0] != q.shape[0] \
            or context_lens.shape != (q.shape[0],):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"context_lens {tuple(context_lens.shape)} do not "
                         f"match q {tuple(q.shape)}")
    B, H, D = q.shape
    P, page, KVH = k_cache.shape[:3]
    max_pages = block_tables.shape[1]
    for tname, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.data_ptr() % 16:
            raise ValueError(f"{tname} must start on a 16-byte boundary")
    if n_split is None:
        n_split = launch_plan(B, H, KVH, D, max_pages, page,
                              _sm_count(q.device))["n_split"]
    elif not 1 <= n_split <= MAX_SPLIT:
        raise ValueError(f"n_split {n_split} not in [1, {MAX_SPLIT}]")
    ptrs = [None, None]
    if n_split > 1 and B > 0:
        need = _scratch_sizes(B, H, KVH, D, n_split)
        ptrs = _split_scratch(q.device, *need) if scratch is None \
            else owned_scratch(scratch, need, (torch.float32, torch.int32),
                               q.device)
    out = torch.empty_like(q)
    scale = float(scale if scale is not None else 1.0 / math.sqrt(D))
    rc = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                   block_tables.data_ptr(), context_lens.data_ptr(),
                   out.data_ptr(), *ptrs, B, H, KVH, D, P, page,
                   max_pages, n_split, scale, _DTYPES[q.dtype],
                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
