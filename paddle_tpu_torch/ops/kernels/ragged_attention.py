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
  the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["ragged_row_index", "paged_attention_reference",
           "ragged_paged_attention_reference", "ragged_paged_attention"]

NEG_INF = -1e30
# tokens per chunk of the plain version's page gather: bounds its memory
# at the serving shapes (a [chunk, max_pages * page, KVH, D] f32 copy)
_REF_CHUNK = 64


def _grouped(H, KVH):
    if H % KVH:
        raise ValueError(f"{H} query heads not divisible by {KVH} KV heads")
    return H // KVH


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


def paged_attention_reference(q, k_cache, v_cache, block_tables,
                              context_lens, scale=None):
    """One query token per row over its paged context (the gather
    formulation of ``paged_attention.py:46``): ``q`` [B, H, D], tables
    [B, max_pages], ``context_lens`` [B]. Block-table ids are clamped,
    keys past the context are masked to -1e30, rows with context 0 come
    out zeroed. GQA-grouped. Computes in f32, returns q's type."""
    B, H, D = q.shape
    KVH = k_cache.shape[2]
    G = _grouped(H, KVH)
    page_size = k_cache.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    bt = block_tables.long().clamp(0, k_cache.shape[0] - 1)
    S = bt.shape[1] * page_size
    k = k_cache[bt].reshape(B, S, KVH, D).float()
    v = v_cache[bt].reshape(B, S, KVH, D).float()
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


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("ragged_paged_attention")
        fn = lib.ragged_paged_attention
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def _check_cuda(q, k_cache, v_cache, meta):
    if q.dtype not in _DTYPES:
        raise TypeError(f"ragged_paged_attention takes float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
    T, H, D = q.shape
    if D not in (64, 128):
        raise ValueError(f"head dim {D} not supported (64 or 128)")
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[3] != D:
        raise ValueError(f"pools {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    _grouped(H, k_cache.shape[2])
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    *meta.items()):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in meta.items():
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")


def ragged_paged_attention(q, k_cache, v_cache, row_starts, row_lens,
                           kv_lens, block_tables, scale=None):
    """One ragged launch -> ``[T, H, D]`` (pad tokens zeroed). CPU tensors
    take the plain version; CUDA tensors launch the kernel (f32 or bf16,
    D in {64, 128}) and every launch adds one to
    ``ragged_paged_attention.launches``; anything else raises."""
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_cache, v_cache, row_starts, row_lens, kv_lens, block_tables,
            scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda (kernel) or "
                         f"cpu (plain version), not {q.device}")
    meta = {"row_starts": row_starts, "row_lens": row_lens,
            "kv_lens": kv_lens, "block_tables": block_tables}
    _check_cuda(q, k_cache, v_cache, meta)
    T, H, D = q.shape
    R = row_starts.shape[0]
    if row_lens.shape != (R,) or kv_lens.shape != (R,) \
            or block_tables.dim() != 2 or block_tables.shape[0] != R:
        raise ValueError("row metadata shapes disagree")
    out = torch.empty_like(q)
    scale = float(scale if scale is not None else 1.0 / math.sqrt(D))
    fn = _kernel()
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            row_starts.data_ptr(), row_lens.data_ptr(), kv_lens.data_ptr(),
            block_tables.data_ptr(), out.data_ptr(), T, H, k_cache.shape[2],
            D, k_cache.shape[0], k_cache.shape[1], R, block_tables.shape[1],
            scale, _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
