"""Paged KV cache — fixed-size pages in a preallocated device pool.

The port of ``paddle_tpu/serving/kv_cache.py``: per-layer pools
``[num_pages, page_size, KVH, Dh]`` on the device, a per-request block table
of physical page ids, and a host-side refcounted free-list allocator.
Memory is bounded by tokens actually cached (rounded up to a page), so the
continuous-batching scheduler admits until the pool, not a batch shape, is
full.

Physical page 0 is reserved as the **scrap page**: pad tokens and unused
rows of a ragged round write there, so masked lanes have a legal target
without branching. The model's ragged branch updates the pools in place.
"""
from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["BlockAllocator", "PagedKVCache", "pages_for", "OutOfPages"]


class OutOfPages(RuntimeError):
    """The pool cannot satisfy an allocation (caller may evict + retry)."""


def pages_for(n_tokens, page_size):
    """Pages needed to hold ``n_tokens`` (ceil division; 0 tokens -> 0)."""
    return -(-int(n_tokens) // int(page_size))


class BlockAllocator:
    """Refcounted free-list page allocator over ``num_pages`` physical
    pages.

    Page ids ``[0, reserved)`` are never handed out (page 0 is the scrap
    page). Every live page carries a refcount (1 at :meth:`alloc`;
    :meth:`reuse_cached` adds readers — prefix-cache hits share one
    physical page).
    :meth:`free` drops one reader; the last reader returns the page to the
    free list, or parks it in a **reclaimable LRU** while a
    :class:`~.prefix_cache.PrefixCache` (``self.cache``) still indexes its
    content. :meth:`alloc` reclaims LRU-oldest reclaimable pages only when
    the free list is empty; a page with live readers is never reclaimed.
    """

    def __init__(self, num_pages, reserved=1):
        if num_pages <= reserved:
            raise ValueError(f"num_pages={num_pages} must exceed "
                             f"reserved={reserved}")
        self.num_pages = int(num_pages)
        self.reserved = int(reserved)
        # LIFO free list: recently-freed (still-warm) pages are reused first
        self._free = list(range(self.num_pages - 1, self.reserved - 1, -1))
        self._refs: dict[int, int] = {}      # page -> live reader count
        # refcount-0 pages still holding indexed prefix-cache content,
        # insertion order == LRU order (oldest first)
        self._reclaimable: dict[int, None] = {}
        self.cache = None                    # PrefixCache collaborator

    @property
    def capacity(self):
        """Allocatable pages (excludes the reserved scrap pages)."""
        return self.num_pages - self.reserved

    @property
    def free_pages(self):
        """Pages allocatable right now (truly free + reclaimable cached)."""
        return len(self._free) + len(self._reclaimable)

    @property
    def used_pages(self):
        """Pages held by live readers (cached-but-unreferenced excluded)."""
        return self.capacity - self.free_pages

    @property
    def cached_pages(self):
        """Refcount-0 pages parked for prefix-cache reuse."""
        return len(self._reclaimable)

    def shared_pages(self):
        """Pages with more than one live reader (prefix-shared)."""
        return sum(1 for rc in self._refs.values() if rc > 1)

    def occupancy_pct(self):
        return 100.0 * self.used_pages / self.capacity if self.capacity \
            else 0.0

    def can_alloc(self, n):
        return n <= self.free_pages

    def alloc(self, n):
        """-> list of ``n`` page ids, each with refcount 1; raises
        :class:`OutOfPages` when free + reclaimable pages are short
        (all-or-nothing). Reclaims LRU-oldest cached pages only after the
        free list is exhausted."""
        n = int(n)
        if n > self.free_pages:
            raise OutOfPages(
                f"need {n} page(s), {self.free_pages} free "
                f"of {self.capacity}")
        out = []
        for _ in range(n):
            if self._free:
                p = self._free.pop()
            else:
                p = next(iter(self._reclaimable))   # LRU oldest
                del self._reclaimable[p]
                if self.cache is not None:
                    self.cache.on_reclaim(p)
            self._refs[p] = 1
            out.append(p)
        return out

    def reuse_cached(self, page):
        """A prefix-cache hit on ``page``: add a reader, reactivating it
        from the reclaimable LRU if it was parked there. -> bool (False
        when the page is no longer available — stale index entry)."""
        page = int(page)
        if page in self._reclaimable:
            del self._reclaimable[page]
            self._refs[page] = 1
            return True
        rc = self._refs.get(page, 0)
        if rc > 0:
            self._refs[page] = rc + 1
            return True
        return False

    def free(self, pages):
        """Drop one reader per page. The last reader returns the page to
        the free list — or parks it in the reclaimable LRU when the
        prefix cache still indexes its content."""
        for p in pages:
            p = int(p)
            if p < self.reserved or p >= self.num_pages:
                raise ValueError(f"page {p} outside allocatable range")
            rc = self._refs.get(p, 0)
            if rc <= 0:
                raise ValueError(f"double free of page {p}")
            if rc > 1:
                self._refs[p] = rc - 1
                continue
            del self._refs[p]
            if self.cache is not None and self.cache.holds(p):
                self._reclaimable[p] = None     # newest = LRU tail
            else:
                self._free.append(p)


class PagedKVCache:
    """Per-layer K/V page pools on the device + the allocator that parcels
    them out. ``k[l]`` / ``v[l]`` are tensors ``[num_pages, page_size, KVH,
    Dh]`` (``KVH`` is the model's KV head count, so GQA pools are H/KVH
    smaller). The model's ragged and paged branches write them in place;
    this class writes a dense prefill's K/V (:meth:`write_prefill`)."""

    def __init__(self, num_layers, num_pages, page_size, num_heads,
                 head_dim, dtype=torch.float32, reserved=1, device=None):
        self.num_layers = int(num_layers)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.device = resolve_device(device)
        shape = (self.num_pages, self.page_size, self.num_heads,
                 self.head_dim)
        self.k = [torch.zeros(shape, dtype=dtype, device=self.device)
                  for _ in range(self.num_layers)]
        self.v = [torch.zeros(shape, dtype=dtype, device=self.device)
                  for _ in range(self.num_layers)]
        self.allocator = BlockAllocator(num_pages, reserved=reserved)

    def nbytes(self):
        return 2 * self.num_layers * self.k[0].numel() \
            * self.k[0].element_size()

    def occupancy_pct(self):
        return self.allocator.occupancy_pct()

    def write_prefill(self, layer, k_new, v_new, pages, length):
        """Write one request's prefill K/V (``[S, KVH, Dh]`` with
        ``S >= length``; rows past ``length`` are padding and dropped) into
        its ``pages`` (a list of page ids, or a long tensor of them on the
        pools' device). The tail of the last page is written with zeros,
        as the JAX package pads it; reads are masked by the context
        anyway."""
        n = len(pages)
        cap = n * self.page_size
        if length > cap:
            raise ValueError(f"{length} tokens > {n} page capacity {cap}")
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for pools, new in ((self.k, k_new), (self.v, v_new)):
            arr = torch.zeros((cap, self.num_heads, self.head_dim),
                              dtype=self.dtype, device=self.device)
            arr[:length] = new[:length]
            pools[layer][idx] = arr.view(n, self.page_size, self.num_heads,
                                         self.head_dim)

    def write_prefill_rows(self, layer, k_new, v_new, block_tables,
                           lengths):
        """:meth:`write_prefill` for a batch of rows on the device, with no
        host read (a captured graph runs it): ``k_new``/``v_new`` [nb, S,
        KVH, Dh], ``block_tables`` [nb, P] (each row's pages, 0 past them),
        ``lengths`` [nb]. Row ``b``'s first ``lengths[b]`` tokens go into
        its pages and the rest of its ``P`` pages are written with zeros,
        as :meth:`write_prefill` writes them. Table entries past a row's
        pages, and the whole table of a pad row (length 0), name the
        reserved scrap page 0, which takes zeros only (never read)."""
        nb, S = k_new.shape[:2]
        P = block_tables.shape[1]
        cap = P * self.page_size
        if cap < S:
            raise ValueError(f"{S} tokens a row > {P} pages' capacity {cap}")
        drop = torch.arange(cap, device=self.device)[None, :] \
            >= lengths.long()[:, None]
        idx = block_tables.long().reshape(-1)
        for pools, new in ((self.k, k_new), (self.v, v_new)):
            arr = torch.zeros((nb, cap, self.num_heads, self.head_dim),
                              dtype=self.dtype, device=self.device)
            arr[:, :S] = new
            arr.masked_fill_(drop[:, :, None, None], 0)
            pools[layer][idx] = arr.view(nb * P, self.page_size,
                                         self.num_heads, self.head_dim)

    def gather(self, layer, pages, length, which="k"):
        """Debug/test readback: the first ``length`` tokens of a request's
        pages as one dense ``[length, KVH, Dh]`` tensor."""
        pool = (self.k if which == "k" else self.v)[layer]
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        return pool[idx].reshape(-1, self.num_heads, self.head_dim)[:length]
