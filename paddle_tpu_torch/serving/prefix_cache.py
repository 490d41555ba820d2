"""Prefix cache — content-addressed KV page sharing across requests.

A copy of ``paddle_tpu/serving/prefix_cache.py`` (host-side, no device
code). Reference capability: vLLM's automatic prefix caching / SGLang's
RadixAttention over the paged pool: thousands of requests sharing a
system-prompt head should prefill it ONCE.

Design — a **page-granular trie** over token content:

* Every *full* page of a prefilled prompt is indexed under the key
  ``(parent_page, page_tokens)`` — the parent link makes the index a trie
  whose path from the root spells out the whole token prefix, so a hit on
  page *i* guarantees the entire preceding context matches (KV content is
  position- and prefix-dependent; a raw per-page hash would alias).
* :meth:`lookup` walks the trie at admission and returns the longest run
  of cached full pages (**capped at ``len(prompt) - 1`` tokens** so the
  last prompt token is always computed — its logits produce the first
  generated token). Hit pages get a reader refcount via the allocator;
  the request chains its private tail pages after them.
* **Copy-on-write at page granularity**: only FULL pages are ever shared,
  and writes only target positions past the shared head — the first
  divergent (or partial-tail) token lands in a freshly-allocated private
  page, never in a shared one. Shared pages are structurally read-only.
* **Refcount-aware reclamation**: a released page whose content is still
  indexed parks in the allocator's reclaimable LRU instead of the free
  list; the pool reclaims LRU-oldest *refcount-0* pages when dry and
  calls :meth:`on_reclaim` so the index drops the page (and its now
  unreachable subtree). Pages with live readers are never reclaimed.

Host-side and model-agnostic, like the scheduler. One instance serves one
engine; page ids are shared across layers (every layer's pool is indexed
by the same block table), so sharing one page id shares all layers' KV.
"""
from __future__ import annotations

__all__ = ["PrefixCache"]

_ROOT = -1


class PrefixCache:
    """Trie index of cached KV pages over the engine's BlockAllocator."""

    def __init__(self, allocator, page_size):
        self.allocator = allocator
        allocator.cache = self
        self.page_size = int(page_size)
        self._index = {}     # (parent_page, tokens tuple) -> page id
        self._entry = {}     # page id -> its key in _index
        self._children = {}  # page id -> set of keys whose parent it is
        # counters (request-level hit/miss + token/page volume)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.reclaimed_pages = 0

    # ------------------------------------------------------------- queries
    def holds(self, page):
        """Is this page's content still indexed? (Allocator consults this
        on last-reader free to park the page in the reclaimable LRU.)"""
        return int(page) in self._entry

    def hit_rate(self):
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    # -------------------------------------------------------------- lookup
    def lookup(self, tokens):
        """Longest cached full-page head of ``tokens`` -> (pages, n_tokens)
        with one reader refcount taken on every returned page (release
        with ``allocator.free`` if admission then fails). Capped so at
        least the last prompt token is left to compute. Does NOT touch
        the hit/miss counters — call :meth:`record` once the admission
        actually goes through."""
        ps = self.page_size
        max_hit_pages = (len(tokens) - 1) // ps
        node, pages = _ROOT, []
        for i in range(max_hit_pages):
            key = (node, tuple(tokens[i * ps:(i + 1) * ps]))
            page = self._index.get(key)
            if page is None:
                break
            if not self.allocator.reuse_cached(page):
                # the page slipped out from under the index (defensive:
                # on_reclaim should have dropped this entry) — drop it now
                self._drop_entry(key, page)
                break
            pages.append(page)
            node = page
        return pages, len(pages) * ps

    def record(self, n_shared_tokens):
        """Count one admitted request against the hit/miss totals."""
        if n_shared_tokens > 0:
            self.hits += 1
            self.hit_tokens += int(n_shared_tokens)
        else:
            self.misses += 1

    # -------------------------------------------------------------- insert
    def insert(self, tokens, pages):
        """Index every full page of a freshly-prefilled prompt (the
        request keeps its own refcount; future lookups add readers).
        Re-inserting an already-indexed chain is a no-op per page — the
        first owner's pages stay canonical, and a duplicate page holding
        identical content simply goes unindexed (it frees normally)."""
        ps = self.page_size
        node = _ROOT
        for i in range(len(tokens) // ps):
            key = (node, tuple(tokens[i * ps:(i + 1) * ps]))
            existing = self._index.get(key)
            if existing is not None:
                node = existing
                continue
            page = int(pages[i])
            if page in self._entry:
                # a page is indexed under at most one key (content is
                # unique per chain position); keep the first
                node = page
                continue
            self._index[key] = page
            self._entry[page] = key
            self._children.setdefault(node, set()).add(key)
            node = page

    # --------------------------------------------------------- reclamation
    def clear(self):
        """Drop EVERY index entry and zero the counters (bench/test
        isolation: a warm-up run's pages must not seed the measured
        run's cache). Pages themselves are untouched — live readers keep
        their refcounts, and already-parked reclaimable pages simply
        stop being hits and drift to the free list as they recycle."""
        self._index.clear()
        self._entry.clear()
        self._children.clear()
        self.hits = self.misses = self.hit_tokens = 0
        self.reclaimed_pages = 0

    def _drop_entry(self, key, page):
        self._index.pop(key, None)
        self._entry.pop(page, None)
        parent = key[0]
        kids = self._children.get(parent)
        if kids is not None:
            kids.discard(key)
            if not kids:
                del self._children[parent]

    def on_reclaim(self, page):
        """The allocator repurposed a reclaimable page: drop its index
        entry AND its whole subtree — descendants' chains run through
        this page, and a later re-index of the reused page id under new
        content must not resurrect them as false hits."""
        stack = [int(page)]
        while stack:
            p = stack.pop()
            key = self._entry.get(p)
            if key is not None:
                self._drop_entry(key, p)
            for k in self._children.pop(p, ()):  # subtree unreachable
                child = self._index.get(k)
                if child is None:
                    self._index.pop(k, None)
                    continue
                # route through _drop_entry: subclasses may hook it
                self._drop_entry(k, child)
                stack.append(child)
        self.reclaimed_pages += 1
