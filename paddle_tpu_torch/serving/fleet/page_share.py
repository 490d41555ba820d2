"""Cross-engine prefix-cache sharing — the fleet-wide page trie.

The port of ``paddle_tpu/serving/fleet/page_share.py``. One engine's
:class:`~..prefix_cache.PrefixCache` is per-process: every replica would
prefill the same system prompt once. This module makes the trie
fleet-wide:

* **Content-addressed chain keys** — page *i* of a prompt is published
  under ``h_i = H(h_{i-1}, page_tokens)``, the store-key mirror of the
  local trie's ``(parent_page, page_tokens)`` key: a hit on ``h_i``
  guarantees the whole preceding context matches, and the key is the
  same on every engine whatever its local page ids. Because the key *is*
  the content, a fetched payload can never be wrong for its key.
* **Publish at insert** — when a prompt finishes prefilling, its first
  ``max_publish_pages`` full pages are pushed through the TCPStore
  (``pshare/<job>/pg/<h>`` payload + ``idx/<h>`` owner record), deduped
  by a check-first write.
* **Import on local miss** — :meth:`SharedPrefixCache.lookup` walks the
  local trie first; where it runs out it continues the chain against the
  store: fetch the payload, allocate a LOCAL page, write it into this
  engine's pools, and index it locally — from then on it is an ordinary
  refcounted/copy-on-write page.
* **Invalidation rides on_reclaim** — when the allocator repurposes a
  page this engine published, the index entry (and payload) is removed
  from the store; readers mid-fetch fall back to a miss.

A payload is one page's K and V over every layer, ``[2, L, page_size,
KVH, Dh]`` in C order, as the raw bytes of the pools' dtype: the JAX
package's payload of the same pages is the same bytes (bf16 included,
which JAX writes through ``ml_dtypes``). On the device:

* a publish gathers the page's ``2 L`` slices into one device tensor and
  copies it once into a pinned host buffer (a copy on the current
  stream, the one the engine's rounds run on, waited on by the host),
  synchronously inside :meth:`SharedPrefixCache.insert`, as in JAX;
* an import copies the payload to the device and writes each layer's
  slice into ``kv.k[l][page]`` / ``kv.v[l][page]`` in place (``copy_``):
  the round programs of :mod:`..compiled` are CUDA graphs that read the
  pools' storage, so a rebound pool would never be read again.

Both run inside the engine's rounds or under its step lock (admission,
``insert`` at prompt completion, :meth:`~..engine.ServingEngine.
prefetch_prefix`), so they are ordered against every round.

The store is any TCPStore-shaped object (``set/get/check/add/
delete_key``) — a plain :class:`TCPStore`, a :class:`FailoverStore`, or
a test double.
"""
from __future__ import annotations

import hashlib
import json
import math
import threading
import time

import torch

from ...distributed import keyspace
from ..prefix_cache import _ROOT, PrefixCache

__all__ = ["PageShareClient", "SharedPrefixCache"]


def chain_hash(parent_hash, tokens):
    """Content-addressed chain key: the store-side mirror of the local
    trie's (parent page, page tokens) key."""
    h = hashlib.sha1()
    h.update(str(parent_hash).encode())
    h.update(b"|")
    h.update(",".join(str(int(t)) for t in tokens).encode())
    return h.hexdigest()


class PageShareClient:
    """Store frontend for one engine's published/imported pages."""

    def __init__(self, store, engine_id, job="fleet",
                 max_publish_pages=8, fetch_timeout=3.0):
        if engine_id is None:
            raise ValueError("page sharing needs an engine_id — the "
                             "index records which engine owns each page")
        self.store = store
        self.engine_id = str(engine_id)
        self.prefix = keyspace.page_share(job)
        self.max_publish_pages = int(max_publish_pages)
        self.fetch_timeout = float(fetch_timeout)
        # counters (engine.stats() and the registry records read these)
        self.published = 0
        self.unpublished = 0
        self.remote_hits = 0          # requests that imported >= 1 page
        self.remote_hit_tokens = 0
        self.stale_misses = 0
        # deferred invalidation: reclaim runs inside the engine's round,
        # and an unpublish costs store round trips (plus the lease
        # grace), so the drop enqueues here and a daemon drains it
        self._unpub_queue: list = []
        self._unpub_lock = threading.Lock()
        self._unpub_thread = None
        # one store client shared by the engine thread and the unpublish
        # daemon: the client is not thread-safe, so ops serialize here
        self._store_lock = threading.Lock()

    def _k(self, kind, h):
        return f"{self.prefix}/{kind}/{h}"

    def unpublish_async(self, h):
        """Queue an invalidation; a lazy daemon drains it off the
        caller's (hot) path."""
        with self._unpub_lock:
            self._unpub_queue.append(h)
            if self._unpub_thread is None or \
                    not self._unpub_thread.is_alive():
                self._unpub_thread = threading.Thread(
                    target=self._drain_unpublish, daemon=True,
                    name=f"pshare-unpub-{self.engine_id}")
                self._unpub_thread.start()

    def _drain_unpublish(self):
        while True:
            with self._unpub_lock:
                if not self._unpub_queue:
                    return
                h = self._unpub_queue.pop(0)
            self.unpublish(h)

    def drain_unpublish(self, timeout=5.0):
        """Block until the deferred invalidations have landed."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._unpub_lock:
                t = self._unpub_thread
                if not self._unpub_queue and (t is None
                                              or not t.is_alive()):
                    return True
            time.sleep(0.01)
        return False

    def publish(self, h, payload: bytes) -> bool:
        """First-writer-wins publication of one page's KV content. The
        payload lands BEFORE the index entry, so a reader that sees the
        index never races a missing payload."""
        try:
            with self._store_lock:
                if self.store.check(self._k("idx", h)):
                    return False
                self.store.set(self._k("pg", h), payload)
                self.store.set(self._k("idx", h),
                               json.dumps({"engine": self.engine_id}))
        except Exception:
            return False  # publication is best-effort: serving goes on
        self.published += 1
        return True

    def fetch(self, h):
        """Payload bytes for chain key ``h`` published by ANOTHER engine,
        or None (unpublished / our own entry / invalidated mid-flight).
        The lease counter brackets the read so an owner invalidating can
        see in-flight readers."""
        try:
            with self._store_lock:
                if not self.store.check(self._k("idx", h)):
                    return None
                owner = json.loads(self.store.get(
                    self._k("idx", h), timeout=self.fetch_timeout))
                if owner.get("engine") == self.engine_id:
                    return None  # our own entry: the local trie covers it
                self.store.add(self._k("lease", h), 1)
                try:
                    if not self.store.check(self._k("pg", h)):
                        self.stale_misses += 1
                        return None
                    return self.store.get(self._k("pg", h),
                                          timeout=self.fetch_timeout)
                finally:
                    self.store.add(self._k("lease", h), -1)
        except Exception:
            self.stale_misses += 1
            return None

    def unpublish(self, h, lease_grace=0.5):
        """Invalidate one published entry (the owner's page was
        reclaimed): index first — no NEW reader can start — then wait
        (bounded) for in-flight leases to drain before the payload goes;
        stragglers past the grace see the payload gone and miss."""
        try:
            with self._store_lock:
                owner = None
                if self.store.check(self._k("idx", h)):
                    owner = json.loads(self.store.get(
                        self._k("idx", h), timeout=self.fetch_timeout))
                if owner is None \
                        or owner.get("engine") != self.engine_id:
                    return False
                self.store.delete_key(self._k("idx", h))
            deadline = time.monotonic() + float(lease_grace)
            while True:
                with self._store_lock:
                    n = int(self.store.add(self._k("lease", h), 0))
                if n <= 0 or time.monotonic() >= deadline:
                    break
                time.sleep(0.02)
            with self._store_lock:
                self.store.delete_key(self._k("pg", h))
                self.store.delete_key(self._k("lease", h))
        except Exception:
            return False
        self.unpublished += 1
        return True


class SharedPrefixCache(PrefixCache):
    """A :class:`PrefixCache` whose trie extends across the fleet.

    Locally identical to the base cache; the delta is at the edges:

    * :meth:`insert` additionally publishes the chain's first
      ``max_publish_pages`` pages through the share client;
    * :meth:`lookup` continues a broken local walk against the published
      index, importing remote pages into the local pools;
    * a reclaimed local page that this engine published is unpublished
      through the same ``_drop_entry`` funnel the base cache uses.
    """

    def __init__(self, kv, page_size, share: PageShareClient):
        super().__init__(kv.allocator, page_size)
        self.kv = kv
        self.share = share
        self._published: dict[int, str] = {}   # local page -> chain hash
        self._host = None     # the publish's host buffer (pinned on CUDA)

    # ---------------------------------------------------------- payloads
    def _payload_shape(self):
        kv = self.kv
        return (2, kv.num_layers, kv.page_size, kv.num_heads, kv.head_dim)

    def _page_payload(self, page) -> bytes:
        """One page's KV across all layers as bytes, ``[2, L, page_size,
        KVH, Dh]`` in the pools' dtype: the page's ``2 L`` slices gathered
        into one device tensor, copied once to the host."""
        kv = self.kv
        shape = self._payload_shape()
        dense = torch.stack([pools[layer][page] for pools in (kv.k, kv.v)
                             for layer in range(kv.num_layers)])
        if self._host is None:
            self._host = torch.empty(shape, dtype=kv.dtype, pin_memory=(
                kv.device.type == "cuda"))
        self._host.view(dense.shape).copy_(dense)
        return self._host.view(torch.uint8).numpy().tobytes()

    def _write_page(self, page, payload: bytes) -> bool:
        """Write a payload into local page ``page`` of every layer's pools,
        in place. False (nothing written) when its size is not this
        engine's page: a foreign or corrupt payload is a miss."""
        kv = self.kv
        shape = self._payload_shape()
        nbytes = math.prod(shape) * torch.empty(
            (), dtype=kv.dtype).element_size()
        if len(payload) != nbytes:
            return False
        arr = torch.frombuffer(bytearray(payload), dtype=kv.dtype) \
            .view(shape).to(kv.device)
        for layer in range(kv.num_layers):
            kv.k[layer][page].copy_(arr[0, layer])
            kv.v[layer][page].copy_(arr[1, layer])
        return True

    # ------------------------------------------------------------ insert
    def insert(self, tokens, pages):
        super().insert(tokens, pages)
        ps = self.page_size
        node, h = _ROOT, "root"
        for i in range(min(len(tokens) // ps,
                           self.share.max_publish_pages)):
            seg = tuple(tokens[i * ps:(i + 1) * ps])
            h = chain_hash(h, seg)
            page = self._index.get((node, seg))
            if page is None:
                break
            if page not in self._published:
                if self.share.publish(h, self._page_payload(page)):
                    self._published[page] = h
            node = page

    # ------------------------------------------------------------ lookup
    def lookup(self, tokens):
        pages, n = super().lookup(tokens)
        ps = self.page_size
        max_hit_pages = (len(tokens) - 1) // ps
        if len(pages) >= max_hit_pages:
            return pages, n
        # continue the chain remotely: recompute the hashes over the
        # locally-covered head, then import page by page until the
        # published chain (or this pool's capacity) runs out
        h = "root"
        imported = 0
        for i in range(max_hit_pages):
            seg = tuple(tokens[i * ps:(i + 1) * ps])
            h = chain_hash(h, seg)
            if i < len(pages):
                continue
            payload = self.share.fetch(h)
            if payload is None:
                break
            try:
                page = self.allocator.alloc(1)[0]
            except Exception:
                break  # pool full: serve what we have
            if not self._write_page(page, payload):
                self.allocator.free([page])
                break
            parent = pages[i - 1] if i > 0 else _ROOT
            key = (parent, seg)
            self._index[key] = page
            self._entry[page] = key
            self._children.setdefault(parent, set()).add(key)
            pages.append(page)
            imported += 1
        if imported:
            self.share.remote_hits += 1
            self.share.remote_hit_tokens += imported * ps
        return pages, len(pages) * ps

    # ------------------------------------------------------ invalidation
    def _drop_entry(self, key, page):
        super()._drop_entry(key, page)
        h = self._published.pop(int(page), None)
        if h is not None:
            # reclaim runs inside the engine's round: defer the store
            # round trips (the keys are content-addressed)
            self.share.unpublish_async(h)

    def clear(self):
        for h in list(self._published.values()):
            self.share.unpublish(h)
        self._published.clear()
        self.share.drain_unpublish()
        super().clear()
