"""Paged KV-cache pool: block allocator + radix prefix index (host side).

The port's own copy of ``repro.launch.kvpool`` (plain Python/numpy — no
device arrays flow through it), without the host-RAM spill tier, which is
not ported yet:

* **Free-list allocator with refcounts** — ``alloc`` hands out pages with
  refcount 1; ``retain``/``release`` move shared pages up and down.  A page
  whose refcount hits 0 returns to the free list unless a radix node still
  owns it, in which case it stays resident as reusable cache until evicted.
* **Radix (trie) prefix index** — prompts split into full ``page_size``
  chunks; each trie edge is one chunk's token tuple and each node owns the
  page holding that chunk's K/V.  Roots are keyed by a fingerprint of the
  pool's byte semantics (``nldpe_fingerprint``), so pages written under
  one numerics mode are never served to another.
* **LRU eviction** — when the free list runs dry, ``alloc`` evicts
  leaf-most radix nodes whose pages have refcount 0, least recently used
  first.

Copy-on-write is a protocol with the engine: when cached pages cover the
whole prompt, the engine forks the boundary page (``alloc`` + device copy
+ ``note_cow``) instead of writing into the shared original.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


def nldpe_fingerprint(nldpe, kv_quant: str | None = None) -> tuple:
    """Stable, hashable fingerprint of the pool's byte semantics: the
    NLDPEConfig (nested dataclasses flattened recursively to sorted
    (name, value) tuples, lists to tuples) and the KV storage grid.  Two
    configs with the same fingerprint produce bit-identical cached K/V for
    the same tokens, which is what radix prefix sharing requires — so an
    fp pool and a quantized one (or "int8" and "log8"), whose bytes mean
    different things, never share a root."""
    def flat(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return tuple(sorted(
                (f.name, flat(getattr(x, f.name)))
                for f in dataclasses.fields(x)))
        if isinstance(x, (list, tuple)):
            return tuple(flat(v) for v in x)
        return x
    return (("kv_quant", kv_quant), ("nldpe", flat(nldpe)))


class RadixNode:
    """One full-page chunk of a published prompt; ``page`` is the physical
    page holding this chunk's K/V in every layer pool (-1 for a root)."""

    __slots__ = ("key", "page", "parent", "children", "last_use")

    def __init__(self, key: tuple, page: int, parent: "RadixNode | None"):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: dict[tuple, RadixNode] = {}
        self.last_use = 0


class PagePool:
    """Block-pool allocator + radix prefix index for a paged KV cache.

    ``num_pages`` is the physical capacity shared by every layer (page
    ``i`` holds block data in layer ``l``'s pool row ``i`` for all ``l``).
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError("num_pages and page_size must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: deque[int] = deque(range(num_pages))
        self._ref = np.zeros(num_pages, np.int64)
        self._node: list[RadixNode | None] = [None] * num_pages
        self._roots: dict[tuple, RadixNode] = {}
        self._clock = 0
        self.stats = {"lookups": 0, "hits": 0, "hit_pages": 0,
                      "prefill_tokens_saved": 0, "evicted": 0,
                      "cow_forks": 0, "published": 0, "gen_published": 0}
        # observation hook: called with the page id after each LRU
        # eviction (the page is already free, so it cannot steer eviction)
        self.on_evict = None

    # -- allocation / refcounts ---------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def _evictable_in(self, root: RadixNode) -> tuple[int, bool]:
        """Post-order walk: (evictable pages under ``root`` inclusive,
        does the subtree hold a referenced page).  A cached refcount-0 page
        is reclaimable only if its whole subtree is refcount 0 too (eviction
        frees leaves first).  Iterative: radix chains can be deeper than
        the recursion limit."""
        out: dict[int, tuple[int, bool]] = {}
        stack: list[tuple[RadixNode, bool]] = [(root, False)]
        while stack:
            node, expanded = stack.pop()
            if not expanded:
                stack.append((node, True))
                stack.extend((c, False) for c in node.children.values())
                continue
            evictable = 0
            referenced = False
            for c in node.children.values():
                e, r = out.pop(id(c))
                evictable += e
                referenced |= r
            if node.page >= 0:
                if self._ref[node.page] > 0:
                    referenced = True
                elif not referenced:
                    evictable += 1
            out[id(node)] = (evictable, referenced)
        return out[id(root)]

    @property
    def cached_pages(self) -> int:
        """Radix-cached refcount-0 pages eviction can actually reclaim."""
        return sum(self._evictable_in(root)[0]
                   for root in self._roots.values())

    def available(self) -> int:
        """Pages obtainable right now: free + evictable cache."""
        return self.free_pages + self.cached_pages

    def alloc(self, n: int) -> list[int] | None:
        """Allocate ``n`` pages (refcount 1 each), evicting LRU cache pages
        as needed; None (allocating nothing) if the pool cannot."""
        if n < 0:
            raise ValueError("alloc(n < 0)")
        if self.available() < n:
            return None
        pages = []
        for _ in range(n):
            if not self._free and self._evict_lru() is None:
                self._free.extend(pages)
                return None
            pages.append(self._free.popleft())
        for p in pages:
            assert self._ref[p] == 0 and self._node[p] is None
            self._ref[p] = 1
        return pages

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def retain(self, pages) -> None:
        for p in pages:
            self._ref[p] += 1

    def release(self, pages) -> None:
        """Drop one reference per page; unreferenced pages return to the
        free list unless a radix node keeps them resident as cache."""
        for p in pages:
            if self._ref[p] <= 0:
                raise ValueError(f"release of unreferenced page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0 and self._node[p] is None:
                self._free.append(p)

    def note_cow(self) -> None:
        """Record one copy-on-write fork (the device copy is the engine's)."""
        self.stats["cow_forks"] += 1

    # -- radix prefix index ---------------------------------------------------

    def _root(self, fingerprint: tuple) -> RadixNode:
        if fingerprint not in self._roots:
            self._roots[fingerprint] = RadixNode((), -1, None)
        return self._roots[fingerprint]

    def _chunks(self, tokens) -> list[tuple]:
        ps = self.page_size
        return [tuple(tokens[i * ps:(i + 1) * ps])
                for i in range(len(tokens) // ps)]

    def match(self, fingerprint: tuple, tokens, *,
              peek: bool = False) -> list[int]:
        """Pages of the longest published full-page prefix of ``tokens``.
        The caller must ``retain`` them before the next ``alloc``.
        ``peek=True`` skips the LRU bump and the hit statistics."""
        node = self._roots.get(fingerprint)
        nodes: list[RadixNode] = []
        if node is not None:
            for chunk in self._chunks(tokens):
                node = node.children.get(chunk)
                if node is None:
                    break
                nodes.append(node)
        if not peek:
            self._clock += 1
            for nd in nodes:
                nd.last_use = self._clock
            self.stats["lookups"] += 1
            if nodes:
                self.stats["hits"] += 1
                self.stats["hit_pages"] += len(nodes)
        return [nd.page for nd in nodes]

    def publish(self, fingerprint: tuple, tokens, pages) -> None:
        """Insert the full-page chunks of ``tokens``, chunk ``i`` backed by
        ``pages[i]``.  Chunks already published keep their original page
        (the duplicate stays private to its slot).  Published pages must be
        live; the index keeps them resident after release until evicted."""
        node = self._root(fingerprint)
        self._clock += 1
        for chunk, page in zip(self._chunks(tokens), pages):
            child = node.children.get(chunk)
            if child is None:
                if self._ref[page] <= 0:
                    raise ValueError(f"publish of dead page {page}")
                if self._node[page] is not None:
                    raise ValueError(f"page {page} already published")
                child = RadixNode(chunk, page, node)
                node.children[chunk] = child
                self._node[page] = child
                self.stats["published"] += 1
            child.last_use = self._clock
            node = child

    def publish_committed(self, fingerprint: tuple, tokens, pages,
                          committed_len: int | None = None) -> None:
        """Publish a finished request's committed sequence as reusable
        prefix cache (the provisional-length publish of speculative
        decoding).  ``tokens``/``pages`` may run past ``committed_len``
        (default ``len(tokens)``): a speculating slot's pages also hold
        drafted-but-unverified K/V.  Only pages whose every position lies
        below the committed length enter the radix index; the rest stay
        private to the slot and return to the free list on release."""
        if committed_len is None:
            committed_len = len(tokens)
        if committed_len < 0 or committed_len > len(tokens):
            raise ValueError(
                f"committed_len={committed_len} outside [0, {len(tokens)}]")
        n_full = committed_len // self.page_size
        before = self.stats["published"]
        self.publish(fingerprint, tokens[:n_full * self.page_size],
                     pages[:n_full])
        self.stats["gen_published"] += self.stats["published"] - before

    # -- LRU eviction -----------------------------------------------------------

    def _evict_lru(self) -> int | None:
        victim = min((nd for nd in self._node
                      if nd is not None and self._ref[nd.page] == 0
                      and not nd.children),
                     default=None, key=lambda nd: nd.last_use)
        if victim is None:
            return None
        page = victim.page
        del victim.parent.children[victim.key]
        self._node[page] = None
        self._free.append(page)
        self.stats["evicted"] += 1
        if self.on_evict is not None:
            self.on_evict(page)
        return page

    # -- invariants (tests call this after every trace) ---------------------------

    def check(self) -> None:
        """Every page is exactly one of: free, referenced, radix-cached."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate free-list entries"
        for p in range(self.num_pages):
            ref = int(self._ref[p])
            node = self._node[p]
            assert ref >= 0
            if p in free:
                assert ref == 0 and node is None, f"freed page {p} still live"
            if node is not None:
                assert node.page == p and p not in free
        for root in self._roots.values():
            stack = list(root.children.values())
            while stack:
                node = stack.pop()
                assert self._node[node.page] is node
                stack.extend(node.children.values())
