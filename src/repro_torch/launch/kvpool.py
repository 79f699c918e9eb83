"""Paged KV-cache pool: block allocator + radix prefix index (host side).

The port's own copy of ``repro.launch.kvpool`` (plain Python/numpy — no
device arrays flow through it):

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
* **Host-RAM spill tier** (DESIGN.md §13) — with ``host_pages > 0`` and an
  ``on_spill`` hook installed, eviction *demotes* instead of destroying:
  the hook copies the page's device bytes to the host (a real copy, never
  a view of the device pool, which the next chunk or decode overwrites in
  place) and the node stays in the index marked SPILLED (``page == -1``,
  ``payload`` holding the host copy).  ``match_tiers`` reports spilled
  continuation nodes so admission can restore them host->device into
  freshly allocated pages before publish.  On any root-to-leaf path,
  device-resident nodes strictly precede spilled ones (spills move leaf
  first up, restores top down), so a restored prefix is always contiguous
  from the root.  The host tier is LRU-bounded too; spilled nodes an
  in-flight admission has matched are ``pinned`` until restored.

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
    """One full-page chunk of a published prompt.  ``page`` is the physical
    page holding this chunk's K/V in every layer pool.

    A node is in exactly one of three states:

    * **root** — ``page == -1``, ``payload is None`` (holds no data);
    * **resident** — ``page >= 0``, ``payload is None`` (device tier);
    * **spilled** — ``page == -1``, ``payload`` holds the host-side copy of
      the page's bytes (one host tensor per pool leaf, real copies).

    ``pinned`` marks a spilled node an in-flight admission has matched and
    will restore: host-tier LRU eviction must not destroy it in between.
    """

    __slots__ = ("key", "page", "parent", "children", "last_use",
                 "payload", "pinned")

    def __init__(self, key: tuple, page: int, parent: "RadixNode | None"):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: dict[tuple, RadixNode] = {}
        self.last_use = 0
        self.payload = None
        self.pinned = False


class PagePool:
    """Block-pool allocator + radix prefix index for a paged KV cache.

    One instance manages the page ids of one engine's per-layer pool
    arrays; ``num_pages`` is the physical capacity shared by every layer
    (page ``i`` holds block data in layer ``l``'s pool row ``i`` for all
    ``l``).
    """

    def __init__(self, num_pages: int, page_size: int,
                 host_pages: int = 0):
        if num_pages < 1 or page_size < 1:
            raise ValueError("num_pages and page_size must be >= 1")
        if host_pages < 0:
            raise ValueError("host_pages must be >= 0")
        self.num_pages = num_pages
        self.page_size = page_size
        self.host_pages = host_pages
        self._free: deque[int] = deque(range(num_pages))
        self._ref = np.zeros(num_pages, np.int64)
        self._node: list[RadixNode | None] = [None] * num_pages
        self._roots: dict[tuple, RadixNode] = {}
        self._spilled: set[RadixNode] = set()
        self._host_used = 0
        self._clock = 0
        self.stats = {"lookups": 0, "hits": 0, "hit_pages": 0,
                      "prefill_tokens_saved": 0, "evicted": 0,
                      "cow_forks": 0, "published": 0, "gen_published": 0,
                      "spilled": 0, "restored": 0, "readopted": 0,
                      "spill_dropped": 0, "host_evicted": 0}
        # observation hook (DESIGN.md §12): called with the page id after
        # each LRU eviction.  Pure notification — by the time it fires the
        # page is already freed, so a callback cannot influence which page
        # was chosen or whether eviction happened.
        self.on_evict = None
        # spill hook (DESIGN.md §13): called with the page id while its
        # device bytes are still resident — the engine must return the host
        # copy (a list of host tensors, real copies) or None to decline
        # the spill (the page is then destroyed as before).  Fires BEFORE
        # the page is freed; ``on_evict`` still fires after, on both the
        # spill and destroy paths.
        self.on_spill = None

    # ------------------------------------------------------------------
    # allocation / refcounts
    # ------------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def host_used(self) -> int:
        """Spilled nodes currently holding a host-tier payload."""
        return self._host_used

    def _evictable_in(self, root: RadixNode) -> tuple[int, bool]:
        """Post-order walk: (evictable pages under ``root`` inclusive,
        does the subtree contain a referenced page).  A cached refcount-0
        page is reclaimable only if *every* page in its descendant subtree
        is also refcount 0 — ``_evict_lru`` frees leaves first, so an
        interior node above a referenced page can never become a leaf.
        Iterative (explicit stack): radix chains are as deep as one
        published prompt's page count, which can exceed the recursion
        limit."""
        out: dict[int, tuple[int, bool]] = {}       # node id -> result
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
            if node.page >= 0:                      # roots hold no page
                if self._ref[node.page] > 0:
                    referenced = True
                elif not referenced:
                    evictable += 1
            out[id(node)] = (evictable, referenced)
        return out[id(root)]

    @property
    def cached_pages(self) -> int:
        """Radix-cached refcount-0 pages that eviction can actually
        reclaim (their whole descendant subtree is refcount 0 too)."""
        return sum(self._evictable_in(root)[0]
                   for root in self._roots.values())

    def available(self) -> int:
        """Pages obtainable right now: free + evictable cache."""
        return self.free_pages + self.cached_pages

    def alloc(self, n: int) -> list[int] | None:
        """Allocate ``n`` pages (refcount 1 each), evicting LRU cache pages
        as needed.  Returns None — allocating nothing — if the pool cannot
        satisfy the request even after evicting every reclaimable page."""
        if n < 0:
            raise ValueError("alloc(n < 0)")
        if self.available() < n:
            return None
        pages = []
        for _ in range(n):
            if not self._free and self._evict_lru() is None:
                # defensive: available() promised this fits, but never
                # crash mid-serve — hand back what we took and report
                # exhaustion so admission defers the request instead
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
        """Drop one reference per page.  Unreferenced pages return to the
        free list unless a radix node keeps them resident as cache."""
        for p in pages:
            if self._ref[p] <= 0:
                raise ValueError(f"release of unreferenced page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0 and self._node[p] is None:
                self._free.append(p)

    def note_cow(self) -> None:
        """Record one copy-on-write fork (the device copy happens in the
        engine; the fork's page came from ``alloc``)."""
        self.stats["cow_forks"] += 1

    # ------------------------------------------------------------------
    # radix prefix index
    # ------------------------------------------------------------------

    def _root(self, fingerprint: tuple) -> RadixNode:
        if fingerprint not in self._roots:
            self._roots[fingerprint] = RadixNode((), -1, None)
        return self._roots[fingerprint]

    def _chunks(self, tokens) -> list[tuple]:
        ps = self.page_size
        n_full = len(tokens) // ps
        return [tuple(tokens[i * ps:(i + 1) * ps]) for i in range(n_full)]

    def _match_nodes(self, fingerprint: tuple, tokens) -> list[RadixNode]:
        """Node chain of the longest published full-page prefix of
        ``tokens``: by the two-tier invariant, a device-resident prefix
        followed by a (possibly empty) spilled suffix."""
        node = self._roots.get(fingerprint)
        out: list[RadixNode] = []
        if node is not None:
            for chunk in self._chunks(tokens):
                child = node.children.get(chunk)
                if child is None:
                    break
                out.append(child)
                node = child
        return out

    def match(self, fingerprint: tuple, tokens, *, peek: bool = False) -> list[int]:
        """Pages of the longest *device-resident* published full-page
        prefix of ``tokens`` (tier-oblivious callers; engines that can
        restore host-tier pages use ``match_tiers``).

        The caller must ``retain`` the returned pages before the next
        ``alloc`` (eviction could otherwise reclaim a refcount-0 hit).
        ``peek=True`` skips the LRU bump and the hit statistics — admission
        planning uses it to cost a request without committing.
        """
        nodes = self._match_nodes(fingerprint, tokens)
        pages: list[int] = []
        for nd in nodes:
            if nd.page < 0:
                break
            pages.append(nd.page)
        if not peek:
            self._clock += 1
            for nd in nodes[:len(pages)]:
                nd.last_use = self._clock
            self.stats["lookups"] += 1
            if pages:
                self.stats["hits"] += 1
                self.stats["hit_pages"] += len(pages)
        return pages

    def match_tiers(self, fingerprint: tuple, tokens, *,
                    peek: bool = False) -> tuple[list[int], list[RadixNode]]:
        """Two-tier lookup: ``(resident_pages, spilled_nodes)`` covering
        the longest published full-page prefix of ``tokens`` — the spilled
        chain continues exactly where the resident one ends.

        Non-peek calls *pin* the returned spilled nodes: host-tier LRU
        eviction will not touch them until the caller either ``restore``\\ s
        each one into a freshly allocated page or ``unpin``\\ s them on a
        rollback.  As with ``match``, resident hit pages must be retained
        before the next ``alloc``.
        """
        nodes = self._match_nodes(fingerprint, tokens)
        pages: list[int] = []
        spilled: list[RadixNode] = []
        for nd in nodes:
            if nd.page >= 0:
                assert not spilled, "resident node below a spilled ancestor"
                pages.append(nd.page)
            else:
                spilled.append(nd)
        if not peek:
            self._clock += 1
            for nd in nodes:
                nd.last_use = self._clock
            for nd in spilled:
                nd.pinned = True
            self.stats["lookups"] += 1
            if nodes:
                self.stats["hits"] += 1
                self.stats["hit_pages"] += len(nodes)
        return pages, spilled

    def restore(self, node: RadixNode, page: int) -> None:
        """Promote a spilled node back to the device tier, attaching the
        freshly allocated ``page`` the caller just injected its payload
        into.  The page arrives refcount-1 (caller-owned, like any alloc);
        the node keeps it cached after release exactly like a published
        page.  Restores must run top-down along the spilled chain so the
        resident-prefix invariant holds at every intermediate state."""
        if node.payload is None or node.page >= 0:
            raise ValueError("restore of a node that is not spilled")
        if node.parent is not None and node.parent.payload is not None:
            raise ValueError("restore below a still-spilled parent")
        if self._ref[page] <= 0:
            raise ValueError(f"restore into dead page {page}")
        if self._node[page] is not None:
            raise ValueError(f"restore into published page {page}")
        node.page = page
        node.payload = None
        node.pinned = False
        self._node[page] = node
        self._spilled.discard(node)
        self._host_used -= 1
        self.stats["restored"] += 1

    def unpin(self, nodes) -> None:
        """Rollback half of the ``match_tiers`` pin protocol: release the
        pins of spilled nodes an admission matched but will not restore."""
        for nd in nodes:
            nd.pinned = False

    def publish(self, fingerprint: tuple, tokens, pages) -> None:
        """Insert the full-page chunks of ``tokens`` into the radix index,
        chunk ``i`` backed by ``pages[i]``.  Chunks already published keep
        their original page (the duplicate stays private to its slot and is
        freed on release).  Published pages must be live (refcount > 0 via
        the publishing slot); the index keeps them resident after release
        until LRU eviction reclaims them.
        """
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
            elif child.page < 0:
                # spilled copy of a chunk a live slot just re-prefilled:
                # re-adopt the slot's device page and drop the host payload.
                # Safe because K/V bytes are deterministic per (fingerprint,
                # token prefix) — both copies are bit-identical — and
                # published full-prompt chunks are never written after
                # prefill, the same invariant ordinary publish relies on.
                if self._ref[page] <= 0:
                    raise ValueError(f"publish of dead page {page}")
                if self._node[page] is not None:
                    raise ValueError(f"page {page} already published")
                child.page = page
                child.payload = None
                child.pinned = False
                self._node[page] = child
                self._spilled.discard(child)
                self._host_used -= 1
                self.stats["readopted"] += 1
            child.last_use = self._clock
            node = child

    def publish_committed(self, fingerprint: tuple, tokens, pages,
                          committed_len: int | None = None) -> None:
        """Provisional-length publish for speculative decode (DESIGN.md §8).

        ``tokens``/``pages`` may extend past ``committed_len`` (defaults to
        ``len(tokens)``): a speculating slot's block table carries pages
        holding drafted-but-unverified K/V — its ``spec_k`` page slack and,
        transiently, positions the verify pass rejected.  Only pages whose
        *every* position lies below the committed length enter the radix
        index, so rejected draft tokens can never be served as cache; the
        uncommitted tail pages stay private to the slot and return to the
        free list on release (no leak — audited by the engine tests).
        """
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

    # ------------------------------------------------------------------
    # LRU eviction
    # ------------------------------------------------------------------

    def _evictable(self):
        """Device-tier leaf radix nodes whose page nobody references — a
        "leaf" here meaning every direct child is already spilled (by the
        two-tier invariant a spilled node's whole subtree is spilled, so
        checking the direct children suffices).  Evicting such a node
        keeps the resident-prefix-then-spilled-suffix shape: spills move
        leaf-first up the tree."""
        for p in range(self.num_pages):
            node = self._node[p]
            if node is not None and self._ref[p] == 0 and all(
                    c.page < 0 for c in node.children.values()):
                yield node

    def _evict_host_lru(self) -> bool:
        """Reclaim one host-tier slot: destroy the least-recently-used
        unpinned spilled *leaf* (host evictions are leaf-first too, for the
        same no-dangling-suffix reason as the device tier)."""
        victim = min((n for n in self._spilled
                      if not n.children and not n.pinned),
                     default=None, key=lambda n: n.last_use)
        if victim is None:
            return False
        del victim.parent.children[victim.key]
        self._spilled.discard(victim)
        self._host_used -= 1
        self.stats["host_evicted"] += 1
        return True

    def _drop_subtree(self, node: RadixNode) -> None:
        """Destroy a device-tier victim *and* its (all-spilled) descendant
        subtree — a spilled suffix must never outlive its prefix, or a
        later match would restore K/V whose preceding positions are gone."""
        del node.parent.children[node.key]
        stack = list(node.children.values())
        while stack:
            c = stack.pop()
            assert c.page < 0 and c.payload is not None and not c.pinned
            self._spilled.discard(c)
            self._host_used -= 1
            self.stats["host_evicted"] += 1
            stack.extend(c.children.values())

    def _evict_lru(self) -> int | None:
        victim = min(self._evictable(), default=None,
                     key=lambda n: n.last_use)
        if victim is None:
            return None
        page = victim.page
        assert victim.parent is not None
        payload = None
        if self.host_pages > 0 and self.on_spill is not None:
            if self._host_used < self.host_pages or self._evict_host_lru():
                # demote: the device bytes are still resident here — the
                # hook copies them host-side (a real copy, never a view;
                # see module docstring)
                payload = self.on_spill(page)
            if payload is None:
                self.stats["spill_dropped"] += 1
        if payload is not None:
            victim.page = -1
            victim.payload = payload
            self._spilled.add(victim)
            self._host_used += 1
            self.stats["spilled"] += 1
        else:
            self._drop_subtree(victim)
        self._node[page] = None
        self._free.append(page)
        self.stats["evicted"] += 1
        if self.on_evict is not None:
            self.on_evict(page)
        return page

    # ------------------------------------------------------------------
    # invariants (tests call this after every trace)
    # ------------------------------------------------------------------

    def check(self) -> None:
        """Every page is exactly one of: free, referenced, or radix-cached;
        the host tier is consistent (spilled-set == payload-holding nodes,
        within budget, spilled suffixes only, no leftover pins)."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate free-list entries"
        for p in range(self.num_pages):
            in_free = p in free
            ref = int(self._ref[p])
            node = self._node[p]
            assert ref >= 0
            if in_free:
                assert ref == 0 and node is None, f"freed page {p} still live"
            if node is not None:
                assert node.page == p
                assert node.payload is None
                assert not in_free
        seen_spilled = 0
        for root in self._roots.values():
            stack = list(root.children.values())
            while stack:
                node = stack.pop()
                if node.page >= 0:
                    assert self._node[node.page] is node
                else:
                    assert node.payload is not None, "dangling spilled node"
                    assert node in self._spilled
                    assert not node.pinned, "pin leaked past admission"
                    assert all(c.page < 0 for c in node.children.values()), \
                        "resident node below a spilled ancestor"
                    seen_spilled += 1
                stack.extend(node.children.values())
        assert seen_spilled == len(self._spilled) == self._host_used
        assert self._host_used <= self.host_pages
