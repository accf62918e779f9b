"""Shared-prefix page cache: page-pool allocator + radix prefix index,
counterpart of ``torchdistx_tpu/serve/prefix_cache.py`` (host-only, kept as
the port's own copy; the JAX package's trace counters are left out).

The host half of the paged KV subsystem (the device half -- page-pool
tensors, page tables, gather/scatter -- lives in
:mod:`~torchdistx_tpu_torch.serve.kv_cache`).  Two pieces:

- :class:`PagePool` -- a free-list allocator with per-page refcounts over
  the ``num_pages`` device pages.  Page 0 is reserved as the **scratch**
  page: never allocated, the target of every unassigned page-table entry
  and of retired slots' frozen decode writes, so a stale table row can
  scribble garbage somewhere harmless instead of into a page another
  request now owns.
- :class:`RadixPrefixIndex` -- a page-granular radix tree (trie) over
  prompt token IDs: one node per cached page, children keyed by the next
  ``page_size`` tokens.  ``match`` returns the longest chain of full-page
  hits (capped at ``len(prompt) - 1`` tokens -- the last prompt token's
  logits must always be computed to sample the first output token);
  ``insert`` adopts a freshly prefilled request's full-prompt pages,
  taking the index's own reference on each.  Eviction walks
  least-recently-used *leaves* whose page nobody else references
  (refcount == 1, the index's own hold) -- interior nodes are at least as
  recent as their children, so leaf-first LRU is chain-consistent.

Sharing is by **table rewrite, never by copying KV**: a prefix hit hands
the new request the very same device pages (refcount bumped), and its
page table simply points at them.  A page is freed only when its refcount
drops to zero: no running request's table references it and the index no
longer holds it.
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Tuple

import numpy as np

__all__ = ["PagePool", "RadixPrefixIndex", "SCRATCH_PAGE"]

SCRATCH_PAGE = 0


class PagePool:
    """Free-list page allocator with refcounts over ``num_pages`` pages.

    Page ``0`` (:data:`SCRATCH_PAGE`) is never handed out; ``capacity``
    is therefore ``num_pages - 1``.  Pages are allocated lowest-id-first
    (deterministic reuse, like the scheduler's slot order) and return to
    the free list when their refcount reaches zero.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (one scratch + one usable), "
                f"got {num_pages}"
            )
        self.num_pages = int(num_pages)
        # min-heap: alloc hands out the lowest free page id, and a
        # freeing decref is O(log F), not a free-list re-sort
        self._free = list(range(1, self.num_pages))
        self._ref = np.zeros(self.num_pages, np.int32)
        self.high_water = 0

    @property
    def capacity(self) -> int:
        """Allocatable pages (the scratch page excluded)."""
        return self.num_pages - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - self.free_count

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages (refcount 1 each).  The caller must have
        checked ``free_count`` (the engine's admission gate does); asking
        for more than is free is a bookkeeping bug, not back-pressure."""
        if n > self.free_count:
            raise RuntimeError(
                f"page pool over-allocated: asked {n}, free {self.free_count}"
            )
        pages = [heapq.heappop(self._free) for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self.high_water = max(self.high_water, self.in_use)
        return pages

    def incref(self, pages: Iterable[int]) -> None:
        for p in pages:
            if self._ref[p] <= 0:
                raise RuntimeError(f"incref of free page {p}")
            self._ref[p] += 1

    def decref(self, pages: Iterable[int]) -> int:
        """Drop one reference per page; pages reaching zero return to the
        free list.  Returns how many were freed."""
        freed = 0
        for p in pages:
            if self._ref[p] <= 0:
                raise RuntimeError(f"decref of free page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                heapq.heappush(self._free, p)
                freed += 1
        return freed


class _Node:
    __slots__ = ("page", "children", "last_used")

    def __init__(self, page: int, last_used: int):
        self.page = page
        self.children: Dict[tuple, "_Node"] = {}
        self.last_used = last_used


class RadixPrefixIndex:
    """Radix tree over prompt tokens at page granularity.

    Each node caches exactly one page (``page_size`` tokens); a path from
    the root spells a page-aligned prompt prefix and its page chain.  The
    index holds its own +1 refcount on every adopted page, so a cached
    prefix outlives the request that computed it until LRU eviction —
    and a page a running request still references (refcount > 1) is
    never evicted from under it.
    """

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        self._children: Dict[tuple, _Node] = {}  # root's children
        self._tick = 0

    def __len__(self) -> int:
        """Cached pages (== nodes)."""

        def count(children) -> int:
            return sum(1 + count(n.children) for n in children.values())

        return count(self._children)

    def _chunks(self, tokens, n_pages: int):
        ps = self.page_size
        toks = np.asarray(tokens).reshape(-1)
        for i in range(n_pages):
            yield tuple(int(t) for t in toks[i * ps : (i + 1) * ps])

    def match(self, prompt) -> List[int]:
        """Longest chain of cached full pages covering at most
        ``len(prompt) - 1`` tokens.  Returns the page ids in prefix
        order; the caller must ``incref`` them before anything else can
        trigger eviction.  Touches matched nodes' recency."""
        n_full = (len(prompt) - 1) // self.page_size
        self._tick += 1
        pages: List[int] = []
        children = self._children
        for chunk in self._chunks(prompt, n_full):
            node = children.get(chunk)
            if node is None:
                break
            node.last_used = self._tick
            pages.append(node.page)
            children = node.children
        return pages

    def match_len(self, prompt) -> int:
        """Read-only probe: the TOKENS a :meth:`match` of ``prompt``
        would serve from cache (full pages only, capped at
        ``len(prompt) - 1`` like ``match``) — WITHOUT handing out pages,
        taking references, or touching any node's recency."""
        n_full = (len(prompt) - 1) // self.page_size
        matched = 0
        children = self._children
        for chunk in self._chunks(prompt, n_full):
            node = children.get(chunk)
            if node is None:
                break
            matched += 1
            children = node.children
        return matched * self.page_size

    def insert(self, tokens, pages: List[int], pool: PagePool) -> int:
        """Adopt a prefilled request's full-prompt page chain:
        ``tokens`` must be ``len(pages) * page_size`` ids and ``pages``
        the device pages holding their KV (still referenced by the
        caller).  Nodes already present keep their existing page (first
        writer wins — the duplicate page stays owned by its request alone
        and is freed at retire).  Returns how many pages were adopted."""
        if len(tokens) != len(pages) * self.page_size:
            raise ValueError(
                f"insert needs page-aligned tokens: {len(tokens)} ids for "
                f"{len(pages)} pages of {self.page_size}"
            )
        self._tick += 1
        adopted = 0
        children = self._children
        for chunk, page in zip(self._chunks(tokens, len(pages)), pages):
            node = children.get(chunk)
            if node is None:
                node = _Node(page, self._tick)
                pool.incref([page])
                children[chunk] = node
                adopted += 1
            node.last_used = self._tick
            children = node.children
        return adopted

    def _evictable_leaves(
        self, pool: PagePool
    ) -> List[Tuple[int, Dict[tuple, _Node], tuple]]:
        """(last_used, parent_children, key) for every leaf whose page
        only the index references."""
        out: List[Tuple[int, Dict[tuple, _Node], tuple]] = []

        def walk(children: Dict[tuple, _Node]):
            for key, node in children.items():
                if node.children:
                    walk(node.children)
                elif pool.refcount(node.page) == 1:
                    out.append((node.last_used, children, key))

        walk(self._children)
        return out

    def evict(self, pool: PagePool, n_needed: int) -> int:
        """Free at least ``n_needed`` pages by dropping LRU leaves (a
        dropped leaf can expose its parent as the next candidate).
        Returns pages actually freed — possibly fewer when everything
        left is pinned by running requests."""
        freed = 0
        while freed < n_needed:
            # re-collect after EVERY eviction: removing a leaf exposes its
            # parent, which is older than any other leaf of its chain and
            # must compete on its own recency
            leaves = self._evictable_leaves(pool)
            if not leaves:
                break
            _, parent, key = min(leaves, key=lambda t: t[0])
            node = parent.pop(key)
            freed += pool.decref([node.page])
        return freed
