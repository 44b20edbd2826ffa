"""Host-side page accounting: refcounted page pool + radix prefix tree
(copy of ``bigdl_tpu/serving/pagepool.py``, so page ids match the
reference's for the same operations).

Pure scheduling state, no tensors. The engine owns ONE
:class:`PagePool` (physical pages of the device arena in
``ops/paged.py``) and, when prefix sharing is on, ONE :class:`RadixCache`
mapping prompt-token chunks to the pages that hold their KV.

Refcount discipline
-------------------
Every mapping of a physical page holds one reference: a slot's block-table
row, and each radix-tree node. A page is returned to the free list exactly
when its count reaches zero; decref below zero raises (the
refcount-never-negative invariant is load-bearing — a double free would
hand the same page to two sequences and silently corrupt both).

Copy-on-write contract
----------------------
The pool only *counts*; the engine decides. Before a slot appends into a
page with refcount > 1 it must allocate a fresh page, copy the old one
(``cow_copy_pages``), swap its block-table entry, and decref the shared
page — the shared copy is never written, so concurrent readers (the radix
tree, other slots) stay byte-identical.

Radix tree
----------
Nodes are keyed by **page-sized token chunks** so one node == one page.
Lookup is longest-prefix: it descends full-page nodes only and returns the
matched pages without touching refcounts (the engine increfs when it
commits the admission — match is a pure read plus an LRU stamp). The
prompt's partial tail chunk IS inserted (as a terminal "partial" node) so
the tail page survives eviction and the writer's next append sees a shared
page — that append is what exercises CoW. Eviction frees only leaves whose
page the tree alone still references (external refcount zero), LRU-first.

Not ported yet: the migration hooks ``export_pages`` / ``import_pages``
and the metrics ``publish``.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from bigdl_tpu_torch.ops.paged import NULL_PAGE


class PagePool:
    """Refcounts + free list over ``num_pages`` physical pages. Page 0
    (``NULL_PAGE``) is pinned: never allocated, never freed — it is the
    arena's write sink for padded positions."""

    def __init__(self, num_pages: int, page_size: int) -> None:
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is reserved), "
                f"got {num_pages}")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list: recently-freed pages are re-handed first (their
        # arena tiles are the likeliest still resident in cache hierarchy)
        self._free: List[int] = list(range(1, num_pages))
        self._ref = [0] * num_pages
        self._ref[NULL_PAGE] = 1     # pinned
        self.exhausted_total = 0     # alloc failures (observability)

    # -- allocation ---------------------------------------------------------

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages at refcount 1, or None (all-or-nothing — a
        partial grant would deadlock two admissions against each other)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            self.exhausted_total += 1
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, page: int) -> int:
        if page == NULL_PAGE:
            return self._ref[NULL_PAGE]
        if self._ref[page] <= 0:
            raise RuntimeError(
                f"incref of free page {page} (use-after-free)")
        self._ref[page] += 1
        return self._ref[page]

    def decref(self, page: int) -> int:
        """Drop one reference; frees the page at zero. Never goes
        negative — that would mean a double release, which is how two
        sequences end up sharing a 'private' page."""
        if page == NULL_PAGE:
            return self._ref[NULL_PAGE]
        if self._ref[page] <= 0:
            raise RuntimeError(
                f"decref of page {page} with refcount "
                f"{self._ref[page]} (double free)")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
        return self._ref[page]

    def refcount(self, page: int) -> int:
        return self._ref[page]

    # -- accounting ---------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        """Allocated pages (excludes the pinned null page)."""
        return (self.num_pages - 1) - len(self._free)

    @property
    def num_shared(self) -> int:
        """Pages mapped more than once (refcount >= 2)."""
        return sum(1 for p, r in enumerate(self._ref)
                   if p != NULL_PAGE and r >= 2)


class _RadixNode:
    __slots__ = ("tokens", "page", "children", "parent", "partial", "tick")

    def __init__(self, tokens: Tuple[int, ...], page: int,
                 parent: Optional["_RadixNode"], partial: bool,
                 tick: int) -> None:
        self.tokens = tokens
        self.page = page
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.parent = parent
        self.partial = partial
        self.tick = tick


class RadixCache:
    """Prompt-prefix radix tree over page-sized token chunks.

    The tree holds ONE reference on every node's page (taken at insert,
    released at evict/drop). ``match`` never mutates refcounts; callers
    incref the returned pages themselves when they commit."""

    def __init__(self, pool: PagePool) -> None:
        self.pool = pool
        self._root = _RadixNode((), NULL_PAGE, None, False, 0)
        self._clock = itertools.count(1)
        self.num_nodes = 0
        # host-visible counters (the engine mirrors them into metrics)
        self.lookups = 0
        self.hits = 0
        self.lookup_tokens = 0
        self.hit_tokens = 0

    def _chunks(self, tokens: Sequence[int]):
        ps = self.pool.page_size
        for i in range(0, len(tokens), ps):
            yield tuple(tokens[i:i + ps])

    # -- insert -------------------------------------------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Record a prompt's pages; returns how many NEW nodes were
        created (each new node increfs its page). Existing nodes keep
        their original page — first writer wins, the newcomer's private
        copy simply stays private to its slot."""
        assert len(pages) == -(-len(tokens) // self.pool.page_size), \
            "one page per (possibly partial) chunk"
        node = self._root
        created = 0
        tick = next(self._clock)
        for chunk, page in zip(self._chunks(tokens), pages):
            partial = len(chunk) < self.pool.page_size
            # dict keys ARE the token tuples, so a partial tail chunk can
            # only ever collide with an identical partial node — full and
            # partial entries with a common prefix coexist as siblings
            child = node.children.get(chunk)
            if child is None:
                child = _RadixNode(chunk, page, node, partial, tick)
                node.children[chunk] = child
                self.pool.incref(page)
                created += 1
                self.num_nodes += 1
            child.tick = tick
            if child.partial:
                break                 # partial nodes are terminal
            node = child
        return created

    # -- lookup -------------------------------------------------------------

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest-prefix match over FULL pages only: (matched_tokens,
        pages). Pure read apart from the LRU stamp; no refcounts move."""
        ps = self.pool.page_size
        node = self._root
        pages: List[int] = []
        tick = next(self._clock)
        for chunk in self._chunks(tokens):
            if len(chunk) < ps:
                break                 # tail chunk: never shared via match
            child = node.children.get(chunk)
            if child is None or child.partial:
                break
            child.tick = tick
            pages.append(child.page)
            node = child
        matched = len(pages) * ps
        self.lookups += 1
        self.lookup_tokens += len(tokens)
        if matched:
            self.hits += 1
            self.hit_tokens += matched
        return matched, pages

    # -- eviction -----------------------------------------------------------

    def _leaves(self) -> List[_RadixNode]:
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pages by removing LRU leaves whose page
        only the tree still references (external refcount zero — a page a
        live slot maps is NEVER evicted). Removing a leaf can expose its
        parent; the sweep repeats until satisfied or nothing qualifies."""
        freed = 0
        while freed < n_pages:
            victims = sorted(
                (leaf for leaf in self._leaves()
                 if self.pool.refcount(leaf.page) == 1),
                key=lambda leaf: leaf.tick)
            if not victims:
                break
            for leaf in victims:
                self._remove(leaf)
                freed += 1
                if freed >= n_pages:
                    break
        return freed

    def _remove(self, node: _RadixNode) -> None:
        assert not node.children
        node.parent.children.pop(node.tokens, None)
        self.num_nodes -= 1
        self.pool.decref(node.page)

    def drop(self, tokens: Sequence[int]) -> int:
        """Purge the exact path for ``tokens`` bottom-up, stopping at the
        first node shared with other prompts (it has other children).
        Used when a prompt is quarantined — its KV must not seed future
        admissions. Returns nodes removed."""
        node = self._root
        path: List[_RadixNode] = []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            path.append(child)
            if child.partial:
                break
            node = child
        removed = 0
        for n in reversed(path):
            if n.children:
                break
            self._remove(n)
            removed += 1
        return removed

    def clear(self) -> int:
        """Drop every node (decref all pages); returns nodes removed."""
        removed = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            n.children.clear()
            self.num_nodes -= 1
            self.pool.decref(n.page)
            removed += 1
        self._root.children.clear()
        return removed

    def snapshot(self) -> dict:
        return {
            "nodes": self.num_nodes,
            "lookups": self.lookups,
            "hits": self.hits,
            "lookup_tokens": self.lookup_tokens,
            "hit_tokens": self.hit_tokens,
        }
