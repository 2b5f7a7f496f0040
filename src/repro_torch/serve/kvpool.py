"""Paged KV-cache management: a fixed pool of pages with refcounts and a
free list, plus a page-granular radix tree for cross-request prefix reuse.
Port of ``repro.serve.kvpool``: pure host code, the same names and
behaviour.

Dense per-slot caches weld slot count to ``max_cache``: every admitted
request reserves ``max_cache`` worth of KV in every layer, whether its
prompt is 4 tokens or 4000. Serving traffic is mostly short-tailed
requests that share long prefixes (system prompts, few-shot templates).
This module is the host-side bookkeeping for both:

* :class:`PagePool` — physical pages. A page is ``page_size`` KV slots in
  every layer's pool tensor (the device tensors live in the engine's
  caches; the pool tracks ids only). Pages carry refcounts so several
  slots can map the same physical page; page 0 is reserved as the TRASH
  page — freed slots point their whole table at it, so the dead rows that
  ride along in the lockstep decode batch scatter their garbage writes
  into a page nothing ever reads, never into a page another request may
  have been handed.

* :class:`RadixCache` — a radix tree over prompt-token prefixes at page
  granularity: each edge is exactly one page worth of tokens (a tuple,
  the dict key), each node owns the physical page holding that span's KV.
  ``match`` walks the longest shared prefix and hands back pages to
  attach BY REFERENCE (refcount bump, zero prefill work); ``insert``
  publishes a freshly prefilled prompt's full pages for the next request.
  Sharing is copy-on-write at page granularity *by construction*: shared
  pages are only ever read (a request's first write lands at its first
  non-shared position, which starts a fresh page because matches are
  whole pages), so the "divergence page" is always privately allocated
  and no page is ever physically copied. Eviction is LRU over
  unreferenced leaves, run only when an allocation would otherwise fail.

The engine (serve/engine.py) owns the mapping slot -> page-table row; the
model (models/lm.py, nn/attention.py) gathers and scatters through that
table and never sees this module.
"""
from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np

TRASH_PAGE = 0


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages covering ``n_tokens`` KV positions."""
    return -(-n_tokens // page_size)


class PagePool:
    """Refcounted free-list allocator over ``total_pages`` physical pages.

    Page ids are plain ints in ``[0, total_pages)``; id 0 is the reserved
    trash page and is never allocated. The pool never touches device
    memory — the engine sizes its device-side pool arrays from
    ``total_pages`` and indexes them with the ids handed out here.
    """

    def __init__(self, total_pages: int, page_size: int):
        if total_pages < 2:
            raise ValueError("PagePool needs >= 2 pages (page 0 is the "
                             f"reserved trash page), got {total_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.total_pages = int(total_pages)
        self.page_size = int(page_size)
        self.refs = np.zeros(total_pages, np.int32)
        # LIFO free list: recently freed pages are reused first (their old
        # contents are provably masked — see nn/attention.py paged reads)
        self._free = list(range(total_pages - 1, 0, -1))

    @property
    def usable_pages(self) -> int:
        return self.total_pages - 1          # minus the trash page

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.usable_pages - len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """``n`` fresh pages at refcount 1, or None if the pool is short
        (caller decides: evict prefix-cache pages, or defer admission)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if len(self._free) < n:
            return None
        pages = [self._free.pop() for _ in range(n)]
        self.refs[pages] = 1
        return pages

    def ref(self, page: int) -> None:
        """Attach one more holder to an allocated page."""
        if page == TRASH_PAGE or self.refs[page] <= 0:
            raise ValueError(f"ref of unallocated page {page}")
        self.refs[page] += 1

    def unref(self, page: int) -> None:
        """Detach one holder; the page returns to the free list at zero."""
        if page == TRASH_PAGE or self.refs[page] <= 0:
            raise ValueError(f"unref of unallocated page {page}")
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self._free.append(page)

    def check(self) -> None:
        """Structural invariants (the fuzz harness calls this every tick):
        refcounts non-negative, trash never allocated, and the free list
        exactly complements the referenced pages."""
        if self.refs[TRASH_PAGE] != 0:
            raise AssertionError("trash page acquired a refcount")
        if (self.refs < 0).any():
            raise AssertionError("negative page refcount")
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate page on the free list")
        for p in free:
            if self.refs[p] != 0:
                raise AssertionError(f"page {p} free but refcount "
                                     f"{self.refs[p]}")
        referenced = {int(p) for p in np.nonzero(self.refs)[0]}
        if free | referenced != set(range(1, self.total_pages)):
            raise AssertionError("free list + referenced pages != pool")


class _Node:
    __slots__ = ("children", "page", "last_used")

    def __init__(self, page: int = TRASH_PAGE):
        self.children: dict[tuple, _Node] = {}
        self.page = page
        self.last_used = 0


class RadixCache:
    """Page-granular radix tree over prompt token prefixes.

    Each node below the root holds exactly one page: the KV of one
    ``page_size``-token span, keyed by that span's token tuple. The tree
    holds its OWN refcount on every published page, so pages survive the
    request that prefilled them and later requests attach by reference;
    eviction (LRU over unreferenced leaves) is the only way the tree lets
    go of a page, which keeps "who owns this page" a pure refcount
    question the fuzz harness can audit.

    ``namespace`` partitions the tree: the KV of a token span is only
    reusable under the SAME model weights, and tenant adapters make
    weights per-request state — a prefix prefilled under tenant A's
    adapter must never attach to tenant B's request.
    Namespace nodes are pageless interior markers (page = TRASH_PAGE):
    never ref'd, never evicted, invisible to ``held_pages``.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self.root = _Node()
        self._clock = itertools.count(1)
        self.n_nodes = 0

    def _spans(self, tokens: Sequence[int]):
        pg = self.page_size
        for i in range(len(tokens) // pg):
            yield tuple(tokens[i * pg:(i + 1) * pg])

    def _ns_root(self, namespace) -> _Node:
        if namespace is None:
            return self.root
        # key shape can't collide with a span (a tuple of ints)
        key = ("\x00ns", namespace)
        child = self.root.children.get(key)
        if child is None:                   # pageless marker, not counted
            child = self.root.children[key] = _Node()
        return child

    def match(self, tokens: Sequence[int], *,
              namespace=None) -> list[int]:
        """Pages of the longest cached full-page prefix of ``tokens``
        within ``namespace``. Touches every matched node (LRU freshness).
        The caller must ``pool.ref`` each page it actually attaches."""
        node, pages = self._ns_root(namespace), []
        now = next(self._clock)
        for span in self._spans(tokens):
            child = node.children.get(span)
            if child is None:
                break
            child.last_used = now
            pages.append(child.page)
            node = child
        return pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int], *,
               namespace=None) -> int:
        """Publish a prefilled prompt's full pages; ``pages[i]`` holds the
        KV of tokens ``[i*pg, (i+1)*pg)``. Spans already in the tree keep
        their existing page (first writer wins — both copies hold bitwise
        identical KV, and the caller's copy dies with its request); new
        nodes take a tree-owned reference on the caller's page. Returns
        the number of pages newly published."""
        node, created = self._ns_root(namespace), 0
        now = next(self._clock)
        for span, page in zip(self._spans(tokens), pages):
            child = node.children.get(span)
            if child is None:
                child = _Node(int(page))
                self.pool.ref(int(page))
                node.children[span] = child
                self.n_nodes += 1
                created += 1
            child.last_used = now
            node = child
        return created

    def _leaves(self):
        out = []

        def walk(node, parent, key):
            for k, c in node.children.items():
                walk(c, node, k)
            if parent is not None and not node.children:
                out.append((node, parent, key))

        walk(self.root, None, None)
        return out

    def evict(self, n_pages: int) -> int:
        """Drop up to ``n_pages`` LRU leaf nodes whose page has no holder
        besides the tree (refcount 1); evicting a leaf may expose its
        parent, so eviction cascades. Returns pages actually freed."""
        freed = 0
        while freed < n_pages:
            evictable = [(n.last_used, n, p, k) for n, p, k in self._leaves()
                         if n.page != TRASH_PAGE        # namespace markers
                         and self.pool.refs[n.page] == 1]
            if not evictable:
                break
            # one eviction per pass: dropping a leaf exposes its parent,
            # which may be older LRU than the next leaf in this snapshot
            _, node, parent, key = min(evictable, key=lambda t: t[0])
            del parent.children[key]
            self.pool.unref(node.page)
            self.n_nodes -= 1
            freed += 1
        return freed

    def clear(self) -> int:
        """Release every tree-held page (drain/shutdown); returns count."""
        released = 0

        def walk(node):
            nonlocal released
            for c in node.children.values():
                walk(c)
            if node is not self.root and node.page != TRASH_PAGE:
                self.pool.unref(node.page)
                released += 1

        walk(self.root)
        self.root = _Node()
        self.n_nodes = 0
        return released

    def held_pages(self) -> list[int]:
        """All tree-held page ids (invariant audits)."""
        out = []

        def walk(node):
            for c in node.children.values():
                if c.page != TRASH_PAGE:
                    out.append(c.page)
                walk(c)

        walk(self.root)
        return out
