"""Cross-request prefix cache: radix index over refcounted KV pages.

BucketServe's bucket batching cuts padding waste; under realistic
agentic traffic (shared system prompts, few-shot headers) the biggest
waste LEFT is re-prefilling identical prefixes per request.  PR 2's
block tables already let two requests point at the same physical page —
this module adds the machinery that exploits it (DESIGN.md §3, "Prefix
sharing"; Apt-Serve arXiv 2504.07494 reports large admission gains from
exactly this reuse):

* a RADIX/TRIE index keyed on token-id chunks of ``page_size``: node
  depth d holds the physical page whose KV covers prompt positions
  ``[d*page, (d+1)*page)`` for that exact token path.  Page content is
  a pure function of the token prefix (RoPE is applied at write time
  with absolute positions), so any request whose prompt walks the same
  path can reference the same page;
* only FULL pages are ever indexed — the final partial page of a prompt
  is always a private page written by the owner's prefill.  This is the
  copy-on-write rule degenerate-cased away: a shared page is immutable
  by construction, and the mutable tail is never shared;
* the cache holds its own PIN (refcount) on every indexed page, so a
  cached prefix survives its writer's release.  LRU eviction (leaf
  first, zero-external-ref only) returns pages to the allocator when
  admission or decode starves.

Hit capping: a lookup never matches a request's ENTIRE prompt — at
least one suffix token must run through prefill to produce the first
output logits — so the usable match is
``min(matched_pages, (prompt_len - 1) // page_size)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PrefixStats:
    """Admission-side accounting (mirrored into ServeResult)."""

    lookups: int = 0           # admitted requests matched against the index
    hits: int = 0              # ... of which matched >= 1 full page
    hit_tokens: int = 0        # total prompt tokens served from cache
    inserted_pages: int = 0    # pages ever pinned into the index
    evictions: int = 0         # pages unpinned by LRU pressure
    peak_shared: int = 0       # max simultaneously shared pages observed


class _Node:
    """One full-page chunk on a token path.  ``key`` is the raw bytes of
    the page's token ids; ``page`` the physical page holding its KV.

    Spill states (PR 5, host tier): LIVE (``hslot is None`` — ``page``
    is a pinned device page), SPILLED (``hslot`` set, ``page`` == -1 —
    content lives in host slot ``hslot``), RESTORING (``hslot`` set AND
    ``page`` >= 0 — a host->device copy into the reserved ``page`` is
    in flight, done at ``ready_at``).  The trie keeps spilled nodes so
    lookups can find — and restore — a spilled continuation of a live
    run.  Structural invariant: every ancestor of a LIVE or RESTORING
    node is LIVE or RESTORING (spill moves leaf-inward, restore moves
    root-outward), so a hit path is always a LIVE prefix followed by at
    most one spilled/restoring run."""

    __slots__ = ("key", "page", "children", "parent", "stamp", "hslot",
                 "ready_at")

    def __init__(self, key: bytes, page: int, parent: "_Node"):
        self.key = key
        self.page = page
        self.children: Dict[bytes, _Node] = {}
        self.parent = parent
        self.stamp = 0
        self.hslot: Optional[int] = None
        self.ready_at: float = -1.0

    @property
    def live(self) -> bool:
        return self.hslot is None

    @property
    def restoring(self) -> bool:
        return self.hslot is not None and self.page >= 0


class PrefixCache:
    """Radix index + LRU eviction over a :class:`BlockAllocator`.

    The cache never owns device memory — it pins allocator pages and
    maps token paths to them.  Both execution backends drive one of
    these through the shared ``paging.admit_blocks`` policy, so hit
    accounting cannot drift between the engine and the cost model."""

    def __init__(self, page_size: int):
        assert page_size > 0
        self.page_size = page_size
        self.root = _Node(b"", -1, None)  # sentinel, never holds a page
        # dict-as-ordered-set (O(1) removal, insertion-ordered
        # iteration): eviction scans once for the LRU evictable leaf
        # but never pays a list.remove on top
        self._nodes: Dict[_Node, None] = {}
        self._clock = 0
        self.stats = PrefixStats()
        # host-drop hook (retention wires the backend copier + stats
        # into it); None for a bare radix with no spill tier
        self.on_host_drop = None

    # ----------------------------------------------------------- helpers --
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _chunk(self, tokens: np.ndarray, j: int) -> bytes:
        p = self.page_size
        return np.ascontiguousarray(
            tokens[j * p:(j + 1) * p], dtype=np.int32).tobytes()

    def __len__(self) -> int:
        return len(self._nodes)

    def pinned_pages(self) -> List[int]:
        return [n.page for n in self._nodes if n.live]

    def spilled_nodes(self) -> int:
        return sum(1 for n in self._nodes if not n.live)

    # ------------------------------------------------------------ lookup --
    def lookup(self, tokens, req=None, alloc=None) -> Tuple[List[int], int]:
        """Longest cached page run for ``tokens``, capped so at least
        one suffix token remains to prefill.  Returns (pages, tokens
        matched); touches the path for LRU.  ``req`` and ``alloc`` are
        part of the shared cache protocol (core/retention.py keys
        session state on the request and reserves restore pages from
        the allocator) and are unused here."""
        pages, _ = self.lookup_run(tokens)
        return pages, len(pages) * self.page_size

    def lookup_run(self, tokens) -> Tuple[List[int], List[_Node]]:
        """The full cached walk for ``tokens``: the LIVE page run, plus
        the SPILLED/RESTORING nodes that continue the same token path
        (the structural invariant guarantees the walk is live-prefix
        then spilled-suffix — a live node can never hide behind a
        spilled one).  The retention layer turns the continuation into
        a restore; a bare radix caller just takes the live run.
        Touches the whole walked path for LRU (spilled nodes too: the
        host-budget LRU ranks them by the same stamps)."""
        tokens = np.asarray(tokens)
        usable_cap = (len(tokens) - 1) // self.page_size
        node, pages, cont = self.root, [], []
        stamp = self._tick()
        for j in range(usable_cap):
            child = node.children.get(self._chunk(tokens, j))
            if child is None:
                break
            if child.live and cont:
                break            # unreachable under the invariant
            child.stamp = stamp
            if child.live:
                pages.append(child.page)
            else:
                cont.append(child)
            node = child
        return pages, cont

    # ---------------------------------------------------------- register --
    def register(self, alloc, tokens, table: List[int]) -> int:
        """Index a freshly prefilled request's FULL prompt pages.  Walks
        the trie along the token path; chunks already present keep their
        canonical page (first-wins — a concurrent cold duplicate's page
        simply stays private); new chunks pin the request's own page.
        A SPILLED chunk on the path is REVIVED for free: the releasing
        request just recomputed the identical KV (page content is a
        pure function of the token path), so the node adopts the fresh
        device page and the host copy is discarded.  A RESTORING chunk
        is left alone — its reserved page's copy is still in flight.
        Returns how many new pages were pinned."""
        tokens = np.asarray(tokens)
        n_full = len(tokens) // self.page_size
        node, added = self.root, 0
        stamp = self._tick()
        for j in range(n_full):
            key = self._chunk(tokens, j)
            child = node.children.get(key)
            if child is None:
                page = table[j]
                alloc.pin(page)
                child = _Node(key, page, node)
                node.children[key] = child
                self._nodes[child] = None
                self.stats.inserted_pages += 1
                added += 1
            elif not child.live and not child.restoring:
                # spilled: adopt the recomputed page, free the host slot
                alloc.pin(table[j])
                self._drop_host(alloc, child.hslot, revived=True)
                child.page = table[j]
                child.hslot = None
                child.ready_at = -1.0
            child.stamp = stamp
            node = child
        return added

    # ---------------------------------------------------------- eviction --
    def _drop_host(self, alloc, hslot: int, revived: bool = False) -> None:
        """Discard one host slot's content; ``on_host_drop`` (wired by
        the retention layer) forwards to the backend copier and the
        spill-drop stats.  ``revived``: the content came back to device
        by recompute, not destruction."""
        ok = alloc.drop_spilled(hslot)
        assert ok, f"host slot {hslot} had a restore in flight"
        if self.on_host_drop is not None:
            self.on_host_drop(hslot, revived)

    def _drop_spilled_subtree(self, alloc, node: _Node) -> None:
        """Remove a node's all-SPILLED subtree (no device pages — only
        host slots return).  Descendants of a spilled node are spilled
        by the structural invariant."""
        for child in list(node.children.values()):
            self._drop_spilled_subtree(alloc, child)
            assert not child.live and not child.restoring, \
                "live/restoring node below a drop point"
            self._drop_host(alloc, child.hslot)
            self._nodes.pop(child, None)
        node.children.clear()

    def _evict_node(self, alloc, node: _Node) -> bool:
        self._drop_spilled_subtree(alloc, node)
        freed = alloc.unpin(node.page)
        assert freed, "evictable leaf had refcount 1 but did not free"
        del node.parent.children[node.key]
        self._nodes.pop(node, None)
        self.stats.evictions += 1
        return freed

    def _evictable(self, alloc, protect) -> List[_Node]:
        """Evictable (destructive drop): a LIVE node with refcount
        exactly 1 (only our pin — no live block table), not in
        ``protect`` (pages matched for the admission in progress), and
        no LIVE or RESTORING child — an interior node on a live path is
        still an ancestor the path needs, but a node whose children are
        all SPILLED is the frontier (dropping it takes its dead spilled
        subtree along)."""
        return [n for n in self._nodes
                if n.live and n.page not in protect
                and alloc.refs(n.page) == 1
                and all(not c.live and not c.restoring
                        for c in n.children.values())]

    # ------------------------------------------------- spill transitions --
    def spill_candidates(self, alloc, protect) -> List[_Node]:
        """Nodes that may move device->host, LRU first: the same
        frontier rule as ``_evictable`` (spill is eviction minus the
        data loss)."""
        return sorted(self._evictable(alloc, set(protect)),
                      key=lambda n: n.stamp)

    def mark_spilled(self, node: _Node, hslot: int) -> None:
        node.page = -1
        node.hslot = hslot
        node.ready_at = -1.0

    def mark_restoring(self, node: _Node, page: int,
                       ready_at: float) -> None:
        node.page = page
        node.ready_at = ready_at

    def mark_live(self, node: _Node) -> None:
        node.hslot = None
        node.ready_at = -1.0

    def lru_spilled_leaf(self) -> Optional[_Node]:
        """LRU candidate for a host-budget drop: a SPILLED node with no
        children at all (dropping an interior spilled node would orphan
        its — equally spilled — descendants)."""
        cands = [n for n in self._nodes
                 if not n.live and not n.restoring and not n.children]
        return min(cands, key=lambda n: n.stamp) if cands else None

    def drop_spilled_node(self, alloc, node: _Node) -> None:
        assert not node.live and not node.restoring and not node.children
        self._drop_host(alloc, node.hslot)
        del node.parent.children[node.key]
        self._nodes.pop(node, None)

    def evict_one(self, alloc, protect=()) -> bool:
        """Evict the least-recently-used evictable leaf; True if a page
        went back to the free list."""
        cands = self._evictable(alloc, set(protect))
        if not cands:
            return False
        return self._evict_node(alloc, min(cands, key=lambda n: n.stamp))

    def evict(self, alloc, need: int, protect=()) -> int:
        """Free up to ``need`` pages, harvesting the evictable leaves
        oldest-stamp-first from ONE scan per generation (evicting a
        whole leaf generation may expose parents as new leaves — the
        outer loop rescans only then).  Returns pages actually freed;
        reclaiming k pages costs O(generations · nodes), not k full
        scans."""
        protect = set(protect)
        freed = 0
        while freed < need:
            cands = self._evictable(alloc, protect)
            if not cands:
                break
            for n in sorted(cands, key=lambda c: c.stamp):
                if freed >= need:
                    break
                freed += self._evict_node(alloc, n)
        return freed

    def clear(self, alloc) -> int:
        """Unpin everything (leaf-first; spilled nodes give back host
        slots, in-flight restores are committed first).  Returns device
        pages freed."""
        freed = 0
        while self._nodes:
            progressed = False
            for n in list(self._nodes):
                if n.children:
                    continue
                if n.restoring:
                    alloc.restore_commit(n.hslot)
                    freed += bool(alloc.unpin(n.page))
                elif n.live:
                    freed += bool(alloc.unpin(n.page))
                else:
                    self._drop_host(alloc, n.hslot)
                del n.parent.children[n.key]
                self._nodes.pop(n, None)
                progressed = True
            assert progressed, "cycle in prefix trie"
        return freed

    # ------------------------------------------------------------- stats --
    def note_admit(self, alloc, req, hit_tokens: int) -> None:
        """Called by ``paging.admit_blocks`` once per ADMITTED request
        (counting only admissions keeps engine/cost-model hit counts
        comparable — both admit identical batches under parity).
        ``req`` is part of the shared cache protocol (the retention
        layer commits its session claim here) and is unused."""
        self.stats.lookups += 1
        if hit_tokens > 0:
            self.stats.hits += 1
            self.stats.hit_tokens += hit_tokens
        self.stats.peak_shared = max(self.stats.peak_shared,
                                     alloc.shared_pages())

    def abort(self, req) -> None:
        """Admission failed after ``lookup`` — nothing to roll back for
        the bare radix (protocol hook for the retention layer)."""

    def pages_saved(self) -> int:
        return self.stats.hit_tokens // self.page_size
