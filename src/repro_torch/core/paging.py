"""Paged KV-cache accounting: fixed-size page pool + block tables.

This is the host-side bookkeeping half of the paged decode pool
(DESIGN.md §3).  A :class:`BlockAllocator` owns a free list of
fixed-size pages and a per-request block table; both execution
backends (real JAX engine and the analytic cost model) drive the SAME
allocator logic through :func:`admit_blocks` / :func:`extend_for_decode`
so their admission decisions cannot drift (the backend-parity
invariant).

The paper's Eq. (6) becomes an EXACT block budget here: a request
holding ``t`` live tokens pins ``ceil(t / page_size)`` pages — no
per-slot ``cache_len`` preallocation, which is what lets a 40-token
Alpaca request and a 32k LongBench request share one HBM pool without
the short request paying for the long one's worst case.

Pages are REFCOUNTED (PR 3): a page may appear in several live block
tables at once (cross-request prefix sharing, core/prefix_cache.py)
and may additionally be pinned by the prefix cache itself.  A page
returns to the free list only when its reference count hits zero, so
releasing one sharer can never corrupt another's cache.

Pages can SPILL to a host-RAM tier (PR 5): a page whose only reference
is its retention pin may move device->host — the HBM page returns to
the free list and a HOST SLOT records where the content went
(``spill``); a later hit restores it through a reserved device page
(``restore_begin``/``restore_commit``, split so the copy can complete
asynchronously while the slot stays accounted).  The allocator is pure
bookkeeping — actual byte movement is the execution backend's job
(core/engine.py gathers/scatters real KV; the cost model only prices
the transfer).

Invariants (property-tested in tests/test_paging.py):
  * a page's refcount always equals (#live tables holding it) + (#pins);
  * free + unique-live + spilled-slots == accounted, i.e. device pages
    still satisfy free + unique-live == n_pages (a spilled page's HBM
    is genuinely freed) and host slots satisfy free-host + spilled ==
    host_pages — no tier leaks, no double-assigned slot in either;
  * a shared page NEVER spills (spill is refused unless the caller's
    pin is the LAST reference);
  * restore is idempotent: ``restore_begin`` on an already-restoring
    slot returns the same reserved page; a second ``restore_commit``
    is a no-op;
  * a live request's table holds exactly ``ceil(tokens / page_size)``
    pages;
  * alloc/extend are all-or-nothing; release is idempotent per rid.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence


class BlockAllocator:
    """Free-list allocator of fixed-size KV pages with refcounts and
    block tables.

    Token-level API: callers say how many tokens a request holds and the
    allocator keeps its table at exactly ``ceil(tokens / page_size)``
    pages.  ``alloc``/``extend`` are all-or-nothing — on exhaustion they
    return None and the allocator state is unchanged (no partial grabs),
    so callers can preempt and retry without unwinding.

    ``alloc(..., shared=pages)`` prepends already-live pages (a cached
    prefix) to the new table, bumping their refcounts instead of popping
    the free list — the request pays only for its private suffix pages.
    ``pin``/``unpin`` are the prefix cache's own references.
    """

    def __init__(self, n_pages: int, page_size: int, host_pages: int = 0,
                 page_bytes: int = 0, host_slot_bytes: int = 0):
        assert n_pages > 0 and page_size > 0, (n_pages, page_size)
        assert host_pages >= 0, host_pages
        self.n_pages = n_pages
        self.page_size = page_size
        # byte denomination of each tier (0 = caller doesn't track
        # bytes): a device page holds page_size tokens at the HOT
        # cache width; a host slot holds the same tokens at the SPILL
        # width — the tiers may differ (DESIGN.md §3 "Tier precision")
        self.page_bytes = page_bytes
        self.host_slot_bytes = host_slot_bytes
        # LIFO free list: released pages are reused first (locality)
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}
        self._refs: Dict[int, int] = {}          # page -> live refcount
        self._pins: Dict[int, int] = {}          # page -> cache-pin count
        # ---- host spill tier (0 host pages = disabled) ----
        self.host_pages = host_pages
        self._free_host: List[int] = list(range(host_pages - 1, -1, -1))
        self._spilled: Dict[int, None] = {}      # hslot, content at rest
        self._restoring: Dict[int, int] = {}     # hslot -> reserved page

    # ----------------------------------------------------------- queries --
    def pages_for(self, tokens: int) -> int:
        return -(-max(tokens, 0) // self.page_size)

    def free_pages(self) -> int:
        return len(self._free)

    def live_pages(self) -> int:
        """UNIQUE live pages (shared pages counted once): the quantity
        that satisfies free + live == total."""
        return len(self._refs)

    def refs(self, page: int) -> int:
        return self._refs.get(page, 0)

    def shared_pages(self) -> int:
        """Pages referenced more than once (table+table or table+pin)."""
        return sum(1 for c in self._refs.values() if c >= 2)

    def reclaimable(self, rid: int) -> int:
        """Pages that would actually return to the free list if ``rid``
        were released NOW (refcount 1 — no other sharer, no cache pin)."""
        return sum(1 for p in self._tables.get(rid, ())
                   if self._refs.get(p) == 1)

    def table(self, rid: int) -> List[int]:
        return list(self._tables.get(rid, ()))

    def table_len(self, rid: int) -> int:
        """O(1) page count of ``rid``'s table (0 if not live) — lets the
        engine's block-table mirror detect growth without copying the
        whole table per dispatch."""
        return len(self._tables.get(rid, ()))

    def table_tail(self, rid: int, start: int) -> List[int]:
        """Pages appended past index ``start`` — O(growth), the
        incremental half of the mirror sync."""
        return list(self._tables.get(rid, ())[start:])

    def holds(self, rid: int) -> bool:
        return rid in self._tables

    # ----------------------------------------------------- host-tier state --
    def spilled_slots(self) -> int:
        """Host slots in use: content at rest + restores in flight."""
        return len(self._spilled) + len(self._restoring)

    def free_host_slots(self) -> int:
        return len(self._free_host)

    def is_spilled(self, hslot: int) -> bool:
        return hslot in self._spilled or hslot in self._restoring

    def device_bytes_in_use(self) -> int:
        """HBM bytes the live pages pin (hot-tier width)."""
        return self.live_pages() * self.page_bytes

    def host_bytes_in_use(self) -> int:
        """Host-RAM bytes the spilled slots pin (spill-tier width —
        compressed when the spill dtype is narrower than the pool)."""
        return self.spilled_slots() * self.host_slot_bytes

    # ------------------------------------------------------------- edits --
    def _pop_free(self) -> int:
        p = self._free.pop()
        self._refs[p] = 1
        return p

    def _unref(self, page: int) -> bool:
        """Drop one reference; True if the page returned to the free
        list (count hit zero)."""
        c = self._refs[page] - 1
        if c == 0:
            del self._refs[page]
            self._free.append(page)
            return True
        self._refs[page] = c
        return False

    def alloc(self, rid: int, tokens: int,
              shared: Optional[Sequence[int]] = None) -> Optional[List[int]]:
        """Admit ``rid`` with ``tokens`` live tokens.  ``shared`` pages
        (a cached prefix, already live/pinned) are prepended to the table
        by reference — only the remaining pages come from the free list.
        Returns the block table, or None if the pool cannot hold it
        (state unchanged, including refcounts)."""
        assert rid not in self._tables, f"rid {rid} already live"
        shared = list(shared or ())
        need = self.pages_for(tokens)
        assert need >= len(shared), \
            f"shared prefix ({len(shared)} pages) exceeds need ({need})"
        if need - len(shared) > len(self._free):
            return None
        for p in shared:
            assert self._refs.get(p, 0) > 0, \
                f"shared page {p} is not live (evicted prefix?)"
            self._refs[p] += 1
        pages = shared + [self._pop_free()
                          for _ in range(need - len(shared))]
        self._tables[rid] = pages
        return list(pages)

    def extend(self, rid: int, tokens: int) -> Optional[List[int]]:
        """Grow ``rid``'s table to cover ``tokens`` tokens.  Returns the
        NEWLY added pages ([] if already covered), or None on exhaustion
        (state unchanged).  Tables never shrink mid-flight.  New pages
        are always private (refcount 1) — growth happens past the
        prompt, where no sharing is possible."""
        assert rid in self._tables, f"rid {rid} not live"
        have = self._tables[rid]
        need = max(self.pages_for(tokens), len(have))
        grow = need - len(have)
        if grow > len(self._free):
            return None
        new = [self._pop_free() for _ in range(grow)]
        have.extend(new)
        return new

    def release(self, rid: int) -> int:
        """Drop ``rid``'s references; returns how many pages actually
        returned to the free list (0 if unknown — release is idempotent
        so preemption/finish races are harmless; shared pages survive
        their co-owners)."""
        pages = self._tables.pop(rid, None)
        if pages is None:
            return 0
        return sum(1 for p in pages if self._unref(p))

    # ------------------------------------------------- prefix-cache pins --
    def pin(self, page: int) -> None:
        """Extra reference held by the prefix cache: the page survives
        its writer's release and stays addressable for future hits."""
        assert self._refs.get(page, 0) > 0, \
            f"pin target {page} is not live"
        self._refs[page] += 1
        self._pins[page] = self._pins.get(page, 0) + 1

    def unpin(self, page: int) -> bool:
        """Drop a cache pin; True if the page was freed (no live table
        referenced it)."""
        assert self._refs.get(page, 0) > 0, f"unpin of dead page {page}"
        assert self._pins.get(page, 0) > 0, f"unpin without pin: {page}"
        if self._pins[page] == 1:
            del self._pins[page]
        else:
            self._pins[page] -= 1
        return self._unref(page)

    # ----------------------------------------------- host spill tier (§3) --
    def spill(self, page: int) -> Optional[int]:
        """Move ``page`` to the host tier: the caller's PIN must be the
        LAST reference — a page referenced by any live block table (or
        another pin) is refused, the sharer would read freed HBM.  On
        success the device page returns to the free list and the
        returned host slot records where the content went.  None when
        refused or the host pool is full (state unchanged) — the
        caller falls back to a destructive drop."""
        if (self._refs.get(page, 0) != 1 or self._pins.get(page, 0) != 1
                or not self._free_host):
            return None
        hslot = self._free_host.pop()
        del self._pins[page]                 # the pin moves to the slot
        freed = self._unref(page)
        assert freed, "sole-reference page did not free on spill"
        self._spilled[hslot] = None
        return hslot

    def restore_begin(self, hslot: int) -> Optional[int]:
        """Reserve a device page for ``hslot``'s content to return to.
        The page carries the caller's pin (refcount 1); the host slot
        stays accounted until ``restore_commit`` — the copy may still
        be reading it (double-buffer rule).  Idempotent: a slot already
        restoring returns its reserved page.  None when no device page
        is free (state unchanged; the caller evicts and retries)."""
        if hslot in self._restoring:
            return self._restoring[hslot]
        assert hslot in self._spilled, f"restore of unspilled slot {hslot}"
        if not self._free:
            return None
        page = self._pop_free()
        self._pins[page] = 1                 # the slot's pin moves back
        del self._spilled[hslot]
        self._restoring[hslot] = page
        return page

    def restore_commit(self, hslot: int) -> bool:
        """The copy landed: release the host slot.  Idempotent — a slot
        not in flight is a no-op returning False."""
        if hslot not in self._restoring:
            return False
        del self._restoring[hslot]
        self._free_host.append(hslot)
        return True

    def restore_cancel(self, hslot: int) -> bool:
        """Abort a restore in flight (channel hard-fault, recovery shed
        — core/recovery.py): the reserved device page returns to the
        free list and the slot's content is back AT REST — the copy
        never landed, so the host bytes are still the truth.  Inverse
        of ``restore_begin``; both two-tier invariants hold across the
        round trip.  False if no restore was in flight."""
        if hslot not in self._restoring:
            return False
        page = self._restoring.pop(hslot)
        assert self._pins.get(page) == 1 and self._refs.get(page) == 1, \
            f"reserved restore page {page} grew references mid-flight"
        del self._pins[page]
        freed = self._unref(page)
        assert freed, "reserved restore page did not free on cancel"
        self._spilled[hslot] = None
        return True

    def drop_spilled(self, hslot: int) -> bool:
        """Destroy spilled content (host-budget LRU, expiry of a demoted
        session): the slot returns to the host free list.  A slot with a
        restore in flight is refused — the copy is reading it."""
        if hslot in self._restoring:
            return False
        assert hslot in self._spilled, f"drop of unspilled slot {hslot}"
        del self._spilled[hslot]
        self._free_host.append(hslot)
        return True


# ------------------------------------------------- tier byte denomination --
def device_pool_pages(cfg, pool_tokens: int, page_size: int) -> int:
    """Device pages a hot-pool budget of ``pool_tokens`` REFERENCE
    (bf16-width) KV tokens buys at the pool's actual cache dtype.

    The budget is a byte quantity expressed in bf16-token units —
    ``pool_tokens × kv_bytes_per_token(2)`` bytes of HBM — and each
    page costs ``page_size × cache_bytes_per_token()`` of it, so an
    int8 pool genuinely holds ~2× the pages of a bf16 pool under the
    SAME budget instead of only shifting the Eq.-(6) token cap.  For a
    bf16 pool this reduces exactly to ``pool_tokens // page_size``
    (the pre-quantized-tiers rule).  THE one sizing rule both
    execution backends share (backend parity)."""
    pool_bytes = max(pool_tokens, 0) * cfg.kv_bytes_per_token(2)
    page_cost = page_size * max(cfg.cache_bytes_per_token(), 1)
    return pool_bytes // page_cost


def host_tier_geometry(cfg, host_pool_tokens: Optional[int],
                       page_size: int, spill_dtype: str = ""):
    """(host_slots, bytes_per_slot) of the host spill tier for a budget
    of ``host_pool_tokens`` reference (bf16-width) KV tokens.

    A slot stores one page at the SPILL dtype's width
    (``cfg.spill_bytes_per_token``), so the same host budget retains
    ~2× (int8) / ~3.5× (int4) more transcript pages than a bf16 spill
    — and ``bytes_per_slot`` is what one page transfer moves over the
    PCIe link, which both backends price identically
    (``bytes_per_slot / spill_bw`` seconds per page)."""
    slot_bytes = page_size * max(cfg.spill_bytes_per_token(spill_dtype), 1)
    budget_bytes = (host_pool_tokens or 0) * cfg.kv_bytes_per_token(2)
    return budget_bytes // slot_bytes, slot_bytes


# ------------------------------------------------------- shared policies --
def admit_blocks(alloc: BlockAllocator, requests: Sequence,
                 insert_tokens: Callable[[object], int],
                 cache=None, tokens_of=None) -> int:
    """Admission gate: allocate insert-time pages for a PREFIX of the
    batch; returns how many requests were admitted.  ``insert_tokens``
    maps a request to the tokens its cache holds right after prefill
    (prompt + the first decode write, window-capped).  The loop re-queues
    the rest — the block analogue of the decode-slot clamp.

    ``cache`` (+ ``tokens_of``) is any retention object speaking the
    shared cache protocol — a bare
    :class:`~repro_torch.core.prefix_cache.PrefixCache` or the full
    :class:`~repro_torch.core.retention.KvRetention` layer.  Each request's
    prompt is first matched against it: matched pages (a cached radix
    run, plus the session's pinned partial tail when the prompt
    continues a retained transcript) are attached by REFERENCE
    (refcount++) and only the uncached suffix is charged to the free
    list.  On exhaustion the cache's ordered eviction policy (expired
    sessions → LRU cold prefixes → live sessions, each rung SPILLING
    to host before it destroys when a spill tier is configured) runs
    before giving up — admission starvation reclaims retained cache
    before it blocks.  A request whose hit continues into spilled
    pages is HELD (``Request.spill_wait`` set by the lookup): it is
    not admitted this pass and the loop re-queues it for when the
    restore lands.  ``note_admit`` commits a session claim on
    success; ``abort`` rolls it back on failure."""
    n = 0
    for r in requests:
        shared: List[int] = []
        hit_tokens = 0
        if cache is not None:
            shared, hit_tokens = cache.lookup(tokens_of(r), req=r,
                                              alloc=alloc)
            if getattr(r, "spill_wait", -1.0) >= 0.0:
                # the hit continues into SPILLED pages and a host->device
                # restore is in flight: HOLD the request (the loop parks
                # it until spill_wait) instead of admitting it to
                # re-prefill work whose KV is coming back over the bus
                cache.abort(r)
                break
        while True:
            got = alloc.alloc(r.rid, insert_tokens(r), shared=shared)
            if got is not None or cache is None:
                break
            short = (alloc.pages_for(insert_tokens(r)) - len(shared)
                     - alloc.free_pages())
            if cache.evict(alloc, short, protect=shared) == 0:
                break
        if got is None:
            if cache is not None:
                cache.abort(r)
            break
        if cache is not None:
            r.prefix_hit_tokens = hit_tokens
            cache.note_admit(alloc, r, hit_tokens)
        n += 1
    return n


def extend_for_decode(alloc: BlockAllocator, pool: Sequence,
                      decode_tokens: Callable[[object], int],
                      cache=None, slack_of=None) -> List:
    """Pre-decode page extension with preemption: grow every pooled
    request's table to cover its next token write; on exhaustion free
    pages in cheapness order — (1) the cache's ordered retention
    policy (expired session tails, then LRU zero-ref cached prefixes,
    then live session tails — nobody in flight loses work, see
    ``KvRetention.evict``), then (2) preempt a pooled request LATER in
    the processing order, preferring the one whose release RECLAIMS the
    most pages (a victim whose pages are all shared frees nothing and
    is never picked).  If the starving request is last in order — or no
    later victim can free a page — it preempts itself rather than
    robbing an earlier request.  Front-of-order-first processing
    therefore guarantees the head of the pool always progresses (no
    livelock).  Returns the victims (their pages already released); the
    caller re-queues them.

    Processing order is the policy knob (DESIGN.md §8):

    * default — oldest first ``(arrival, rid)``; victims prefer
      (most reclaimable pages, youngest) — the legacy youngest-first
      preemption every pre-goodput gate was built on;
    * ``slack_of`` set (slack-aware schedulers) — least deadline slack
      first; victims prefer (MOST slack, most reclaimable).  The
      sacrificed request is the one whose class budget tolerates the
      restart best.  ``slack_of`` must be CLOCK-FREE
      (``Request.sacrifice_slack``) or preemption decisions would
      diverge between the wall- and virtual-clock backends.

    Victim membership is tracked in a rid-keyed set — the old
    ``c not in victims`` list scan made this O(n^2) in pool size."""
    if slack_of is None:
        def key(r):
            return (r.arrival, r.rid)

        def vkey(c):
            return (alloc.reclaimable(c.rid), c.arrival, c.rid)
    else:
        def key(r):
            return (slack_of(r), r.rid)

        def vkey(c):
            return (slack_of(c), alloc.reclaimable(c.rid), c.rid)
    victims: List = []
    victim_rids = set()
    order = sorted(pool, key=key)
    for r in order:
        if r.rid in victim_rids:
            continue
        while alloc.extend(r.rid, decode_tokens(r)) is None:
            if cache is not None and cache.evict_one(alloc):
                continue                     # freed a cached page; retry
            later = [c for c in order if c.rid not in victim_rids
                     and c is not r and alloc.holds(c.rid)
                     and key(c) > key(r)
                     and alloc.reclaimable(c.rid) > 0]
            if not later:
                # r is last in the processing order (or nobody after it
                # can free a page) and still starves: it preempts
                # ITSELF — never one ahead of it (those are either
                # older or tighter on deadline)
                alloc.release(r.rid)
                victims.append(r)
                victim_rids.add(r.rid)
                break
            v = max(later, key=vkey)
            alloc.release(v.rid)
            victims.append(v)
            victim_rids.add(v.rid)
    return victims
