"""Unified KV retention: one end-of-life policy for every cached page.

Before this layer, "a request finished" meant "free its pages" — with
one ad-hoc exception (the prefix cache pinned FULL prompt pages at
prefill time) and no way to keep a *conversation's* cache alive between
turns.  BucketServe's motivating traffic is exactly the workload where
that hurts: agentic/chat sessions re-send the whole transcript every
turn, so turn N+1 re-prefills tokens whose KV was in the pool seconds
ago (Apt-Serve arXiv 2504.07494, UELLM arXiv 2409.14961).

:class:`KvRetention` makes "free on release" one case of a general
retention policy (DESIGN.md §3 "Session retention"):

* the PR 3 radix index (:class:`~repro_torch.core.prefix_cache.PrefixCache`)
  becomes the SHARED-PREFIX BACKEND.  At release, the finished
  request's full transcript — prompt AND generated tokens — is
  registered: page content is a pure function of the token path (RoPE
  uses absolute positions), so generated tokens simply EXTEND the
  radix path past the prompt.  Any later request whose prompt walks
  the same token path (most importantly the session's own next turn)
  reuses those pages by reference;
* a SESSION TABLE holds the one page the radix cannot: the partial
  tail (``transcript_len % page`` tokens).  It stays pinned PRIVATELY
  under the session key with a TTL; the next turn of the same session
  — after verifying its prompt continues the exact transcript token
  path — takes the pin over (the tail becomes its private page at the
  right virtual index) and prefill resumes past the whole restored
  transcript, not just its page-aligned prefix;
* eviction pressure walks ONE ordered policy: expired session tails →
  LRU cold radix prefixes → live session tails (soonest-expiring
  first) → and only then does the caller fall back to refcount-aware
  request preemption (``paging.extend_for_decode``).  A pinned session
  is therefore always unpinned before any live request loses work.

HOST SPILL TIER (PR 5, ``host_pool_pages > 0``): every rung above gains
a non-destructive option — before a retained page is DROPPED (and its
next use pays a full re-prefill), it is SPILLED: copied device→host
(``BlockAllocator.spill``) so only its HBM is reclaimed.  A later
lookup whose hit continues into spilled pages triggers a host→device
RESTORE instead of a re-prefill: device pages are reserved, the copy is
dispatched, and the request is HELD (``Request.spill_wait``) until the
transfer lands — converting the dominant multi-turn perf cliff
(pressure/TTL eviction → cold re-prefill) into an overlappable
PCIe-bandwidth cost (Apt-Serve's hybrid cache, arXiv 2504.07494).
Destruction happens only when the host budget is ALSO exhausted, and
then against the host pool's own LRU.  With spill enabled, TTL expiry
DEMOTES a session tail to host (the entry stays resumable — host RAM
is cheap) rather than destroying it.  The actual byte movement is the
backend's job (``copier``: the engine gathers/scatters real KV; the
cost model prices the transfer seconds only), but every DECISION —
what spills, what restores, when a transfer completes relative to the
serving clock — lives here, shared by both backends, so spill/restore
counts hold under backend parity.

The layer owns the whole pin lifecycle (TTL tick, pressure unpin,
release-time registration, spill/restore transitions) — call sites in
the loop/backends only forward their clock.  Both execution backends
drive one instance through the shared ``paging.admit_blocks`` policy,
so session hit counts cannot drift between the engine and the cost
model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .prefix_cache import PrefixCache
from .telemetry import NULL_TRACER


@dataclasses.dataclass
class RetentionStats:
    """Session-side accounting (the radix side lives in PrefixStats)."""

    sessions_retained: int = 0   # release-time session entries created
    session_lookups: int = 0     # admitted requests carrying a session id
    session_hits: int = 0        # ... resumed from a live session entry
    session_hit_tokens: int = 0  # transcript tokens restored via sessions
    tail_reuses: int = 0         # pinned partial tail pages handed back
    sessions_expired: int = 0    # entries DROPPED by the TTL tick
    sessions_evicted: int = 0    # entries unpinned by memory pressure
    # ---- host spill tier (PR 5) ----
    pages_spilled: int = 0       # device->host page copies initiated
    pages_restored: int = 0      # host->device page copies completed
    restored_tokens: int = 0     # KV tokens brought back instead of re-prefilled
    spill_drops: int = 0         # spilled entries destroyed (host LRU/teardown)
    restore_holds: int = 0       # restore runs that held a request on TTFT
    spill_seconds: float = 0.0   # priced device->host transfer time
    restore_seconds: float = 0.0  # priced host->device transfer time
    # ---- quantized spill tier (byte denomination) ----
    bytes_spilled: int = 0       # COMPRESSED bytes moved device->host
    bytes_restored: int = 0      # COMPRESSED bytes moved host->device
    # ---- fault/recovery plane (core/faults.py, core/recovery.py) ----
    restore_stalls: int = 0      # injected channel stalls absorbed
    restore_retries: int = 0     # channel hard-faults retried (backoff)
    restore_failures: int = 0    # restore runs abandoned after retries
    restore_sheds: int = 0       # runs shed by the deadline-slack rule
    restore_timeouts: int = 0    # held requests unparked by the timeout
    corruptions: int = 0         # host-slot checksum mismatches caught


@dataclasses.dataclass
class _Session:
    """Retained transcript of one conversation's last finished turn.

    Tail spill states mirror the radix node's: LIVE (``tail_page`` set,
    ``tail_hslot`` None), SPILLED (``tail_hslot`` set, ``tail_page``
    None — demoted to host, ``expires_at`` becomes inf because the host
    LRU owns its lifetime now), RESTORING (both set — the reserved
    device page's copy lands at ``tail_ready``)."""

    sid: int
    turn: int
    path: np.ndarray             # transcript token ids (len = T)
    full_tokens: int             # page-aligned prefix registered on the radix
    tail_page: Optional[int]     # pinned private partial tail (None if T%page==0)
    expires_at: float
    claimed_by: Optional[int] = None   # rid mid-admission (commit/abort pending)
    tail_hslot: Optional[int] = None   # host slot (spilled/restoring tail)
    tail_ready: float = -1.0           # restore completion time
    stamp: int = 0                     # LRU rank shared with radix nodes
    # class TTFT budget of the turn that retained this transcript: the
    # slack-aware eviction rung's CLOCK-FREE sacrifice rank (a
    # loose-budget batch session tolerates a cold resume far better
    # than a 2 s-TTFT chat session — DESIGN.md §8)
    slo_ttft: float = 2.0


class KvRetention:
    """Retention policy over a BlockAllocator: radix prefix backend +
    TTL'd session table.  Duck-type-compatible with the ``cache``
    argument of ``paging.admit_blocks`` / ``paging.extend_for_decode``
    (lookup / evict / evict_one / note_admit / abort), which is how
    both backends route their admit and eviction paths through it."""

    def __init__(self, page_size: int,
                 session_ttl: Optional[float] = None,
                 host_pool_pages: int = 0,
                 spill_seconds_per_page: float = 0.0,
                 spill_page_bytes: int = 0):
        assert page_size > 0
        assert host_pool_pages >= 0
        self.page_size = page_size
        self.session_ttl = session_ttl
        self.host_pool_pages = host_pool_pages
        self.spill_seconds_per_page = spill_seconds_per_page
        # bytes one page occupies in the HOST tier (at the spill dtype,
        # scales included) — what a spill/restore transfer MOVES; 0 in
        # legacy call sites that never read the byte stats
        self.spill_page_bytes = spill_page_bytes
        # slack-aware sacrifice ordering (DESIGN.md §8): armed by the
        # ServingLoop when the scheduler is deadline-slack aware — the
        # live-session eviction rung then sacrifices the session whose
        # class budget tolerates a cold resume best (largest slo_ttft)
        # instead of the soonest-expiring one
        self.slack_aware = False
        # fault-injection / recovery seams (core/faults.py §9): armed by
        # the ServingLoop AFTER backend.begin (backends rebuild retention
        # there).  ``faults`` draws restore-channel stall / hard-error /
        # host-corruption decisions; ``recovery`` bounds the retries and
        # carries the deadline-slack shed rule.  Both None in a
        # fault-free run — every new branch below is skipped.
        self.faults = None
        self.recovery = None
        self.prefix = PrefixCache(page_size)
        self.prefix.on_host_drop = self._on_host_drop
        # event-timeline seam (core/telemetry.py): the ServingLoop
        # overwrites this after backend.begin when tracing is on
        self.tracer = NULL_TRACER
        self.sessions: Dict[int, _Session] = {}
        self.stats = RetentionStats()
        self._now = 0.0
        # backend-supplied data mover (spill/restore/drop/poll); None
        # for the cost model, which only prices the transfers
        self.copier = None
        # in-flight restores: (hslot, "node"/"tail", node-or-sid);
        # completion times live on the node/entry, the watermark keeps
        # the per-iteration poll O(1) until something is actually due
        self._restores: List[Tuple[int, str, object]] = []
        self._next_restore = math.inf
        self._restore_free = 0.0     # when the host<->device channel frees
        # anti-thrash reservations: rid -> (expiry, hit-path pages).  A
        # held request's whole hit path (live prefix + restoring run)
        # is protected from eviction until that request consumes it at
        # admission (note_admit) — otherwise concurrent restores under
        # a tight pool spill each other's just-restored pages and the
        # system livelocks copying instead of serving.  The expiry is a
        # leak backstop for requests that never come back.
        self._reserved: Dict[int, Tuple[float, frozenset]] = {}
        # per-slot integrity checksums stamped at SPILL time and
        # verified when the restore channel next READS the slot — a
        # corrupted host copy is destroyed (cold re-prefill) instead of
        # ever being copied back and served
        self._checksums: Dict[int, int] = {}
        # earliest expires_at across live entries (inf when none): the
        # per-iteration TTL tick early-returns on it, so steady-state
        # serving pays O(1) per tick, not O(live sessions)
        self._next_expiry = math.inf

    def _on_host_drop(self, hslot: int, revived: bool) -> None:
        """PrefixCache destroyed/revived a spilled node's host copy."""
        self._checksums.pop(hslot, None)
        if self.copier is not None:
            self.copier.drop(hslot)
        if not revived:
            self.stats.spill_drops += 1

    def _drop_host_slot(self, alloc, hslot: int) -> None:
        """Destroy a session tail's host copy — the ONE teardown path
        (slot back to the allocator, copier staging discarded, drop
        counted) for every session-side site."""
        self._checksums.pop(hslot, None)
        alloc.drop_spilled(hslot)
        if self.copier is not None:
            self.copier.drop(hslot)
        self.stats.spill_drops += 1

    # -------------------------------------------- host-slot integrity --
    @staticmethod
    def _expected_checksum(hslot: int) -> int:
        """Model-level per-slot checksum: a pure function of the slot,
        identical in both backends (the engine's real bytes are
        bit-exact across spill/restore by the PR 5 copier tests, so the
        model checksum tracks the DECISION — was the content rotted —
        which is the parity surface)."""
        return (hslot * 0x9E3779B1 + 0x7F4A7C15) & 0xFFFFFFFF

    def _stamp_checksum(self, hslot: int) -> None:
        """At spill time: record the slot checksum.  An injected
        ``host_corrupt`` fault rots the stored value — bit-rot at rest,
        caught only when the slot is next read."""
        chk = self._expected_checksum(hslot)
        if self.faults is not None and self.faults.fire("host_corrupt"):
            chk ^= 1
        self._checksums[hslot] = chk

    def _checksum_ok(self, hslot: int) -> bool:
        return self._checksums.get(
            hslot, self._expected_checksum(hslot)) \
            == self._expected_checksum(hslot)

    # ------------------------------------------------------------ queries --
    @property
    def sessions_enabled(self) -> bool:
        return self.session_ttl is not None

    @property
    def spill_enabled(self) -> bool:
        return self.host_pool_pages > 0

    def __len__(self) -> int:
        return len(self.prefix)

    def live_sessions(self) -> int:
        return len(self.sessions)

    def restores_in_flight(self) -> int:
        return len(self._restores)

    def restore_pages_in_flight(self) -> int:
        """Device pages currently reserved by in-flight restores —
        real KV occupancy Eq. (6) would otherwise miss (the pages left
        the free list at ``restore_begin`` but belong to no table)."""
        return len(self._restores)

    def restore_backlog_bytes(self) -> int:
        """Compressed bytes still queued on the modeled PCIe channel —
        the restore-aware admission term's input (DESIGN.md §4)."""
        return len(self._restores) * self.spill_page_bytes

    # ------------------------------------------------------- pin lifecycle --
    def tick(self, alloc, now: float) -> int:
        """Housekeeping, called by BOTH backends each loop iteration
        through the one shared :func:`maintain_backend` path: (1) flip
        in-flight restores whose transfer landed to LIVE, (2) TTL
        maintenance — with spill enabled an expired tail is DEMOTED to
        host (the session stays resumable for a bandwidth cost);
        without, or when demotion is impossible, the entry drops as
        before.  Returns device pages actually freed.  O(1) until a
        watermark (earliest expiry / earliest restore) actually
        passes."""
        self._now = max(self._now, now)
        if self._now >= self._next_restore:
            self._complete_restores(alloc)
        if self.copier is not None:
            self.copier.poll()
        if self._now < self._next_expiry:
            return 0
        freed = 0
        for sid in [s for s, e in self.sessions.items()
                    if e.claimed_by is None and e.expires_at <= self._now]:
            e = self.sessions[sid]
            if self.spill_enabled and self._spill_tail(alloc, e):
                freed += 1           # demoted: HBM freed, entry survives
            else:
                freed += self._drop_session(alloc, sid, expired=True)
        # claimed entries (transient, mid-admission) stay in the min so
        # a later tick retries them after commit/abort resolves
        self._next_expiry = min(
            (e.expires_at for e in self.sessions.values()),
            default=math.inf)
        return freed

    def _complete_restores(self, alloc) -> None:
        """Flip every in-flight restore whose modeled transfer time has
        passed: the host slot releases (restore_commit) and the page
        becomes an ordinary LIVE retained page — the held request's
        next admission attaches it by reference like any other hit."""
        still = []
        for hslot, kind, obj in self._restores:
            if kind == "node":
                node = obj
                if not node.restoring or node.hslot != hslot:
                    continue                      # torn down meanwhile
                if node.ready_at > self._now:
                    still.append((hslot, kind, obj))
                    continue
                alloc.restore_commit(hslot)
                self.prefix.mark_live(node)
                self.stats.pages_restored += 1
                self.stats.restored_tokens += self.page_size
                self.stats.bytes_restored += self.spill_page_bytes
            else:                                 # session tail
                e = self.sessions.get(obj)
                if e is None or e.tail_hslot != hslot:
                    continue                      # replaced meanwhile
                if e.tail_ready > self._now:
                    still.append((hslot, kind, obj))
                    continue
                alloc.restore_commit(hslot)
                e.tail_hslot = None
                e.tail_ready = -1.0
                self.stats.pages_restored += 1
                self.stats.restored_tokens += len(e.path) - e.full_tokens
                self.stats.bytes_restored += self.spill_page_bytes
        self._restores = still
        self._next_restore = min(
            (o.ready_at if k == "node" else self.sessions[o].tail_ready
             for _, k, o in still), default=math.inf)

    def _release_tail(self, alloc, e: _Session) -> int:
        """Tear down an entry's tail wherever it lives: LIVE unpins,
        SPILLED gives the host slot back, RESTORING commits the
        in-flight copy first (the content is already on device) and
        then unpins.  Returns device pages freed."""
        if e.tail_hslot is not None:
            if e.tail_page is not None:           # restore in flight
                alloc.restore_commit(e.tail_hslot)
                e.tail_hslot = None
                return int(alloc.unpin(e.tail_page))
            self._drop_host_slot(alloc, e.tail_hslot)
            e.tail_hslot = None
            return 0
        if e.tail_page is not None:
            return int(alloc.unpin(e.tail_page))
        return 0

    def _drop_session(self, alloc, sid: int, *, expired: bool) -> int:
        e = self.sessions.pop(sid)
        freed = self._release_tail(alloc, e)
        if expired:
            self.stats.sessions_expired += 1
        else:
            self.stats.sessions_evicted += 1
        return freed

    def on_release(self, alloc, req, path_tokens, now: float) -> int:
        """End-of-life for a finished request's pages — the ONE place
        release policy lives.  ``path_tokens`` is the transcript whose
        KV the pool physically holds: prompt + generated[:-1] (the last
        generated token's KV is never written).  Full pages go onto the
        radix path; the partial tail is pinned under the session key
        with a TTL; only then are the table's references dropped, so
        retained pages survive.  Returns pages freed (like
        ``BlockAllocator.release``); idempotent per rid."""
        self._now = max(self._now, now)
        if not alloc.holds(req.rid):
            return 0
        if not self.sessions_enabled or path_tokens is None:
            return alloc.release(req.rid)
        path = np.ascontiguousarray(path_tokens, dtype=np.int32)
        table = alloc.table(req.rid)
        T = min(len(path), len(table) * self.page_size)
        full = T // self.page_size
        if full:
            self.prefix.register(alloc, path[:full * self.page_size], table)
        sid = req.session_id
        if sid is not None:
            tail_page = table[full] if T % self.page_size else None
            if tail_page is not None:
                alloc.pin(tail_page)
            old = self.sessions.pop(sid, None)
            if old is not None:
                self._release_tail(alloc, old)
            expires = self._now + self.session_ttl
            self.sessions[sid] = _Session(
                sid=sid, turn=req.turn, path=path[:T],
                full_tokens=full * self.page_size, tail_page=tail_page,
                expires_at=expires, stamp=self.prefix._tick(),
                slo_ttft=req.slo_ttft)
            self._next_expiry = min(self._next_expiry, expires)
            self.stats.sessions_retained += 1
        return alloc.release(req.rid)

    # ------------------------------------------------- admission (lookup) --
    def lookup(self, tokens, req=None, alloc=None) -> Tuple[List[int], int]:
        """Longest retained run for ``tokens``: the radix walk first;
        then, if the request belongs to a live session whose transcript
        the prompt EXACTLY continues (token-path verified — the tail's
        KV is only valid for that path) and the radix still covers the
        whole page-aligned transcript (no gap), the pinned tail extends
        the hit to the full transcript length.  The entry is CLAIMED,
        not consumed — ``note_admit`` commits the claim (pin hand-over)
        once the allocator accepted the request; ``abort`` rolls it
        back if admission failed.

        SPILLED continuation (host tier): when the walk runs into pages
        that were spilled to host — cold radix pages or a demoted
        session tail — the lookup initiates their host→device RESTORE
        (device pages reserved, copies dispatched) and flags the
        request HELD via ``req.spill_wait``: ``admit_blocks`` does not
        admit it, the loop parks it until the transfer lands, and its
        NEXT admission finds the pages live and resumes past them —
        restore latency lands on that request's TTFT instead of a full
        re-prefill.  If no device page can be reserved even after
        eviction, the request falls back to its live hit (cold
        re-prefill of the spilled part, which ``register`` then uses to
        revive the spilled nodes for free)."""
        tokens = np.asarray(tokens)
        pages, cont = self.prefix.lookup_run(tokens)
        hit = len(pages) * self.page_size
        e = None
        sid = getattr(req, "session_id", None)
        if sid is not None and self.sessions_enabled:
            cand = self.sessions.get(sid)
            # expires_at is inf for a demoted (spilled) entry: host
            # residence, not the TTL, bounds its life now
            if (cand is not None and cand.claimed_by is None
                    and cand.expires_at > self._now):
                T = len(cand.path)
                walk = hit + len(cont) * self.page_size
                # the walk must REACH the transcript's full pages but
                # the live hit must not overshoot them: a radix run
                # extending past full_tokens (another request indexed
                # more of the same path) already serves the whole
                # transcript better than the tail hand-over would —
                # claiming then would hand the tail to the wrong table
                # index and shrink the prefix skip (the PR 4 `==` rule)
                if (walk >= cand.full_tokens and hit <= cand.full_tokens
                        and len(tokens) > T
                        and np.array_equal(tokens[:T], cand.path)):
                    e = cand
                    e.stamp = self.prefix._tick()
        if (cont or (e is not None and e.tail_hslot is not None)) \
                and self.spill_enabled and alloc is not None:
            if self._restore_path(alloc, req, pages, cont, e):
                return pages, hit                # held — not admitted
        if e is not None and hit == e.full_tokens and e.tail_hslot is None:
            e.claimed_by = req.rid
            req.session_hit_tokens = len(e.path)
            if e.tail_page is not None:
                return pages + [e.tail_page], len(e.path)
        return pages, hit

    def _restore_path(self, alloc, req, pages: List[int], cont,
                      e: Optional[_Session]) -> bool:
        """Bring the spilled continuation of a hit back to device:
        reserve a destination page per spilled node (evicting colder
        retained pages if the free list is short), dispatch the copies,
        and model their completion — one transfer channel, so a run of
        k pages lands ``k * spill_seconds_per_page`` after the channel
        frees.  Returns True when the request must be HELD
        (``req.spill_wait`` set to the completion time).  Restores that
        are already in flight are joined, not re-issued (idempotence);
        a run that cannot reserve pages degrades to the live hit."""
        ready = -1.0
        new = 0
        protect = list(pages)
        planned: List[Tuple[int, int]] = []      # (hslot, page) copies
        broken = False
        for node in cont:
            if node.restoring:
                ready = max(ready, node.ready_at)
                protect.append(node.page)
                continue
            if not self._checksum_ok(node.hslot):
                # bit-rot at rest: destroy the node (and its — equally
                # spilled — subtree) before any copy moves garbage; the
                # request degrades to its live hit and re-prefills
                self.stats.corruptions += 1
                if self.tracer.enabled:
                    self.tracer.instant(
                        "restore-channel", "corrupt-slot", self._now,
                        cat="fault", args={"hslot": node.hslot})
                self.prefix._drop_spilled_subtree(alloc, node)
                self.prefix.drop_spilled_node(alloc, node)
                broken = True
                break
            page = self._reserve_page(alloc, node.hslot, protect)
            if page is None:
                broken = True
                break
            self.prefix.mark_restoring(node, page, math.inf)
            self._restores.append((node.hslot, "node", node))
            planned.append((node.hslot, page))
            protect.append(page)
            new += 1
        if (e is not None and e.tail_hslot is not None
                and e.tail_page is None and not broken):
            if not self._checksum_ok(e.tail_hslot):
                # the tail tokens are lost to bit-rot: the entry
                # survives truncated to its page-aligned transcript
                # (the radix still backs that); an entry with nothing
                # left drops entirely
                self.stats.corruptions += 1
                h = e.tail_hslot
                e.tail_hslot = None
                e.tail_ready = -1.0
                self._drop_host_slot(alloc, h)
                e.path = e.path[:e.full_tokens]
                if e.full_tokens == 0:
                    self._drop_session(alloc, e.sid, expired=False)
            else:
                page = self._reserve_page(alloc, e.tail_hslot, protect)
                if page is not None:
                    e.tail_page = page
                    self._restores.append((e.tail_hslot, "tail", e.sid))
                    planned.append((e.tail_hslot, page))
                    protect.append(page)
                    new += 1
        elif e is not None and e.tail_hslot is not None \
                and e.tail_page is not None:
            ready = max(ready, e.tail_ready)          # already in flight
            protect.append(e.tail_page)
        if new:
            # fault plane (core/faults.py): one stall draw + a bounded
            # retry loop of hard-error draws per dispatched run.  Draws
            # happen BEFORE any copy is issued, so a failed run cancels
            # cleanly (reserved pages return, slots back at rest).
            stall = 0.0
            attempts = 0
            failed = False
            if self.faults is not None:
                if self.faults.fire("restore_stall"):
                    stall = self.faults.plan.stall_s
                    self.stats.restore_stalls += 1
                max_r = self.recovery.max_retries \
                    if self.recovery is not None else 0
                while self.faults.fire("restore_error"):
                    attempts += 1
                    if attempts > max_r:
                        failed = True
                        break
            if failed:
                self._cancel_new_restores(alloc, new, e)
                self.stats.restore_failures += 1
                self.stats.restore_retries += attempts - 1
                if self.tracer.enabled:
                    self.tracer.instant(
                        "restore-channel", "restore-failed", self._now,
                        cat="fault", args={"pages": new, "rid": req.rid})
                new = 0
            else:
                # each retry re-sends the whole run (burns the channel);
                # backoff gaps sit between sends
                xfer = (attempts + 1) * new * self.spill_seconds_per_page
                backoff = sum(self.recovery.backoff(i)
                              for i in range(attempts)) \
                    if attempts and self.recovery is not None else 0.0
                ch_start = max(self._now, self._restore_free)
                done = ch_start + stall + xfer + backoff
                # deadline-slack shed rule (core/recovery.py): when the
                # restore cannot land inside the requester's remaining
                # TTFT budget, give the channel to winnable work and
                # fall back to recompute
                if (self.recovery is not None and req is not None
                        and self.recovery.should_shed(
                            req.slo_ttft - (self._now - req.t0()),
                            done - self._now)):
                    self._cancel_new_restores(alloc, new, e)
                    self.stats.restore_sheds += 1
                    self.stats.restore_retries += attempts
                    new = 0
                else:
                    self._restore_free = done
                    if self.copier is not None:
                        for hslot, page in planned:
                            self.copier.restore(hslot, page)
                    if self.tracer.enabled:
                        self.tracer.complete(
                            "restore-channel", f"restore x{new}", ch_start,
                            done - ch_start, cat="restore",
                            args={"pages": new, "rid": req.rid,
                                  "retries": attempts, "stall_s": stall})
                    self.stats.restore_seconds += xfer
                    self.stats.restore_retries += attempts
                    for hslot, kind, obj in self._restores[-new:]:
                        if kind == "node":
                            obj.ready_at = done
                        else:                     # tail (only if tail_new)
                            e.tail_ready = done
                    self._next_restore = min(self._next_restore, done)
                    ready = max(ready, done)
        if ready >= 0.0:
            req.spill_wait = ready
            self.stats.restore_holds += 1
            self._reserved[req.rid] = (ready + 60.0, frozenset(protect))
            return True
        return False

    def _cancel_new_restores(self, alloc, new: int, e) -> None:
        """Unwind the trailing ``new`` restores of a run that never
        dispatched (hard fault after retries, or shed): reserved pages
        return to the free list, slots go back AT REST — the inverse of
        the reservation walk, no copy was ever issued."""
        for hslot, kind, obj in self._restores[-new:]:
            ok = alloc.restore_cancel(hslot)
            assert ok, f"cancel of slot {hslot} found no restore in flight"
            if kind == "node":
                self.prefix.mark_spilled(obj, hslot)
            else:
                e.tail_page = None
                e.tail_ready = -1.0
        del self._restores[-new:]

    def _reserve_page(self, alloc, hslot: int, protect) -> Optional[int]:
        page = alloc.restore_begin(hslot)
        if page is None and self.evict(alloc, 1, protect=protect) > 0:
            page = alloc.restore_begin(hslot)
        return page

    def _protected(self, protect) -> set:
        """Caller's protect set plus every unexpired restore
        reservation (expired ones are dropped — the leak backstop)."""
        p = set(protect)
        for rid in list(self._reserved):
            expiry, pages = self._reserved[rid]
            if expiry <= self._now:
                del self._reserved[rid]
            else:
                p |= pages
        return p

    def note_admit(self, alloc, req, hit_tokens: int) -> None:
        """A request was ADMITTED (pages allocated): fold its hit into
        the radix stats and commit any pending session claim — the
        table now references the tail, so the session pin transfers
        (unpin) and the entry is consumed."""
        self._reserved.pop(req.rid, None)      # restore consumed
        self.prefix.note_admit(alloc, req, hit_tokens)
        sid = getattr(req, "session_id", None)
        if sid is None or not self.sessions_enabled:
            return
        self.stats.session_lookups += 1
        e = self.sessions.get(sid)
        if e is None or e.claimed_by != req.rid:
            return
        del self.sessions[sid]
        if e.tail_page is not None:
            alloc.unpin(e.tail_page)
            self.stats.tail_reuses += 1
        self.stats.session_hits += 1
        self.stats.session_hit_tokens += len(e.path)

    def abort(self, req) -> None:
        """Admission failed after ``lookup``: release the claim so the
        session stays resumable (nothing was mutated yet).  Also the
        HOLD path: a held request keeps no claim — in-flight restores
        stay owned by the retention layer and complete regardless."""
        sid = getattr(req, "session_id", None)
        if sid is None:
            return
        e = self.sessions.get(sid)
        if e is not None and e.claimed_by == req.rid:
            e.claimed_by = None
        req.session_hit_tokens = 0

    # ---------------------------------------------------------- eviction --
    def evict(self, alloc, need: int, protect=()) -> int:
        """Free up to ``need`` device pages along the ONE retention
        order: (1) expired session tails (dead weight), (2) LRU cold
        radix prefixes (nobody loses work), (3) live session tails,
        soonest-expiring first (a session loses its resume, no live
        request loses work).  With the host tier enabled every rung
        tries to SPILL its victim first — the HBM page frees either
        way, but a spilled victim stays restorable for a bandwidth
        cost — and destroys only when the host budget is ALSO
        exhausted (after the host pool's own LRU failed to make room
        for a warmer entry).  The caller (``paging.extend_for_decode``)
        falls back to request preemption only when every rung comes up
        empty — a retained page is always sacrificed before any live
        request loses work.

        Pages reserved by an in-flight restore (``_reserved``) are
        protected too: spilling a page some held request is about to
        consume would trade one copy for another forever (restore
        thrash) instead of making progress."""
        protect = self._protected(protect)
        freed = self._reclaim_sessions(alloc, need, protect,
                                       expired_only=True)
        if freed < need:
            freed += self._reclaim_prefix(alloc, need - freed, protect)
        if freed < need:
            freed += self._reclaim_sessions(alloc, need - freed, protect,
                                            expired_only=False)
        if self.tracer.enabled:
            self.tracer.instant("retention", "evict-walk", self._now,
                                cat="evict",
                                args={"need": need, "freed": freed})
        return freed

    def evict_one(self, alloc, protect=()) -> bool:
        return self.evict(alloc, 1, protect) > 0

    def _reclaim_sessions(self, alloc, need: int, protect,
                          expired_only: bool) -> int:
        freed = 0
        if need <= 0 or not self.sessions:
            return 0
        if self.slack_aware and not expired_only:
            # slack-ordered sacrifice (DESIGN.md §8): unpin the session
            # whose class TTFT budget is LOOSEST first — a batch-class
            # transcript eats a cold resume inside its budget; a chat
            # session does not.  Ties fall back to soonest-expiring.
            # The rank is clock-free (class budgets only), so eviction
            # decisions stay parity-equal across backends.
            key = lambda kv: (-kv[1].slo_ttft, kv[1].expires_at)  # noqa: E731
        else:
            key = lambda kv: kv[1].expires_at                     # noqa: E731
        for sid, e in sorted(self.sessions.items(), key=key):
            if freed >= need:
                break
            if (e.claimed_by is not None or e.tail_page is None
                    or e.tail_hslot is not None    # no HBM behind it
                    or e.tail_page in protect
                    or alloc.refs(e.tail_page) != 1):
                continue
            if expired_only and e.expires_at > self._now:
                continue
            if self.spill_enabled and self._spill_tail(alloc, e):
                freed += 1                         # demoted, not destroyed
                continue
            expired = e.expires_at <= self._now
            freed += self._drop_session(alloc, sid, expired=expired)
        return freed

    def _reclaim_prefix(self, alloc, need: int, protect) -> int:
        """Radix rung: spill the LRU frontier to host while the budget
        lasts (spilling a leaf exposes its parent, so rescan per
        generation like ``PrefixCache.evict``), then fall back to
        destructive LRU eviction for the remainder."""
        freed = 0
        if need <= 0:
            return 0
        if self.spill_enabled:
            exhausted = False
            while freed < need and not exhausted:
                progressed = False
                for node in self.prefix.spill_candidates(alloc, protect):
                    if freed >= need:
                        break
                    if not self._spill_node(alloc, node):
                        exhausted = True           # host budget is gone
                        break
                    freed += 1
                    progressed = True
                if not progressed:
                    break
        if freed < need:
            freed += self.prefix.evict(alloc, need - freed, protect)
        return freed

    # ------------------------------------------------- spill transitions --
    def _spill_node(self, alloc, node) -> bool:
        if not self._host_slot_for(alloc, node.stamp):
            return False
        h = alloc.spill(node.page)
        if h is None:
            return False
        if self.copier is not None:
            self.copier.spill(node.page, h)
        self._stamp_checksum(h)
        self.prefix.mark_spilled(node, h)
        self.stats.pages_spilled += 1
        self.stats.spill_seconds += self.spill_seconds_per_page
        self.stats.bytes_spilled += self.spill_page_bytes
        if self.tracer.enabled:
            self.tracer.complete("spill-channel", "spill", self._now,
                                 self.spill_seconds_per_page, cat="spill",
                                 args={"hslot": h, "kind": "prefix"})
        return True

    def _spill_tail(self, alloc, e: _Session) -> bool:
        if (e.tail_page is None or e.tail_hslot is not None
                or e.claimed_by is not None
                or alloc.refs(e.tail_page) != 1
                or not self._host_slot_for(alloc, e.stamp)):
            return False
        h = alloc.spill(e.tail_page)
        if h is None:
            return False
        if self.copier is not None:
            self.copier.spill(e.tail_page, h)
        self._stamp_checksum(h)
        e.tail_page = None
        e.tail_hslot = h
        e.expires_at = math.inf        # demoted: host LRU owns it now
        self.stats.pages_spilled += 1
        self.stats.spill_seconds += self.spill_seconds_per_page
        self.stats.bytes_spilled += self.spill_page_bytes
        if self.tracer.enabled:
            self.tracer.complete("spill-channel", "spill", self._now,
                                 self.spill_seconds_per_page, cat="spill",
                                 args={"hslot": h, "kind": "tail"})
        return True

    def _host_slot_for(self, alloc, stamp: int) -> bool:
        """Ensure a free host slot for an item stamped ``stamp``: when
        the pool is full, drop the LRU spilled item (radix leaf or
        demoted session tail) — but only one COLDER than the incoming
        item, so the host pool converges to the warmest retained set
        instead of thrashing."""
        if not self.spill_enabled:
            return False
        while alloc.free_host_slots() == 0:
            cands = []
            node = self.prefix.lru_spilled_leaf()
            if node is not None:
                cands.append((node.stamp, 0, node))
            sess = min((e for e in self.sessions.values()
                        if e.tail_hslot is not None and e.tail_page is None
                        and e.claimed_by is None),
                       key=lambda e: e.stamp, default=None)
            if sess is not None:
                cands.append((sess.stamp, 1, sess))
            if not cands:
                return False
            vstamp, kind, victim = min(cands)
            if vstamp >= stamp:
                return False           # incoming is colder than the pool
            if kind == 0:
                self.prefix.drop_spilled_node(alloc, victim)
            else:
                self.sessions.pop(victim.sid)
                self._drop_host_slot(alloc, victim.tail_hslot)
        return True

    # --------------------------------------------- recovery / drain hooks --
    def cancel_hold(self, req, timeout: bool = True) -> None:
        """A held request abandons its parked restore — the restore
        timeout fired (stalled channel) or the loop is draining: drop
        its anti-thrash reservation and any session claim so it
        re-enters the queue COLD.  In-flight restores stay owned by the
        layer — if the copies ever land, the pages become ordinary
        retained pages a later admission can hit."""
        self._reserved.pop(req.rid, None)
        self.abort(req)
        if timeout:
            self.stats.restore_timeouts += 1
            if self.tracer.enabled:
                self.tracer.instant("restore-channel", "hold-timeout",
                                    self._now, cat="fault",
                                    args={"rid": req.rid})

    def demote_all(self, alloc) -> int:
        """Drain (core/recovery.py): demote every live session tail
        device->host so retained transcripts survive device teardown —
        the host tier is the designated survivor of device loss.
        Returns tails demoted."""
        n = 0
        for e in list(self.sessions.values()):
            if e.tail_page is not None and e.tail_hslot is None \
                    and e.claimed_by is None \
                    and self._spill_tail(alloc, e):
                n += 1
        return n

    def clear(self, alloc) -> int:
        """Unpin everything — every session tail (committing in-flight
        restores, returning host slots), then the whole radix.
        Returns device pages freed."""
        freed = 0
        for sid in list(self.sessions):
            freed += self._drop_session(alloc, sid, expired=False)
        self._restores.clear()
        self._next_restore = math.inf
        self._checksums.clear()
        return freed + self.prefix.clear(alloc)


# ------------------------------------------------------ shared maintain ---
def maintain_backend(backend, now: float) -> None:
    """THE one housekeeping path for every execution backend's
    ``maintain`` hook: tick the retention layer (TTL expiry/demotion
    AND spill/restore completion polling) exactly when a paged pool
    with a retention layer exists.  Both ``JaxEngineBackend`` and
    ``CostModelBackend`` delegate here verbatim, so an event that fires
    at clock time t in one backend fires at t in the other — the
    pre-PR-5 backends each hand-rolled this guard, and a drift in
    either (ticking without paged, forgetting the completion poll)
    silently broke parity."""
    rt = getattr(backend, "retention", None)
    if rt is not None and getattr(backend, "paged", False):
        rt.tick(backend.alloc, now)
