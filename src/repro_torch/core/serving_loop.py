"""Event-driven serving loop — ONE orchestrator for every substrate.

Historically the repo had two divergent run loops: three hand-rolled
mode loops in ``core/simulator.py`` and a synchronous coupled loop in
``core/engine.py``.  This module extracts the shared orchestration —
arrivals, scheduler ticks, prefill dispatch (optionally in chunks),
KV-transfer/join, decode-pool admission, OOM handling/re-queue, and
per-request timing — into a single :class:`ServingLoop` that drives any
object implementing the :class:`ExecutionBackend` protocol
(DESIGN.md §2).

Backends plug in the substrate:

* ``CostModelBackend`` (core/simulator.py) — analytic A100/TPU cost
  model on a :class:`VirtualClock`; paper-scale discrete-event runs.
* ``JaxEngineBackend`` (core/engine.py)    — real jitted prefill/decode
  on a :class:`WallClock`; tiny-model CPU/TPU runs, token for token.

Execution topology is loop *configuration*, not loop code:

* ``disagg``  — separate prefill/decode executors + KV transfer
  (BucketServe, DistServe).  The real engine also runs this topology:
  chunked prefill interleaves decode iterations between prompt chunks,
  so decode never stalls behind a long prefill.
* ``coupled`` — one executor; each iteration fuses the new prefill
  batch with one decode step over the live pool (Orca-style
  iteration-level scheduling; prefill inflates every concurrent TPOT).
* ``static``  — one executor; a formed batch runs prefill + ALL decode
  steps to completion before the next batch starts, every iteration
  reading the PADDED batch context (paper Fig. 3b waste).

OOM semantics: admitting more live KV tokens than the backend budget
triggers an OOM event — the offending batch is evicted and re-queued
(``requeue=True``: workload stats are not double-counted) after a
restart penalty.  BucketServe's Eq. (5)/(6) safety avoids these by
construction.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import time
from typing import (Dict, List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import numpy as np

from .batcher import FormedBatch
from .monitor import _nearest_rank
from .recovery import (DEFAULT_RECOVERY, LoopCheckpoint, RecoveryPolicy,
                       build_checkpoint)
from .request import Request
from .telemetry import (NULL_TRACER, WAIT_PHASES, LatencyLedger,
                        blame_means)


# -------------------------------------------------------------- clocks ----
class Clock(Protocol):
    """Minimal clock the loop schedules against.  ``virtual`` clocks jump
    between events (discrete-event time); wall clocks sleep."""

    virtual: bool

    def now(self) -> float: ...

    def advance(self, to: float) -> None: ...


class VirtualClock:
    """Discrete-event time: ``advance`` jumps straight to the event."""

    virtual = True

    def __init__(self) -> None:
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def advance(self, to: float) -> None:
        self.t = max(self.t, to)


class WallClock:
    """Scaled wall time: ``time_scale`` virtual seconds per wall second.
    ``advance`` sleeps (capped at 1 ms so arrivals stay responsive)."""

    virtual = False

    def __init__(self, time_scale: float = 1.0) -> None:
        self.time_scale = time_scale
        self._t0 = time.perf_counter()

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return (time.perf_counter() - self._t0) * self.time_scale

    def advance(self, to: float) -> None:
        dt = (to - self.now()) / self.time_scale
        if dt > 0:
            time.sleep(min(dt, 0.001))

    def wall_elapsed(self) -> float:
        return time.perf_counter() - self._t0


# ---------------------------------------------------------------- jobs ----
def plan_chunks(total: int, chunk: Optional[int],
                skip: int = 0) -> List[Tuple[int, int]]:
    """Split ``total`` padded prompt tokens into (start, length) spans.
    ``chunk`` of None/<=0/>=remaining means whole-prompt (one span).
    ``skip`` head positions (a cached prefix) are excluded from
    planning but spans keep ABSOLUTE offsets, so token slicing and RoPE
    stay positionally exact.  Shared by every backend so the span math
    cannot drift between substrates."""
    if skip:
        assert 0 < skip < total, (skip, total)
        return [(skip + s, ln) for s, ln in plan_chunks(total - skip, chunk)]
    if not chunk or chunk <= 0 or chunk >= total:
        return [(0, total)]
    return [(s, min(chunk, total - s)) for s in range(0, total, chunk)]


def batch_prefix_skip(batch: FormedBatch) -> int:
    """Prompt positions a whole batch can skip: the MINIMUM cached
    prefix across rows (page-aligned; a cold row pins it to 0).  Rows
    with longer hits recompute the overlap — bit-identical by
    construction, so correctness never depends on batch mixing.  The
    ONE min-over-batch rule both backends plan chunks with."""
    return min((r.prefix_hit_tokens for r in batch.requests), default=0)


@dataclasses.dataclass
class PrefillJob:
    """A formed batch scheduled onto the prefill executor, split into
    token-span chunks.  Un-chunked execution is the 1-chunk case."""

    batch: FormedBatch
    chunks: List[Tuple[int, int]]            # (start, length) token spans
    next_chunk: int = 0
    started_at: float = -1.0
    handle: object = None                    # backend-private chunk state
    fault_attempts: int = 0                  # injected chunk faults absorbed
    faulted: bool = False                    # ledgers parked in fault_retry

    @property
    def done(self) -> bool:
        return self.next_chunk >= len(self.chunks)


# ------------------------------------------------------------- protocol ---
@runtime_checkable
class ExecutionBackend(Protocol):
    """What a substrate must provide to be driven by the ServingLoop.

    The backend owns *execution* (device state, cost math) and its own
    notion of time; the loop owns *orchestration* (queues, admission,
    OOM policy, timing bookkeeping).  Durations are in the clock's
    (virtual) seconds.  On a wall clock the calls block for real and the
    returned duration is ignored — the loop reads the clock instead.
    """

    clock: Clock
    flops_per_token: float        # model FLOPs per processed token (2·P)
    prefill_needs_slots: bool     # True: a batch needs free decode slots
    supports_decode: bool         # False: requests finish at first token

    def begin(self, requests: Sequence[Request]) -> None:
        """Reset per-run state (token materialization, clock start)."""

    def kv_budget_tokens(self) -> float:
        """Live-token budget for OOM admission (inf = substrate-managed)."""

    def free_slots(self) -> int:
        """Free decode slots (only consulted when prefill_needs_slots)."""

    def admit_blocks(self, requests: Sequence[Request]) -> int:
        """Reserve insert-time KV pages for a PREFIX of the batch; return
        how many requests got pages (all of them for non-paged backends).
        The loop re-queues the rest — the block analogue of the
        decode-slot clamp.  Prefix-cached backends also match each
        prompt against their radix index here, setting
        ``Request.prefix_hit_tokens`` (the loop feeds it to the
        monitor and the chunk plan skips the cached span)."""

    def decode_preempt(self, pool: Sequence[Request]) -> List[Request]:
        """Called before each decode iteration: grow every pooled
        request's pages to cover its next token write, preempting
        requests on pool exhaustion (youngest first, or most-slack
        first when the loop armed ``slack_of``; KV pages for victims
        are already freed).  The loop re-queues the returned victims
        via ``requeue=True``.  Non-paged backends return []."""

    def on_slice_yield(self, req: Request, keep: int) -> None:
        """A preempted request kept its first ``keep`` generated tokens
        (slice-boundary yield): drop backend generation state PAST them
        — the engine truncates its output list, the cost model's
        deterministic id stream is prefix-stable by construction."""

    def on_preempt_reset(self, req: Request) -> None:
        """A preempted request restarts from scratch: drop all of its
        generated state (the engine wipes its output list)."""

    def chunk_plan(self, batch: FormedBatch) -> List[Tuple[int, int]]:
        """Split a batch's padded prompt into (start, length) spans."""

    def prefill_chunk(self, job: PrefillJob, idx: int) -> float:
        """Execute chunk ``idx`` of ``job``; return its duration."""

    def transfer_seconds(self, batch: FormedBatch) -> float:
        """Prefill->decode KV transfer time for the whole batch."""

    def decode_iter(self, pool: Sequence[Request],
                    context_tokens: int) -> float:
        """One decode iteration over the pool (one token per request);
        return its duration.  ``context_tokens`` is the KV volume the
        loop's mode says this iteration reads (exact live tokens, or the
        padded batch context in ``static`` mode)."""

    def release(self, req: Request) -> None:
        """A pooled request finished: end-of-life for its slot/state.
        Retention-aware backends route this through
        ``KvRetention.on_release`` (register the transcript's full
        pages on the radix, pin the partial tail under the session key)
        instead of freeing unconditionally."""

    def generated_tokens(self, req: Request) -> "np.ndarray":
        """Token ids this backend generated for ``req`` so far (the
        engine's actual argmax outputs; the cost model's deterministic
        synthetic ids).  The loop composes the next session turn's
        prompt from them — each backend is self-consistent, which is
        all transcript reuse needs."""

    def maintain(self, now: float) -> None:
        """Periodic housekeeping at clock time ``now`` (the retention
        layer's session-TTL tick).  Called once per loop iteration."""


# -------------------------------------------------------------- results ---
@dataclasses.dataclass
class ServeResult:
    """Per-run outcome + executor accounting (works for both virtual and
    wall backends; ``makespan`` is in the backend clock's seconds)."""

    requests: List[Request]
    makespan: float
    busy_prefill: float
    busy_decode: float
    useful_flops: float
    padded_flops: float
    oom_events: int
    bucketing_overhead_s: float
    prefill_time_total: float = 0.0
    decode_time_total: float = 0.0
    transfer_time_total: float = 0.0
    interleaved_decode_steps: int = 0    # decode iters run mid-prefill-job
    peak_pool: int = 0                   # max concurrent decode requests
    preempt_events: int = 0              # paged-pool mid-decode evictions
    slice_yields: int = 0                # ... that preserved generated work
    # ---- prefix-cache accounting (core/prefix_cache.py) ----
    prefill_tokens_processed: int = 0    # padded prompt tokens actually run
    prefill_tokens_skipped: int = 0      # prompt tokens served from cache
    prefix_lookups: int = 0              # admitted requests matched
    prefix_hits: int = 0                 # ... with >= 1 cached page
    prefix_hit_tokens: int = 0
    prefix_pages_saved: int = 0
    prefix_evictions: int = 0
    shared_pages_peak: int = 0
    # ---- session retention accounting (core/retention.py) ----
    session_lookups: int = 0             # admitted requests with a session id
    session_hits: int = 0                # ... resumed from a live entry
    session_hit_tokens: int = 0          # transcript tokens restored
    sessions_retained: int = 0           # release-time entries created
    sessions_expired: int = 0            # TTL-tick unpins
    sessions_evicted: int = 0            # pressure unpins
    tail_pages_reused: int = 0           # pinned partial tails handed back
    # ---- host spill tier accounting (core/retention.py, PR 5) ----
    spilled_pages: int = 0               # device->host copies initiated
    restored_pages: int = 0              # host->device copies completed
    restored_tokens: int = 0             # KV tokens restored, not re-prefilled
    spill_drops: int = 0                 # spilled entries destroyed
    spill_hold_events: int = 0           # requests held on a restore
    spill_time_total: float = 0.0        # priced device->host transfer s
    restore_time_total: float = 0.0      # priced host->device transfer s
    spilled_bytes: int = 0               # COMPRESSED bytes moved dev->host
    restored_bytes: int = 0              # COMPRESSED bytes moved host->dev
    # ---- observability gauges (core/telemetry.py, PR 8) ----
    # time-weighted mean KV-pool occupancy over the run (paged: used
    # pages / pool pages; token-budget: live tokens / budget; slot
    # engine: occupied slots / slots)
    kv_util_time_weighted: float = 0.0
    # per dispatched prefill batch, in dispatch order: measured Eq.-(1)
    # padding waste and min/max-length homogeneity
    batch_padding_fractions: List[float] = dataclasses.field(
        default_factory=list)
    batch_homogeneity: List[float] = dataclasses.field(default_factory=list)
    # ---- fault/recovery plane (core/faults.py, core/recovery.py) ----
    fault_events: int = 0            # injected faults absorbed by the loop
    fault_retries: int = 0           # backoff retries (prefill/decode)
    fault_kills: int = 0             # decode pools killed after max retries
    quarantined: int = 0             # poisoned requests dropped (ledger-closed)
    restore_stalls: int = 0          # injected restore-channel stalls
    restore_retries: int = 0         # restore-channel retries (backoff)
    restore_failures: int = 0        # restore runs abandoned after retries
    restore_sheds: int = 0           # restores shed by the slack rule
    restore_timeouts: int = 0        # held requests unparked by the timeout
    corruptions: int = 0             # host-slot checksum mismatches caught

    def finished(self):
        return [r for r in self.requests if r.finished >= 0]

    # ---- tail-latency percentiles (PR 7) ----------------------------
    # Gates are on P99, not means: a mean hides the convoy-effect tail
    # that SLO attainment is actually about (DESIGN.md §6).  Nearest-
    # rank percentiles (ceil(q/100 * n)-th sorted sample) so hand-built
    # test series have exact expected values — no interpolation.

    def classes(self) -> List[str]:
        """Distinct request class tags present (sorted; '' excluded)."""
        return sorted({r.cls for r in self.requests if r.cls})

    def incomplete(self, cls: Optional[str] = None) -> int:
        """Requests that never produced a first token (dropped or still
        queued at time limit).  EXCLUDED from the TTFT series — an inf
        sample would poison every percentile above its rank — but
        reported here so a run can't quietly shed its tail."""
        return sum(1 for r in self.requests
                   if r.first_token < 0 and (cls is None or r.cls == cls))

    def ttft_series(self, cls: Optional[str] = None) -> List[float]:
        return [r.ttft() for r in self.requests
                if r.first_token >= 0 and (cls is None or r.cls == cls)]

    def tpot_series(self, cls: Optional[str] = None) -> List[float]:
        # needs >= 2 tokens for a per-token interval to exist
        return [r.tpot() for r in self.requests
                if r.finished >= 0 and r.generated > 1
                and (cls is None or r.cls == cls)]

    def percentile(self, q: float, metric: str = "ttft",
                   cls: Optional[str] = None) -> float:
        assert metric in ("ttft", "tpot"), metric
        xs = self.ttft_series(cls) if metric == "ttft" \
            else self.tpot_series(cls)
        if not xs:
            return float("nan")
        # the SAME nearest-rank rule GlobalMonitor snapshots use
        # (monitor._nearest_rank) — live and post-run percentile
        # definitions cannot diverge
        return _nearest_rank(xs, q)

    def p50(self, metric: str = "ttft", cls: Optional[str] = None) -> float:
        return self.percentile(50.0, metric, cls)

    def p95(self, metric: str = "ttft", cls: Optional[str] = None) -> float:
        return self.percentile(95.0, metric, cls)

    def p99(self, metric: str = "ttft", cls: Optional[str] = None) -> float:
        return self.percentile(99.0, metric, cls)

    def throughput_tok_s(self) -> float:
        toks = sum(r.generated + r.prompt_len for r in self.finished())
        return toks / max(self.makespan, 1e-9)

    def output_tok_s(self) -> float:
        return sum(r.generated for r in self.finished()) / max(self.makespan,
                                                               1e-9)

    def server_rps(self) -> float:
        return len(self.finished()) / max(self.makespan, 1e-9)

    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / max(self.prefix_lookups, 1)

    def session_hit_rate(self) -> float:
        return self.session_hits / max(self.session_lookups, 1)

    def slo_attainment(self, cls: Optional[str] = None) -> float:
        """Fraction of requests meeting BOTH SLO budgets (per-request
        budgets — under a heterogeneous mix each class carries its own).
        Optional ``cls`` filters to one class."""
        reqs = [r for r in self.requests if cls is None or r.cls == cls]
        if not reqs:
            return 0.0
        return sum(r.slo_met() for r in reqs) / len(reqs)

    def goodput(self, cls: Optional[str] = None) -> float:
        """Requests per second that FINISHED inside both SLO budgets —
        the deadline-aware throughput the goodput scheduler optimizes
        (DESIGN.md §8).  Unlike ``slo_attainment`` (a fraction) this is
        denominated in absolute work, so shedding load can never game
        it; unlike ``server_rps`` a late finish earns nothing."""
        n = sum(1 for r in self.requests
                if r.slo_met() and (cls is None or r.cls == cls))
        return n / max(self.makespan, 1e-9)

    def utilization(self, hw) -> float:
        """Model-FLOPs utilization over the busy window (the cost model's
        analogue of the paper's GPU-utilization metric)."""
        chips = hw.prefill_chips + hw.decode_chips
        return self.useful_flops / max(
            chips * hw.peak_flops * self.makespan, 1e-9)

    def padding_efficiency(self) -> float:
        return self.useful_flops / max(self.padded_flops, 1e-9)

    # ---- latency blame (core/telemetry.py ledgers, PR 8) -------------
    def padding_waste_ratio(self) -> float:
        """Mean measured per-batch padding fraction (Eq. 1's overhead,
        observed at dispatch rather than modeled)."""
        fr = self.batch_padding_fractions
        return sum(fr) / len(fr) if fr else 0.0

    def blame(self, cls: Optional[str] = None) -> Dict[str, float]:
        """Mean end-to-end phase breakdown (seconds per request) over
        retired requests — where a request's lifetime actually went."""
        return blame_means(
            [r.ledger.phases for r in self.requests
             if r.ledger is not None and r.ledger.closed
             and (cls is None or r.cls == cls)])

    def ttft_blame(self, cls: Optional[str] = None,
                   tail_q: Optional[float] = None) -> Dict[str, float]:
        """Mean phase breakdown of the time UP TO first token, over
        requests that produced one; ``tail_q`` restricts to the TTFT
        tail at/above that percentile (e.g. 99 -> the P99 convoy)."""
        reqs = [r for r in self.requests
                if r.first_token >= 0 and r.ledger is not None
                and r.ledger.ttft_phases is not None
                and (cls is None or r.cls == cls)]
        if tail_q is not None and reqs:
            thresh = self.percentile(tail_q, "ttft", cls)
            reqs = [r for r in reqs if r.ttft() >= thresh]
        return blame_means([r.ledger.ttft_phases for r in reqs])

    def ttft_wait_share(self, cls: Optional[str] = None,
                        tail_q: Optional[float] = None) -> float:
        """Fraction of (tail) TTFT spent WAITING (queue / clamp /
        requeue / restore hold) vs compute+transfer — the one number
        the burst-tail blame gate reads: static batching's P99 TTFT is
        queue-dominated, BucketServe's is not."""
        b = self.ttft_blame(cls, tail_q)
        tot = sum(b.values())
        if tot <= 0.0:
            return 0.0
        return sum(b.get(p, 0.0) for p in WAIT_PHASES) / tot

    def busy_utilization(self, n_executors: int = 2) -> float:
        """Fraction of executor-time busy — the closest analogue of the
        paper's 'average GPU utilization' (Fig. 5b)."""
        return min(1.0, (self.busy_prefill + self.busy_decode)
                   / max(n_executors * self.makespan, 1e-9))


@dataclasses.dataclass
class _LoopState:
    kv_budget: float
    ai: int = 0
    done: int = 0
    busy_p: float = 0.0
    busy_d: float = 0.0
    useful: float = 0.0
    padded: float = 0.0
    oom: int = 0
    t_pre: float = 0.0
    t_dec: float = 0.0
    t_xfer: float = 0.0
    interleaved: int = 0
    peak: int = 0
    preempts: int = 0
    slice_yields: int = 0
    prefill_tok: int = 0
    prefill_skip: int = 0
    # time-weighted KV occupancy integral (level x dt, advanced once
    # per loop iteration in _maintain) and per-batch waste gauges
    util_acc: float = 0.0
    util_t: float = 0.0
    pad_fracs: List[float] = dataclasses.field(default_factory=list)
    homog: List[float] = dataclasses.field(default_factory=list)
    # fault/recovery counters (core/faults.py)
    faults: int = 0
    retries: int = 0
    kills: int = 0
    quarantined: int = 0
    restore_timeouts: int = 0


# ---------------------------------------------------------------- config --
@dataclasses.dataclass(frozen=True)
class LoopConfig:
    mode: str = "disagg"              # disagg | coupled | static
    decode_slot_cap: int = 256
    restart_penalty: float = 0.5
    tick: float = 0.005
    # slice-boundary preemption (DESIGN.md §8, arXiv 2406.13511): a
    # preempted decode request keeps its generated tokens up to the
    # last multiple of ``slice_tokens`` — they are promoted into its
    # prompt, so the requeued request RE-PREFILLS the preserved work
    # (bounded, parallel) instead of re-decoding it (serial).  None
    # disables (legacy full-restart preemption).  Disagg mode only.
    slice_tokens: Optional[int] = None
    # restore-hold timeout (DESIGN.md §9, satellite of the fault plane
    # but active in EVERY run): a request parked on a host->device
    # restore for longer than this re-enters the queue COLD — a stalled
    # PCIe channel costs a re-prefill, never a hang.  <= 0 disables.
    restore_timeout: float = 30.0


# ------------------------------------------------------------------ loop --
class ServingLoop:
    """Drives a scheduler policy against an :class:`ExecutionBackend`."""

    def __init__(self, scheduler, backend: ExecutionBackend,
                 config: LoopConfig = LoopConfig(), recorder=None,
                 tracer=None, faults=None,
                 recovery: Optional[RecoveryPolicy] = None):
        assert config.mode in ("disagg", "coupled", "static"), config.mode
        # slice resume re-enters through chunked prefill + transfer/join;
        # the fused loops stamp first_token/generated unconditionally
        assert config.slice_tokens is None or config.mode == "disagg", \
            "slice-boundary preemption requires the disagg topology"
        # the decode-step/prefill-chunk injection sites live on the
        # overlapped executors; chaos runs use the disagg topology
        assert faults is None or config.mode == "disagg", \
            "fault injection requires the disagg topology"
        self.sched = scheduler
        self.backend = backend
        self.cfg = config
        # fault-injection / recovery plane (core/faults.py, DESIGN.md
        # §9).  The policy is ALWAYS armed (the restore-hold timeout
        # protects fault-free runs too); the injector defaults off.
        self._faults = faults
        self._recovery = recovery if recovery is not None \
            else DEFAULT_RECOVERY
        # optional TraceRecorder (data/trace.py): pristine request
        # snapshots after backend.begin + the run's dispatch/requeue/
        # turn event log (the replay bit-identity surface)
        self.recorder = recorder
        # optional event timeline (core/telemetry.py).  Call sites guard
        # on tracer.enabled before building any event argument — the
        # disabled default costs no allocations on the hot path.
        self.tracer = tracer if tracer is not None else NULL_TRACER

    # ------------------------------------------------------------- run ----
    def run(self, requests: List[Request], time_limit: float = 3600.0,
            max_wall_s: Optional[float] = None,
            drain_at: Optional[float] = None,
            resume_clock: Optional[float] = None) -> ServeResult:
        # Later session turns are HELD until their predecessor finishes
        # — only then can their prompt (prior transcript + utterance) be
        # composed and their arrival (finish + think gap) be known.  A
        # turn whose tokens are ALREADY composed needs no predecessor:
        # it was unlocked before a checkpointed drain (its predecessor
        # finished pre-drain and is absent here), so it re-enters as a
        # plain arrival with its recorded think-gap arrival time.
        self._held: Dict[Tuple[int, int], Request] = {
            (r.session_id, r.turn): r for r in requests
            if r.session_id is not None and r.turn > 0
            and r.tokens is None}
        self._arrivals = sorted(
            (r for r in requests
             if r.session_id is None or r.turn == 0
             or r.tokens is not None),
            key=lambda r: r.arrival)
        self._requests = requests                # drain() snapshots these
        self._n = len(requests)
        self._max_wall_s = max_wall_s
        self._drain_at = drain_at
        self._drained: Optional[LoopCheckpoint] = None
        self._drain_demoted = 0
        self.pool: List[Request] = []
        self.pending_join: List[list] = []       # [ready_time, request]
        # restore-in-flight requests, PARKED (not re-prefilled) until
        # their host->device copy lands: [ready, request, held_since]
        self._held_restore: List[list] = []
        self._spill_seen = (0, 0)                # (spilled, restored) fed
        self.job: Optional[PrefillJob] = None
        self._decode_fault_attempts = 0          # consecutive decode faults
        self._decode_faulted = False             # pool needs a re-stamp
        self.st = _LoopState(kv_budget=self.backend.kv_budget_tokens())
        self._last_util = -1.0                   # last emitted kv counter
        # fresh ledgers: phase stamping starts from a clean slate even
        # when a request object is reused across runs
        for r in requests:
            r.ledger = LatencyLedger()
        self.backend.begin(requests)
        rebase = 0.0
        if resume_clock is not None:
            if self.backend.clock.virtual:
                # cold resume from a LoopCheckpoint: continue at the
                # drain clock so resumed timings compose with pre-drain
                # anchors
                self.backend.clock.advance(resume_clock)
            else:
                # a wall clock cannot jump to the drain time: instead
                # rebase every checkpoint-frame stamp (anchors,
                # arrivals) into THIS clock's frame — deadlines and
                # think gaps are relative ages, so shifting both ends
                # preserves them exactly (AFTER begin: it restarts the
                # wall clock)
                rebase = self.backend.clock.now() - resume_clock
        for r in requests:
            if rebase:
                r.arrival += rebase
                if r.t0_anchor >= 0.0:
                    r.t0_anchor = r.t0_anchor + rebase
            # resumed requests carry their ORIGINAL first-arrival anchor
            # across the checkpoint boundary: deadlines survive a drain
            if r.t0_anchor >= 0.0:
                r.ledger.start(r.t0_anchor)
        # arm the fault/recovery seam on the retention layer AFTER begin
        # (backends rebuild retention there).  Recovery is armed only
        # with an injector — the fault-free restore path stays priced by
        # the channel model alone; the LOOP-level restore-hold timeout
        # (cfg.restore_timeout) protects every run regardless.
        if self._faults is not None:
            rt_f = getattr(self.backend, "retention", None)
            if rt_f is not None:
                rt_f.faults = self._faults
                rt_f.recovery = self._recovery
        # deadline-slack sacrifice wiring (DESIGN.md §8): when the
        # scheduler is slack-aware, every sacrifice point — decode
        # victim choice, retention eviction rungs, restore-hold release
        # — prefers the request/session with the MOST remaining slack.
        # AFTER begin: backends rebuild retention there.  The victim
        # key is the CLOCK-FREE class-budget proxy so both substrates
        # pick identical victims regardless of clock skew.
        self._slack_aware = bool(getattr(self.sched, "slack_aware", False))
        if self._slack_aware:
            self.backend.slack_of = Request.sacrifice_slack
            rt0 = getattr(self.backend, "retention", None)
            if rt0 is not None:
                rt0.slack_aware = True
        if self.tracer.enabled:
            # propagate the seam to the layers that emit their own
            # events; AFTER begin — backends rebuild retention there
            self.sched.tracer = self.tracer
            rt = getattr(self.backend, "retention", None)
            if rt is not None:
                rt.tracer = self.tracer
        if self.recorder is not None:
            # AFTER begin (prompt ids materialized), BEFORE the loop
            # mutates state (requeues overwrite arrivals, session turns
            # get composed prompts) — see data/trace.py contract
            self.recorder.on_begin(requests)
        if self.cfg.mode == "disagg":
            self._run_overlapped(time_limit)
        else:
            self._run_fused(time_limit, static=self.cfg.mode == "static")
        st = self.st
        self._note_util(self.backend.clock.now())   # close the integral
        overhead = getattr(getattr(self.sched, "buckets", None),
                           "overhead_s", 0.0)
        extra = {}
        pc = getattr(self.backend, "prefix_cache", None)
        if pc is not None:
            extra = dict(prefix_lookups=pc.stats.lookups,
                         prefix_hits=pc.stats.hits,
                         prefix_hit_tokens=pc.stats.hit_tokens,
                         prefix_pages_saved=pc.pages_saved(),
                         prefix_evictions=pc.stats.evictions,
                         shared_pages_peak=pc.stats.peak_shared)
        rt = getattr(self.backend, "retention", None)
        if rt is not None:
            extra.update(session_lookups=rt.stats.session_lookups,
                         session_hits=rt.stats.session_hits,
                         session_hit_tokens=rt.stats.session_hit_tokens,
                         sessions_retained=rt.stats.sessions_retained,
                         sessions_expired=rt.stats.sessions_expired,
                         sessions_evicted=rt.stats.sessions_evicted,
                         tail_pages_reused=rt.stats.tail_reuses,
                         spilled_pages=rt.stats.pages_spilled,
                         restored_pages=rt.stats.pages_restored,
                         restored_tokens=rt.stats.restored_tokens,
                         spill_drops=rt.stats.spill_drops,
                         spill_hold_events=rt.stats.restore_holds,
                         spill_time_total=rt.stats.spill_seconds,
                         restore_time_total=rt.stats.restore_seconds,
                         spilled_bytes=rt.stats.bytes_spilled,
                         restored_bytes=rt.stats.bytes_restored,
                         restore_stalls=rt.stats.restore_stalls,
                         restore_retries=rt.stats.restore_retries,
                         restore_failures=rt.stats.restore_failures,
                         restore_sheds=rt.stats.restore_sheds,
                         corruptions=rt.stats.corruptions)
        return ServeResult(
            requests=requests, makespan=self.backend.clock.now(),
            busy_prefill=st.busy_p, busy_decode=st.busy_d,
            useful_flops=st.useful, padded_flops=st.padded,
            oom_events=st.oom, bucketing_overhead_s=overhead,
            prefill_time_total=st.t_pre, decode_time_total=st.t_dec,
            transfer_time_total=st.t_xfer,
            interleaved_decode_steps=st.interleaved,
            peak_pool=st.peak, preempt_events=st.preempts,
            slice_yields=st.slice_yields,
            prefill_tokens_processed=st.prefill_tok,
            prefill_tokens_skipped=st.prefill_skip,
            kv_util_time_weighted=st.util_acc
            / max(self.backend.clock.now(), 1e-9),
            batch_padding_fractions=st.pad_fracs,
            batch_homogeneity=st.homog,
            fault_events=st.faults, fault_retries=st.retries,
            fault_kills=st.kills, quarantined=st.quarantined,
            restore_timeouts=st.restore_timeouts, **extra)

    # ------------------------------------------------- drain / resume -----
    def drain(self) -> LoopCheckpoint:
        """Checkpointed drain (DESIGN.md §9): quiesce every in-flight
        request WORK-PRESERVINGLY — pooled decodes yield at their last
        slice boundary, transfer-waits and mid-prefill rows fold back
        onto their preserved prompts, parked restores abandon their
        holds — demote live session tails to the host tier, and emit
        the serializable checkpoint a COLD loop ``resume``s from.
        Call after ``run(..., drain_at=t)`` returned."""
        now = self.backend.clock.now()
        evict = getattr(self.backend, "evict_request", None)
        for r in list(self.pool):
            self.pool.remove(r)
            self.sched.release_decode(r)
            if evict is not None:
                evict(r)
            self._yield_or_reset(r)
        for item in list(self.pending_join):
            r = item[1]
            self.sched.release_decode(r)   # admitted at prefill end
            if evict is not None:
                evict(r)
            self._yield_or_reset(r)
        self.pending_join.clear()
        if self.job is not None:
            abort = getattr(self.backend, "abort_prefill", None)
            for r in self.job.batch.requests:
                if abort is not None:
                    abort(r)
                self._yield_or_reset(r)
            self.job = None
        rt = getattr(self.backend, "retention", None)
        for item in list(self._held_restore):
            r = item[1]
            r.spill_wait = -1.0
            if rt is not None:
                rt.cancel_hold(r, timeout=False)
        self._held_restore.clear()
        self._drain_demoted = 0
        alloc = getattr(self.backend, "alloc", None)
        if rt is not None and alloc is not None:
            self._drain_demoted = rt.demote_all(alloc)
        ck = build_checkpoint(self, now)
        self._drained = ck
        if self.tracer.enabled:
            self.tracer.instant("loop", "drain", now, cat="drain",
                                args={"requests": len(ck.requests),
                                      "held_turns": len(ck.held_turns),
                                      "tails_demoted": ck.tails_demoted})
        return ck

    def resume(self, ck: LoopCheckpoint, time_limit: float = 3600.0,
               max_wall_s: Optional[float] = None) -> ServeResult:
        """Continue a drained run on THIS loop (typically a cold one in
        a new process): the checkpoint's requests re-enter in original
        arrival order carrying their deadline anchors, and the clock
        starts at the drain time so post-resume stamps compose with
        pre-drain anchors.  Preserved work re-prefills from each
        request's prompt — continuation token ids are bit-identical to
        the undrained run (the PR 9 slice-resume argument, applied
        across a process boundary)."""
        return self.run(ck.restore_requests(), time_limit=time_limit,
                        max_wall_s=max_wall_s, resume_clock=ck.now)

    # ------------------------------------------------------------ shared --
    def _wall_exceeded(self) -> bool:
        return (self._max_wall_s is not None
                and not self.backend.clock.virtual
                and self.backend.clock.wall_elapsed() > self._max_wall_s)

    def _after(self, start: float, duration: float) -> float:
        """Completion time of a backend call dispatched at ``start``: in
        virtual time the event is scheduled; in wall time it already
        happened — read the clock."""
        if self.backend.clock.virtual:
            return start + duration
        return self.backend.clock.now()

    def _admit_arrivals(self, now: float) -> None:
        # _arrivals can be SHORTER than _n (held session turns join it
        # only when their predecessor finishes) and can grow mid-run
        st = self.st
        while st.ai < len(self._arrivals) \
                and self._arrivals[st.ai].arrival <= now:
            r = self._arrivals[st.ai]
            t = r.arrival if self.backend.clock.virtual else now
            self.sched.on_arrival(r, t)
            if r.ledger is not None and not r.ledger.started:
                r.ledger.start(t)
            if self.tracer.enabled:
                self.tracer.async_begin(
                    "requests", f"req-{r.rid}", t, r.rid,
                    args={"cls": r.cls, "prompt_len": r.prompt_len})
            st.ai += 1

    def _process_joins(self, now: float) -> None:
        for item in list(self.pending_join):
            if item[0] <= now and len(self.pool) < self.cfg.decode_slot_cap:
                r = item[1]
                self.pool.append(r)
                self.pending_join.remove(item)
                if r.ledger is not None:
                    # the transfer phase absorbs any decode-slot wait
                    # past the modeled copy time (join is slot-gated)
                    r.ledger.to("decode", now)
        self.st.peak = max(self.st.peak, len(self.pool))

    @staticmethod
    def _live_tokens(pool: Sequence[Request]) -> int:
        return sum(r.prompt_len + r.generated for r in pool)

    def _requeue(self, r: Request, t: float, cause: str = "clamp",
                 at: Optional[float] = None) -> None:
        """THE re-queue funnel: every path that puts a request back in
        the arrival queue (OOM restart, slot/page clamp, preemption,
        restore-hold release) goes through here, so the recorder sees
        every re-arrival and stats are never double-counted.

        ``cause`` picks the ledger phase the coming wait is blamed on:
        "clamp" -> ``admission_block`` (bounced off a slot/page limit),
        "restore" -> back to plain ``queue`` (the hold itself was
        already accounted as ``restore_hold``), "oom"/"preempt"/"fault"
        -> the restart-penalty ``requeue_gap``, which begins at ``at``
        (the eviction instant), not at the post-penalty re-arrival
        ``t``."""
        led = r.ledger
        if led is not None and led.started and not led.closed:
            if cause == "clamp":
                led.to("admission_block", at if at is not None else t)
            elif cause == "restore":
                led.to("queue", at if at is not None else t)
            else:                                    # oom | preempt | fault
                led.gap(at if at is not None else t, r.arrival)
        self.sched.on_arrival(r, t, requeue=True)
        if self.recorder is not None:
            self.recorder.on_requeue(r, t)

    def _handle_oom(self, batch: FormedBatch, now: float) -> None:
        """Evict + re-queue; oversized singletons are dropped (unservable);
        the scheduler's retry backoff (notify_oom) shrinks its next cap.
        Re-queues use ``requeue=True`` so arrival stats are not
        double-counted."""
        if hasattr(self.sched, "notify_oom"):
            self.sched.notify_oom()
        for r in batch.requests:
            if r.prompt_len + r.max_new_tokens > self.st.kv_budget:
                r.dropped = True
                r.finished = -1.0
                self._retire(r, now)
                continue
            r.arrival = now + self.cfg.restart_penalty
            self._requeue(r, r.arrival, cause="oom", at=now)

    def _note_first(self, r: Request) -> None:
        """First token just stamped: feed the TTFT sample to the monitor
        so snapshots expose live tail percentiles."""
        mon = getattr(self.sched, "monitor", None)
        if mon is not None and hasattr(mon, "on_first_token"):
            mon.on_first_token(r.ttft(), r.cls)

    # ----------------------------------------------- sessions (retirement) --
    def _retire(self, r: Request, end: float) -> None:
        """A request left the system (finished or dropped): count it
        done and, if it was a session turn, unlock the next one."""
        self.st.done += 1
        led = r.ledger
        if led is not None and led.started and not led.closed:
            # close at the request's OWN finish stamp when it has one
            # (static mode retires the whole batch at the batch end);
            # drops close at the drop instant — they conserve too
            led.close(r.finished if r.finished >= 0 else end)
        if self.tracer.enabled:
            self.tracer.async_end(
                "requests", f"req-{r.rid}",
                r.finished if r.finished >= 0 else end, r.rid,
                args={"dropped": r.dropped})
        mon = getattr(self.sched, "monitor", None)
        if mon is not None:
            if r.finished >= 0 and r.generated > 1 \
                    and hasattr(mon, "on_tpot"):
                mon.on_tpot(r.tpot(), r.cls)
            if led is not None and led.closed and hasattr(mon, "on_retire"):
                mon.on_retire(r.cls, led.phases, slo_met=r.slo_met())
        self._unlock_next_turn(r, end)

    def _unlock_next_turn(self, r: Request, end: float) -> None:
        """Compose and release the successor turn of ``r``'s session:
        prompt = prior prompt + this turn's ACTUAL generated tokens +
        the successor's utterance, arriving after the think-time gap.
        Each backend supplies its own generated ids (the engine's real
        argmax outputs, the cost model's deterministic synthetics), so
        transcripts are self-consistent per substrate — which is what
        makes a resumed turn's prefill skip bit-exact.  A dropped turn
        cascades: its successors can never be composed."""
        if r.session_id is None:
            return
        nxt = self._held.pop((r.session_id, r.turn + 1), None)
        if nxt is None:
            return
        if r.dropped or r.finished < 0:
            while nxt is not None:
                nxt.dropped = True
                nxt.finished = -1.0
                led = nxt.ledger
                if led is not None and not led.closed:
                    # never admitted: open-and-shut at the cascade time
                    # so dropped turns still satisfy conservation
                    if not led.started:
                        led.start(end)
                    led.close(end)
                self.st.done += 1
                nxt = self._held.pop((r.session_id, nxt.turn + 1), None)
            return
        if r.tokens is not None and nxt.utterance is not None:
            gen = np.asarray(self.backend.generated_tokens(r),
                             dtype=np.int32)
            prompt = np.concatenate([
                np.asarray(r.tokens[:r.prompt_len], dtype=np.int32),
                gen, nxt.utterance])
            assert len(prompt) == nxt.prompt_len, \
                (len(prompt), nxt.prompt_len, r.rid, nxt.rid)
            nxt.tokens = prompt
            nxt.history_tokens = r.prompt_len + len(gen)
        nxt.arrival = end + max(nxt.think_gap, 0.0)
        if self.recorder is not None:
            self.recorder.on_turn(nxt, nxt.arrival)
        bisect.insort(self._arrivals, nxt, lo=self.st.ai,
                      key=lambda q: q.arrival)

    def _maintain(self, now: float) -> None:
        """Backend housekeeping (session-TTL tick + spill/restore
        completion polling) once per iteration; forwards spill traffic
        deltas to the monitor."""
        self._note_util(now)
        m = getattr(self.backend, "maintain", None)
        if m is not None:
            if self._faults is not None \
                    and self._faults.fire("maintain_tick"):
                # maintain-tick clock hiccup: this housekeeping tick is
                # lost.  TTL expiry and spill/restore completion polling
                # are deadline-idempotent, so a skipped tick only delays
                # them to the next iteration — which is the invariant
                # the chaos suite pins down.
                self.st.faults += 1
            else:
                m(now)
        rt = getattr(self.backend, "retention", None)
        mon = getattr(self.sched, "monitor", None)
        if rt is not None and mon is not None:
            sp, re = rt.stats.pages_spilled, rt.stats.pages_restored
            if (sp, re) != self._spill_seen:
                mon.on_spill_traffic(sp - self._spill_seen[0],
                                     re - self._spill_seen[1])
                self._spill_seen = (sp, re)
            # restore-aware admission pricing: expose the in-flight
            # restore LEVEL so Eq. (6) leaves headroom for reserved
            # pages and the compressed channel backlog
            if hasattr(mon, "on_restore_state"):
                mon.on_restore_state(rt.restore_pages_in_flight(),
                                     rt.restore_backlog_bytes())

    def _kv_level(self) -> float:
        """Instantaneous KV-pool occupancy in [0, 1]: used pages for
        paged backends, occupied slots for the slot engine, live tokens
        against the Eq. (6) budget otherwise."""
        alloc = getattr(self.backend, "alloc", None)
        if alloc is not None:
            n = getattr(alloc, "n_pages", 0)
            if n:
                return 1.0 - alloc.free_pages() / n
        if self.backend.prefill_needs_slots:
            cap = max(self.cfg.decode_slot_cap, 1)
            return min(1.0, max(0.0,
                                1.0 - self.backend.free_slots() / cap))
        if math.isfinite(self.st.kv_budget) and self.st.kv_budget > 0:
            return min(1.0,
                       self._live_tokens(self.pool) / self.st.kv_budget)
        return 0.0

    def _note_util(self, now: float) -> None:
        """Advance the time-weighted pool-occupancy integral to ``now``
        (sampled once per loop iteration — level changes only at events,
        which always run through an iteration boundary)."""
        st = self.st
        if now <= st.util_t:
            return
        level = self._kv_level()
        st.util_acc += level * (now - st.util_t)
        st.util_t = now
        if self.tracer.enabled and abs(level - self._last_util) > 1e-9:
            self.tracer.counter("kv", "kv_util", now, {"util": level})
            self._last_util = level

    def _release_held(self, now: float) -> None:
        """Re-queue parked requests whose restore landed — their next
        admission finds the restored pages LIVE and resumes past them.
        Under a slack-aware scheduler the batch of due releases re-enters
        tightest-budget first, so a same-tick admission race between two
        resumed requests is settled in deadline order."""
        timeout = self.cfg.restore_timeout
        due, timed_out = [], []
        for item in self._held_restore:
            if item[0] <= now:
                due.append(item)
            elif timeout > 0 and now >= item[2] + timeout:
                timed_out.append(item)
        for item in timed_out:
            # restore-hold timeout (DESIGN.md §9): the channel never
            # delivered — abandon the claimed restore and re-enter COLD.
            # A stalled PCIe link costs a re-prefill, never a hang.
            self._held_restore.remove(item)
            r = item[1]
            r.spill_wait = -1.0
            rt = getattr(self.backend, "retention", None)
            if rt is not None:
                rt.cancel_hold(r)
            self.st.restore_timeouts += 1
            self._requeue(r, now, cause="restore")
        if not due:
            return
        if getattr(self, "_slack_aware", False):
            due.sort(key=lambda it: (it[1].sacrifice_slack(), it[1].rid))
        for item in due:
            self._held_restore.remove(item)
            r = item[1]
            r.spill_wait = -1.0
            # arrival stays untouched: the hold is queueing delay,
            # so the restore latency lands on this request's TTFT
            self._requeue(r, now, cause="restore")

    def _form_batch(self, now: float, *,
                    count_pending: bool) -> Tuple[Optional[FormedBatch], bool]:
        """One scheduler tick -> (batch, oomed).  Applies the backend KV
        budget (virtual substrates) and the decode-slot clamp (real
        substrates, excess re-queued without stat double-counting)."""
        st = self.st
        if self.backend.prefill_needs_slots and self.backend.free_slots() <= 0:
            return None, False
        batch = self.sched.next_prefill_batch(now)
        if batch is None:
            return None, False
        if self.backend.prefill_needs_slots:
            free = self.backend.free_slots()
            if batch.size > free:                    # slot-capacity clamp
                for r in batch.requests[free:]:
                    self._requeue(r, now)
                batch = FormedBatch(batch.requests[:free], batch.pad_to,
                                    bucket=batch.bucket)
        if math.isfinite(st.kv_budget):
            batch_tokens = sum(r.prompt_len + r.max_new_tokens
                               for r in batch.requests)
            pending_tokens = sum(it[1].prompt_len + it[1].max_new_tokens
                                 for it in self.pending_join) \
                if count_pending else 0
            if (self._live_tokens(self.pool) + pending_tokens
                    + batch_tokens > st.kv_budget):
                st.oom += 1
                self._handle_oom(batch, now)
                return None, True
        n_blk = self.backend.admit_blocks(batch.requests)
        if n_blk < batch.size:                       # KV-page clamp (paged)
            for r in batch.requests[n_blk:]:
                if r.spill_wait >= 0.0:
                    # hit continues into spilled pages: PARK until the
                    # host->device restore lands — re-prefilling now
                    # would throw away restorable KV
                    if r.ledger is not None:
                        r.ledger.to("restore_hold", now)
                    self._held_restore.append([r.spill_wait, r, now])
                else:
                    self._requeue(r, now)
            if n_blk == 0:
                return None, False
            batch = FormedBatch(batch.requests[:n_blk], batch.pad_to,
                                bucket=batch.bucket)
        if hasattr(self.sched, "notify_dispatch"):
            self.sched.notify_dispatch()             # OOM-backoff recovery
        pc = getattr(self.backend, "prefix_cache", None)
        mon = getattr(self.sched, "monitor", None)
        if pc is not None and mon is not None:
            for r in batch.requests:
                mon.on_prefix_lookup(r.prefix_hit_tokens, pc.page_size)
                if r.session_hit_tokens:
                    mon.on_session_hit(r.session_hit_tokens)
        st.pad_fracs.append(batch.padding_fraction)
        st.homog.append(batch.homogeneity)
        for r in batch.requests:
            if r.ledger is not None:
                r.ledger.to("formed", now)
        if self.recorder is not None:
            self.recorder.on_dispatch("prefill", batch.requests, now)
        return batch, False

    def _account_prefill_batch(self, batch: FormedBatch,
                               skip: int = 0) -> None:
        """``skip`` prompt positions per row were served from the prefix
        cache — neither useful nor padded FLOPs were spent on them."""
        fpt = self.backend.flops_per_token
        if skip:
            self.st.useful += fpt * sum(max(r.prompt_len - skip, 0)
                                        for r in batch.requests)
            self.st.padded += fpt * max(batch.pad_to - skip, 0) * batch.size
        else:
            self.st.useful += fpt * batch.total_tokens
            self.st.padded += fpt * batch.padded_tokens

    def _preempt_for_decode(self, now: float) -> bool:
        """Paged backends may need to evict pooled requests to free KV
        pages for the survivors' next token (DESIGN.md §3; victim order
        is youngest-first, or most-slack-first under a slack-aware
        scheduler).  The backend tears down its own state and returns
        the victims; scheduling state is reset here and they re-enter
        the queue via the requeue path (restart penalty, no stat
        double-count).

        With ``slice_tokens = K`` set (DESIGN.md §8, arXiv 2406.13511),
        a victim yields at the last K-aligned SLICE BOUNDARY instead of
        restarting: generated tokens up to the boundary are promoted
        into its prompt (``Request.sliced_tokens`` tracks the split),
        so the requeued request re-PREFILLS the preserved work at
        identical absolute positions — RoPE and causal attention see
        the same stream, making the continuation bit-identical — and
        resumes decoding where it left off.  Only the unaligned tail
        past the boundary is recomputed.  Session turns never slice:
        the next turn's prompt composition assumes an unsliced
        transcript shape (``_unlock_next_turn``)."""
        victims = self.backend.decode_preempt(self.pool)
        for r in victims:
            self.pool.remove(r)
            self.sched.release_decode(r)
            sliced = self._yield_or_reset(r)
            r.arrival = now + self.cfg.restart_penalty
            self._requeue(r, r.arrival, cause="preempt", at=now)
            self.st.preempts += 1
            if self.tracer.enabled:
                self.tracer.instant(
                    "decode", "slice-yield" if sliced else "preempt", now,
                    cat="preempt",
                    args={"rid": r.rid,
                          "kept_tokens": r.sliced_tokens if sliced else 0})
        return bool(victims)

    def _yield_or_reset(self, r: Request) -> bool:
        """Work-preservation core shared by preemption, the decode-pool
        fault kill, and checkpointed drain: yield ``r`` at its last
        K-aligned slice boundary — generated tokens up to the boundary
        are promoted into the prompt (``Request.sliced_tokens`` tracks
        the split), so the re-queued request re-PREFILLS the preserved
        work at identical absolute positions and the continuation stays
        bit-identical — or reset it to scratch when slicing is off, no
        boundary is reached, or it is a session turn (the next turn's
        prompt composition assumes an unsliced transcript shape).
        Returns True when work was preserved.  The CALLER owns queue
        and backend slot/page disposition."""
        K = self.cfg.slice_tokens
        keep = (r.generated // K) * K if K else 0
        sliced = keep > 0 and r.session_id is None
        if sliced:
            # promote the newly preserved span into the prompt;
            # everything up to r.sliced_tokens was promoted by an
            # earlier yield and already sits inside tokens[:prompt_len]
            if r.tokens is not None:
                gen = np.asarray(self.backend.generated_tokens(r),
                                 dtype=np.int32)
                r.tokens = np.concatenate([
                    np.asarray(r.tokens[:r.prompt_len], dtype=np.int32),
                    gen[r.sliced_tokens:keep]])
            r.prompt_len += keep - r.sliced_tokens
            r.sliced_tokens = keep
            r.generated = keep
            # first_token survives: the tokens that defined it are
            # preserved, so TTFT stands and the preemption delay
            # lands on TPOT — exactly what slack accounting wants
            hook = getattr(self.backend, "on_slice_yield", None)
            if hook is not None:
                hook(r, keep)
            self.st.slice_yields += 1
        else:
            reset = getattr(self.backend, "on_preempt_reset", None)
            if reset is not None:
                reset(r)
            r.generated = 0
            r.first_token = -1.0
        r.prefill_start = -1.0
        r.prefix_hit_tokens = 0       # re-matched at the next admission
        r.session_hit_tokens = 0
        return sliced

    def _abandon_job(self, job: PrefillJob, now: float) -> None:
        """Retry budget exhausted on a prefill job: free its partial
        backend state (``abort_prefill`` — NOT ``release``, which would
        register garbage partial KV with the retention layer) and
        disposition the rows.  Poisoned rows (``fault_streak`` at the
        quarantine threshold) are dropped terminally with their ledgers
        closed — a single unservable request can never kill the loop —
        the rest re-enter the queue cold after the restart penalty.
        Work already promoted into a row's prompt by earlier slice
        yields survives: only the un-prefilled remainder is redone."""
        abort = getattr(self.backend, "abort_prefill", None)
        for r in job.batch.requests:
            if abort is not None:
                abort(r)
            r.prefill_start = -1.0
            r.prefix_hit_tokens = 0
            r.session_hit_tokens = 0
            if r.fault_streak >= self._recovery.quarantine_after:
                r.dropped = True
                r.quarantined = True
                r.finished = -1.0
                self.st.quarantined += 1
                if self.tracer.enabled:
                    self.tracer.instant(
                        "prefill", "quarantine", now, cat="fault",
                        args={"rid": r.rid, "streak": r.fault_streak})
                self._retire(r, now)
            else:
                r.arrival = now + self.cfg.restart_penalty
                self._requeue(r, r.arrival, cause="fault", at=now)
        if self.tracer.enabled:
            self.tracer.instant(
                "prefill", "job-abandoned", now, cat="fault",
                args={"rows": job.batch.size,
                      "attempts": job.fault_attempts})
        self.job = None

    def _kill_decode_pool(self, now: float) -> None:
        """Decode executor declared dead for this pool (consecutive
        fault budget exhausted): WORK-PRESERVING kill.  Every pooled
        request yields at its last slice boundary (or resets), its
        backend slot/pages are torn down via ``evict_request``, and it
        re-enters the queue — the loop outlives the device error."""
        st = self.st
        st.kills += 1
        n = len(self.pool)
        evict = getattr(self.backend, "evict_request", None)
        for r in list(self.pool):
            self.pool.remove(r)
            self.sched.release_decode(r)
            if evict is not None:
                evict(r)
            self._yield_or_reset(r)
            r.arrival = now + self.cfg.restart_penalty
            self._requeue(r, r.arrival, cause="fault", at=now)
        self._decode_faulted = False
        self._decode_fault_attempts = 0
        if self.tracer.enabled:
            self.tracer.instant("decode", "pool-kill", now, cat="fault",
                                args={"victims": n})

    def _advance_pool(self, end: float) -> None:
        """One token for every pooled request; retire finished ones."""
        for r in list(self.pool):
            r.generated += 1
            if r.generated >= r.max_new_tokens:
                r.finished = end
                self.pool.remove(r)
                self.backend.release(r)
                self.sched.release_decode(r)
                self._retire(r, end)

    @staticmethod
    def _bucket_track(batch: FormedBatch) -> str:
        """Timeline track a batch's spans land on: its bucket's length
        band, or the bare executor for bucketless policies."""
        b = batch.bucket
        return f"bucket[{b.low},{b.up})" if b is not None else "prefill"

    def _next_arrival(self) -> Optional[float]:
        if self.st.ai < len(self._arrivals):
            return self._arrivals[self.st.ai].arrival
        return None

    def _held_wakeups(self) -> List[float]:
        """Clock targets for parked restores: the copy's ready time or
        the hold timeout, whichever comes first — the idle advance must
        never jump past the timeout to a stalled channel's far-future
        ready stamp."""
        to = self.cfg.restore_timeout
        return [min(it[0], it[2] + to) if to > 0 else it[0]
                for it in self._held_restore]

    # -------------------------------------------- disagg (overlapped) -----
    def _run_overlapped(self, time_limit: float) -> None:
        """Separate prefill/decode executors (+ KV transfer between).  On
        a wall clock the two 'executors' are the same synchronous device
        stream — chunked prefill is what lets decode interleave."""
        clock, st, sched = self.backend.clock, self.st, self.sched
        prefill_free = decode_free = 0.0

        while st.done < self._n and clock.now() < time_limit:
            if self._wall_exceeded():
                break
            now = clock.now()
            if self._drain_at is not None and now >= self._drain_at:
                break                      # caller drains to a checkpoint
            self._maintain(now)
            self._release_held(now)
            self._admit_arrivals(now)
            self._process_joins(now)

            progressed = False
            # ---------------------------------------- prefill executor ----
            if prefill_free <= now:
                if self.job is None and sched.queued():
                    batch, oomed = self._form_batch(now, count_pending=True)
                    if oomed:
                        prefill_free = now + self.cfg.restart_penalty
                    elif batch is not None:
                        self.job = PrefillJob(
                            batch, self.backend.chunk_plan(batch))
                if self.job is not None:
                    end = self._run_chunk(self.job, now)
                    prefill_free = end
                    progressed = True
            # ----------------------------------------- decode executor ----
            if decode_free <= now and self.pool:
                if self._preempt_for_decode(now):
                    progressed = True
                if self.pool:
                    decode_free = self._run_decode_iter(now)
                    progressed = True

            if not progressed:
                cands = [c for c in
                         [prefill_free if sched.queued() or self.job
                          else None,
                          decode_free if self.pool else None,
                          self._next_arrival()]
                         + [it[0] for it in self.pending_join]
                         + self._held_wakeups()
                         if c is not None and c > now]
                if cands:
                    clock.advance(min(cands))
                elif clock.virtual:
                    clock.advance(now + self.cfg.tick)
                elif (not sched.queued() and not self.pool
                      and not self.pending_join and not self._held_restore
                      and self.job is None
                      and self._next_arrival() is None):
                    break                      # drained: nothing can progress
                else:
                    clock.advance(now + self.cfg.tick)

    def _run_chunk(self, job: PrefillJob, now: float) -> float:
        """Execute the job's next prefill chunk; on the last chunk stamp
        first-token times and hand requests to transfer/decode.

        Fault seam (DESIGN.md §9): an injected ``prefill_chunk`` fault
        costs a backoff'd retry of the SAME chunk; past the retry budget
        the whole job is abandoned (``_abandon_job``) — poisoned rows
        quarantined, the rest re-queued cold."""
        st, sched, batch = self.st, self.sched, job.batch
        if self._faults is not None and self._faults.fire("prefill_chunk"):
            st.faults += 1
            job.fault_attempts += 1
            job.faulted = True
            for r in batch.requests:
                r.fault_streak += 1
                if r.ledger is not None and not r.ledger.closed:
                    r.ledger.to("fault_retry", now)
            if self.tracer.enabled:
                self.tracer.instant(
                    "prefill", "chunk-fault", now, cat="fault",
                    args={"attempt": job.fault_attempts,
                          "rows": batch.size})
            if job.fault_attempts > self._recovery.max_retries:
                self._abandon_job(job, now)
                return now
            st.retries += 1
            return now + self._recovery.backoff(job.fault_attempts - 1)
        stamp = job.started_at < 0 or job.faulted
        if job.started_at < 0:
            job.started_at = now
            for r in batch.requests:
                r.prefill_start = now
        if stamp:
            for r in batch.requests:
                if job.faulted:
                    r.fault_streak = 0       # survived: streak broken
                if r.ledger is not None and not r.ledger.closed:
                    r.ledger.to("prefill", now)
            job.faulted = False
        idx = job.next_chunk
        dur = self.backend.prefill_chunk(job, idx)
        job.next_chunk += 1
        end = self._after(now, dur)
        dur = dur if self.backend.clock.virtual else end - now
        st.busy_p += dur
        st.t_pre += dur * batch.size
        st.prefill_tok += job.chunks[idx][1] * batch.size
        for r in batch.requests:
            r.prefilled_tokens += job.chunks[idx][1]
        if self.tracer.enabled:
            self.tracer.complete(
                self._bucket_track(batch), f"chunk {idx}", now, dur,
                cat="prefill", args={"rows": batch.size,
                                     "tokens": job.chunks[idx][1]})

        if job.done:
            # a chunk plan starting past 0 skipped a cached prefix: those
            # positions were never run through the prefill executor
            skip = job.chunks[0][0]
            st.prefill_skip += skip * batch.size
            self._account_prefill_batch(batch, skip=skip)
            xfer = self.backend.transfer_seconds(batch)
            if self.tracer.enabled:
                self.tracer.complete(
                    self._bucket_track(batch), f"batch x{batch.size}",
                    job.started_at, end - job.started_at, cat="batch",
                    args={"size": batch.size, "pad_to": batch.pad_to,
                          "padding_fraction": batch.padding_fraction,
                          "homogeneity": batch.homogeneity})
            for r in batch.requests:
                # prefill's last position predicts one token: for a
                # fresh request that's the FIRST token (0 -> 1); for a
                # slice-yield resume (generated == sliced_tokens > 0)
                # it's the next token after the preserved span —
                # first_token was stamped on the original pass and
                # stands, so the preemption delay shows up in TPOT
                r.generated += 1
                if r.first_token < 0:
                    r.first_token = end
                    if r.ledger is not None:
                        r.ledger.mark_first(end)
                    self._note_first(r)
                if r.generated >= r.max_new_tokens \
                        or not self.backend.supports_decode:
                    r.finished = end
                    self.backend.release(r)     # retention/free of KV pages
                    self._retire(r, end)
                else:
                    # KV allocated AT PREFILL: account it now so the
                    # batcher's Eq. (6) sees in-transfer caches too
                    # (prevents admission overshoot).
                    sched.admit_decode(r)
                    if r.ledger is not None:
                        r.ledger.to("transfer", end)
                    self.pending_join.append([end + xfer, r])
            st.t_xfer += xfer * batch.size
            self.job = None
            # zero-latency transfers (real engine) join before the next
            # decode dispatch — the substrate already holds their slots
            self._process_joins(self.backend.clock.now())
        return end

    def _run_decode_iter(self, now: float) -> float:
        st = self.st
        if self._faults is not None and self._faults.fire("decode_step"):
            # transient decode-step device error: the whole iteration is
            # lost; pooled ledgers park in fault_retry until a step
            # lands.  Past the consecutive-retry budget the pool is
            # killed work-preservingly instead of spinning forever.
            st.faults += 1
            self._decode_fault_attempts += 1
            self._decode_faulted = True
            # wall clocks advance DURING a loop iteration (a prefill
            # finishing first stamps joiners with fresh samples): clamp
            # so fault stamps never run backwards on a joiner's ledger
            now = max(now, self.backend.clock.now())
            for r in self.pool:
                if r.ledger is not None and not r.ledger.closed:
                    r.ledger.to("fault_retry", now)
            if self.tracer.enabled:
                self.tracer.instant(
                    "decode", "decode-fault", now, cat="fault",
                    args={"attempt": self._decode_fault_attempts,
                          "pool": len(self.pool)})
            if self._decode_fault_attempts > self._recovery.max_retries:
                self._kill_decode_pool(now)
                return now
            st.retries += 1
            return now + self._recovery.backoff(
                self._decode_fault_attempts - 1)
        if self._decode_faulted:
            # a step landed: streak broken, ledgers resume decode
            self._decode_faulted = False
            self._decode_fault_attempts = 0
            ts = max(now, self.backend.clock.now())   # see fault clamp
            for r in self.pool:
                if r.ledger is not None and not r.ledger.closed:
                    r.ledger.to("decode", ts)
        n = len(self.pool)
        dur = self.backend.decode_iter(self.pool, self._live_tokens(self.pool))
        end = self._after(now, dur)
        dur = dur if self.backend.clock.virtual else end - now
        st.busy_d += dur
        st.t_dec += dur * n
        fpt = self.backend.flops_per_token
        st.useful += fpt * n
        st.padded += fpt * n
        if self.job is not None:
            st.interleaved += 1       # decode ran between prefill chunks
        if self.tracer.enabled:
            self.tracer.complete("decode", "decode-iter", now, dur,
                                 cat="decode", args={"pool": n})
            self.tracer.counter("decode", "pool", now, {"requests": n})
        self._advance_pool(end)
        return end

    # --------------------------------------- coupled / static (fused) -----
    def _run_fused(self, time_limit: float, static: bool) -> None:
        """Single executor.  ``coupled``: each iteration fuses the new
        prefill batch (if any) with one decode step over the live pool
        (Orca).  ``static``: a formed batch runs prefill + decode TO
        COMPLETION with padded context reads (convoy effect)."""
        clock, st, sched = self.backend.clock, self.st, self.sched
        cooldown = 0.0

        while st.done < self._n and clock.now() < time_limit:
            if self._wall_exceeded():
                break
            now = clock.now()
            if self._drain_at is not None and now >= self._drain_at:
                break                      # caller drains to a checkpoint
            self._maintain(now)
            self._release_held(now)
            self._admit_arrivals(now)

            batch = None
            can_admit = ((not static) or not self.pool) and now >= cooldown
            if sched.queued() and can_admit and \
                    len(self.pool) < self.cfg.decode_slot_cap:
                batch, oomed = self._form_batch(now, count_pending=False)
                if oomed:
                    cooldown = now + self.cfg.restart_penalty

            if static:
                if batch is not None:
                    self._run_batch_to_completion(batch, now)
                else:
                    cands = [c for c in [self._next_arrival()]
                             + self._held_wakeups()
                             if c is not None and c > now]
                    if sched.queued():
                        cands.append(now + self.cfg.tick)
                    clock.advance(min(cands) if cands else now
                                  + self.cfg.tick)
                continue

            if batch is None and not self.pool:
                cands = [c for c in [self._next_arrival()]
                         + self._held_wakeups()
                         if c is not None and c > now]
                clock.advance(min(cands) if cands else now + self.cfg.tick)
                continue

            # one fused iteration: prefill the new batch + one decode step
            dt = 0.0
            if batch is not None:
                job = PrefillJob(batch, [(0, batch.pad_to)])
                pdt = self.backend.prefill_chunk(job, 0)
                job.next_chunk = 1
                dt += pdt
            if self.pool:
                self._preempt_for_decode(now)
            n_pool = len(self.pool)
            if n_pool:
                ddt = self.backend.decode_iter(
                    self.pool, self._live_tokens(self.pool))
                dt += ddt
            end = now + dt if clock.virtual else clock.now()
            if batch is not None:
                if self.tracer.enabled:
                    self.tracer.complete(
                        self._bucket_track(batch), f"batch x{batch.size}",
                        now, end - now, cat="batch",
                        args={"size": batch.size, "pad_to": batch.pad_to,
                              "padding_fraction": batch.padding_fraction,
                              "homogeneity": batch.homogeneity})
                for r in batch.requests:
                    r.prefill_start = now
                    if r.ledger is not None:
                        r.ledger.to("prefill", now)
                    r.first_token = end          # interference: full iter
                    r.generated = 1
                    if r.ledger is not None:
                        r.ledger.mark_first(end)
                    self._note_first(r)
                st.busy_p += pdt
                st.t_pre += pdt * batch.size
                st.prefill_tok += batch.pad_to * batch.size
                for r in batch.requests:
                    r.prefilled_tokens += batch.pad_to
                self._account_prefill_batch(batch)
            if n_pool:
                st.busy_d += ddt
                st.t_dec += ddt * n_pool
                fpt = self.backend.flops_per_token
                st.useful += fpt * n_pool
                st.padded += fpt * n_pool
                self._advance_pool(end)
            if batch is not None:
                for r in batch.requests:
                    if r.generated >= r.max_new_tokens \
                            or not self.backend.supports_decode:
                        r.finished = end
                        self.backend.release(r)
                        self._retire(r, end)
                    else:
                        self.pool.append(r)
                        if r.ledger is not None:
                            r.ledger.to("decode", end)
                        sched.admit_decode(r)
                st.peak = max(st.peak, len(self.pool))
            clock.advance(end)

    def _run_batch_to_completion(self, batch: FormedBatch,
                                 now: float) -> None:
        """Static/batch-granularity execution with padded decode reads:
        every iteration reads the PADDED batch context (all slots padded
        to the batch max) and the executor is held until the longest
        member finishes."""
        st, sched, clock = self.st, self.sched, self.backend.clock
        n, pad = batch.size, batch.pad_to
        fpt = self.backend.flops_per_token
        job = PrefillJob(batch, [(0, pad)])
        pdt = self.backend.prefill_chunk(job, 0)
        job.next_chunk = 1
        st.busy_p += pdt
        st.t_pre += pdt * n
        st.prefill_tok += pad * n
        for r in batch.requests:
            r.prefilled_tokens += pad
        self._account_prefill_batch(batch)
        t = self._after(now, pdt)
        for r in batch.requests:
            r.prefill_start = now
            if r.ledger is not None:
                r.ledger.to("prefill", now)
            r.first_token = t
            r.generated = 1
            if r.ledger is not None:
                r.ledger.mark_first(t)
                r.ledger.to("decode", t)
            self._note_first(r)
            sched.admit_decode(r)
        iters = max(r.max_new_tokens for r in batch.requests) - 1
        for i in range(1, iters + 1):
            context = n * (pad + i)              # PADDED batch KV read
            ddt = self.backend.decode_iter(batch.requests, context)
            t = self._after(t, ddt)
            st.busy_d += ddt
            st.t_dec += ddt * n
            st.useful += fpt * sum(
                1 for r in batch.requests if r.generated < r.max_new_tokens)
            st.padded += fpt * n
            for r in batch.requests:
                if r.generated < r.max_new_tokens:
                    r.generated += 1
                    if r.generated >= r.max_new_tokens:
                        r.finished = t
        for r in batch.requests:
            if r.finished < 0:
                r.finished = t
            sched.release_decode(r)
            self.backend.release(r)
            self._retire(r, t)
        if self.tracer.enabled:
            # one span per batch covering the FULL executor hold —
            # static mode's convoy effect, visible on the timeline
            self.tracer.complete(
                self._bucket_track(batch), f"batch x{n}", now, t - now,
                cat="batch",
                args={"size": n, "pad_to": pad,
                      "padding_fraction": batch.padding_fraction,
                      "homogeneity": batch.homogeneity})
        clock.advance(t)
