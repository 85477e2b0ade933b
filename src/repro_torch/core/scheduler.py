"""P/D scheduler: bucket-aware prefill batching + continuous-batching
decode, with prefill->decode KV transfer (paper §III "P/D Scheduler").

The scheduler is pure policy — no clocks, no devices.  The unified
ServingLoop (core/serving_loop.py) drives it against either execution
backend (cost model or real JAX engine):

    on_arrival(req, now[, requeue])  assign to bucket (Algorithm 1 insert)
    next_prefill_batch(now, ...)     adjust buckets, pick bucket, form batch
    (decode admission is slot-based continuous batching in the loop)

Bucket choice: ONLINE requests first (bucket holding the earliest-arrived
online request — paper: "online tasks prioritize buckets based on
earliest request arrival time"); otherwise offline buckets ordered by the
configured within-bucket policy (SJF for RPS, LJF for token throughput).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.config import ModelConfig
from .batcher import DynamicBatchController, FormedBatch, MemoryBudget
from .bucket import Bucket, BucketManager
from .monitor import GlobalMonitor
from .request import Request, TaskType
from .telemetry import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    offline_policy: str = "sjf"          # sjf | ljf  (paper §II-B)
    theta: float = 0.5                   # Algorithm 1 split threshold
    assignment: str = "linear"           # linear (paper) | bisect (beyond)
    refine: str = "midpoint"             # midpoint (paper) | eq4 (beyond)
    trigger: str = "majority"            # majority (paper) | waste (beyond)
    memory_model: str = "sum"            # sum (Eq. 6) | padded | paged
    page_size: int = 128                 # KV page (memory_model="paged")
    max_batch: int = 512
    decode_reserve: float = 0.5
    kv_transfer_bw: float = 50e9         # ICI per link (TPU adaptation)


class SchedulerBase:
    """Loop-facing scheduler surface (DESIGN.md §2): everything the
    ServingLoop drives — arrival/requeue bookkeeping, decode-pool
    accounting, OOM retry backoff — lives here ONCE; policies supply the
    queue structure (``_enqueue``/``queued``) and batch formation
    (``next_prefill_batch``).  Pure policy: no clocks, no devices."""

    name = "base"
    #: Deadline-slack scheduling (DESIGN.md §8): when True, the
    #: ServingLoop arms slack-aware sacrifice ordering in the backend
    #: (extend_for_decode victims, retention rungs, restore-hold
    #: release).  Base schedulers keep the legacy youngest-first/LRU
    #: orderings so existing gates are untouched.
    slack_aware = False

    def __init__(self, cfg: ModelConfig, budget: MemoryBudget, *,
                 memory_model: str = "sum", max_batch: int = 512,
                 decode_reserve: float = 0.5, page_size: int = 128):
        self.cfg = cfg
        self.batcher = DynamicBatchController(
            cfg, budget, memory_model=memory_model, max_batch=max_batch,
            decode_reserve=decode_reserve, page_size=page_size)
        self.monitor = GlobalMonitor()
        self.monitor.kv_budget_tokens = self.batcher.token_budget()
        # event-timeline seam (core/telemetry.py): the ServingLoop
        # overwrites this with its live Tracer when tracing is on
        self.tracer = NULL_TRACER
        self._last_n_max = -1

    # ------------------------------------------------------------ events --
    def _enqueue(self, req: Request) -> None:
        raise NotImplementedError

    def queued(self) -> int:
        raise NotImplementedError

    def next_prefill_batch(self, now: float) -> Optional[FormedBatch]:
        raise NotImplementedError

    def on_arrival(self, req: Request, now: float,
                   requeue: bool = False) -> None:
        """Queue a request.  ``requeue=True`` marks a re-admission (OOM
        eviction, slot clamp): the request re-enters the queue but the
        monitor's arrival-rate / seq-len workload stats are NOT
        re-counted."""
        self._enqueue(req)
        if requeue:
            self.monitor.on_requeue()
        else:
            self.monitor.on_arrival(now, req.prompt_len)

    # ----------------------------------------------------- OOM backoff ----
    def notify_oom(self) -> None:
        """Retry backoff every real system has: shrink the admission cap."""
        self._oom_shrink = max(0.4, getattr(self, "_oom_shrink", 1.0) * 0.85)

    def notify_dispatch(self) -> None:
        """A batch actually dispatched: step the backoff recovery.  The
        loop calls this ONCE per successful dispatch — recovery must not
        advance on ticks that form no batch (the old ``_cap_scale``
        mutated on every read, so idle polling silently restored the cap
        while nothing had been proven safe)."""
        self._oom_shrink = min(1.0, getattr(self, "_oom_shrink", 1.0) * 1.02)

    def _cap_scale(self) -> float:
        """Pure read of the current OOM-shrink factor."""
        return getattr(self, "_oom_shrink", 1.0)

    # -------------------------------------------------- decode admission --
    def _pressure_tokens(self) -> int:
        """Restore-aware admission pricing: Eq.-(6) token-equivalents
        of the in-flight host-tier restore state (reserved device pages
        + compressed channel backlog) the monitor's plain in-flight sum
        misses.  Added to ``in_flight_tokens`` wherever Eq. (6) is
        consulted, so admission leaves headroom for restores about to
        land instead of racing them for the same pages."""
        return self.batcher.admission_pressure_tokens(
            self.monitor.restore_pages_in_flight,
            self.monitor.restore_backlog_bytes)

    def _live_tokens(self, req: Request) -> int:
        """In-flight KV tokens a live request is charged: prompt +
        output, capped at the sliding/local window (a ring cache never
        holds more than the window — EVERY scheduler serves windowed
        configs, so the cap lives here in the base, not in a
        policy-specific override that baselines silently miss),
        page-granular under the paged memory model, discounted by the
        shared prefix-cache hit."""
        tokens = req.prompt_len + req.max_new_tokens
        win = self.cfg.sliding_window or (
            self.cfg.local_window if self.cfg.arch_type == "hybrid" else 0)
        if win:
            tokens = min(tokens, win)
        return self.batcher.charge_tokens(tokens, req.prefix_hit_tokens)

    def admit_decode(self, req: Request) -> None:
        self.monitor.decode_pool += 1
        self.monitor.in_flight_tokens += self._live_tokens(req)

    def release_decode(self, req: Request) -> None:
        self.monitor.decode_pool -= 1
        self.monitor.in_flight_tokens -= self._live_tokens(req)


class BucketServeScheduler(SchedulerBase):
    """The paper's middleware: Bucketing Manager + Batching Controller."""

    name = "bucketserve"

    def __init__(self, cfg: ModelConfig, budget: MemoryBudget,
                 sched: SchedulerConfig = SchedulerConfig()):
        super().__init__(cfg, budget, memory_model=sched.memory_model,
                         max_batch=sched.max_batch,
                         decode_reserve=sched.decode_reserve,
                         page_size=sched.page_size)
        self.sched = sched
        self.buckets = BucketManager(
            l_max=cfg.max_seq_len, theta=sched.theta,
            assignment=sched.assignment, refine=sched.refine,
            trigger=sched.trigger)

    # ------------------------------------------------------------ events --
    def _enqueue(self, req: Request) -> None:
        self.buckets.add(req)            # Algorithm 1 insert

    def queued(self) -> int:
        return self.buckets.total()

    # -------------------------------------------------------- scheduling --
    def _n_max(self) -> int:
        return self.batcher.n_max(
            self.monitor.mean_seq_len(),
            self.monitor.in_flight_tokens + self._pressure_tokens())

    def _pick_bucket(self, now: float) -> Optional[Bucket]:
        """Bucket choice per scheduling tick.  The earliest-online
        arrival per bucket is maintained INCREMENTALLY by the
        BucketManager (O(1) on add, recomputed only for buckets that
        lose members) — the old ``min(r.arrival for r in b.requests)``
        here rescanned every queued request in every bucket on every
        tick, O(total queued) per tick."""
        nonempty = self.buckets.nonempty()
        if not nonempty:
            return None
        online = [b for b in nonempty if b.earliest_online() is not None]
        if online:
            return min(online, key=lambda b: b.earliest_online())
        if self.sched.offline_policy == "sjf":
            return min(nonempty, key=lambda b: b.low)
        return max(nonempty, key=lambda b: b.up)

    def _order_bucket(self, b: Bucket, now: float):
        """Within-bucket candidate ordering (the form_batch greedy packs
        a prefix of this list) — the policy hook subclasses override."""
        has_online = b.earliest_online() is not None
        policy = "fcfs" if has_online else self.sched.offline_policy
        return self.buckets.order_bucket(b, policy)

    def next_prefill_batch(self, now: float) -> Optional[FormedBatch]:
        """One scheduling tick: Algorithm 1 adjust + batch formation."""
        n_max = self._n_max()
        if self.tracer.enabled and n_max != self._last_n_max:
            self.tracer.counter("controller", "n_max", now,
                                {"n_max": n_max})
            self._last_n_max = n_max
        self.buckets.adjust(n_max)
        self.monitor.n_buckets = len(self.buckets.buckets)
        b = self._pick_bucket(now)
        if b is None:
            return None
        ordered = self._order_bucket(b, now)
        batch = self.batcher.form_batch(
            ordered, self.monitor.in_flight_tokens + self._pressure_tokens())
        if not batch.requests:
            return None
        batch.bucket = b
        self.buckets.pop(batch.requests)
        self.monitor.queue_len -= len(batch.requests)
        return batch

    # ------------------------------------------------------- KV transfer --
    def kv_transfer_seconds(self, batch: FormedBatch) -> float:
        """Prefill->decode cache move over ICI (TPU adaptation of the
        paper's NVLink transfer)."""
        bytes_ = sum(r.prompt_len for r in batch.requests) * \
            self.batcher.kv_per_tok
        return bytes_ / self.sched.kv_transfer_bw


class GoodputScheduler(BucketServeScheduler):
    """Deadline-slack goodput scheduler (DESIGN.md §8).

    Same Bucketing Manager + Eq.-(6) Batching Controller as BucketServe
    — batches stay size-homogeneous — but candidate ORDER inside the
    picked bucket (and the bucket pick itself) is driven by per-request
    deadline urgency instead of arrival order:

        urgency  = waited / slo_ttft        (class-normalized queue age)
        bonus    = 1 - tokens_left / ref    (short jobs retire SLOs fast)
        priority = urgency + bonus

    the SLA-constrained priority-scheduler shape (arXiv 2503.05248):
    normalizing the wait by the CLASS budget is what lets a 2 s-TTFT
    chat request overtake a 120 s-budget batch job that arrived first.
    ``waited`` anchors on ``Request.t0()`` (the ledger's first-arrival
    stamp), so OOM/preempt requeues cannot silently reset urgency.

    Force-include SLA protection, in three tiers.  A request whose
    remaining slack has shrunk below ``force_frac`` of its class budget
    but is STILL WINNABLE sorts ahead of every unforced candidate
    regardless of score — the form_batch greedy packs a prefix of the
    ordering, so forced requests can only be excluded by the memory
    bound itself.  A request already PAST its deadline is the
    opposite case: it can never earn goodput again, so it demotes
    below every winnable candidate instead of clogging the front of
    the queue (it still gets served — whenever no winnable work is
    queued — so throughput is shed last, not first).

    ``slack_aware = True`` additionally flips every sacrifice point the
    ServingLoop arms (extend_for_decode victims, retention rungs,
    restore-hold release) to slack ordering — see
    ``Request.sacrifice_slack`` for why those use a clock-free proxy.
    """

    name = "goodput"
    slack_aware = True
    #: tokens_left normalizer for the short-job bonus: one full
    #: normalizer of remaining decode work cancels one full TTFT budget
    #: of queue age (the exemplar's ``(10 - tokens_left)/10`` shape,
    #: scaled to this repo's output lengths).
    short_job_ref = 256.0
    #: force-include threshold: a winnable request whose remaining
    #: slack is below this fraction of its class budget jumps every
    #: unforced candidate.
    force_frac = 0.3

    # ------------------------------------------------------------ scoring --
    def _priority(self, r: Request, now: float) -> float:
        waited = max(now - r.t0(), 0.0)
        urgency = waited / max(r.slo_ttft, 1e-9)
        left = max(r.max_new_tokens - r.generated, 0)
        bonus = max(0.0, 1.0 - left / self.short_job_ref)
        return urgency + bonus

    def _tier(self, r: Request, now: float) -> int:
        """+1 forced (winnable, nearly late), 0 normal, -1 past its
        deadline (can never earn goodput — served when nothing winnable
        queues).  The budget normalizing the slack is the phase's own:
        TTFT before the first token, the remaining-token TPOT budget
        after (a slice-yielded request re-queues mid-generation)."""
        budget = r.slo_ttft if r.first_token < 0 \
            else r.slo_tpot * max(r.max_new_tokens - 1, 1)
        ratio = r.slack(now) / max(budget, 1e-9)
        if ratio <= 0.0:
            return -1
        return 1 if ratio <= self.force_frac else 0

    def _score_key(self, r: Request, now: float):
        # rid tiebreak keeps the ordering fully deterministic (and
        # backend-independent when scores tie)
        return (self._tier(r, now), self._priority(r, now), -r.rid)

    # ----------------------------------------------------------- ordering --
    def _order_bucket(self, b: Bucket, now: float):
        return sorted(b.requests,
                      key=lambda r: self._score_key(r, now), reverse=True)

    def _pick_bucket(self, now: float) -> Optional[Bucket]:
        """The bucket holding the most urgent candidate wins — batches
        stay homogeneous (one bucket per batch), urgency just decides
        WHICH bucket forms next."""
        nonempty = self.buckets.nonempty()
        if not nonempty:
            return None
        return max(nonempty,
                   key=lambda b: max(self._score_key(r, now)
                                     for r in b.requests))

    # ------------------------------------------------------------- gauges --
    def next_prefill_batch(self, now: float) -> Optional[FormedBatch]:
        slacks = [r.slack(now)
                  for b in self.buckets.nonempty() for r in b.requests]
        if slacks:
            self.monitor.on_slack(min(slacks))
        return super().next_prefill_batch(now)

    def _pressure_tokens(self) -> int:
        """Slack-aware restore pricing: when the queue's minimum slack
        is tight, the restore-backlog admission throttle is relaxed —
        protecting a restore's resume-TTFT is pointless while a
        deadline-critical request starves in the queue."""
        return self.batcher.admission_pressure_tokens(
            self.monitor.restore_pages_in_flight,
            self.monitor.restore_backlog_bytes,
            min_slack=self.monitor.min_slack_s)
