"""Global Monitor — system-wide metric aggregation (paper §III).

Feeds the Dynamic Batching Controller (memory pressure) and the P/D
Scheduler (queue occupancy, waiting times).  Pure bookkeeping: works for
both the discrete-event simulator and the real engine.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List

from .telemetry import blame_means


@dataclasses.dataclass
class Snapshot:
    t: float
    queue_len: int
    decode_pool: int
    in_flight_tokens: int
    arrival_rate: float
    mean_seq_len: float
    n_buckets: int
    kv_util: float
    prefix_hit_rate: float = 0.0
    prefix_pages_saved: int = 0
    session_hits: int = 0
    session_hit_tokens: int = 0
    spilled_pages: int = 0
    restored_pages: int = 0
    # live tail-latency state (PR 7): nearest-rank percentiles over the
    # rolling TTFT/TPOT sample windows — what an SLO-aware scheduler
    # steers on (a mean hides exactly the tail it must protect).  p95
    # included because the SLO gates read p95 (PR 8).
    ttft_p50: float = 0.0
    ttft_p99: float = 0.0
    tpot_p50: float = 0.0
    tpot_p99: float = 0.0
    ttft_p95: float = 0.0
    tpot_p95: float = 0.0
    # mean seconds per ledger phase over the rolling retirement window
    # (core/telemetry.py blame_means — the ONE aggregation rule shared
    # with ServeResult.blame)
    blame: Dict[str, float] = dataclasses.field(default_factory=dict)
    # deadline-slack state (DESIGN.md §8): rolling per-class goodput
    # (fraction of recently retired requests meeting BOTH SLO budgets)
    # and the tightest live deadline slack seen at the goodput
    # scheduler's last queue scan — what its admission relief steers on
    class_goodput: Dict[str, float] = dataclasses.field(default_factory=dict)
    min_slack_s: float = float("inf")


def _nearest_rank(xs, q: float) -> float:
    """Nearest-rank percentile (ceil(q/100 * n)-th sorted sample); 0.0
    on an empty series.  The SAME rule ServeResult uses, so live
    snapshots and post-run gates can never disagree on definition."""
    if not xs:
        return 0.0
    s = sorted(xs)
    rank = max(-(-int(q * len(s)) // 100), 1)   # ceil without float error
    return s[min(rank, len(s)) - 1]


class GlobalMonitor:
    def __init__(self, window_s: float = 10.0):
        self.window_s = window_s
        self.arrivals: Deque[float] = collections.deque()
        self.seq_lens: Deque[int] = collections.deque(maxlen=512)
        self.batch_lat: Deque[float] = collections.deque(maxlen=512)
        # rolling tail-latency samples (PR 7), fed by the ServingLoop
        # at first-token / retirement time
        self.ttft_samples: Deque[float] = collections.deque(maxlen=512)
        self.tpot_samples: Deque[float] = collections.deque(maxlen=512)
        # rolling per-class latency-blame samples (PR 8): closed ledger
        # phase dicts keyed by request class ('' = untagged)
        self.blame_samples: Dict[str, Deque[Dict[str, float]]] = \
            collections.defaultdict(lambda: collections.deque(maxlen=512))
        # rolling per-class SLO outcomes (DESIGN.md §8): one met/missed
        # flag per retired request, windowed like blame — the live
        # goodput estimate a deadline-aware scheduler steers on
        self.slo_samples: Dict[str, Deque[bool]] = \
            collections.defaultdict(lambda: collections.deque(maxlen=512))
        # tightest deadline slack over the queued requests at the
        # goodput scheduler's last scan (a LEVEL, overwritten per scan;
        # inf = no queue or no slack-aware scheduler attached)
        self.min_slack_s = float("inf")
        self.history: List[Snapshot] = []
        self.in_flight_tokens = 0
        self.decode_pool = 0
        self.queue_len = 0
        self.n_buckets = 1
        self.kv_budget_tokens = 1.0
        # cross-request prefix cache (core/prefix_cache.py): admission
        # hit accounting, fed by the ServingLoop per admitted request
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_pages_saved = 0
        # session retention (core/retention.py): admitted requests that
        # resumed a retained conversation transcript
        self.session_hits = 0
        self.session_hit_tokens = 0
        # host spill tier (core/retention.py, PR 5): pages moved over
        # the host<->device channel instead of dropped/re-prefilled
        self.spilled_pages = 0
        self.restored_pages = 0
        # restore-aware admission pricing: the CURRENT in-flight
        # restore state (pages reserved on device, compressed bytes
        # still queued on the channel) — levels, not counters; the
        # loop's maintain step overwrites them each iteration and the
        # batch controller folds them into Eq. (6)
        self.restore_pages_in_flight = 0
        self.restore_backlog_bytes = 0

    # ------------------------------------------------------------ events --
    def on_arrival(self, t: float, seq_len: int) -> None:
        self.arrivals.append(t)
        self._prune_arrivals(t)
        self.seq_lens.append(seq_len)
        self.queue_len += 1

    def on_requeue(self) -> None:
        """Re-admission of an already-counted request (OOM eviction,
        slot-capacity clamp).  Restores queue occupancy WITHOUT touching
        the arrival-rate window or the sequence-length stats — those
        describe the client workload, which did not change."""
        self.queue_len += 1

    def on_batch(self, latency_s: float) -> None:
        self.batch_lat.append(latency_s)

    def on_first_token(self, ttft_s: float, cls: str = "") -> None:
        """A request produced its first token ``ttft_s`` after arrival."""
        self.ttft_samples.append(ttft_s)

    def on_tpot(self, tpot_s: float, cls: str = "") -> None:
        """A request finished with a per-output-token latency sample."""
        self.tpot_samples.append(tpot_s)

    def on_retire(self, cls: str, phases: Dict[str, float],
                  slo_met: bool | None = None) -> None:
        """A request retired with a closed latency ledger: keep its
        phase breakdown in the rolling per-class blame window, and
        (when the loop reports it) its SLO outcome in the rolling
        goodput window."""
        self.blame_samples[cls].append(dict(phases))
        if slo_met is not None:
            self.slo_samples[cls].append(bool(slo_met))

    def on_slack(self, slack_s: float) -> None:
        """The slack-aware scheduler scanned its queue: overwrite the
        tightest remaining deadline slack it saw (seconds; negative =
        a request is already past its TTFT budget)."""
        self.min_slack_s = slack_s

    def on_prefix_lookup(self, hit_tokens: int, page_size: int) -> None:
        """One admitted request matched against the prefix cache:
        ``hit_tokens`` prompt tokens (page-aligned, 0 = cold) will be
        served from shared pages instead of re-prefilled."""
        self.prefix_lookups += 1
        if hit_tokens > 0:
            self.prefix_hits += 1
            self.prefix_hit_tokens += hit_tokens
            self.prefix_pages_saved += hit_tokens // max(page_size, 1)

    def on_session_hit(self, hit_tokens: int) -> None:
        """One admitted request resumed a retained session transcript:
        ``hit_tokens`` transcript tokens (including the pinned partial
        tail) restored instead of re-prefilled."""
        self.session_hits += 1
        self.session_hit_tokens += hit_tokens

    def on_spill_traffic(self, spilled: int, restored: int) -> None:
        """Host-tier copy traffic since the last report: pages that
        moved device->host (eviction demoted, not destroyed) and pages
        that came back host->device (restored instead of
        re-prefilled)."""
        self.spilled_pages += spilled
        self.restored_pages += restored

    def on_restore_state(self, pages_in_flight: int,
                         backlog_bytes: int) -> None:
        """Overwrite the in-flight restore LEVEL (not a delta): device
        pages reserved by restores plus compressed bytes queued on the
        host channel, read off the retention layer each maintain
        tick."""
        self.restore_pages_in_flight = pages_in_flight
        self.restore_backlog_bytes = backlog_bytes

    # ------------------------------------------------------------- stats --
    def _prune_arrivals(self, t: float) -> None:
        """Drop arrival stamps older than the window.  Called on BOTH
        arrival and snapshot — an idle tail with no arrivals must decay
        to rate 0, not keep reporting the last burst forever."""
        while self.arrivals and self.arrivals[0] < t - self.window_s:
            self.arrivals.popleft()

    def arrival_rate(self) -> float:
        if len(self.arrivals) < 2:
            return 0.0
        span = max(self.arrivals[-1] - self.arrivals[0], 1e-6)
        return (len(self.arrivals) - 1) / span

    def mean_seq_len(self) -> float:
        if not self.seq_lens:
            return 1.0
        return sum(self.seq_lens) / len(self.seq_lens)

    def mean_batch_latency(self) -> float:
        if not self.batch_lat:
            return 0.0
        return sum(self.batch_lat) / len(self.batch_lat)

    def kv_util(self) -> float:
        return min(1.0, self.in_flight_tokens / max(self.kv_budget_tokens, 1))

    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / max(self.prefix_lookups, 1)

    def ttft_percentile(self, q: float) -> float:
        return _nearest_rank(self.ttft_samples, q)

    def tpot_percentile(self, q: float) -> float:
        return _nearest_rank(self.tpot_samples, q)

    def blame(self, cls: str = "") -> Dict[str, float]:
        """Mean seconds per phase over the rolling window for one
        request class (all classes pooled when every sample is '')."""
        return blame_means(list(self.blame_samples.get(cls, ())))

    def class_goodput(self) -> Dict[str, float]:
        """Rolling per-class goodput: fraction of recently retired
        requests (the slo_samples window) that met both SLO budgets."""
        return {cls: sum(dq) / len(dq)
                for cls, dq in self.slo_samples.items() if dq}

    def snapshot(self, t: float) -> Snapshot:
        self._prune_arrivals(t)     # idle tail: rate decays without events
        pooled = [s for dq in self.blame_samples.values() for s in dq]
        s = Snapshot(t, self.queue_len, self.decode_pool,
                     self.in_flight_tokens, self.arrival_rate(),
                     self.mean_seq_len(), self.n_buckets, self.kv_util(),
                     self.prefix_hit_rate(), self.prefix_pages_saved,
                     self.session_hits, self.session_hit_tokens,
                     self.spilled_pages, self.restored_pages,
                     self.ttft_percentile(50), self.ttft_percentile(99),
                     self.tpot_percentile(50), self.tpot_percentile(99),
                     ttft_p95=self.ttft_percentile(95),
                     tpot_p95=self.tpot_percentile(95),
                     blame=blame_means(pooled),
                     class_goodput=self.class_goodput(),
                     min_slack_s=self.min_slack_s)
        self.history.append(s)
        return s
