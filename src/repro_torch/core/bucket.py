"""Adaptive bucketing — faithful implementation of paper Algorithm 1.

* System starts with one bucket [0, L_max).
* Requests are assigned to the bucket whose [low, up) contains S.
* ``adjust(n_max)``:
    - if total queued < n_max: merge everything back into one bucket
      (low-load fast path, lines 11-13);
    - else one split round: every bucket with more than ``min_split``
      (= n_max in the paper) requests of which a fraction > θ lies below
      the interval midpoint is bisected (lines 14-29).
  Midpoint bisection approximates the Eq.-(4) optimal boundary; repeated
  rounds (one per scheduling tick) converge as the workload demands.

Beyond-paper extensions (flagged, off by default for the faithful path):
  * ``assignment="bisect"`` — O(log k) bucket lookup on sorted bounds
    (the paper's own "binary tree" suggestion, §IV).
  * ``refine="eq4"`` — instead of the midpoint, split at the empirical
    conditional expectation (Eq. 4) of the bucket's requests.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, List, Optional

from .request import Request, TaskType


@dataclasses.dataclass
class Bucket:
    low: int
    up: int
    requests: List[Request] = dataclasses.field(default_factory=list)
    # cached min over ONLINE members' arrivals (None = no online member).
    # The scheduler's bucket pick reads this every tick — maintained
    # incrementally (O(1) on add, recomputed only when a bucket loses
    # members) instead of rescanned over every request in every bucket.
    _online_min: Optional[float] = dataclasses.field(default=None,
                                                     repr=False)

    def __contains__(self, s: int) -> bool:
        return self.low <= s < self.up

    @property
    def midpoint(self) -> float:
        return (self.low + self.up) / 2

    def __len__(self) -> int:
        return len(self.requests)

    # ----------------------------------- earliest-online maintenance --
    def append(self, r: Request) -> None:
        """The ONE way a request enters a bucket: keeps the cached
        earliest-online arrival exact in O(1)."""
        self.requests.append(r)
        if r.task_type == TaskType.ONLINE and (
                self._online_min is None or r.arrival < self._online_min):
            self._online_min = r.arrival

    def refresh_online(self) -> None:
        """Recompute the cache after members were REMOVED (the dropped
        one may have been the min) — O(len), paid only by buckets that
        actually changed."""
        arr = [r.arrival for r in self.requests
               if r.task_type == TaskType.ONLINE]
        self._online_min = min(arr) if arr else None

    def earliest_online(self) -> Optional[float]:
        """Arrival of the earliest ONLINE member (None if none)."""
        return self._online_min


class BucketManager:
    def __init__(self, l_max: int, theta: float = 0.5,
                 assignment: str = "linear", refine: str = "midpoint",
                 trigger: str = "majority", min_bucket_span: int = 16,
                 waste_gain_min: float = 0.005):
        self.l_max = l_max
        self.theta = theta
        self.assignment = assignment
        self.refine = refine
        # "majority": the paper's line-19 rule (fraction below midpoint
        #   > theta).  Degenerates on 50/50 bimodal mixes: 49.9% short
        #   never splits (see benchmarks/waste_model.py).
        # "waste": beyond-paper — split whenever bisection reduces the
        #   bucket's empirical Eq.-(3) waste by > waste_gain_min.  This is
        #   the "distribution-aware splitting criteria" the paper names as
        #   future work (§IV).
        self.trigger = trigger
        self.min_bucket_span = min_bucket_span
        self.waste_gain_min = waste_gain_min
        self.buckets: List[Bucket] = [Bucket(0, l_max)]
        # instrumentation (Fig. 6 overhead accounting)
        self.overhead_s = 0.0
        self.n_splits = 0
        self.n_merges = 0

    # ------------------------------------------------------------ assign --
    def add(self, req: Request) -> None:
        t0 = time.perf_counter()
        s = min(req.prompt_len, self.l_max - 1)
        if self.assignment == "bisect":
            lows = [b.low for b in self.buckets]
            i = bisect.bisect_right(lows, s) - 1
            assert s in self.buckets[i]
            self.buckets[i].append(req)
        else:  # paper lines 2-8: linear scan
            for b in self.buckets:
                if s in b:
                    b.append(req)
                    break
            else:  # pragma: no cover
                raise RuntimeError("bucket cover violated")
        self.overhead_s += time.perf_counter() - t0

    # ------------------------------------------------------------ adjust --
    def total(self) -> int:
        return sum(len(b) for b in self.buckets)

    def adjust(self, n_max: int) -> None:
        """Paper AdjustBuckets (lines 10-31); one split round per call."""
        t0 = time.perf_counter()
        total = self.total()
        if total < n_max:
            if len(self.buckets) > 1:
                merged = Bucket(0, self.l_max)
                for b in self.buckets:
                    merged.requests.extend(b.requests)
                merged.refresh_online()
                self.buckets = [merged]
                self.n_merges += 1
        else:
            split_list = []
            min_split = n_max                       # paper: m = N_max
            for b in self.buckets:
                if len(b) <= min_split:
                    continue
                if b.up - b.low <= self.min_bucket_span:
                    continue                        # do not split degenerate spans
                if self.trigger == "waste":
                    if self._waste_gain(b) > self.waste_gain_min:
                        split_list.append(b)
                    continue
                mid = b.midpoint
                c_s = sum(1 for r in b.requests if r.prompt_len < mid)
                if c_s / len(b) > self.theta:
                    split_list.append(b)
            for b in split_list:
                mid = self._split_point(b)
                b_l = Bucket(b.low, mid)
                b_r = Bucket(mid, b.up)
                for r in b.requests:
                    (b_l if min(r.prompt_len, self.l_max - 1) < mid
                     else b_r).append(r)
                i = self.buckets.index(b)
                self.buckets[i:i + 1] = [b_l, b_r]
                self.n_splits += 1
        self.overhead_s += time.perf_counter() - t0

    def _waste_gain(self, b: Bucket) -> float:
        """Empirical Eq.-(3) waste reduction a bisection would bring."""
        mid = self._split_point(b)
        lens = [min(r.prompt_len, self.l_max - 1) for r in b.requests]
        lo = [s for s in lens if s < mid]
        hi = [s for s in lens if s >= mid]
        if not lo or not hi:
            return 0.0
        before = 1.0 - (sum(lens) / len(lens)) / b.up
        after = (len(lo) * (1.0 - (sum(lo) / len(lo)) / mid)
                 + len(hi) * (1.0 - (sum(hi) / len(hi)) / b.up)) / len(lens)
        return before - after

    def _split_point(self, b: Bucket) -> int:
        if self.refine == "eq4":
            # beyond-paper: empirical conditional expectation (Eq. 4)
            mid = sum(r.prompt_len for r in b.requests) / len(b)
            mid = int(min(max(mid, b.low + 1), b.up - 1))
            return mid
        return int(b.midpoint)                      # paper: bisection

    # ------------------------------------------------------------- query --
    def boundaries(self) -> List[int]:
        return [b.low for b in self.buckets] + [self.buckets[-1].up]

    def nonempty(self) -> List[Bucket]:
        return [b for b in self.buckets if len(b)]

    def pop(self, reqs: List[Request]) -> None:
        ids = {id(r) for r in reqs}
        for b in self.buckets:
            kept = [r for r in b.requests if id(r) not in ids]
            if len(kept) != len(b.requests):
                b.requests = kept
                b.refresh_online()      # the min may have been removed

    def order_bucket(self, b: Bucket, policy: str) -> List[Request]:
        """Within-bucket ordering (paper §IV): SJF / LJF for offline,
        earliest-arrival for online SLO compliance."""
        if policy == "sjf":
            return sorted(b.requests, key=lambda r: r.prompt_len)
        if policy == "ljf":
            return sorted(b.requests, key=lambda r: -r.prompt_len)
        if policy == "fcfs":
            return sorted(b.requests, key=lambda r: r.arrival)
        raise ValueError(policy)
