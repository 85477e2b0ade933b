"""Baseline schedulers (paper §V baselines, re-implemented as policies).

All share the BucketServeScheduler interface so the simulator and the
real engine can drive any of them:

* ``StaticBatchScheduler``   — naive: waits for a fixed batch size (or a
  timeout), FCFS, pads to batch max.  The paper's motivating strawman.
* ``OrcaLikeScheduler``      — continuous batching, FCFS, exact lengths,
  no bucketing (run COUPLED: iteration-level single executor) [Orca].
* ``UELLMLikeScheduler``     — profiles-predicted batching: groups by a
  fine-tuned-LLM *prediction* of resource demand (we model the paper's
  reported >15% prediction error), couples P/D, no dynamic adaptation
  [UELLM].  Prediction error causes both OOM evictions and conservative
  under-batching — the two failure modes BucketServe's Eq. (6) removes.
* ``DistServeLikeScheduler`` — disaggregated P/D, FCFS prefill batches
  under a static conservative token cap, continuous decode, NO
  length-aware grouping (heterogeneous batches -> padding waste)
  [DistServe].
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.models.config import ModelConfig
from .batcher import FormedBatch, MemoryBudget
from .request import Request
from .scheduler import SchedulerBase


class _BaseScheduler(SchedulerBase):
    """FCFS-queue baseline base: the shared queue/monitor/OOM-backoff
    boilerplate lives in SchedulerBase (the loop-facing surface); this
    adds the flat list queue and greedy take."""

    name = "base"

    def __init__(self, cfg: ModelConfig, budget: MemoryBudget,
                 max_batch: int = 512, decode_reserve: float = 0.5):
        super().__init__(cfg, budget, memory_model="sum",
                         max_batch=max_batch, decode_reserve=decode_reserve)
        self.queue: List[Request] = []

    def _enqueue(self, req: Request) -> None:
        self.queue.append(req)

    def queued(self) -> int:
        return len(self.queue)

    def _take(self, reqs: List[Request]) -> FormedBatch:
        for r in reqs:
            self.queue.remove(r)
        self.monitor.queue_len -= len(reqs)
        pad = self.batcher.round_up(
            max((r.prompt_len for r in reqs), default=0))
        return FormedBatch(list(reqs), pad)


class StaticBatchScheduler(_BaseScheduler):
    name = "static"

    def __init__(self, cfg, budget, batch_size: int = 8,
                 timeout_s: float = 0.5, **kw):
        super().__init__(cfg, budget, **kw)
        self.batch_size = batch_size
        self.timeout_s = timeout_s

    def next_prefill_batch(self, now):
        if not self.queue:
            return None
        self.queue.sort(key=lambda r: r.arrival)
        oldest = self.queue[0].arrival
        if len(self.queue) < self.batch_size and now - oldest < self.timeout_s:
            return None                      # wait for a full batch
        return self._take(self.queue[:self.batch_size])


class OrcaLikeScheduler(_BaseScheduler):
    """Continuous batching; iteration-level admission; FCFS; coupled."""
    name = "orca"

    def next_prefill_batch(self, now):
        if not self.queue:
            return None
        ordered = sorted(self.queue, key=lambda r: r.arrival)
        batch = self.batcher.form_batch(ordered,
                                        self.monitor.in_flight_tokens)
        if not batch.requests:
            return None
        return self._take(batch.requests)


class UELLMLikeScheduler(_BaseScheduler):
    """Batches on *predicted* lengths with ~15% error; coupled P/D."""
    name = "uellm"

    def __init__(self, cfg, budget, pred_error: float = 0.15, seed: int = 0,
                 **kw):
        # UELLM trusts its predictor: no decode headroom is reserved, so
        # under-predictions overfill memory (OOM evictions under long/mixed
        # traffic) — the failure mode the paper ascribes to it (§V).
        kw.setdefault("decode_reserve", 0.0)
        super().__init__(cfg, budget, **kw)
        self.rng = np.random.default_rng(seed)
        self.pred_error = pred_error
        self._pred = {}

    def _predict(self, r: Request) -> float:
        if r.rid not in self._pred:
            noise = self.rng.lognormal(0.0, self.pred_error)
            self._pred[r.rid] = (r.prompt_len + r.max_new_tokens) * noise
        return self._pred[r.rid]

    def next_prefill_batch(self, now):
        if not self.queue:
            return None
        # deployment-profile batching: sort by predicted demand, greedy fill
        ordered = sorted(self.queue, key=self._predict)
        cap = self.batcher.token_budget(self.monitor.in_flight_tokens) \
            * (1 - self.batcher.decode_reserve) * self._cap_scale()
        take, tot = [], 0.0
        for r in ordered:
            pred = self._predict(r)
            if take and tot + pred > cap:
                break
            take.append(r)
            tot += pred                      # predicted, not actual -> OOM risk
            if len(take) >= self.batcher.max_batch:
                break
        if not take:
            return None
        return self._take(take)


class DistServeLikeScheduler(_BaseScheduler):
    """Disaggregated FCFS; conservative static cap; no length grouping."""
    name = "distserve"

    def __init__(self, cfg, budget, conservatism: float = 0.7, **kw):
        # DistServe sizes its prefill/decode instances statically (per-phase
        # placement optimization); there is no cross-phase decode-headroom
        # coupling like BucketServe's Eq.-(6) reserve -> admission is bounded
        # only by the conservative static cap.
        kw.setdefault("decode_reserve", 0.0)
        super().__init__(cfg, budget, **kw)
        self.conservatism = conservatism

    def next_prefill_batch(self, now):
        if not self.queue:
            return None
        ordered = sorted(self.queue, key=lambda r: r.arrival)
        cap = self.batcher.token_budget(self.monitor.in_flight_tokens) \
            * (1 - self.batcher.decode_reserve) * self.conservatism \
            * self._cap_scale()
        take, tot = [], 0
        for r in ordered:
            clen = r.prompt_len + r.max_new_tokens
            if take and tot + clen > cap:
                break
            take.append(r)
            tot += clen
            if len(take) >= self.batcher.max_batch:
                break
        if not take:
            return None
        return self._take(take)


def make_scheduler(name: str, cfg: ModelConfig, budget: MemoryBudget, **kw):
    from .scheduler import BucketServeScheduler, SchedulerConfig
    if name == "bucketserve":
        sk = {k: v for k, v in kw.items()
              if k in SchedulerConfig.__dataclass_fields__}
        return BucketServeScheduler(cfg, budget, SchedulerConfig(**sk))
    cls = {"static": StaticBatchScheduler, "orca": OrcaLikeScheduler,
           "uellm": UELLMLikeScheduler,
           "distserve": DistServeLikeScheduler}[name]
    return cls(cfg, budget, **kw)


# Execution mode per system (see Simulator): UELLM batches by predicted
# profiles at BATCH granularity (it predates iteration-level scheduling,
# coupling P/D per the paper's critique); Orca is iteration-level coupled;
# DistServe/BucketServe are disaggregated.
SIM_MODE = {"static": "static", "orca": "coupled", "uellm": "static",
            "distserve": "disagg", "bucketserve": "disagg"}

# Chip split on the paper's 4-GPU testbed: disaggregated systems dedicate
# 2 chips to each phase; coupled systems use all 4 for everything.
def hardware_for(name: str, base_hw):
    import dataclasses as _dc
    if SIM_MODE[name] == "disagg":
        return base_hw, base_hw.decode_chips, 2
    total = base_hw.prefill_chips + base_hw.decode_chips
    return (_dc.replace(base_hw, prefill_chips=total, decode_chips=total),
            total, 1)
