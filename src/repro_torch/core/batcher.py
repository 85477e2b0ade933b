"""Dynamic batching controller — paper Eqs. (1), (5), (6).

Memory safety:
    M_safe = 0.9 × M_remain                                   (Eq. 5)
    N_max  = max{ N : Σ_{i<=N} S_i  <=  M_safe / (2·L·H·D·B) } (Eq. 6)

The 2LHDB factor is ``ModelConfig.kv_bytes_per_token`` (which correctly
zeroes attention-free layers and window-caps SWA/local-attention layers —
the TPU adaptation of the paper's A100 memory model, DESIGN.md §4).

Three memory models:
  * ``"sum"``    — the paper's Eq. (6): footprint ∝ Σ S_i (per-request
    exact allocation; the idealized lower bound).
  * ``"padded"`` — footprint ∝ N × S_pad (bucket-upper padding; what the
    real engine's contiguous slot pool actually allocates).  Beyond-paper
    but required for honest TPU memory accounting.
  * ``"paged"``  — footprint ∝ Σ ceil(S_i / page) × page: Eq. (6) made
    EXACT for the block-table decode pool (core/paging.py, DESIGN.md §3)
    — within one page of "sum" per request, and what the paged engine
    physically pins.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.models.config import ModelConfig
from .bucket import Bucket, BucketManager
from .request import Request, TaskType


@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    hbm_bytes_per_device: int = 16 * 2 ** 30      # v5e
    n_devices: int = 1                             # devices holding this cache
    weight_bytes: int = 0                          # model weights (sharded)
    activation_reserve: float = 0.05               # fraction held back
    reserve: float = 0.10                          # paper's 10% (Eq. 5)

    def m_safe(self) -> float:
        total = self.hbm_bytes_per_device * self.n_devices
        remain = total - self.weight_bytes - self.activation_reserve * total
        return max(0.0, (1.0 - self.reserve) * remain)   # Eq. (5)


@dataclasses.dataclass
class FormedBatch:
    requests: List[Request]
    pad_to: int                                    # padded sequence length
    bucket: Optional[Bucket] = None

    @property
    def size(self) -> int:
        return len(self.requests)

    @property
    def total_tokens(self) -> int:
        return sum(r.prompt_len for r in self.requests)

    @property
    def padded_tokens(self) -> int:
        return self.pad_to * len(self.requests)

    # ---- per-batch waste gauges (core/telemetry.py timeline args) ----
    @property
    def padding_fraction(self) -> float:
        """Fraction of the padded prefill compute that is pure padding
        — Eq. (1)'s overhead MEASURED per dispatched batch."""
        padded = self.padded_tokens
        return 1.0 - self.total_tokens / padded if padded else 0.0

    @property
    def homogeneity(self) -> float:
        """min/max prompt length across rows: 1.0 = perfectly uniform
        batch (the bucket did its job), ->0 = pathological mixing."""
        if not self.requests:
            return 1.0
        lens = [r.prompt_len for r in self.requests]
        return min(lens) / max(max(lens), 1)


class DynamicBatchController:
    def __init__(self, cfg: ModelConfig, budget: MemoryBudget,
                 memory_model: str = "sum", bytes_per_el: int = 2,
                 max_batch: int = 512, decode_reserve: float = 0.5,
                 pad_multiple: int = 128, page_size: int = 128):
        assert memory_model in ("sum", "padded", "paged"), memory_model
        self.cfg = cfg
        self.budget = budget
        self.memory_model = memory_model
        self.page_size = page_size
        # quantized-KV variant: Eq. (6) admits ~2x the live tokens
        self.kv_per_tok = max(cfg.cache_bytes_per_token(), 1)
        self.state_per_req = cfg.state_bytes(bytes_per_el)
        self.max_batch = max_batch
        # fraction of the KV budget reserved for in-flight decode caches
        self.decode_reserve = decode_reserve
        self.pad_multiple = pad_multiple

    # -------------------------------------------------------------- Eq 6 --
    def token_budget(self, in_flight_tokens: int = 0) -> float:
        """M_safe / 2LHDB minus what live decode caches already hold."""
        cap = self.budget.m_safe() / self.kv_per_tok
        return max(0.0, cap - in_flight_tokens)

    def n_max(self, mean_len: float, in_flight_tokens: int = 0) -> int:
        """Scalar N_max used by Algorithm 1's split threshold."""
        cap = self.token_budget(in_flight_tokens) * (1 - self.decode_reserve)
        return max(1, min(self.max_batch, int(cap / max(mean_len, 1.0))))

    #: min-slack scale (s) over which the restore-backlog admission
    #: throttle fades out: a queue whose tightest deadline has less
    #: than this much slack left gets the restore pressure discounted
    #: proportionally (zero slack = no throttle at all)
    slack_relief_s = 1.0

    def admission_pressure_tokens(self, restore_pages: int,
                                  restore_backlog_bytes: int,
                                  min_slack: Optional[float] = None) -> int:
        """Restore-aware admission pricing (DESIGN.md §4): Eq.-(6)
        token-equivalents of host-tier restore traffic the plain
        in-flight sum misses.

        Two terms: (1) device pages already RESERVED by in-flight
        restores (``restore_begin`` took them off the free list, but no
        block table holds them yet) — real KV occupancy under paged
        accounting; (2) the COMPRESSED bytes still queued on the PCIe
        channel, converted through Eq. (6)'s own denominator
        (``kv_per_tok``) — restores about to land and occupy pages get
        priced before admission overfills the pool and forces the
        evict/restore thrash the reservations exist to prevent.  A
        compressed spill tier (int8/int4) queues fewer bytes per page,
        so its backlog term is proportionally cheaper — quantized spill
        shows up in admission exactly as it does on the wire.

        ``min_slack`` (DESIGN.md §8, fed by the goodput scheduler from
        the monitor's minimum-slack gauge) scales the BACKLOG term by
        how much deadline slack the queue still has: throttling
        admission to protect a restore's resume-TTFT is the wrong trade
        while a near-deadline request starves, so the channel-backlog
        pressure fades linearly to zero as min slack approaches zero.
        Reserved pages are never discounted — they are physically
        occupied."""
        pages = restore_pages * self.page_size \
            if self.memory_model == "paged" else 0
        backlog = int(restore_backlog_bytes / self.kv_per_tok)
        if min_slack is not None:
            backlog = int(backlog * min(
                max(min_slack / self.slack_relief_s, 0.0), 1.0))
        return pages + backlog

    def _cache_len(self, r: Request) -> int:
        win = self.cfg.sliding_window or (
            self.cfg.local_window if self.cfg.arch_type == "hybrid" else 0)
        need = r.prompt_len + r.max_new_tokens
        return min(need, win) if win else need

    def form_batch(self, ordered: List[Request],
                   in_flight_tokens: int = 0) -> FormedBatch:
        """Greedy prefix of `ordered` under Eq. (6) (or padded model)."""
        cap = self.token_budget(in_flight_tokens) * (1 - self.decode_reserve)
        take, tot, pad = [], 0, 0
        for r in ordered:
            if len(take) >= self.max_batch:
                break
            clen = self._cache_len(r)
            if self.memory_model in ("sum", "paged"):
                new_tot = tot + self.charge_tokens(clen)
                if take and new_tot > cap:
                    break
                tot = new_tot
            else:  # padded
                new_pad = max(pad, self.round_up(clen))
                if take and new_pad * (len(take) + 1) > cap:
                    break
                pad = new_pad
                tot = pad * (len(take) + 1)
            take.append(r)
            # SSM/hybrid per-request state counts against the budget too
            tot += self.state_per_req / self.kv_per_tok
        pad_to = self.round_up(max((r.prompt_len for r in take), default=0))
        return FormedBatch(take, pad_to)

    def round_up(self, n: int) -> int:
        """Round a sequence length up to the controller's pad multiple —
        the padded shape a formed batch compiles/executes at."""
        m = self.pad_multiple
        return -(-n // m) * m if n else 0

    def charge_tokens(self, cache_tokens: int, shared_tokens: int = 0) -> int:
        """Tokens a cache of ``cache_tokens`` is CHARGED against the
        budget: exact under "sum"/"padded" accounting, ceil-to-page under
        "paged" (a request pins whole pages — Eq. (6) on page granules).
        ``shared_tokens`` (paged model only) is the retention hit:
        shared pages are charged ONCE by whoever first materialized
        them, so a sharer pays only its private suffix.  The discount is
        FLOORED to full pages — a session-resumed hit is unaligned, but
        its partial tail page is handed over PRIVATE to the request
        (core/retention.py), so the request pays for that whole page."""
        if self.memory_model != "paged":
            return cache_tokens
        p = self.page_size
        return max((-(-cache_tokens // p) - shared_tokens // p) * p, 0)
