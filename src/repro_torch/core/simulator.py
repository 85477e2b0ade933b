"""Analytic cost-model backend: paper-scale end-to-end serving runs.

The container is CPU-only, so the paper's 4×A100 experiments (Fig. 5/6)
are reproduced on an analytic cost model; the same scheduler objects also
drive the *real* JAX engine (core/engine.py) at tiny-model scale, which
is how the cost model's scheduling behaviour is validated.

All orchestration lives in core/serving_loop.py — this module only
prices the substrate: :class:`CostModelBackend` implements the
``ExecutionBackend`` protocol on a :class:`VirtualClock`, and
:class:`Simulator` is a thin facade wiring (scheduler, cost model,
execution mode) into a :class:`ServingLoop`.

Cost model:
  prefill (compute-bound):  t = FLOPs(padded tokens) / (chips·peak·MFU)
  decode  (memory-bound) :  t = max(weight+KV bytes / (chips·BW·eff),
                                     FLOPs / (chips·peak·MFU))
  KV transfer prefill->decode over NVLink (A100) / ICI (TPU).

OOM semantics: schedulers admitting more live KV tokens than the device
budget trigger an OOM event — the offending batch is evicted and
re-queued after a restart penalty (models vLLM preemption/recompute).
BucketServe's Eq. (5)/(6) memory safety avoids these by construction.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import math

import numpy as np

from repro_torch.models.config import ModelConfig
from . import paging
from .batcher import FormedBatch
from .faults import FaultInjector
from .prefix_cache import PrefixCache
from .request import Request
from .retention import KvRetention, maintain_backend
from .serving_loop import (LoopConfig, PrefillJob, ServeResult, ServingLoop,
                           VirtualClock, batch_prefix_skip, plan_chunks)

# Back-compat alias: benchmark/analysis code predating the unified loop
# imports the result type under its simulator-era name.
SimResult = ServeResult


# ------------------------------------------------------------- hardware ---
@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float            # per chip, bf16
    hbm_bw: float                # per chip
    link_bw: float               # inter-chip (KV transfer)
    hbm_bytes: int               # per chip
    prefill_chips: int = 2
    decode_chips: int = 2
    mfu: float = 0.55            # achievable fraction of peak in prefill
    bw_eff: float = 0.80         # achievable fraction of HBM bandwidth


A100X4 = HardwareSpec("a100x4", 312e12, 1.555e12, 300e9, 40 * 2 ** 30,
                      prefill_chips=2, decode_chips=2)
V5E_POD = HardwareSpec("v5e", 197e12, 819e9, 50e9, 16 * 2 ** 30,
                       prefill_chips=128, decode_chips=128)


class CostModel:
    def __init__(self, cfg: ModelConfig, hw: HardwareSpec,
                 bytes_per_el: int = 2):
        self.cfg = cfg
        self.hw = hw
        self.b = bytes_per_el
        self.p_active = cfg.active_param_count()
        # honors the int8-KV serving variant (halved cache traffic/budget)
        self.kv_per_tok = max(cfg.cache_bytes_per_token(), 1)
        self.weight_bytes = cfg.param_count() * bytes_per_el

    def _attn_flops(self, s: int) -> float:
        """Quadratic attention FLOPs per sequence of length s (score+value)."""
        win = self.cfg.sliding_window or (
            self.cfg.local_window if self.cfg.arch_type == "hybrid" else 0)
        if self.cfg.attention_free:
            return 2.0 * 2 * self.cfg.n_layers * self.cfg.d_model * s * 64
        eff = min(s, win) if win else s
        n_attn = self.cfg.n_layers
        return 2.0 * 2 * n_attn * self.cfg.n_heads * self.cfg.d_head * s * eff

    def prefill_seconds(self, n: int, pad_to: int) -> float:
        tokens = n * pad_to                      # padded compute (TPU shapes)
        flops = 2.0 * self.p_active * tokens + n * self._attn_flops(pad_to)
        chips = self.hw.prefill_chips
        return flops / (chips * self.hw.peak_flops * self.hw.mfu)

    def prefill_chunk_seconds(self, n: int, start: int, length: int) -> float:
        """One chunked-prefill step: linear FLOPs for the chunk's tokens
        plus the *incremental* quadratic attention cost of extending each
        sequence from ``start`` to ``start+length`` context."""
        flops = 2.0 * self.p_active * n * length + n * (
            self._attn_flops(start + length) - self._attn_flops(start))
        chips = self.hw.prefill_chips
        return flops / (chips * self.hw.peak_flops * self.hw.mfu)

    def decode_iter_seconds(self, context_tokens: int, pool: int) -> float:
        """One iteration over the decode pool (one token each).
        `context_tokens`: KV tokens actually READ this iteration — exact
        live tokens for continuous/paged systems, padded-batch tokens for
        batch-granularity systems (the paper's Fig. 3b waste)."""
        if pool == 0:
            return 0.0
        chips = self.hw.decode_chips
        mem = (self.weight_bytes / chips +
               context_tokens * self.kv_per_tok / chips) / \
            (self.hw.hbm_bw * self.hw.bw_eff)
        comp = 2.0 * self.p_active * pool / (chips * self.hw.peak_flops
                                             * self.hw.mfu)
        return max(mem, comp)

    def transfer_seconds(self, prompt_tokens: int) -> float:
        return prompt_tokens * self.kv_per_tok / self.hw.link_bw

    def kv_budget_tokens(self, chips: int, reserve: float = 0.10,
                         act_reserve: float = 0.05) -> float:
        total = self.hw.hbm_bytes * chips
        remain = total - self.weight_bytes - act_reserve * total
        return max(0.0, (1 - reserve) * remain) / self.kv_per_tok


# -------------------------------------------------------------- backend ---
class CostModelBackend:
    """ExecutionBackend over the analytic cost model (virtual time).

    ``prefill_chunk``/``decode_iter`` price work instead of running it —
    the ServingLoop advances request state itself.  ``chunk_tokens``
    enables chunked prefill in the cost model too (incremental quadratic
    attention per chunk); default is whole-prompt prefill, matching the
    paper's setup.

    ``paged=True`` mirrors the real engine's block accounting
    (core/paging.py): the token KV budget becomes a page budget driven
    through the same BlockAllocator + admit/extend/preempt policies, so
    the two backends make identical paged admission decisions (the
    backend-parity invariant, DESIGN.md §3).

    ``prefix_cache=True`` mirrors the engine's cross-request prefix
    cache too: token ids are materialized with the engine's exact rng
    rule, the same radix index drives lookups/registration through
    ``paging.admit_blocks``, and chunk plans skip the cached prefix —
    so hit counts, admission decisions AND the priced prefill work
    (incremental attention from the resume offset) stay in parity.
    """

    prefill_needs_slots = False
    supports_decode = True
    # armed by the ServingLoop when the scheduler is slack-aware: a
    # CLOCK-FREE key (Request -> seconds) preferring the victim with
    # the most remaining deadline slack (DESIGN.md §8)
    slack_of = None

    def __init__(self, cost: CostModel, *, kv_budget: float,
                 chunk_tokens: Optional[int] = None, paged: bool = False,
                 page_size: int = 128,
                 kv_pool_tokens: Optional[int] = None,
                 cache_len: Optional[int] = None,
                 prefix_cache: bool = False,
                 session_ttl: Optional[float] = None,
                 host_pool_tokens: Optional[int] = None,
                 spill_bw: float = 16e9,
                 spill_dtype: str = ""):
        self.cost = cost
        self.clock = VirtualClock()
        self.paged = paged
        self.chunk_tokens = chunk_tokens
        self.flops_per_token = 2.0 * cost.p_active
        self.session_ttl = session_ttl
        self.spill_dtype = spill_dtype
        self.page_size = page_size
        # host spill tier: SAME geometry + per-page transfer pricing
        # rule as the engine (paging.host_tier_geometry: slots and
        # seconds both denominated in COMPRESSED spill-dtype bytes), so
        # spill decisions and hold times agree between the backends
        self._host_pages, self._slot_bytes = paging.host_tier_geometry(
            cost.cfg, host_pool_tokens, page_size, spill_dtype)
        self._spill_sec = self._slot_bytes / spill_bw
        self.retention: Optional[KvRetention] = None
        prefix_cache = prefix_cache or session_ttl is not None
        if prefix_cache:
            assert paged, "KV retention rides on the paged KV pool"
            assert cost.cfg.prefix_cacheable, \
                f"{cost.cfg.name}: KV retention needs chunk-resumable " \
                "prefill and purely attention-paged state"
            self.retention = self._make_retention()
        else:
            assert not self._host_pages, \
                "the host spill tier rides on the retention layer"
        if paged:
            # block accounting REPLACES the token-budget OOM check
            self._kv_budget = math.inf
            cfg = cost.cfg
            # the ONE window-cap rule both backends share (parity)
            self._cap = cfg.attn_cache_len(cache_len or cfg.max_seq_len)
            # mirror the engine's sizing EXACTLY (byte-denominated
            # through the same paging.device_pool_pages rule, one page
            # of the budget reserved as the dead-slot trash page) so
            # identical kv_pool_tokens yields identical admission
            # decisions.  kv_budget needs no re-denomination: it is
            # ALREADY cache-dtype tokens (kv_budget_tokens divided the
            # HBM bytes by cache_bytes_per_token)
            if kv_pool_tokens is not None:
                n_pages = paging.device_pool_pages(
                    cfg, int(kv_pool_tokens), page_size) - 1
            else:
                n_pages = int(kv_budget) // page_size - 1
            min_pages = -(-self._cap // page_size)
            if kv_pool_tokens is not None and n_pages < min_pages:
                raise ValueError(
                    f"kv_pool_tokens={kv_pool_tokens} too small: the "
                    f"paged pool needs at least "
                    f"{(min_pages + 1) * page_size} tokens (one full "
                    f"request of {min_pages} pages + the trash page)")
            self.alloc = self._make_alloc(max(n_pages, min_pages))
        else:
            self._kv_budget = kv_budget

    def _make_retention(self) -> KvRetention:
        return KvRetention(
            self.page_size,
            session_ttl=self.session_ttl,
            host_pool_pages=self._host_pages,
            spill_seconds_per_page=self._spill_sec,
            spill_page_bytes=self._slot_bytes)

    def _make_alloc(self, n_pages: int) -> paging.BlockAllocator:
        cfg = self.cost.cfg
        return paging.BlockAllocator(
            n_pages, self.page_size, host_pages=self._host_pages,
            page_bytes=self.page_size * max(cfg.cache_bytes_per_token(), 1),
            host_slot_bytes=self._slot_bytes)

    @property
    def prefix_cache(self) -> Optional[PrefixCache]:
        """The retention layer's radix backend (None when disabled) —
        the surface older call sites and tests address."""
        return self.retention.prefix if self.retention is not None else None

    def begin(self, requests: Sequence[Request]) -> None:
        self.clock = VirtualClock()
        if self.paged:
            self.alloc = self._make_alloc(self.alloc.n_pages)
        if self.retention is not None:
            self.retention = self._make_retention()
            # the radix index keys on ACTUAL token ids: materialize them
            # through the one shared rule (Request.materialize_tokens —
            # which leaves later session turns for the loop to compose)
            # so both backends make identical hit/miss decisions
            for r in requests:
                r.materialize_tokens(self.cost.cfg.vocab_size)

    def kv_budget_tokens(self) -> float:
        return self._kv_budget

    def maintain(self, now: float) -> None:
        maintain_backend(self, now)

    def free_slots(self) -> int:          # pragma: no cover - not consulted
        return 1 << 30

    # ------------------------------------------------- paged KV mirror ----
    def _insert_tokens(self, r: Request) -> int:
        return min(r.prompt_len + 1, self._cap)

    def _decode_tokens(self, r: Request) -> int:
        # sliced_tokens were PROMOTED into the prompt by a slice-yield
        # (serving_loop._preempt_for_decode): they are already counted
        # inside prompt_len, so only the post-promotion generation adds
        # physical context on top
        return min(r.prompt_len + r.generated - r.sliced_tokens, self._cap)

    def _prompt_tokens(self, r: Request):
        return r.tokens[:r.prompt_len]

    def admit_blocks(self, requests: Sequence[Request]) -> int:
        if not self.paged:
            return len(requests)
        return paging.admit_blocks(self.alloc, requests, self._insert_tokens,
                                   cache=self.retention,
                                   tokens_of=self._prompt_tokens)

    def decode_preempt(self, pool: Sequence[Request]) -> List[Request]:
        if not self.paged:
            return []
        return paging.extend_for_decode(self.alloc, pool,
                                        self._decode_tokens,
                                        cache=self.retention,
                                        slack_of=self.slack_of)

    def on_slice_yield(self, req: Request, keep: int) -> None:
        # the synthetic id stream (generated_tokens) is prefix-stable:
        # truncating req.generated back to ``keep`` IS the truncation
        pass

    def on_preempt_reset(self, req: Request) -> None:
        pass

    # ------------------------------------------- fault/drain teardown -----
    def abort_prefill(self, req: Request) -> None:
        """A mid-prefill request leaves before its KV enters service
        (prefill-job abandon, checkpointed drain): free its pages
        OUTRIGHT — never through ``release``, which would register a
        garbage partial transcript with the retention layer."""
        if self.paged:
            self.alloc.release(req.rid)     # idempotent: no-table is a no-op

    def evict_request(self, req: Request) -> None:
        """Tear down a pooled request's KV without retention
        registration — the decode-pool kill / drain analogue of a
        preemption victim's teardown (which ``extend_for_decode`` does
        inside the backend)."""
        if self.paged:
            self.alloc.release(req.rid)

    def chunk_plan(self, batch: FormedBatch) -> List[Tuple[int, int]]:
        # same gate as the real engine (cfg.chunkable_prefill) so the two
        # backends schedule identically for ring-cache/VLM configs
        c = self.chunk_tokens if self.cost.cfg.chunkable_prefill else None
        skip = batch_prefix_skip(batch) if self.prefix_cache is not None \
            else 0
        return plan_chunks(batch.pad_to, c, skip=skip)

    def prefill_chunk(self, job: PrefillJob, idx: int) -> float:
        start, length = job.chunks[idx]
        if idx == len(job.chunks) - 1 and self.prefix_cache is not None:
            # mirror the engine's registration point (end of prefill,
            # decode-continuing rows only) so hit counts stay in parity
            for r in job.batch.requests:
                if r.max_new_tokens > 1 and self.cost.cfg.has_decode:
                    self.prefix_cache.register(
                        self.alloc, self._prompt_tokens(r),
                        self.alloc.table(r.rid))
        if len(job.chunks) == 1 and start == 0:
            return self.cost.prefill_seconds(job.batch.size, length)
        # a span starting past 0 (later chunk OR resumed-after-prefix
        # prefill) pays the incremental quadratic attention cost of
        # extending each sequence's context from ``start``
        return self.cost.prefill_chunk_seconds(job.batch.size, start, length)

    def transfer_seconds(self, batch: FormedBatch) -> float:
        return self.cost.transfer_seconds(batch.total_tokens)

    def decode_iter(self, pool: Sequence[Request],
                    context_tokens: int) -> float:
        return self.cost.decode_iter_seconds(context_tokens, len(pool))

    def release(self, req: Request) -> None:
        if not self.paged:
            return
        # retention applies only to decode-continuing requests — the
        # engine never scatters a first-token-only row's KV into the
        # pool, so retaining it here would break hit-count parity
        if self.retention is not None and req.max_new_tokens > 1 \
                and self.cost.cfg.has_decode:
            self.retention.on_release(self.alloc, req,
                                      self._transcript_tokens(req),
                                      self.clock.now())
        else:
            self.alloc.release(req.rid)

    def _transcript_tokens(self, req: Request) -> Optional[np.ndarray]:
        """Mirror of the engine's rule: the pool holds KV for the
        prompt plus generated[:-1]."""
        if req.tokens is None:
            return None
        # generated[:sliced_tokens] already live inside tokens[:prompt_len]
        # (slice-yield promotion) — exclude them or they'd count twice
        gen = self.generated_tokens(req)[req.sliced_tokens:
                                         max(req.generated - 1, 0)]
        return np.concatenate(
            [np.asarray(req.tokens[:req.prompt_len], np.int32), gen])

    def generated_tokens(self, req: Request) -> np.ndarray:
        """Deterministic SYNTHETIC generated ids — the cost model runs
        no model, but session transcripts must still be concrete token
        paths.  Seeded per rid (disjoint from the prompt
        materialization rule), so regenerating the same request yields
        the same transcript: hit counts stay reproducible and in
        parity with the engine's (whose ids differ but whose
        transcript STRUCTURE is identical)."""
        rng = np.random.default_rng([req.rid, 0xD3C0DE])
        return rng.integers(0, self.cost.cfg.vocab_size,
                            req.generated).astype(np.int32)


# ------------------------------------------------------------ simulator ---
class Simulator:
    """Facade: (scheduler, cost model, mode) -> configured ServingLoop.

    Execution modes (loop topology, see serving_loop.ServingLoop):

    * ``disagg``  — separate prefill/decode executors + KV transfer
      (BucketServe, DistServe).
    * ``coupled`` — ONE executor; each iteration fuses the new prefill
      batch (if any) with one decode step over the live pool — Orca-style
      iteration-level scheduling.  Prefill work inflates every concurrent
      request's TPOT: the phase interference DistServe/BucketServe remove.
    * ``static``  — one executor; a batch runs prefill + ALL decode steps
      to completion before the next batch starts (naive static batching).
    """

    def __init__(self, scheduler, cost: CostModel, *, mode: str = "disagg",
                 decode_slot_cap: int = 256, restart_penalty: float = 0.5,
                 tick: float = 0.005, chunk_tokens: Optional[int] = None,
                 paged: bool = False, page_size: int = 128,
                 kv_pool_tokens: Optional[int] = None,
                 cache_len: Optional[int] = None,
                 prefix_cache: bool = False,
                 session_ttl: Optional[float] = None,
                 host_pool_tokens: Optional[int] = None,
                 spill_bw: float = 16e9,
                 spill_dtype: str = "",
                 slice_tokens: Optional[int] = None,
                 recorder=None, tracer=None,
                 fault_plan=None, recovery=None,
                 restore_timeout: float = 30.0):
        assert mode in ("disagg", "coupled", "static")
        prefix_cache = prefix_cache or session_ttl is not None
        # static mode runs a batch to completion without per-iteration
        # decode_preempt extends, so paged accounting would silently
        # understate the live footprint — refuse the combination
        assert not (paged and mode == "static"), \
            "paged KV accounting needs iteration-level decode " \
            "(disagg/coupled)"
        # fused-iteration modes bypass backend.chunk_plan (prefill is one
        # hardcoded whole-prompt span), so a prefix cache would count
        # hits and discount charges WITHOUT ever skipping prefill —
        # refuse rather than silently misreport
        assert not (prefix_cache and mode != "disagg"), \
            "prefix cache needs chunk-planned prefill (disagg mode)"
        self.sched = scheduler
        self.cost = cost
        self.mode = mode
        chips = cost.hw.decode_chips if mode == "disagg" \
            else cost.hw.decode_chips + cost.hw.prefill_chips
        self.backend = CostModelBackend(
            cost, kv_budget=cost.kv_budget_tokens(chips),
            chunk_tokens=chunk_tokens, paged=paged, page_size=page_size,
            kv_pool_tokens=kv_pool_tokens, cache_len=cache_len,
            prefix_cache=prefix_cache, session_ttl=session_ttl,
            host_pool_tokens=host_pool_tokens, spill_bw=spill_bw,
            spill_dtype=spill_dtype)
        # fault-injection plane (core/faults.py): a FaultPlan is turned
        # into a per-run injector HERE so the facade owns the arming —
        # passing a plan with no armed site is the same as passing None
        faults = None
        if fault_plan is not None and fault_plan.any_armed:
            faults = FaultInjector(fault_plan)
        self.faults = faults
        self.loop = ServingLoop(scheduler, self.backend, LoopConfig(
            mode=mode, decode_slot_cap=decode_slot_cap,
            restart_penalty=restart_penalty, tick=tick,
            slice_tokens=slice_tokens, restore_timeout=restore_timeout),
            recorder=recorder, tracer=tracer,
            faults=faults, recovery=recovery)

    def run(self, requests: List[Request], time_limit: float = 3600.0,
            drain_at: Optional[float] = None,
            resume_clock: Optional[float] = None) -> SimResult:
        return self.loop.run(requests, time_limit=time_limit,
                             drain_at=drain_at, resume_clock=resume_clock)
