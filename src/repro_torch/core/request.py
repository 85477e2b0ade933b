"""Request model for the serving system."""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from .telemetry import LatencyLedger


class TaskType(enum.Enum):
    ONLINE = "online"     # latency-sensitive, SLO-bound
    OFFLINE = "offline"   # throughput-oriented


@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    prompt_len: int                      # S in the paper
    max_new_tokens: int
    arrival: float                       # seconds
    task_type: TaskType = TaskType.ONLINE
    slo_ttft: float = 2.0                # time-to-first-token SLO (s)
    slo_tpot: float = 0.2                # time-per-output-token SLO (s)
    tokens: Optional[np.ndarray] = None  # actual token ids (real engine)
    # request class tag for heterogeneous traffic (data/workload.py /
    # data/trace.py): "chat" | "longctx" | "batch" | "" (untagged
    # classic workloads).  The SLO budgets above are per-class under a
    # heterogeneous mix and travel WITH the request through trace
    # record/replay, so tail gates and the SLO scheduler read budgets
    # off the request, never off a workload-global spec.
    cls: str = ""

    # --- multi-turn sessions (core/retention.py) ---
    # Turn t (> 0) of a conversation: its prompt is the FULL transcript
    # of turns 0..t-1 (prompt + generated tokens) followed by this
    # turn's new user ``utterance``.  The transcript part cannot be
    # known until the previous turn finishes, so ``tokens`` stays None
    # and the ServingLoop composes it at unlock time; ``prompt_len`` IS
    # known up front (the loop always generates exactly
    # ``max_new_tokens``), which keeps batch formation deterministic.
    session_id: Optional[int] = None     # conversation key (None = one-shot)
    turn: int = 0                        # 0-based turn index in the session
    think_gap: float = 0.0               # arrival delay after prior finish
    utterance: Optional[np.ndarray] = None  # this turn's NEW user tokens
    history_tokens: int = 0              # leading prompt tokens that are
    #                                      prior transcript (0 for turn 0)

    # --- lifecycle (filled by scheduler/engine) ---
    # prompt tokens served from the cross-request prefix cache at the
    # LAST admission (page-aligned unless a session tail was restored;
    # 0 = cold).  Set by paging.admit_blocks, reset when a preemption
    # re-queues the request.
    prefix_hit_tokens: int = 0
    # transcript tokens restored from the SESSION table at the last
    # admission (includes the pinned partial tail; 0 = no session hit)
    session_hit_tokens: int = 0
    # host-spill restore in flight (core/retention.py): the clock time
    # when the pages this request's hit continues into finish their
    # host->device copy.  >= 0 means HELD — the loop parks the request
    # instead of admitting it to re-prefill restorable KV; reset to -1
    # when it re-enters the queue.
    spill_wait: float = -1.0
    # padded prompt tokens this request actually ran through the
    # prefill executor (accumulates across preemption restarts)
    prefilled_tokens: int = 0
    # slice-boundary preemption (DESIGN.md §8): generated tokens that
    # were PROMOTED into the prompt when a mid-generation yield
    # preserved work — ``tokens[:prompt_len]`` then ends with
    # ``sliced_tokens`` already-generated ids, and the true user prompt
    # is ``prompt_len - sliced_tokens`` tokens.  0 = never sliced.
    sliced_tokens: int = 0
    # per-request phase attribution (core/telemetry.py): the ServingLoop
    # installs a fresh ledger at run start and stamps every transition;
    # phase durations sum to (retirement - first arrival) — the
    # conservation invariant the observability tests assert.  ``arrival``
    # above is OVERWRITTEN on requeue/preempt; the ledger's ``t0`` keeps
    # the original.
    ledger: Optional[LatencyLedger] = None
    prefill_start: float = -1.0
    first_token: float = -1.0
    finished: float = -1.0
    generated: int = 0
    dropped: bool = False
    # --- fault/recovery bookkeeping (core/faults.py, core/recovery.py) ---
    # consecutive faults this request absorbed since its last clean
    # chunk (reset on success); reaching RecoveryPolicy.quarantine_after
    # marks it poisoned and it is dropped with a closed ledger rather
    # than allowed to wedge the loop
    fault_streak: int = 0
    quarantined: bool = False
    # drain/resume (core/recovery.py LoopCheckpoint): original ledger t0
    # carried across the checkpoint so deadlines do NOT reset on the
    # cold loop — ``run()`` re-anchors the fresh ledger here (< 0: none)
    t0_anchor: float = -1.0

    @property
    def S(self) -> int:
        return self.prompt_len

    def t0(self) -> float:
        """FIRST arrival — the deadline anchor.  Requeue paths
        (OOM/preempt restart penalties) overwrite ``arrival``; anchoring
        SLOs there would silently extend every deadline a requeue
        touches.  The ledger keeps the original stamp."""
        if self.ledger is not None and self.ledger.started:
            return self.ledger.t0
        return self.arrival

    def ttft(self) -> float:
        return self.first_token - self.t0() if self.first_token >= 0 \
            else float("inf")

    def tpot(self) -> float:
        if self.finished < 0 or self.generated <= 1:
            return 0.0
        return (self.finished - self.first_token) / max(self.generated - 1, 1)

    def e2e(self) -> float:
        return self.finished - self.t0() if self.finished >= 0 \
            else float("inf")

    # ------------------------------------------------ deadline slack ------
    def ttft_slack(self, now: float) -> float:
        """Seconds until the TTFT budget is blown (negative = late)."""
        return self.slo_ttft - (now - self.t0())

    def tpot_slack(self, now: float) -> float:
        """Seconds of per-token budget remaining: the class allows
        ``slo_tpot`` per generated token after the first."""
        budget = self.slo_tpot * max(self.generated - 1, 1)
        return budget - (now - self.first_token)

    def slack(self, now: float) -> float:
        """Live deadline slack: TTFT slack before the first token,
        per-token TPOT slack after."""
        if self.first_token < 0:
            return self.ttft_slack(now)
        return self.tpot_slack(now)

    def sacrifice_slack(self) -> float:
        """CLOCK-FREE slack proxy for victim/eviction ordering.

        Live ``slack(now)`` depends on the backend clock (wall vs
        virtual seconds), so ordering sacrifices by it would break
        engine-vs-sim parity on preemption decisions.  This proxy ranks
        by how much budget the CLASS still grants — the full TTFT
        budget before the first token, the remaining-token TPOT budget
        after — which depends only on class budgets and token counts,
        both parity-equal.  Larger = more tolerant of being sacrificed.
        """
        if self.first_token < 0:
            return self.slo_ttft
        return self.slo_tpot * max(self.max_new_tokens - self.generated, 1)

    def slo_met(self) -> bool:
        """SLO attainment: both TTFT and per-token latency within bound."""
        if self.finished < 0 or self.dropped:
            return False
        return self.ttft() <= self.slo_ttft and self.tpot() <= self.slo_tpot

    def materialize_tokens(self, vocab_size: int) -> None:
        """Fill in concrete prompt token ids when the workload supplied
        none.  THE one seeding rule shared by every execution backend —
        the prefix cache's radix index keys on these ids, so any drift
        between backends would silently break hit-count parity.

        A later session turn (``utterance`` set, ``tokens`` None) is
        deliberately left alone: its prompt is the prior transcript +
        utterance, composed by the ServingLoop when the previous turn
        finishes — random ids here would break transcript reuse."""
        if self.tokens is None and self.utterance is None:
            rng = np.random.default_rng(self.rid)
            self.tokens = rng.integers(
                0, vocab_size, self.prompt_len).astype(np.int32)
