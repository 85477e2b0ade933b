"""Recovery policies + checkpointed drain/resume (DESIGN.md §9).

Companion to core/faults.py: the injector decides WHEN the substrate
fails, this module decides WHAT the loop does about it —

* :class:`RecoveryPolicy` — bounded retry with exponential backoff for
  transient faults, the deadline-slack shed rule (a retry that cannot
  beat the request's remaining SLO budget sheds to cold recompute
  instead of burning the restore channel), poisoned-request quarantine
  after K consecutive faults, and the restore-hold timeout that keeps a
  stalled PCIe channel from parking requests forever.

* :class:`LoopCheckpoint` — the serializable drain artifact: every
  unfinished request (with slice-boundary work promoted into its
  prompt), held future session turns, the retention layer's session
  transcripts, the radix spill inventory, and the drain clock.  A COLD
  loop resumes from it: requests re-enter in original arrival order
  with their deadline anchors (``Request.t0_anchor``) preserved —
  requeues and drains never extend a deadline — and continuation token
  ids are bit-identical because preserved work re-enters as prompt
  prefix at identical absolute positions (the PR 9 slice-resume
  argument, applied across a process boundary).

The checkpoint is plain JSON: nothing in it references live objects,
device memory, or clocks other than the recorded drain time, so it can
cross a process/replica boundary — the failover primitive the
multi-replica ROADMAP item composes.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

import numpy as np

from .request import Request, TaskType

CHECKPOINT_VERSION = 1


# ---------------------------------------------------------------- policy --
@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Knobs for every recovery decision.  Frozen so a policy can be
    shared between the loop and the retention layer without aliasing
    surprises."""

    max_retries: int = 3           # bounded retry per faulted operation
    backoff_base: float = 0.05     # first retry delay (virtual seconds)
    backoff_factor: float = 2.0
    backoff_cap: float = 2.0       # ceiling on any single backoff
    quarantine_after: int = 6      # consecutive faults -> poisoned request
    restore_timeout: float = 30.0  # max restore-hold before cold re-prefill

    def backoff(self, attempt: int) -> float:
        """Delay before retry number ``attempt`` (0-based)."""
        return min(self.backoff_cap,
                   self.backoff_base * self.backoff_factor ** attempt)

    def should_shed(self, slack_remaining: float, eta: float) -> bool:
        """The slack rule: shed (fall back to recompute / drop the
        retry) when the operation's completion ``eta`` seconds from now
        cannot beat the request's remaining SLO budget.  A request
        already past its budget sheds unconditionally — burning the
        channel for it steals bandwidth from winnable work."""
        return eta > max(slack_remaining, 0.0)


DEFAULT_RECOVERY = RecoveryPolicy()


# ------------------------------------------------------- (de)serialization --
def _arr(x: Optional[np.ndarray]) -> Optional[List[int]]:
    return None if x is None else [int(v) for v in np.asarray(x)]


def _req_to_dict(r: Request, now: float) -> Dict[str, Any]:
    """Snapshot one unfinished request for the checkpoint.  Execution
    state (pages, slots, outputs) is deliberately ABSENT: preserved
    work lives in the prompt (slice promotion ran before this), so a
    cold backend rebuilds everything from token ids."""
    return {
        "rid": int(r.rid), "prompt_len": int(r.prompt_len),
        "max_new_tokens": int(r.max_new_tokens),
        # past arrivals resume immediately; future ones (think-time
        # gaps, unreleased turns) keep their stamp
        "arrival": float(max(r.arrival, 0.0)),
        "task_type": r.task_type.value,
        "slo_ttft": float(r.slo_ttft), "slo_tpot": float(r.slo_tpot),
        "cls": r.cls,
        "tokens": _arr(r.tokens),
        "session_id": r.session_id, "turn": int(r.turn),
        "think_gap": float(r.think_gap),
        "utterance": _arr(r.utterance),
        "history_tokens": int(r.history_tokens),
        "sliced_tokens": int(r.sliced_tokens),
        "generated": int(r.generated),
        # deadline anchor: first arrival from the ledger when it
        # started, else the (possibly future) arrival itself
        "t0_anchor": float(r.ledger.t0 if r.ledger is not None
                           and r.ledger.started else -1.0),
    }


def _req_from_dict(d: Dict[str, Any]) -> Request:
    toks = d["tokens"]
    utt = d["utterance"]
    return Request(
        rid=d["rid"], prompt_len=d["prompt_len"],
        max_new_tokens=d["max_new_tokens"], arrival=d["arrival"],
        task_type=TaskType(d["task_type"]),
        slo_ttft=d["slo_ttft"], slo_tpot=d["slo_tpot"], cls=d["cls"],
        tokens=None if toks is None else np.asarray(toks, dtype=np.int32),
        session_id=d["session_id"], turn=d["turn"],
        think_gap=d["think_gap"],
        utterance=None if utt is None else np.asarray(utt, dtype=np.int32),
        history_tokens=d["history_tokens"],
        sliced_tokens=d["sliced_tokens"],
        generated=d["generated"],
        t0_anchor=d["t0_anchor"],
    )


# ------------------------------------------------------------ checkpoint --
@dataclasses.dataclass
class LoopCheckpoint:
    """Serializable drain state (see module docstring)."""

    now: float                                  # drain clock time
    requests: List[Dict[str, Any]]              # unfinished, work promoted
    held_turns: List[Dict[str, Any]]            # future session turns
    sessions: List[Dict[str, Any]]              # retention transcripts
    radix_spilled: int                          # spilled nodes at drain
    tails_demoted: int                          # tails pushed host-ward
    version: int = CHECKPOINT_VERSION

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "LoopCheckpoint":
        d = json.loads(s)
        assert d.get("version") == CHECKPOINT_VERSION, d.get("version")
        return cls(**d)

    def restore_requests(self) -> List[Request]:
        """Materialize the cold-loop request set: queued/in-flight
        requests plus the held future turns, in one list the loop's
        ``run()`` accepts (it re-splits held turns itself)."""
        reqs = [_req_from_dict(d) for d in self.requests]
        reqs += [_req_from_dict(d) for d in self.held_turns]
        reqs.sort(key=lambda r: (r.arrival, r.rid))
        return reqs


def build_checkpoint(loop, now: float) -> LoopCheckpoint:
    """Assemble a :class:`LoopCheckpoint` from a quiesced loop (every
    in-flight request already reset/promoted by ``ServingLoop.drain``).
    Separated from the loop so the serialization surface stays in one
    reviewable place."""
    held_keys = set()
    held = []
    for (sid, turn), r in sorted(loop._held.items()):
        held_keys.add(r.rid)
        held.append(_req_to_dict(r, now))
    live = [r for r in loop._requests
            if r.finished < 0 and not r.dropped and r.rid not in held_keys]
    live.sort(key=lambda r: (r.arrival, r.rid))
    sessions = []
    rt = getattr(loop.backend, "retention", None)
    spilled_nodes = 0
    if rt is not None:
        for sid, e in sorted(rt.sessions.items()):
            sessions.append({
                "sid": int(sid), "turn": int(e.turn),
                "path": _arr(e.path),
                "full_tokens": int(e.full_tokens),
                "slo_ttft": float(e.slo_ttft),
            })
        pc = getattr(rt, "prefix", None)
        if pc is not None:
            spilled_nodes = pc.spilled_nodes()
    return LoopCheckpoint(
        now=float(now), requests=[_req_to_dict(r, now) for r in live],
        held_turns=held, sessions=sessions,
        radix_spilled=spilled_nodes,
        tails_demoted=getattr(loop, "_drain_demoted", 0))
