"""Versioned JSONL request traces: record any serve run, replay it
bit-identically through either execution backend.

Schema (one JSON object per line):

* Line 0 — header: ``{"schema": "bucketserve.trace", "version": 1,
  "n": <request count>, "meta": {...}}``.  Readers HARD-FAIL
  (``TraceError``) on schema/version mismatch, corrupt JSON, or a
  body shorter than ``n`` lines (truncation is never silent).
* Lines 1..n — one request each, sorted by arrival (nondecreasing is
  VALIDATED on both write and read: an out-of-order trace is a bug in
  the producer, not something to quietly sort away).  Fields are the
  request's pre-run workload identity: ``rid``, ``arrival``,
  ``prompt_len``, ``max_new_tokens``, ``cls``, ``task``, per-class
  ``slo_ttft``/``slo_tpot``, session keys (``session_id``, ``turn``,
  ``think_gap``, ``history_tokens``), and materialized token ids —
  ``tokens`` for one-shot / turn-0 prompts, ``utterance`` for later
  session turns (their full prompt is composed at unlock time from the
  backend's actual generated ids, so a trace stores what the WORKLOAD
  supplied, never what a particular run composed).

Determinism contract: a trace captures requests AFTER
``backend.begin`` materializes prompt ids but BEFORE the run loop
mutates anything (arrivals get overwritten on requeue, session turns
get composed prompts).  Replaying preserves rids, so the rid-seeded
materialization rule (core/request.py) and the per-rid synthetic
generated-id rule (core/simulator.py) regenerate identical ids even
for fields a trace stores as null — the same backend-parity invariant
the existing cross-backend tests gate on.  JSON round-trips Python
floats exactly (repr-based shortest-repr), so arrivals and SLO budgets
survive record -> replay bit-identically.
"""
from __future__ import annotations

import copy
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.request import Request, TaskType

TRACE_SCHEMA = "bucketserve.trace"
TRACE_VERSION = 1


class TraceError(ValueError):
    """Raised for any malformed trace: wrong schema/version, corrupt
    JSON, truncation, or out-of-order arrivals."""


def _ids(arr: Optional[np.ndarray]) -> Optional[List[int]]:
    return None if arr is None else [int(x) for x in arr]


def _arr(ids) -> Optional[np.ndarray]:
    return None if ids is None else np.asarray(ids, np.int32)


def request_to_record(r: Request) -> Dict:
    """The pre-run identity of a request (see module doc)."""
    return {
        "rid": r.rid,
        "arrival": r.arrival,
        "prompt_len": r.prompt_len,
        "max_new_tokens": r.max_new_tokens,
        "cls": r.cls,
        "task": r.task_type.value,
        "slo_ttft": r.slo_ttft,
        "slo_tpot": r.slo_tpot,
        "session_id": r.session_id,
        "turn": r.turn,
        "think_gap": r.think_gap,
        "history_tokens": r.history_tokens,
        "tokens": None if r.turn > 0 else _ids(r.tokens),
        "utterance": _ids(r.utterance),
    }


def record_to_request(rec: Dict) -> Request:
    try:
        return Request(
            rid=int(rec["rid"]),
            prompt_len=int(rec["prompt_len"]),
            max_new_tokens=int(rec["max_new_tokens"]),
            arrival=float(rec["arrival"]),
            task_type=TaskType(rec["task"]),
            slo_ttft=float(rec["slo_ttft"]),
            slo_tpot=float(rec["slo_tpot"]),
            tokens=_arr(rec["tokens"]),
            cls=str(rec.get("cls", "")),
            session_id=rec["session_id"],
            turn=int(rec["turn"]),
            think_gap=float(rec["think_gap"]),
            utterance=_arr(rec["utterance"]),
            history_tokens=int(rec["history_tokens"]),
        )
    except (KeyError, TypeError) as e:
        raise TraceError(f"malformed trace record: {e!r}") from e


def write_trace(path: str, requests: List[Request],
                meta: Optional[Dict] = None) -> None:
    """Serialize ``requests`` (must already be sorted by arrival)."""
    last = float("-inf")
    for r in requests:
        if r.arrival < last:
            raise TraceError(
                f"out-of-order arrivals: rid={r.rid} at {r.arrival} "
                f"after {last}")
        last = r.arrival
    header = {"schema": TRACE_SCHEMA, "version": TRACE_VERSION,
              "n": len(requests), "meta": meta or {}}
    with open(path, "w") as f:
        f.write(json.dumps(header) + "\n")
        for r in requests:
            f.write(json.dumps(request_to_record(r)) + "\n")


def read_trace(path: str) -> Tuple[Dict, List[Request]]:
    """Parse and validate a trace; returns (header, requests)."""
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines:
        raise TraceError(f"{path}: empty trace (missing header)")

    def parse(i: int) -> Dict:
        try:
            obj = json.loads(lines[i])
        except json.JSONDecodeError as e:
            raise TraceError(f"{path}:{i + 1}: corrupt JSON: {e}") from e
        if not isinstance(obj, dict):
            raise TraceError(f"{path}:{i + 1}: expected an object")
        return obj

    header = parse(0)
    if header.get("schema") != TRACE_SCHEMA:
        raise TraceError(
            f"{path}: schema {header.get('schema')!r}, "
            f"expected {TRACE_SCHEMA!r}")
    if header.get("version") != TRACE_VERSION:
        raise TraceError(
            f"{path}: trace version {header.get('version')!r}, this "
            f"reader understands version {TRACE_VERSION}")
    n = header.get("n")
    if not isinstance(n, int) or n < 0:
        raise TraceError(f"{path}: bad request count {n!r}")
    if len(lines) - 1 < n:
        raise TraceError(
            f"{path}: truncated trace — header promises {n} requests, "
            f"found {len(lines) - 1}")
    reqs = [record_to_request(parse(i)) for i in range(1, n + 1)]
    last = float("-inf")
    for r in reqs:
        if r.arrival < last:
            raise TraceError(
                f"{path}: out-of-order arrivals at rid={r.rid}")
        last = r.arrival
    return header, reqs


class TraceRecorder:
    """Attach to a ServingLoop (``recorder=`` kwarg) to capture a run.

    * ``on_begin``   — pristine per-request snapshots, taken after
      ``backend.begin`` (token ids materialized) and before the loop
      mutates state.  This is what ``save`` writes.
    * ``on_dispatch``/``on_requeue``/``on_turn`` — the run's event log:
      formed batches (the bit-identity surface replay is checked
      against), requeue arrivals, and session-turn compositions.
    """

    def __init__(self) -> None:
        self.snapshots: List[Request] = []
        self.batch_log: List[Tuple[str, Tuple[int, ...]]] = []
        self.requeues: List[Tuple[int, float]] = []
        self.turns: List[Tuple[int, float]] = []

    # -- ServingLoop hooks -------------------------------------------
    def on_begin(self, requests: List[Request]) -> None:
        self.snapshots = [copy.deepcopy(r) for r in requests]
        self.snapshots.sort(key=lambda r: (r.arrival, r.rid))

    def on_dispatch(self, kind: str, batch: List[Request],
                    t: float) -> None:
        self.batch_log.append((kind, tuple(r.rid for r in batch)))

    def on_requeue(self, r: Request, t: float) -> None:
        self.requeues.append((r.rid, t))

    def on_turn(self, r: Request, t: float) -> None:
        self.turns.append((r.rid, t))

    # -- outputs ------------------------------------------------------
    def save(self, path: str, meta: Optional[Dict] = None) -> None:
        m = dict(meta or {})
        m.setdefault("n_batches", len(self.batch_log))
        m.setdefault("n_requeues", len(self.requeues))
        m.setdefault("n_turns", len(self.turns))
        write_trace(path, self.snapshots, meta=m)


class TraceWorkload:
    """Load a trace back into the ``Request`` stream.  ``requests()``
    deep-copies on every call: serving mutates requests in place, so
    each run (and each backend in a parity check) must get a fresh,
    pristine stream with the recorded arrival timestamps."""

    def __init__(self, path: str) -> None:
        self.header, self._requests = read_trace(path)

    @property
    def meta(self) -> Dict:
        return self.header.get("meta", {})

    def __len__(self) -> int:
        return len(self._requests)

    def requests(self) -> List[Request]:
        return [copy.deepcopy(r) for r in self._requests]
