"""Observability layer: per-request latency ledger + typed event
timeline (DESIGN.md §7).

Two instruments, both backend-agnostic (they stamp whatever clock the
ServingLoop runs on — virtual seconds on the cost model, scaled wall
seconds on the engine):

* :class:`LatencyLedger` — a phase state machine every ``Request``
  carries.  A request is in exactly ONE phase at any instant; each
  transition accumulates the elapsed interval into the phase being
  left.  Because transitions are stamped with the loop's monotonic
  clock and the partition is exhaustive, a **conservation invariant**
  holds by construction: the phase durations sum to
  ``closed_at - t0`` (first arrival to retirement) to float tolerance
  — asserted in tests for every request in both backends, including
  dropped ones (their phases sum to the drop time).

* :class:`Tracer` — a typed event sink (complete/instant/counter/async
  spans) exportable as Chrome trace-event JSON, so a serve run opens
  directly in ``ui.perfetto.dev`` with one track per bucket / spill
  channel / executor.  The disabled default (:data:`NULL_TRACER`) is a
  zero-overhead seam: every hot-path call site guards on
  ``tracer.enabled`` before building any argument, so a disabled run
  performs no tracer calls and no event allocations at all — the
  regression test drives the loop with a tracer whose methods *raise*
  (enabled=False) and must complete untouched.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------- ledger --
#: The exhaustive, non-overlapping phase partition of a request's life:
#:   queue           — bucket dwell: arrival (or requeue release) until
#:                     batch dispatch
#:   admission_block — waiting after a slot-capacity / KV-page clamp
#:                     bounced the request back to the queue
#:   requeue_gap     — the restart-penalty window after an OOM eviction
#:                     or a mid-decode preemption (time past the window
#:                     spills into ``queue``)
#:   restore_hold    — parked while a host->device KV restore is in
#:                     flight (core/retention.py spill tier)
#:   formed          — dispatched into a formed batch, not yet executing
#:                     (batch-formation overhead on the request clock;
#:                     the scheduler's own bucketing cost is accounted
#:                     separately as ``bucketing_overhead_s``)
#:   prefill         — prompt chunks running (includes inter-chunk
#:                     residency while decode interleaves)
#:   transfer        — prefill->decode KV transfer + decode-slot wait
#:                     (disagg topology only)
#:   decode          — live in the decode pool until finish/preemption
#:   fault_retry     — stalled on an injected/substrate fault while the
#:                     recovery policy backs off and retries (core/
#:                     faults.py); zero in a fault-free run
PHASES = ("queue", "admission_block", "requeue_gap", "restore_hold",
          "formed", "prefill", "transfer", "decode", "fault_retry")

#: Phases that are WAITING (scheduler-inflicted) rather than compute —
#: the numerator of the latency-blame share the burst-tail gates read.
#: Fault backoff counts as waiting: the request burned wall time without
#: compute progressing.
WAIT_PHASES = ("queue", "admission_block", "requeue_gap", "restore_hold",
               "fault_retry")

#: Conservation tolerance: phase sums are chains of float adds over the
#: same stamps the end-to-end subtraction uses, so only accumulation
#: roundoff can appear.
CONSERVE_TOL = 1e-6


class LatencyLedger:
    """Per-request phase accounting (see :data:`PHASES`).

    ``seq`` records the *transition labels* in order (phase re-entries
    that don't change phase are accumulated silently) — the surface the
    engine-vs-sim parity suite compares, since wall/virtual durations
    legitimately differ but the decision sequence must not.
    """

    __slots__ = ("t0", "closed_at", "phases", "seq", "ttft_phases",
                 "_cur", "_since", "_gap_until")

    def __init__(self) -> None:
        self.t0 = -1.0                       # FIRST arrival (requeues
        #                                      overwrite Request.arrival)
        self.closed_at = -1.0
        self.phases: Dict[str, float] = {}
        self.seq: List[str] = []
        # phase breakdown frozen at first-token time (what TTFT blame
        # reads); overwritten if a preemption forces a second prefill
        self.ttft_phases: Optional[Dict[str, float]] = None
        self._cur: Optional[str] = None
        self._since = 0.0
        self._gap_until = -1.0

    # ------------------------------------------------------------ state --
    @property
    def started(self) -> bool:
        return self.t0 >= 0.0

    @property
    def closed(self) -> bool:
        return self.closed_at >= 0.0

    # ------------------------------------------------------ transitions --
    def start(self, t: float) -> None:
        """First arrival: the request enters ``queue`` at ``t``."""
        assert not self.started, "ledger already started"
        self.t0 = t
        self._cur = "queue"
        self._since = t
        self.seq.append("queue")

    def _accumulate(self, t: float) -> None:
        assert self.started and not self.closed, (self.t0, self.closed_at)
        assert t >= self._since - 1e-9, \
            f"non-monotonic ledger stamp: {t} < {self._since} in {self._cur}"
        t = max(t, self._since)
        ph = self.phases
        if self._cur == "requeue_gap" and self._gap_until >= 0.0:
            # split at the penalty-window end: the remainder is ordinary
            # queueing (the request was schedulable again)
            cut = min(max(self._gap_until, self._since), t)
            ph["requeue_gap"] = ph.get("requeue_gap", 0.0) \
                + (cut - self._since)
            if t > cut:
                ph["queue"] = ph.get("queue", 0.0) + (t - cut)
            self._gap_until = -1.0
        else:
            ph[self._cur] = ph.get(self._cur, 0.0) + (t - self._since)
        self._since = t

    def to(self, phase: str, t: float) -> None:
        """Transition into ``phase`` at time ``t`` (no-op accumulate if
        already there)."""
        assert phase in PHASES, phase
        self._accumulate(t)
        if phase != self._cur:
            self._cur = phase
            self.seq.append(phase)

    def gap(self, t: float, until: float) -> None:
        """Enter the restart-penalty window at ``t``; time past
        ``until`` counts as ``queue`` again."""
        self.to("requeue_gap", t)
        self._gap_until = until

    def mark_first(self, t: float) -> None:
        """First token stamped at ``t``: freeze the TTFT-phase view."""
        self._accumulate(t)
        self.ttft_phases = dict(self.phases)

    def close(self, t: float) -> None:
        """Retirement (finish OR drop) at ``t``."""
        self._accumulate(t)
        self.closed_at = t
        self._cur = None

    # ----------------------------------------------------- conservation --
    def total(self) -> float:
        return sum(self.phases.values())

    def residual(self) -> float:
        """Conservation defect: ``(closed_at - t0) - sum(phases)``."""
        assert self.closed, "ledger still open"
        return (self.closed_at - self.t0) - self.total()

    def conserved(self, tol: float = CONSERVE_TOL) -> bool:
        return self.closed and abs(self.residual()) <= tol

    def wait_share(self, phases: Optional[Dict[str, float]] = None) -> float:
        """Fraction of the (given or lifetime) phase sum spent WAITING
        (:data:`WAIT_PHASES`) rather than in compute/transfer."""
        ph = self.phases if phases is None else phases
        tot = sum(ph.values())
        if tot <= 0.0:
            return 0.0
        return sum(ph.get(p, 0.0) for p in WAIT_PHASES) / tot


def blame_means(samples: List[Dict[str, float]]) -> Dict[str, float]:
    """Mean seconds per phase over a list of phase dicts (the ONE
    aggregation rule `ServeResult.blame` and the monitor share)."""
    if not samples:
        return {}
    out: Dict[str, float] = {}
    for p in PHASES:
        tot = sum(s.get(p, 0.0) for s in samples)
        if tot > 0.0:
            out[p] = tot / len(samples)
    return out


# ---------------------------------------------------------------- tracer --
class NullTracer:
    """Disabled tracer: ``enabled`` is False and every emit is a no-op.
    Hot-path call sites must guard on ``enabled`` BEFORE building event
    arguments — that guard, not these no-op bodies, is the zero-overhead
    contract (DESIGN.md §7)."""

    enabled = False

    def track(self, name: str) -> int:
        return 0

    def complete(self, track, name, ts, dur, cat="span", args=None) -> None:
        pass

    def instant(self, track, name, ts, cat="event", args=None) -> None:
        pass

    def counter(self, track, name, ts, values) -> None:
        pass

    def async_begin(self, track, name, ts, id_, cat="request",
                    args=None) -> None:
        pass

    def async_end(self, track, name, ts, id_, cat="request",
                  args=None) -> None:
        pass

    def export(self) -> Dict:
        return {"traceEvents": []}


#: Module singleton: the default `tracer` attribute everywhere.
NULL_TRACER = NullTracer()


class Tracer:
    """Collects Chrome trace-event records (`ph`: X/i/C/b/e) with one
    pseudo-thread per named track.  Timestamps are the loop clock's
    seconds, stored as microseconds (the trace-event unit).  ``export``
    sorts by timestamp (emission order is NOT monotonic — batch spans
    are emitted at completion with their start stamp) and prepends
    thread-name metadata so Perfetto renders named tracks."""

    enabled = True

    def __init__(self) -> None:
        self.events: List[Dict] = []
        self._tracks: Dict[str, int] = {}

    # ------------------------------------------------------------ tracks --
    def track(self, name: str) -> int:
        tid = self._tracks.get(name)
        if tid is None:
            tid = len(self._tracks) + 1
            self._tracks[name] = tid
        return tid

    # ------------------------------------------------------------- emits --
    def _ev(self, ph: str, track: str, name: str, ts: float, cat: str,
            args: Optional[Dict]) -> Dict:
        ev = {"name": name, "cat": cat, "ph": ph, "ts": ts * 1e6,
              "pid": 1, "tid": self.track(track)}
        if args is not None:
            ev["args"] = args
        self.events.append(ev)
        return ev

    def complete(self, track: str, name: str, ts: float, dur: float,
                 cat: str = "span", args: Optional[Dict] = None) -> None:
        ev = self._ev("X", track, name, ts, cat, args)
        ev["dur"] = max(dur, 0.0) * 1e6

    def instant(self, track: str, name: str, ts: float,
                cat: str = "event", args: Optional[Dict] = None) -> None:
        ev = self._ev("i", track, name, ts, cat, args)
        ev["s"] = "t"                                  # thread-scoped

    def counter(self, track: str, name: str, ts: float,
                values: Dict[str, float]) -> None:
        self._ev("C", track, name, ts, "counter", dict(values))

    def async_begin(self, track: str, name: str, ts: float, id_,
                    cat: str = "request",
                    args: Optional[Dict] = None) -> None:
        self._ev("b", track, name, ts, cat, args)["id"] = id_

    def async_end(self, track: str, name: str, ts: float, id_,
                  cat: str = "request",
                  args: Optional[Dict] = None) -> None:
        self._ev("e", track, name, ts, cat, args)["id"] = id_

    # ------------------------------------------------------------ export --
    def export(self) -> Dict:
        meta: List[Dict] = [{"name": "process_name", "ph": "M", "pid": 1,
                             "args": {"name": "bucketserve"}}]
        for name, tid in sorted(self._tracks.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                         "tid": tid, "args": {"name": name}})
        # stable sort: a 'b' emitted before its same-stamp 'e' stays first
        return {"traceEvents": meta + sorted(self.events,
                                             key=lambda e: e["ts"]),
                "displayTimeUnit": "ms"}

    def save(self, path: str) -> Dict:
        doc = self.export()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


# ------------------------------------------------------------ validation --
_VALID_PH = ("X", "i", "C", "b", "e", "M")


def validate_perfetto(doc) -> List[str]:
    """Schema check for an exported trace-event document.  Returns a
    list of problems (empty = valid): monotonic non-negative ``ts`` in
    file order, ``X`` spans with non-negative ``dur``, non-empty
    numeric ``C`` counter args, and balanced ``b``/``e`` async pairs
    per (cat, id) with no orphan ends."""
    errs: List[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["missing traceEvents list"]
    last_ts = -math.inf
    open_async: Dict[Tuple, int] = {}
    for i, e in enumerate(doc["traceEvents"]):
        if not isinstance(e, dict) or "name" not in e:
            errs.append(f"event {i}: not an object with a name")
            continue
        ph = e.get("ph")
        if ph not in _VALID_PH:
            errs.append(f"event {i} ({e['name']}): unknown ph {ph!r}")
            continue
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"event {i} ({e['name']}): bad ts {ts!r}")
            continue
        if ts < last_ts:
            errs.append(f"event {i} ({e['name']}): non-monotonic ts "
                        f"{ts} < {last_ts}")
        last_ts = ts
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event {i} ({e['name']}): X without "
                            f"non-negative dur ({dur!r})")
        elif ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                errs.append(f"event {i} ({e['name']}): counter needs "
                            "non-empty numeric args")
        elif ph in ("b", "e"):
            if "id" not in e:
                errs.append(f"event {i} ({e['name']}): async without id")
                continue
            key = (e.get("cat"), e["id"])
            if ph == "b":
                open_async[key] = open_async.get(key, 0) + 1
            elif open_async.get(key, 0) <= 0:
                errs.append(f"event {i} ({e['name']}): orphan async end "
                            f"{key}")
            else:
                open_async[key] -= 1
    for key, n in open_async.items():
        if n:
            errs.append(f"unbalanced async span {key}: {n} unclosed")
    return errs
