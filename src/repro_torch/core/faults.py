"""Deterministic fault-injection plane (DESIGN.md §9).

The reproduction's robustness claims are only testable if the substrate
can FAIL on demand — and only debuggable if it fails the SAME way every
run.  This module is the seeded chaos seam both execution backends and
the retention layer consult at their typed injection sites:

* ``decode_step``    — transient device error on a decode iteration
                       (the loop backs off and retries the step);
* ``prefill_chunk``  — a prefill chunk fails (retry with backoff;
                       repeated failure abandons the job and may
                       quarantine poisoned requests);
* ``restore_stall``  — the host->device restore channel stalls for
                       ``stall_s`` virtual seconds (held requests hit
                       the loop's restore timeout and re-prefill cold);
* ``restore_error``  — a restore transfer hard-fails (retention retries
                       with backoff, burning the channel, then cancels
                       the in-flight restores and degrades to
                       recompute);
* ``host_corrupt``   — a host slot's content rots AT SPILL TIME; the
                       per-slot checksum stamped by the retention layer
                       detects it at restore-commit and the page is
                       discarded instead of served;
* ``maintain_tick``  — a housekeeping tick is lost (clock hiccup); TTL
                       expiry and restore completion slip one iteration.

Determinism contract: every decision is a PURE function of
``(plan.seed, site, counter)`` where ``counter`` is the per-site draw
index — never the clock, never Python's global RNG.  Two runs with the
same plan draw identical fault sequences, and because both backends
share the loop/retention code paths that draw, a faulted run replays
bit-identically into either substrate (the chaos extension of the
engine-vs-sim parity surface).  The mixer is splitmix64 (integer-only,
~30 ns per draw) so high-frequency sites stay off the profile.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

# the typed injection sites — ``FaultPlan`` rejects anything else so a
# typo'd spec fails loudly instead of silently never firing
SITES: Tuple[str, ...] = ("decode_step", "prefill_chunk", "restore_stall",
                          "restore_error", "host_corrupt", "maintain_tick")

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a bijective avalanche on 64-bit ints."""
    x = (x + _GOLDEN) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _u01(seed: int, site_id: int, counter: int) -> float:
    """Uniform [0, 1) from the (seed, site, counter) triple — THE
    determinism contract.  53 mantissa bits of a double."""
    h = _mix64(_mix64(seed & _M64) ^ _mix64((site_id * _GOLDEN) & _M64)
               ^ (counter & _M64))
    return (h >> 11) * (1.0 / (1 << 53))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Per-site fire probabilities + fault magnitudes.  Immutable so a
    plan can be shared between a reference and a chaos run, serialized
    into a trace header, or round-tripped through ``spec()``."""

    seed: int = 0
    rates: Mapping[str, float] = dataclasses.field(default_factory=dict)
    stall_s: float = 30.0          # restore-channel stall magnitude

    def __post_init__(self):
        for site, rate in self.rates.items():
            assert site in SITES, f"unknown fault site {site!r}"
            assert 0.0 <= rate <= 1.0, (site, rate)

    def rate(self, site: str) -> float:
        return self.rates.get(site, 0.0)

    @property
    def any_armed(self) -> bool:
        return any(r > 0.0 for r in self.rates.values())

    # ------------------------------------------------ spec round-trip --
    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the compact CLI form, e.g.
        ``"seed=7,decode_step=0.02,restore_stall=0.5,stall_s=5"``.
        Keys are sites (value = rate) or the scalars seed / stall_s."""
        seed, stall_s, rates = 0, 30.0, {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            key = key.strip()
            if key == "seed":
                seed = int(val)
            elif key == "stall_s":
                stall_s = float(val)
            else:
                assert key in SITES, f"unknown fault site {key!r} in spec"
                rates[key] = float(val)
        return cls(seed=seed, rates=rates, stall_s=stall_s)

    def spec(self) -> str:
        parts = [f"seed={self.seed}"] + [
            f"{s}={self.rates[s]:g}" for s in SITES if s in self.rates]
        parts.append(f"stall_s={self.stall_s:g}")
        return ",".join(parts)


class FaultInjector:
    """Draws fault decisions against a :class:`FaultPlan` and keeps the
    replay log.  One injector per run; the loop threads it through both
    backends and the retention layer, so every draw site is shared code
    and the per-site counters advance identically on both substrates."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._counters: Dict[str, int] = {s: 0 for s in SITES}
        self._site_ids: Dict[str, int] = {s: i for i, s in enumerate(SITES)}
        # replay surface: every FIRED event as (site, counter)
        self.log: List[Tuple[str, int]] = []

    def fire(self, site: str) -> bool:
        """One decision at ``site``.  Advances the site counter whether
        or not the fault fires — the counter indexes DRAWS, so the
        decision stream is independent of what other sites do."""
        c = self._counters[site]
        self._counters[site] = c + 1
        rate = self.plan.rate(site)
        if rate <= 0.0:
            return False
        fired = _u01(self.plan.seed, self._site_ids[site], c) < rate
        if fired:
            self.log.append((site, c))
        return fired

    def draws(self, site: str) -> int:
        return self._counters[site]

    def fired(self, site: str) -> List[int]:
        """Counters at which ``site`` fired, in draw order — the
        per-site sequence the cross-backend parity gate compares."""
        return [c for s, c in self.log if s == site]

    def fired_count(self) -> int:
        return len(self.log)
