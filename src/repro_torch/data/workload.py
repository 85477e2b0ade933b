"""Synthetic serving workloads mirroring the paper's datasets (§V-A).

* ``alpaca``    — short instructions: lognormal, mean ≈ 83 tokens (paper
  Fig. 2a), outputs ~ geometric/lognormal around 120 tokens.
* ``longbench`` — long-document summarization: heavy-tailed lognormal with
  median ≈ 41k tokens, truncated to the model max (the paper does the
  same), outputs around 250 tokens.
* ``mixed``     — 50/50 of the two (paper's heterogeneous case).

Arrivals are Poisson at a given RPS.  Everything is seeded/deterministic.

Shared-prefix scenario family (PR 3, for the cross-request prefix
cache): ``prefix_groups > 0`` materializes ACTUAL token ids — each
request samples one of N distinct "system prompts" of
``prefix_tokens`` ids with Zipf-distributed reuse (a few prompts
dominate, the long tail is cold — standard multi-tenant agentic
traffic shape) and appends a per-request random suffix drawn from the
dataset's length distribution.  Requests carrying tokens flow through
both execution backends unchanged, so the engine and the cost model
see bit-identical prompts.

Heterogeneous trace family (PR 7, for trace-driven traffic +
tail-latency gates, data/trace.py): ``class_mix`` nonempty mixes three
request classes in ONE arrival stream — ``chat`` (short prompts, tight
TTFT SLO), ``longctx`` (heavy-tailed long-document prompts, relaxed
TTFT), ``batch`` (offline bulk generation, throughput-only SLO) — the
heterogeneous mix UELLM (arXiv 2409.14961) targets.  Arrivals are a
non-homogeneous Poisson process: a sinusoidal diurnal envelope plus
Poisson-arriving burst windows push the instantaneous rate up to
``burst_factor`` x the steady ``rps`` (sampled by thinning against the
peak rate, so the empirical rate tracks ``rate_envelope`` exactly in
expectation).  Each class carries its OWN SLO budgets (CLASS_SLOS)
attached per request.  Composable with the prefix/session knobs: with
``prefix_groups`` every request draws a shared system prompt; with
``sessions`` the first N chat-class arrivals become multi-turn
conversations.

Multi-turn conversation family (PR 4, for the session retention layer,
core/retention.py): ``sessions > 0`` generates ``sessions x turns``
requests.  Turn 0 of a session is a normal materialized prompt; turn
t > 0 re-sends the FULL transcript (previous prompt + generated
tokens) followed by a fresh user ``utterance`` — the standard chat
transcript-growth shape.  The transcript part cannot be sampled here
(generated ids are the serving backend's to produce), so later turns
carry only their utterance and ``prompt_len``/``history_tokens``
(lengths ARE known up front: the loop always generates exactly
``max_new_tokens``); the ServingLoop composes the actual prompt ids
when the previous turn finishes, after a per-turn think-time gap.
Everything sampled here is seeded/deterministic, so the same spec
regenerates bit-identical requests across calls and backends.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, List, Tuple

import numpy as np

from repro_torch.core.request import Request, TaskType

ALPACA_MEAN = 83.0
LONGBENCH_MEDIAN = 41417.0

# Per-class SLO budgets (TTFT s, TPOT s) for the heterogeneous family.
# Values are attached to every emitted Request — trace record/replay
# and the SLO scheduler read budgets off the REQUEST, never off the
# spec.  "batch" is offline bulk work: budgets are deliberately loose
# (finite so they stay JSON-serializable in traces) — batch goodput is
# throughput, not latency.
CLASS_SLOS = {
    "chat": (2.0, 0.2),
    "longctx": (10.0, 0.4),
    "batch": (120.0, 2.0),
}

DEFAULT_CLASS_MIX: Tuple[Tuple[str, float], ...] = (
    ("chat", 0.60), ("longctx", 0.15), ("batch", 0.25))


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    dataset: str = "alpaca"        # alpaca | longbench | mixed
    rps: float = 4.0
    n_requests: int = 256
    max_model_len: int = 32768
    task_type: TaskType = TaskType.ONLINE
    slo_ttft: float = 2.0
    slo_tpot: float = 0.2
    seed: int = 0
    max_new_tokens: int = 0        # 0 = sample per dataset
    # ---- shared-prefix scenario family (0 = classic length-only) ----
    prefix_groups: int = 0         # N distinct shared system prompts
    prefix_tokens: int = 256       # length of each shared prefix
    prefix_zipf: float = 1.2       # Zipf skew of prefix reuse (> 1)
    vocab_size: int = 32000        # id range for materialized tokens
    # ---- multi-turn conversation family (0 = single-shot requests) ----
    sessions: int = 0              # number of conversations (overrides
    #                                n_requests: emits sessions x turns)
    turns: int = 4                 # turns per conversation
    think_time_s: float = 0.0      # mean think-time gap between turns
    utterance_tokens: int = 0      # new-user-tokens per later turn
    #                                (0 = sample the dataset distribution)
    # ---- heterogeneous trace family (empty = no class mixing) ----
    class_mix: Tuple[Tuple[str, float], ...] = ()   # ((name, weight), ...)
    burst_factor: float = 1.0      # peak/steady arrival-rate ratio
    diurnal_period_s: float = 60.0  # sinusoidal modulation period
    burst_every_s: float = 30.0    # mean gap between Poisson burst windows
    burst_duration_s: float = 3.0  # width of each burst window


def _sample_prompt_lens(rng, dataset: str, n: int, max_len: int):
    if dataset == "alpaca":
        # lognormal with mean 83: mu + sigma^2/2 = ln 83
        sigma = 0.9
        mu = np.log(ALPACA_MEAN) - sigma ** 2 / 2
        lens = rng.lognormal(mu, sigma, n)
    elif dataset == "longbench":
        # heavy tail, median 41417 -> mu = ln(median)
        sigma = 1.1
        lens = rng.lognormal(np.log(LONGBENCH_MEDIAN), sigma, n)
    elif dataset == "mixed":
        half = rng.random(n) < 0.5
        a = _sample_prompt_lens(rng, "alpaca", n, max_len)
        b = _sample_prompt_lens(rng, "longbench", n, max_len)
        lens = np.where(half, a, b)
    else:
        raise ValueError(dataset)
    return np.clip(lens, 4, max_len - 1).astype(np.int64)


def _sample_output_lens(rng, dataset: str, n: int):
    # Output lengths sized so decode dominates e2e time (~90%, paper
    # Fig. 6a): chat/summary responses of a few hundred tokens.
    if dataset == "alpaca":
        out = rng.lognormal(np.log(300), 0.6, n)
    elif dataset == "longbench":
        out = rng.lognormal(np.log(350), 0.5, n)
    else:
        half = rng.random(n) < 0.5
        out = np.where(half, rng.lognormal(np.log(300), 0.6, n),
                       rng.lognormal(np.log(350), 0.5, n))
    return np.clip(out, 4, 1024).astype(np.int64)


# ---------------------------------------- heterogeneous trace family ----
def trace_horizon(spec: WorkloadSpec) -> float:
    """Time window the burst-window process is materialized over: a
    generous multiple of the steady-state drain time, so the thinning
    sampler practically never outruns it (past the horizon the envelope
    degrades gracefully to the diurnal part alone)."""
    return 4.0 * spec.n_requests / max(spec.rps, 1e-9) \
        + 2.0 * max(spec.diurnal_period_s, 1.0)


def burst_windows(spec: WorkloadSpec) -> List[Tuple[float, float]]:
    """Poisson-arriving burst windows over [0, horizon).  Drawn from a
    DISJOINT rng stream keyed on the spec seed, so toggling burst knobs
    never shifts the length/class draws of the main stream."""
    if spec.burst_factor <= 1.0 or spec.burst_every_s <= 0:
        return []
    rng = np.random.default_rng([spec.seed, 0xB065])
    horizon = trace_horizon(spec)
    wins, t = [], 0.0
    while True:
        t += float(rng.exponential(spec.burst_every_s))
        if t >= horizon:
            return wins
        wins.append((t, t + spec.burst_duration_s))


def rate_envelope(spec: WorkloadSpec, t: float,
                  windows: List[Tuple[float, float]]) -> float:
    """Instantaneous arrival rate lambda(t): steady ``rps`` modulated by
    a sinusoidal diurnal swing, overridden to the full ``burst_factor``
    inside a burst window; never exceeds rps * burst_factor (the
    thinning bound)."""
    bf = max(spec.burst_factor, 1.0)
    m = 1.0
    if spec.diurnal_period_s > 0 and bf > 1.0:
        m += (bf - 1.0) * 0.5 * (1.0 - math.cos(
            2.0 * math.pi * t / spec.diurnal_period_s))
    for lo, hi in windows:
        if lo <= t < hi:
            m = bf
            break
        if lo > t:
            break
    return spec.rps * min(m, bf)


def envelope_fn(spec: WorkloadSpec) -> Callable[[float], float]:
    """The exact lambda(t) the generator thinned against — the property
    test compares empirical bin rates to this."""
    wins = burst_windows(spec)
    return lambda t: rate_envelope(spec, t, wins)


def _bursty_arrivals(spec: WorkloadSpec, rng) -> np.ndarray:
    """Non-homogeneous Poisson arrivals by thinning against the peak
    rate rps * burst_factor."""
    lam = envelope_fn(spec)
    lam_max = spec.rps * max(spec.burst_factor, 1.0)
    out, t = [], 0.0
    while len(out) < spec.n_requests:
        t += float(rng.exponential(1.0 / max(lam_max, 1e-9)))
        if float(rng.random()) * lam_max <= lam(t):
            out.append(t)
    return np.asarray(out)


def _generate_heterogeneous(spec: WorkloadSpec, rng) -> List[Request]:
    """Three-class mixed stream (see module doc).  All randomness flows
    through ``rng`` in a FIXED order (arrivals, classes, per-class
    length tables, then per-request materialization), so the same spec
    regenerates a bit-identical workload."""
    mix = spec.class_mix
    names = [c for c, _ in mix]
    w = np.asarray([max(float(p), 0.0) for _, p in mix])
    assert w.sum() > 0, "class_mix weights must not all be zero"
    for c in names:
        assert c in CLASS_SLOS, f"unknown request class {c!r}"
    n = spec.n_requests
    arrivals = _bursty_arrivals(spec, rng)
    cls_idx = rng.choice(len(names), size=n, p=w / w.sum())
    max_len = spec.max_model_len
    # per-class length tables (sampled in full, selected by mask — the
    # same pattern the "mixed" dataset uses, so draws stay vectorized
    # and deterministic)
    plens_by = {
        "chat": _sample_prompt_lens(rng, "alpaca", n, max_len),
        "longctx": _sample_prompt_lens(rng, "longbench", n, max_len),
        "batch": np.clip(rng.lognormal(np.log(900.0), 0.8, n),
                         4, max_len - 1).astype(np.int64),
    }
    olens_by = {
        "chat": _sample_output_lens(rng, "alpaca", n),
        "longctx": _sample_output_lens(rng, "longbench", n),
        "batch": np.clip(rng.lognormal(np.log(700.0), 0.6, n),
                         16, 2048).astype(np.int64),
    }
    plens = np.asarray([plens_by[names[c]][i]
                        for i, c in enumerate(cls_idx)], np.int64)
    olens = np.asarray([olens_by[names[c]][i]
                        for i, c in enumerate(cls_idx)], np.int64)
    if spec.max_new_tokens > 0:
        olens = np.full(n, spec.max_new_tokens, np.int64)
    # shared-prefix composability: identical materialization rule to the
    # classic family (N system prompts, Zipf reuse, dataset lengths
    # become suffix lengths)
    tokens: List = [None] * n
    if spec.prefix_groups > 0:
        assert spec.prefix_zipf > 1.0, "np Zipf needs skew > 1"
        pre = min(max(spec.prefix_tokens, 1), max_len - 2)
        prefixes = [rng.integers(0, spec.vocab_size, pre).astype(np.int32)
                    for _ in range(spec.prefix_groups)]
        groups = (rng.zipf(spec.prefix_zipf, n) - 1) % spec.prefix_groups
        slens = np.clip(plens, 1, max_len - 1 - pre)
        for i in range(n):
            suffix = rng.integers(0, spec.vocab_size,
                                  int(slens[i])).astype(np.int32)
            tokens[i] = np.concatenate([prefixes[int(groups[i])], suffix])
        plens = pre + slens
    olens = np.maximum(np.minimum(olens, max_len - plens), 1)
    # session composability: the first ``sessions`` chat-class arrivals
    # become multi-turn conversations (transcript growth, PR 4 shape)
    session_of: dict = {}
    if spec.sessions > 0:
        chat_ix = [i for i in range(n) if names[cls_idx[i]] == "chat"]
        for s, i in enumerate(chat_ix[:spec.sessions]):
            session_of[i] = s
    reqs: List[Request] = []
    rid = 0
    for i in range(n):
        cls = names[cls_idx[i]]
        slo_ttft, slo_tpot = CLASS_SLOS[cls]
        task = TaskType.OFFLINE if cls == "batch" else spec.task_type
        if i not in session_of:
            reqs.append(Request(
                rid=rid, prompt_len=int(plens[i]),
                max_new_tokens=int(olens[i]), arrival=float(arrivals[i]),
                task_type=task, slo_ttft=slo_ttft, slo_tpot=slo_tpot,
                tokens=tokens[i], cls=cls))
            rid += 1
            continue
        # a chat session head: emit its turns (window-budgeted exactly
        # like _generate_sessions; the ServingLoop composes turn > 0
        # prompts from actual generated ids at unlock time)
        sid = session_of[i]
        transcript = 0
        for t in range(spec.turns):
            room = max_len - transcript - 2
            if room < 1:
                break
            ulen = spec.utterance_tokens or int(_sample_prompt_lens(
                rng, "alpaca", 1, max_len)[0])
            ulen = max(1, min(ulen, room))
            out = int(spec.max_new_tokens
                      or _sample_output_lens(rng, "alpaca", 1)[0])
            out = max(1, min(out, max_len - transcript - ulen))
            utter = rng.integers(0, spec.vocab_size, ulen).astype(np.int32)
            gap = float(rng.exponential(spec.think_time_s)) if t else 0.0
            reqs.append(Request(
                rid=rid, prompt_len=transcript + ulen, max_new_tokens=out,
                arrival=float(arrivals[i]), task_type=task,
                slo_ttft=slo_ttft, slo_tpot=slo_tpot,
                tokens=utter if t == 0 else None, cls=cls,
                session_id=sid, turn=t, think_gap=gap, utterance=utter,
                history_tokens=transcript))
            transcript += ulen + out
            rid += 1
    return reqs


def _generate_sessions(spec: WorkloadSpec, rng) -> List[Request]:
    """sessions x turns transcript-growth requests (see module doc).
    Every turn's prompt_len/max_new_tokens/utterance are sampled HERE
    (deterministic); only the transcript token ids of turns > 0 are
    composed later by the ServingLoop from actual generated output."""
    assert spec.turns >= 1
    starts = np.cumsum(rng.exponential(1.0 / max(spec.rps, 1e-9),
                                       spec.sessions))
    reqs: List[Request] = []
    rid = 0
    for s in range(spec.sessions):
        transcript = 0                      # tokens of turns 0..t-1
        for t in range(spec.turns):
            # keep the whole conversation inside the model window: the
            # utterance and output budgets shrink as the transcript
            # grows, and a session whose transcript has exhausted the
            # window simply ENDS early (every emitted turn satisfies
            # prompt_len + max_new_tokens <= max_model_len — an
            # oversized turn could never be served)
            room = spec.max_model_len - transcript - 2
            if room < 1:
                break
            if spec.utterance_tokens > 0:
                ulen = spec.utterance_tokens
            else:
                ulen = int(_sample_prompt_lens(
                    rng, spec.dataset if t == 0 else "alpaca", 1,
                    spec.max_model_len)[0])
            ulen = max(1, min(ulen, room))
            out = int(spec.max_new_tokens
                      or _sample_output_lens(rng, spec.dataset, 1)[0])
            out = max(1, min(out, spec.max_model_len - transcript - ulen))
            utter = rng.integers(0, spec.vocab_size, ulen).astype(np.int32)
            gap = float(rng.exponential(spec.think_time_s)) if t else 0.0
            reqs.append(Request(
                rid=rid, prompt_len=transcript + ulen, max_new_tokens=out,
                arrival=float(starts[s]), task_type=spec.task_type,
                slo_ttft=spec.slo_ttft, slo_tpot=spec.slo_tpot,
                tokens=utter if t == 0 else None,
                session_id=s, turn=t, think_gap=gap, utterance=utter,
                history_tokens=transcript))
            transcript += ulen + out            # next turn's history
            rid += 1
    return reqs


def generate(spec: WorkloadSpec) -> List[Request]:
    rng = np.random.default_rng(spec.seed)
    if spec.class_mix:
        return _generate_heterogeneous(spec, rng)
    if spec.sessions > 0:
        return _generate_sessions(spec, rng)
    n = spec.n_requests
    gaps = rng.exponential(1.0 / max(spec.rps, 1e-9), n)
    arrivals = np.cumsum(gaps)
    plens = _sample_prompt_lens(rng, spec.dataset, n, spec.max_model_len)
    tokens: List = [None] * n
    if spec.prefix_groups > 0:
        assert spec.prefix_zipf > 1.0, "np Zipf needs skew > 1"
        pre = min(max(spec.prefix_tokens, 1), spec.max_model_len - 2)
        prefixes = [rng.integers(0, spec.vocab_size, pre).astype(np.int32)
                    for _ in range(spec.prefix_groups)]
        groups = (rng.zipf(spec.prefix_zipf, n) - 1) % spec.prefix_groups
        # dataset lengths become the SUFFIX lengths (>= 1 so at least
        # one uncached token always runs through prefill)
        slens = np.clip(plens, 1, spec.max_model_len - 1 - pre)
        for i in range(n):
            suffix = rng.integers(0, spec.vocab_size,
                                  int(slens[i])).astype(np.int32)
            tokens[i] = np.concatenate([prefixes[int(groups[i])], suffix])
        plens = pre + slens
    olens = (_sample_output_lens(rng, spec.dataset, n)
             if spec.max_new_tokens == 0
             else np.full(n, spec.max_new_tokens, np.int64))
    # keep prompt+output within the model window
    olens = np.minimum(olens, spec.max_model_len - plens)
    return [
        Request(rid=i, prompt_len=int(plens[i]),
                max_new_tokens=max(int(olens[i]), 1),
                arrival=float(arrivals[i]), task_type=spec.task_type,
                slo_ttft=spec.slo_ttft, slo_tpot=spec.slo_tpot,
                tokens=tokens[i])
        for i in range(n)
    ]
