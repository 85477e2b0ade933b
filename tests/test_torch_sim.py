"""The port's cost model, its baselines and its launcher's ``--backend
sim``, against the reference package and against the port's engine.

* The two launchers, given the same explicit flags with ``--backend
  sim``, record byte-identical request traces and print identical
  ``[sim]`` (and ``[drain]``) lines: the same scheduler (``--trigger``
  included) and the same requests (``--dataset``, ``--rps``, the
  ``max_seq_len - 16`` prompt clip).  Both run in this process through
  ``main`` with ``sys.argv`` patched, as the reference's launcher reads
  it.
* The port's ``Simulator`` gives the reference's results for the five
  systems of ``baselines.SIM_MODE`` under ``hardware_for``: the mirror of
  ``tests/test_serving.py``'s ``run_sim``, held to equality.
* The engine against the cost model, each test the mirror of one
  reference test with the port's engine (CPU, f32) and the port's cost
  model in place of the JAX engine and the JAX cost model, on the same
  smoke configs and workloads: formed or dispatched batches, bucket
  bounds, ledger transitions, page counts, hit, spill, victim and slice
  counts, fired fault sequences, and a trace replayed into both.
"""
import dataclasses
import functools
import math
import re
import sys

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_config as jax_get_config
from repro.core import baselines as jbase
from repro.core import simulator as jsim
from repro.data.workload import WorkloadSpec as JaxSpec
from repro.data.workload import generate as jax_generate
from repro.launch import serve as jserve
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import baselines as tbase
from repro_torch.core import simulator as tsim
from repro_torch.core.engine import ServingEngine
from repro_torch.core.faults import SITES, FaultPlan
from repro_torch.core.hardware import H100
from repro_torch.core.request import Request, TaskType
from repro_torch.core.simulator import A100X4, CostModel, Simulator
from repro_torch.data.trace import TraceRecorder, TraceWorkload
from repro_torch.data.workload import DEFAULT_CLASS_MIX, WorkloadSpec, generate
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tfm

BUDGET = dict(hbm_bytes_per_device=2 ** 30, n_devices=1, weight_bytes=0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke model's ops are tiny: torch's intra-op threads only
    contend with the other test workers for the cores.  Restored
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ launchers ---
LAUNCHER_FLAGS = {
    "plain": [],
    "paged": ["--paged"],
    "trigger-majority": ["--trigger", "majority"],
    "burst": ["--burst-factor", "3"],
    "sessions": ["--sessions", "2"],
    "drain-after": ["--drain-after", "2"],
    # the mesh axes: accepted, and never read by the cost model
    "mesh": ["--data", "2", "--model", "2"],
    # the full config (the cost model builds no model): its buckets
    # split, and the split rule decides where
    "llama2-13b": ["--arch", "llama2-13b", "--requests", "64"],
    # a hybrid: ring caches of the local window, RG-LRU state per request
    "recurrentgemma-2b": ["--arch", "recurrentgemma-2b", "--requests",
                          "12"],
    # the full VLM and nemotron: their weights leave no pool on the cost
    # model's chips, so every request is refused (OOM), as the
    # reference's launcher prints; the VLM at smoke size is served
    "llama-3.2-vision-90b": ["--arch", "llama-3.2-vision-90b", "--requests",
                             "32"],
    "nemotron-4-340b": ["--arch", "nemotron-4-340b", "--requests", "32"],
    "llama-3.2-vision-90b-smoke": ["--smoke", "--arch",
                                   "llama-3.2-vision-90b", "--requests",
                                   "12"],
    # an encoder: both launchers exit before serving, with one message
    "hubert-xlarge": ["--arch", "hubert-xlarge", "--requests", "12"],
}
OOM_CASES = ("llama-3.2-vision-90b", "nemotron-4-340b")


def _launch(main, flags, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve.py"] + flags)
    main()
    return capsys.readouterr().out


@pytest.mark.parametrize("case", sorted(LAUNCHER_FLAGS))
def test_launchers_print_the_same_sim_lines_and_record_the_same_requests(
        case, tmp_path, monkeypatch, capsys):
    """The reference's launcher and the port's, both ``--backend sim``
    with the same explicit flags (``--arch`` and ``--requests`` included:
    their defaults differ on purpose), print the same lines and record
    the same trace, byte for byte."""
    flags = LAUNCHER_FLAGS[case]
    base = ["--backend", "sim"]
    if "--arch" not in flags:
        base += ["--smoke", "--arch", "qwen3-14b", "--requests", "12"]
    out, traces = {}, {}
    for side, main in (("jax", jserve.main), ("torch", tserve.main)):
        path = tmp_path / f"{side}.jsonl"
        rec = [] if case == "drain-after" else ["--trace-record", str(path)]
        if case == "hubert-xlarge":
            with pytest.raises(SystemExit) as exit_:
                _launch(main, base + flags + rec, monkeypatch, capsys)
            out[side], traces[side] = str(exit_.value), b""
            continue
        text = _launch(main, base + flags + rec, monkeypatch, capsys)
        out[side] = text.replace(str(path), "TRACE")
        traces[side] = path.read_bytes() if rec else b""
    assert out["torch"] == out["jax"]
    assert traces["torch"] == traces["jax"]
    if case == "hubert-xlarge":
        assert out["torch"] == ("hubert-xlarge is encoder-only; serve "
                                "prefill-only workloads via max_new_tokens=1")
        return
    lines = out["torch"].splitlines()
    if case == "drain-after":
        assert any("drain-resume token ids identical" in x for x in lines)
        return
    served = re.search(r"^\[sim\] served (\d+)/(\d+) requests.*; OOM (\d+);",
                       out["torch"], re.MULTILINE)
    assert served, out["torch"]
    if case in OOM_CASES:
        assert served[1] == "0" and served[3] == served[2], out["torch"]
    else:
        assert served[1] == served[2], out["torch"]
    for head in ("[sim] tails: TTFT p50/p95/p99", "[sim] kv util "
                 "(time-weighted)", "recorded "):
        assert any(x.startswith(head) for x in lines), (head, lines)
    assert "padding waste" in out["torch"] and "buckets: [" in out["torch"]


def test_trigger_flag_reaches_the_buckets(monkeypatch, capsys):
    """``--trigger`` is read: on the full llama2-13b config the two split
    rules leave different buckets, and without the flag the port splits
    as the reference's default (``waste``) does."""
    flags = ["--backend", "sim", "--arch", "llama2-13b", "--requests", "64"]
    buckets = {}
    for trig in ("", "waste", "majority"):
        extra = ["--trigger", trig] if trig else []
        out = _launch(tserve.main, flags + extra, monkeypatch, capsys)
        buckets[trig] = re.search(r"buckets: (\[.*\])", out)[1]
    assert buckets[""] == buckets["waste"] != buckets["majority"]


# ---------------------------------------------------------- cost model ---
SYSTEMS = sorted(tbase.SIM_MODE)


def _run_sim(side, name, hw_name, n=150):
    """``tests/test_serving.py``'s ``run_sim`` on one package: llama2-13b,
    the mixed workload at 8 req/s, the system's mode and chip split."""
    core, sim, base = ((jcore, jsim, jbase) if side == "jax"
                       else (tcore, tsim, tbase))
    cfg = (jax_get_config if side == "jax" else get_config)("llama2-13b")
    spec = (JaxSpec if side == "jax" else WorkloadSpec)(
        dataset="mixed", rps=8, n_requests=n, max_model_len=cfg.max_seq_len)
    reqs = (jax_generate if side == "jax" else generate)(spec)
    hw0 = sim.A100X4 if hw_name == "a100x4" else \
        sim.HardwareSpec(**dataclasses.asdict(H100))
    hw, nd, _ = base.hardware_for(name, hw0)
    budget = core.MemoryBudget(hw0.hbm_bytes, nd, cfg.param_count() * 2)
    s = sim.Simulator(base.make_scheduler(name, cfg, budget),
                      sim.CostModel(cfg, hw), mode=base.SIM_MODE[name])
    return s.run(reqs)


@pytest.mark.parametrize("hw_name", ["a100x4", "h100"])
@pytest.mark.parametrize("name", SYSTEMS)
def test_simulator_results_equal_the_reference(name, hw_name):
    """Both packages' cost models on the same seeded workload: equal
    throughput, SLO attainment, OOM events, padding waste and per-request
    timings, on the reference's spec and on the port's ``H100``."""
    ref = _run_sim("jax", name, hw_name)
    got = _run_sim("torch", name, hw_name)
    assert got.throughput_tok_s() == ref.throughput_tok_s()
    assert got.slo_attainment() == ref.slo_attainment()
    assert got.oom_events == ref.oom_events
    assert got.padding_waste_ratio() == ref.padding_waste_ratio()
    assert got.makespan == ref.makespan
    assert [(r.rid, r.first_token, r.finished, r.generated, r.dropped)
            for r in got.requests] == \
        [(r.rid, r.first_token, r.finished, r.generated, r.dropped)
         for r in ref.requests]
    assert len(got.finished()) + sum(r.dropped for r in got.requests) \
        == len(got.requests)


def test_h100_spec_is_one_card():
    """One card runs both phases (``prefill_chips = decode_chips = 1``),
    at the card's published peaks and 80 GiB."""
    assert (H100.prefill_chips, H100.decode_chips) == (1, 1)
    assert (H100.peak_flops, H100.hbm_bw) == (989e12, 3.35e12)
    assert H100.hbm_bytes == 80 * 2 ** 30
    assert 0 < H100.mfu <= 1 and 0 < H100.bw_eff <= 1
    assert 0 < H100.link_bw < H100.hbm_bw


# --------------------------------------------- engine against cost model ---
class Recording(tcore.BucketServeScheduler):
    """Records every formed batch (request-id tuples)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.formed = []

    def next_prefill_batch(self, now):
        batch = super().next_prefill_batch(now)
        if batch is not None:
            self.formed.append(tuple(r.rid for r in batch.requests))
        return batch


@functools.lru_cache(maxsize=None)
def _model(max_seq_len):
    cfg = get_smoke_config("qwen3-14b", max_seq_len=max_seq_len)
    return tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")


def _engine(cfg, sched, **kw):
    return ServingEngine(cfg, _model(cfg.max_seq_len), sched, device="cpu",
                         **kw)


def _record_dispatched(backend, log):
    """Batches that dispatch (reach prefill chunk 0)."""
    orig = backend.prefill_chunk

    def rec(job, idx, _orig=orig, _log=log):
        if idx == 0:
            _log.append(tuple(r.rid for r in job.batch.requests))
        return _orig(job, idx)
    backend.prefill_chunk = rec


def _record_victims(backend, log):
    """Preemption victims at the decision point."""
    orig = backend.decode_preempt

    def rec(pool, _orig=orig, _log=log):
        victims = _orig(pool)
        if victims:
            _log.append(tuple(v.rid for v in victims))
        return victims
    backend.decode_preempt = rec


def _uniform_workload(n=12, seed=11, lo=8, hi=100, new=4):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt_len=int(rng.integers(lo, hi)),
                    max_new_tokens=new, arrival=0.0,
                    task_type=TaskType.ONLINE) for i in range(n)]


@pytest.mark.parametrize("paged", [False, True])
def test_same_batches_and_buckets(paged):
    """``tests/test_serving.py::TestBackendParity`` (contiguous) and
    ``tests/test_paged_serving.py::TestPagedBackendParity`` (paged, the
    cache length below ``max_seq_len`` so both backends derive the page
    cap from the same rule): the same formed batches, bucket bounds and
    ledger transition sequences, every ledger conserved; paged, equal
    page counts and no preemption."""
    slots, page = 4, 128
    if paged:
        cfg = get_smoke_config("qwen3-14b", max_seq_len=256)
        cache_len, pool = 128, 16 * page
        mm = dict(memory_model="paged", page_size=page)
        pg = dict(paged=True, page_size=page, kv_pool_tokens=pool,
                  cache_len=cache_len)
    else:
        cfg = get_smoke_config("qwen3-14b", max_seq_len=128)
        mm, pg = {}, dict(cache_len=128)

    def sched():
        return Recording(cfg, tcore.MemoryBudget(**BUDGET),
                         tcore.SchedulerConfig(max_batch=slots, **mm))
    s_sim = sched()
    sim = Simulator(s_sim, CostModel(cfg, A100X4), mode="disagg",
                    decode_slot_cap=slots, **pg)
    res = sim.run(_uniform_workload())
    assert len(res.finished()) == 12

    s_eng = sched()
    eng = _engine(cfg, s_eng, max_slots=slots, **pg)
    eng.submit(_uniform_workload())
    assert len(eng.run(max_wall_s=300)) == 12

    assert s_sim.formed == s_eng.formed
    assert [(b.low, b.up) for b in s_sim.buckets.buckets] == \
        [(b.low, b.up) for b in s_eng.buckets.buckets]
    assert {r.rid: r.ledger.seq for r in res.requests} == \
        {r.rid: r.ledger.seq for r in eng.result.requests}
    for r in (*res.requests, *eng.result.requests):
        assert r.ledger.conserved(), (r.rid, r.ledger.residual())
    if paged:
        assert res.preempt_events == eng.result.preempt_events == 0
        assert eng.backend.alloc.n_pages == sim.backend.alloc.n_pages


PAGE_E = 128


def _prefix_workload(cfg):
    """``tests/test_prefix_cache.py``'s shared-prefix workload, every
    request queued at 0."""
    reqs = generate(WorkloadSpec(
        dataset="alpaca", rps=1e6, n_requests=12, seed=3,
        max_model_len=cfg.max_seq_len, task_type=TaskType.OFFLINE,
        prefix_groups=2, prefix_tokens=128, vocab_size=cfg.vocab_size))
    for r in reqs:
        r.max_new_tokens = min(r.max_new_tokens, 3)
        r.arrival = 0.0
    return reqs


def _session_workload(cfg, turns):
    """``tests/test_session_reuse.py``'s conversations, starts at 0."""
    reqs = generate(WorkloadSpec(
        dataset="alpaca", rps=1e6, sessions=2, turns=turns,
        utterance_tokens=220, max_new_tokens=4, seed=7,
        task_type=TaskType.OFFLINE, max_model_len=cfg.max_seq_len,
        vocab_size=cfg.vocab_size))
    for r in reqs:
        r.arrival = 0.0
    return reqs


# (max_seq_len, workload, backend options, surface compared, counters)
RETENTION_CASES = {
    # tests/test_prefix_cache.py::TestPrefixBackendParity
    "prefix": (256, _prefix_workload,
               dict(kv_pool_tokens=64 * PAGE_E, prefix_cache=True),
               "formed", ("prefix_lookups", "prefix_hits",
                          "prefix_hit_tokens", "prefill_tokens_skipped")),
    # tests/test_session_reuse.py::TestSessionBackendParity
    "session": (1024, functools.partial(_session_workload, turns=3),
                dict(kv_pool_tokens=64 * PAGE_E, session_ttl=1000.0),
                "formed", ("session_lookups", "session_hits",
                           "session_hit_tokens", "tail_pages_reused",
                           "sessions_retained", "prefix_hit_tokens",
                           "prefill_tokens_skipped")),
    # tests/test_kv_spill.py::TestSpillBackendParity, both spill dtypes
    **{f"spill-{dt}": (1024, functools.partial(_session_workload, turns=4),
                       dict(kv_pool_tokens=10 * PAGE_E, session_ttl=1000.0,
                            host_pool_tokens=64 * PAGE_E, spill_dtype=dt),
                       "dispatched",
                       ("spilled_pages", "restored_pages", "restored_tokens",
                        "spill_drops", "spill_hold_events",
                        "session_lookups", "session_hits",
                        "session_hit_tokens", "prefill_tokens_skipped",
                        "spilled_bytes", "restored_bytes"))
       for dt in ("bf16", "int4")},
}
# counters the reference's assertions also require to be positive
POSITIVE = {"prefix_lookups", "prefix_hits", "prefill_tokens_skipped",
            "session_lookups", "session_hits", "tail_pages_reused",
            "spilled_pages", "restored_pages", "restored_tokens",
            "spill_hold_events", "spilled_bytes", "restored_bytes"}


@pytest.mark.parametrize("case", sorted(RETENTION_CASES))
def test_retention_decisions_match_the_cost_model(case):
    """The prefix-cache, session and spill parity tests of the reference
    (``test_same_batches_and_hit_counts``,
    ``test_same_batches_and_session_hit_counts``,
    ``test_same_batches_and_spill_counts``): the same formed (spill:
    dispatched) batches and the same hit, spill and restore counters on
    the engine and on the cost model, with equal page counts and, under
    the spill tier, the same modelled restore time.  The spill cases run
    the engine's clock at 10x (the retention layer's 60 s restore
    reservation on held turns passes in 6 s)."""
    max_seq, workload, opts, surface, counters = RETENTION_CASES[case]
    cfg = get_smoke_config("qwen3-14b", max_seq_len=max_seq)
    slots = 4

    def sched():
        return Recording(cfg, tcore.MemoryBudget(**BUDGET),
                         tcore.SchedulerConfig(
                             max_batch=slots, memory_model="paged",
                             page_size=PAGE_E))
    kw = dict(paged=True, page_size=PAGE_E, cache_len=cfg.max_seq_len,
              **opts)
    s_sim = sched()
    sim = Simulator(s_sim, CostModel(cfg, A100X4), mode="disagg",
                    decode_slot_cap=slots, **kw)
    disp_sim = []
    _record_dispatched(sim.backend, disp_sim)
    reqs = workload(cfg)
    res_sim = sim.run(reqs)
    assert len(res_sim.finished()) == len(reqs)

    s_eng = sched()
    scale = 10.0 if "host_pool_tokens" in opts else 1.0
    eng = _engine(cfg, s_eng, max_slots=slots, time_scale=scale, **kw)
    disp_eng = []
    _record_dispatched(eng.backend, disp_eng)
    eng.submit(workload(cfg))
    assert len(eng.run(max_wall_s=300)) == len(reqs)
    res_eng = eng.result

    if surface == "formed":
        assert s_sim.formed == s_eng.formed
    else:
        assert disp_sim == disp_eng
    for c in counters:
        got, want = getattr(res_eng, c), getattr(res_sim, c)
        assert got == want, c
        if c in POSITIVE:
            assert got > 0, c
    assert sim.backend.alloc.n_pages == eng.backend.alloc.n_pages
    if "host_pool_tokens" in opts:
        assert res_sim.restore_time_total == \
            pytest.approx(res_eng.restore_time_total)


def test_batches_victims_and_slices_match():
    """``tests/test_goodput.py::TestGoodputBackendParity``: the goodput
    scheduler over a 5-page pool with slice 4, the same dispatched
    batches, preemption victims and slice-yield outcomes on both."""
    cfg = get_smoke_config("qwen3-14b", max_seq_len=128)

    def sched():
        return tcore.GoodputScheduler(cfg, tcore.MemoryBudget(**BUDGET),
                                      tcore.SchedulerConfig(
                                          max_batch=4, memory_model="paged",
                                          page_size=32))

    def workload():
        return _uniform_workload(n=6, lo=20, hi=40, new=24)
    kw = dict(paged=True, page_size=32, kv_pool_tokens=5 * 32,
              cache_len=128, slice_tokens=4)
    sim = Simulator(sched(), CostModel(cfg, A100X4), mode="disagg",
                    decode_slot_cap=4, **kw)
    disp_sim, vic_sim = [], []
    _record_dispatched(sim.backend, disp_sim)
    _record_victims(sim.backend, vic_sim)
    res_sim = sim.run(workload())
    assert len(res_sim.finished()) == 6
    assert res_sim.preempt_events > 0

    eng = _engine(cfg, sched(), max_slots=4, **kw)
    disp_eng, vic_eng = [], []
    _record_dispatched(eng.backend, disp_eng)
    _record_victims(eng.backend, vic_eng)
    eng.submit(workload())
    assert len(eng.run(max_wall_s=600)) == 6
    res_eng = eng.result

    assert disp_sim == disp_eng
    assert vic_sim == vic_eng and vic_sim
    assert res_sim.preempt_events == res_eng.preempt_events
    assert res_sim.slice_yields == res_eng.slice_yields > 0
    assert {r.rid: (r.sliced_tokens, r.generated)
            for r in res_sim.requests} == \
        {r.rid: (r.sliced_tokens, r.generated) for r in res_eng.requests}


def _chaos_sim(plan):
    """``tests/test_faults.py``'s ``_chaos_sim``: llama2-13b on the cost
    model, the bursty three-class mix with shared prefixes and sessions,
    the fault plan armed."""
    cfg = get_config("llama2-13b")
    budget = tcore.MemoryBudget(hbm_bytes_per_device=40 * 2 ** 30,
                                n_devices=3,
                                weight_bytes=cfg.param_count() * 2)
    sched = tcore.BucketServeScheduler(cfg, budget, tcore.SchedulerConfig(
        max_batch=8, memory_model="paged", page_size=PAGE_E))
    sim = Simulator(sched, CostModel(cfg, A100X4), mode="disagg",
                    decode_slot_cap=64, paged=True, page_size=PAGE_E,
                    kv_pool_tokens=16 * 1024, prefix_cache=True,
                    session_ttl=600.0, host_pool_tokens=64 * 1024,
                    fault_plan=plan)
    spec = WorkloadSpec(rps=6.0, n_requests=40,
                        max_model_len=cfg.max_seq_len,
                        vocab_size=cfg.vocab_size,
                        class_mix=DEFAULT_CLASS_MIX, burst_factor=4.0,
                        diurnal_period_s=40.0, burst_every_s=15.0,
                        burst_duration_s=4.0, prefix_groups=4,
                        prefix_tokens=2 * PAGE_E, sessions=8, turns=3,
                        think_time_s=2.0, seed=7)
    return sim, generate(spec)


def test_fired_sequences_bit_identical_across_backends():
    """``tests/test_faults.py::TestEngineFaults``: one plan drives the
    port's engine and the cost model; per site, the faults fired at the
    draw counters both reached are the same."""
    plan = FaultPlan(seed=5, rates={"prefill_chunk": 0.15,
                                    "decode_step": 0.05,
                                    "maintain_tick": 0.1})
    cfg = get_smoke_config("qwen3-14b", max_seq_len=128)
    sched = tcore.BucketServeScheduler(cfg, tcore.MemoryBudget(**BUDGET),
                                       tcore.SchedulerConfig(max_batch=4))
    eng = _engine(cfg, sched, max_slots=4, cache_len=128, fault_plan=plan)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt_len=int(rng.integers(8, 48)),
                    max_new_tokens=6, arrival=0.0,
                    task_type=TaskType.OFFLINE) for i in range(8)]
    eng.submit(reqs)
    done = eng.run(max_wall_s=300)
    assert len(done) + sum(r.dropped for r in reqs) == len(reqs)
    for r in done:
        assert len(eng.outputs[r.rid]) == r.max_new_tokens
    assert eng.result.fault_events > 0

    sim, sreqs = _chaos_sim(plan)
    sim.run(sreqs, time_limit=40000.0)
    shared = 0
    for site in SITES:
        k = min(eng.faults.draws(site), sim.faults.draws(site))
        ef = [c for c in eng.faults.fired(site) if c < k]
        sf = [c for c in sim.faults.fired(site) if c < k]
        assert ef == sf, site
        shared += k
    assert shared > 0


def _replay_workload(cfg, page):
    """``tests/test_serving.py::TestTraceRoundTrip``'s heterogeneous
    trace: class mix, shared prefixes and one 2-turn session, queued at 0
    with the later turn parked 8 s after its predecessor."""
    reqs = generate(WorkloadSpec(
        rps=1e6, n_requests=10, seed=23, max_model_len=cfg.max_seq_len,
        vocab_size=cfg.vocab_size, class_mix=DEFAULT_CLASS_MIX,
        burst_factor=4.0, prefix_groups=2, prefix_tokens=2 * page,
        sessions=1, turns=2, think_time_s=0.0))
    for r in reqs:
        r.arrival = 0.0
        r.think_gap = 8.0 if r.turn > 0 else 0.0
        r.max_new_tokens = min(r.max_new_tokens, 4)
        if r.tokens is not None:
            r.prompt_len = min(r.prompt_len, 120)
            r.tokens = r.tokens[:r.prompt_len]
        if r.utterance is not None:
            r.utterance = r.utterance[:64]
    by_turn = {(r.session_id, r.turn): r for r in reqs
               if r.session_id is not None}
    for (sid, t), r in sorted(by_turn.items()):
        if t == 0:
            continue
        prev = by_turn[(sid, t - 1)]
        r.history_tokens = prev.prompt_len + prev.max_new_tokens
        r.prompt_len = r.history_tokens + len(r.utterance)
        assert r.prompt_len < cfg.max_seq_len
    return reqs


def test_replay_into_both_backends(tmp_path):
    """``tests/test_serving.py::TestTraceRoundTrip``: a run on the cost
    model with the recorder attached, its trace replayed into the cost
    model (bit-identical: batch log, formed batches, prompt ids, hit
    counters, per-request timings and ledgers) and into the port's engine
    (the same formed batches, prompt ids and hit counters, every ledger
    conserved).  The engine gets 3x the slots: it shares them between
    prefill admission and live decodes, where the cost model gives
    prefill its own."""
    slots, page = 4, 16
    cfg = get_smoke_config("qwen3-14b", max_seq_len=512)

    def sched():
        return Recording(cfg, tcore.MemoryBudget(**BUDGET),
                         tcore.SchedulerConfig(
                             max_batch=slots, memory_model="paged",
                             page_size=page))
    kw = dict(paged=True, page_size=page, kv_pool_tokens=256 * page,
              cache_len=cfg.max_seq_len, prefix_cache=True,
              session_ttl=1000.0)

    def sim_run(reqs, recorder):
        s = sched()
        sim = Simulator(s, CostModel(cfg, A100X4), mode="disagg",
                        decode_slot_cap=slots, recorder=recorder, **kw)
        return s, sim.run(reqs)

    def prompt_ids(res):
        return {r.rid: (None if r.tokens is None else r.tokens.tobytes())
                for r in res.requests if r.turn == 0}

    def hits(res):
        return (res.prefix_lookups, res.prefix_hits, res.prefix_hit_tokens,
                res.session_lookups, res.session_hits,
                res.session_hit_tokens)

    reqs = _replay_workload(cfg, page)
    n = len(reqs)
    rec = TraceRecorder()
    s0, res0 = sim_run(reqs, rec)
    assert len(res0.finished()) == n
    assert res0.prefix_hits > 0 and res0.session_hits > 0
    path = str(tmp_path / "round.jsonl")
    rec.save(path)

    tw = TraceWorkload(path)
    assert len(tw) == n
    rec1 = TraceRecorder()
    s1, res1 = sim_run(tw.requests(), rec1)
    assert rec1.batch_log == rec.batch_log
    assert s1.formed == s0.formed
    assert prompt_ids(res1) == prompt_ids(res0)
    assert hits(res1) == hits(res0)
    assert sorted((r.rid, r.finished, r.first_token, r.generated)
                  for r in res1.requests) == \
        sorted((r.rid, r.finished, r.first_token, r.generated)
               for r in res0.requests)
    assert {r.rid: (r.ledger.seq, r.ledger.phases) for r in res1.requests} \
        == {r.rid: (r.ledger.seq, r.ledger.phases) for r in res0.requests}
    for r in res0.requests:
        assert r.ledger.conserved(), (r.rid, r.ledger.residual())

    s2 = sched()
    eng = _engine(cfg, s2, max_slots=3 * slots, **kw)
    eng.submit(tw.requests())
    assert len(eng.run(max_wall_s=300)) == n
    assert s2.formed == s0.formed
    assert prompt_ids(eng.result) == prompt_ids(res0)
    assert hits(eng.result) == hits(res0)
    for r in eng.result.requests:
        assert r.ledger.conserved(), (r.rid, r.ledger.residual())
    assert math.isfinite(eng.result.makespan)


# ---------------------------------------------- the torch backend's lines ---
TAIL = (r"^tails: TTFT p50/p95/p99 \d+\.\d{3}/\d+\.\d{3}/\d+\.\d{3} s, "
        r"TPOT p50/p95/p99 \d+\.\d/\d+\.\d/\d+\.\d ms, (\d+) incomplete$")
CLASS = (r"^class (\w+): TTFT p50/p95/p99 \d+\.\d{3}/\d+\.\d{3}/\d+\.\d{3} "
         r"s, TPOT p99 (\d+\.\d|nan) ms, attainment \d\.\d\d, goodput "
         r"\d+\.\d{3} req/s$")
UTIL = (r"^kv util \(time-weighted\) \d\.\d\d; padding waste (\d\.\d{3}); "
        r"blame \{\w+: [\d.]+s(, \w+: [\d.]+s)*\}$")


def test_torch_backend_prints_the_reference_tail_and_waste_lines(capsys):
    """``--backend torch --device cpu`` on the smoke config prints the
    reference launcher's ``tails:`` line (p50/p95/p99, incomplete count),
    a line per request class with attainment and goodput under the burst
    mix, the goodput line, and the kv util / padding waste / blame line,
    beside the port's kernel launch line."""
    tserve.main(["--backend", "torch", "--smoke", "--device", "cpu",
                 "--dtype", "f32", "--requests", "6", "--burst-factor", "3",
                 "--paged", "--page-size", "32", "--chunk", "64",
                 "--slots", "4"])
    out = capsys.readouterr().out
    assert re.search(r"served 6/6 requests", out), out
    tail = re.search(TAIL, out, re.MULTILINE)
    assert tail and tail[1] == "0", out
    classes = re.findall(CLASS, out, re.MULTILINE)
    assert classes and {c for c, _ in classes} <= {"chat", "longctx",
                                                    "batch"}, out
    assert re.search(r"^goodput \d+\.\d{3} req/s \(\d+\.\d{3} finished "
                     r"req/s\)$", out, re.MULTILINE), out
    util = re.search(UTIL, out, re.MULTILINE)
    assert util and 0.0 <= float(util[1]) < 1.0, out
    assert "kernel launches: flash_prefill 0" in out


def test_torch_backend_refuses_drain_after_with_the_reference_message():
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--backend", "torch", "--smoke", "--device", "cpu",
                     "--drain-after", "1"])
    assert exc.value.code == ("--drain-after is a cost-model smoke: "
                              "use --backend sim")
