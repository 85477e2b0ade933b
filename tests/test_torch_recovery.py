"""Slice-boundary preemption, fault injection, recovery and checkpointed
drain in the port's engine, with its launcher's trace and timeline
flags.

The port's counterparts of ``tests/test_goodput.py``'s
``TestSlicePreemption`` and ``test_session_turns_never_sliced``, with
the reference's assertions; ``TestGoodputBackendParity`` and
``tests/test_faults.py``'s ``TestEngineFaults`` with the JAX engine in
the place of the cost model (the same workload, plan and weights, f32:
the same dispatched batches, victims, slice yields, fired fault counters
and token ids).  Then the three places where a torch engine differs
from a JAX one: an abandoned prefill job must leave nothing in the
engine's batch cache for the next job, an evicted slot must not write
through its old block-table row, and a restore's queued copy must
land before its page changes owner.  Last, the launcher: a trace the
JAX package wrote replays with the same batch log, the fault line and
the validated timeline print, and ``--drain-after`` is refused.
"""
import dataclasses
import json
import math
import re

import numpy as np
import pytest

import repro.core as jcore
from repro.core.engine import ServingEngine as JaxEngine
from repro.core.faults import FaultPlan as JaxFaultPlan
from repro.core.telemetry import validate_perfetto
from repro.data.trace import TraceRecorder as JaxRecorder
from repro.data.trace import TraceWorkload as JaxTraceWorkload
from repro_torch.core.engine import ServingEngine as TorchEngine
from repro_torch.core.faults import SITES, FaultPlan
from repro_torch.core.recovery import LoopCheckpoint, RecoveryPolicy
from repro_torch.data.trace import TraceWorkload, write_trace
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttfm

from test_torch_prefix import (CORE, jax_params, one_torch_thread,  # noqa: F401
                               session_workload, smoke_cfg, torch_model)

BUDGET = dict(hbm_bytes_per_device=2 ** 30, n_devices=1, weight_bytes=0)
PLAN = dict(seed=5, rates={"prefill_chunk": 0.15, "decode_step": 0.05,
                           "maintain_tick": 0.1})


def engine(side, cfg, *, sched="bucket", slots=4, max_batch=None,
           paged=False, page=32, pool_tokens=None, fault_plan=None, **kw):
    """One engine ("jax" or "torch", the port on the CPU) on the
    reference's test weights, its batches capped at ``max_batch`` (by
    default ``slots``); the port's batch prefill cache has that many
    rows from construction."""
    core = CORE[side]
    cls = core.GoodputScheduler if sched == "goodput" \
        else core.BucketServeScheduler
    s = cls(cfg, core.MemoryBudget(**BUDGET), core.SchedulerConfig(
        max_batch=max_batch or slots,
        memory_model="paged" if paged else "sum",
        page_size=page))
    if fault_plan is not None:
        fault_plan = (JaxFaultPlan if side == "jax" else FaultPlan)(
            **fault_plan)
    opts = dict(max_slots=slots, cache_len=cfg.max_seq_len, paged=paged,
                page_size=page, kv_pool_tokens=pool_tokens,
                fault_plan=fault_plan, **kw)
    if side == "jax":
        return JaxEngine(cfg, jax_params(), s, **opts)
    return TorchEngine(cfg, torch_model(), s, device="cpu",
                       prefill_rows=max_batch or slots, **opts)


def record_dispatch(eng, log, victims=None):
    """Batches that dispatch (first chunk of each job) and preemption
    victims at the decision point: ``tests/test_goodput.py``'s
    ``_record_dispatched`` / ``_record_victims``."""
    be = eng.backend
    prefill, preempt = be.prefill_chunk, be.decode_preempt

    def chunk(job, idx):
        if idx == 0:
            log.append(tuple(r.rid for r in job.batch.requests))
        return prefill(job, idx)
    be.prefill_chunk = chunk
    if victims is not None:
        def decode_preempt(pool):
            out = preempt(pool)
            if out:
                victims.append(tuple(v.rid for v in out))
            return out
        be.decode_preempt = decode_preempt


def ids(eng, reqs):
    return {r.rid: list(eng.outputs[r.rid]) for r in reqs}


def serve_all(eng, reqs):
    eng.submit(reqs)
    done = eng.run(max_wall_s=300)
    assert len(done) == len(reqs)
    for r in reqs:
        assert len(eng.outputs[r.rid]) == r.max_new_tokens, r.rid
    return ids(eng, reqs)


# --------------------------------------- slice-boundary preemption -------
def preempt_workload(side, n=6, seed=3, new_lo=20, new_hi=40):
    """``tests/test_goodput.py:_preempt_workload``."""
    core = CORE[side]
    rng = np.random.default_rng(seed)
    return [core.Request(rid=i, prompt_len=int(rng.integers(20, 40)),
                         max_new_tokens=int(rng.integers(new_lo, new_hi)),
                         arrival=0.0, task_type=core.TaskType.OFFLINE)
            for i in range(n)]


def test_engine_yield_resume_bit_identical():
    """Pool exhaustion forces yields at slice boundaries; every resumed
    request's ids equal the uncontended run's bit for bit, and the kept
    tokens are the head of its final output."""
    cfg = smoke_cfg("torch", max_seq_len=128)
    eng = engine("torch", cfg, paged=True, pool_tokens=5 * 32,
                 slice_tokens=4)
    reqs = preempt_workload("torch")
    kept = {}
    hook = eng.backend.on_slice_yield

    def on_yield(req, keep):
        hook(req, keep)
        kept.setdefault(req.rid, []).append(list(eng.outputs[req.rid]))
    eng.backend.on_slice_yield = on_yield
    got = serve_all(eng, reqs)
    assert eng.result.slice_yields > 0
    sliced = [r for r in reqs if r.sliced_tokens > 0]
    assert sliced, "no request ever yielded at a slice boundary"
    for r in sliced:
        assert r.sliced_tokens % 4 == 0
        assert r.first_token >= 0          # first token not reset
        for head in kept[r.rid]:
            assert got[r.rid][:len(head)] == head
    assert eng.backend.free_blocks() == eng.backend.alloc.n_pages

    ref = engine("torch", cfg, paged=True)
    want = serve_all(ref, [dataclasses.replace(
        r, arrival=0.0, generated=0, prompt_len=r.prompt_len
        - r.sliced_tokens, tokens=r.tokens[:r.prompt_len - r.sliced_tokens],
        sliced_tokens=0, first_token=-1.0, prefill_start=-1.0,
        finished=-1.0) for r in reqs])
    assert got == want


def test_session_turns_never_sliced():
    """Slice yields would corrupt a session transcript: under page
    pressure with ``slice_tokens`` set, session turns only reset."""
    cfg = smoke_cfg("torch", max_seq_len=1024)
    eng = engine("torch", cfg, paged=True, page=128,
                 pool_tokens=12 * 128, session_ttl=1000.0, slice_tokens=4)
    reqs = session_workload("torch", cfg, sessions=3, turns=4, utter=200,
                            out=16)
    serve_all(eng, reqs)
    assert eng.result.preempt_events > 0
    assert eng.result.slice_yields == 0
    assert all(r.sliced_tokens == 0 for r in reqs)


def goodput_workload(side):
    """``TestGoodputBackendParity._workload``: uniform max_new keeps the
    tier and score order clock-independent."""
    core = CORE[side]
    rng = np.random.default_rng(11)
    return [core.Request(rid=i, prompt_len=int(rng.integers(20, 40)),
                         max_new_tokens=24, arrival=0.0,
                         task_type=core.TaskType.ONLINE) for i in range(6)]


def test_goodput_parity_with_jax_engine():
    """The GoodputScheduler over a pool tight enough to preempt: the same
    dispatched batches, victims, slice yields, per-rid (sliced, generated)
    and token ids as the JAX engine."""
    runs = {}
    for side in ("jax", "torch"):
        cfg = smoke_cfg(side, max_seq_len=128)
        eng = engine(side, cfg, sched="goodput", paged=True,
                     pool_tokens=5 * 32, slice_tokens=4)
        disp, vic = [], []
        record_dispatch(eng, disp, vic)
        reqs = goodput_workload(side)
        out = serve_all(eng, reqs)
        res = eng.result
        runs[side] = (disp, vic, res.preempt_events, res.slice_yields,
                      {r.rid: (r.sliced_tokens, r.generated) for r in reqs},
                      out)
    j, t = runs["jax"], runs["torch"]
    assert t[1] and t[2] > 0 and t[3] > 0
    assert t == j


# ------------------------------------------------------------ faults -----
def fault_workload(side, n=8, seed=3, mnt=6):
    """``tests/test_faults.py:_eng_reqs``."""
    core = CORE[side]
    rng = np.random.default_rng(seed)
    return [core.Request(rid=i, prompt_len=int(rng.integers(8, 48)),
                         max_new_tokens=mnt, arrival=0.0,
                         task_type=core.TaskType.OFFLINE) for i in range(n)]


def test_fired_faults_and_ids_match_jax_engine():
    """``TestEngineFaults``' plan through both engines: every request
    finishes with its full output, the fired counters of every site are
    equal up to the shared draw count, and the ids are the JAX engine's
    and the fault-free run's."""
    runs = {}
    for side in ("jax", "torch"):
        cfg = smoke_cfg(side, max_seq_len=128)
        eng = engine(side, cfg, fault_plan=PLAN)
        out = serve_all(eng, fault_workload(side))
        assert eng.result.fault_events > 0
        runs[side] = (eng.faults, out)
    (jf, jout), (tf, tout) = runs["jax"], runs["torch"]
    for site in SITES:
        k = min(jf.draws(site), tf.draws(site))
        assert [c for c in tf.fired(site) if c < k] == \
            [c for c in jf.fired(site) if c < k], site
    assert sum(len(tf.fired(s)) for s in SITES) > 0
    assert tout == jout
    cfg = smoke_cfg("torch", max_seq_len=128)
    assert serve_all(engine("torch", cfg), fault_workload("torch")) == tout


def drain_when(eng, where, after):
    """Stop the run for a drain after the ``after``-th call of the
    backend's ``where`` ("decode_iter", or "prefill_chunk" of a job with
    chunks left, so that the drain finds a prefill in flight)."""
    be, loop = eng.backend, eng.loop
    fn, n = getattr(be, where), [0]

    def call(*args):
        out = fn(*args)
        if where == "prefill_chunk":
            job, idx = args
            if idx == len(job.chunks) - 1:
                return out
        n[0] += 1
        if n[0] == after:
            loop._drain_at = -math.inf     # the loop breaks at its top
        return out
    setattr(be, where, call)


@pytest.mark.parametrize("where,after", [("decode_iter", 6),
                                         ("prefill_chunk", 2)])
def test_drain_resume_ids_equal_uninterrupted_and_jax(where, after):
    """Drain mid-run (a decode pool, or a prefill job in flight), round
    trip the checkpoint through JSON, resume on a cold engine: nothing
    lost or duplicated, every id equal to the uninterrupted run's, which
    equals the JAX engine's; pages balance in both engines."""
    kw = dict(slice_tokens=2, paged=True, page=16, chunk_tokens=16)
    cfg = smoke_cfg("torch", max_seq_len=128)
    want = serve_all(engine("torch", cfg, **kw), fault_workload("torch"))
    assert want == serve_all(engine("jax", smoke_cfg("jax", max_seq_len=128),
                                    **kw), fault_workload("jax"))

    eng = engine("torch", cfg, **kw)
    drain_when(eng, where, after)
    reqs = fault_workload("torch")
    eng.loop.run(reqs, time_limit=math.inf, max_wall_s=300,
                 drain_at=math.inf)
    if where == "prefill_chunk":
        assert eng.loop.job is not None
    else:
        assert eng.loop.pool
    ck = LoopCheckpoint.from_json(eng.loop.drain().to_json())
    assert eng.backend.free_blocks() == eng.backend.alloc.n_pages
    assert eng.backend._job is None
    cold_eng = engine("torch", cfg, **kw)
    cold = ck.restore_requests()
    assert cold
    cold_eng.loop.run(cold, time_limit=math.inf, max_wall_s=300,
                      resume_clock=ck.now)
    assert cold_eng.backend.free_blocks() == cold_eng.backend.alloc.n_pages

    done1 = {r.rid for r in reqs if r.finished >= 0 and not r.dropped}
    done2 = {r.rid for r in cold if r.finished >= 0 and not r.dropped}
    assert done1 | done2 == set(want)          # nothing lost
    assert not done1 & done2                   # nothing duplicated
    assert any(r.sliced_tokens for r in cold) or where == "prefill_chunk"
    for rid in done1:
        assert eng.outputs[rid] == want[rid], rid
    for rid in done2:
        assert cold_eng.outputs[rid] == want[rid], rid


# ----------------------------------------- the port's own three traps ----
def test_abandoned_prefill_job_leaves_no_pages_and_no_live_cache(
        monkeypatch):
    """A prefill-chunk storm past the retry budget: every abandoned job
    is dropped the moment the loop drops it (the job object itself is
    still on the caller's frame then) and its pages are free; the batch
    cache is the engine's one, made once, and the rows an abandoned job
    wrote are zero again when the next job starts, so nothing of it is
    live for the next job; every request finishes or is quarantined."""
    cfg = smoke_cfg("torch", max_seq_len=128)
    caches = []
    real = ttfm.init_cache

    def tracked(*args, **kw):
        cache = real(*args, **kw)
        caches.append(cache["groups"][0][0]["k"])
        return cache
    monkeypatch.setattr(ttfm, "init_cache", tracked)
    eng = engine("torch", cfg, paged=True, page=16, chunk_tokens=8,
                 fault_plan=dict(seed=3, rates={"prefill_chunk": 0.35}),
                 recovery=RecoveryPolicy(max_retries=0))
    loop, be = eng.loop, eng.backend
    assert len(caches) == 1                    # the batch cache, once
    leaf = caches[0]
    abandon, checked, dirty = loop._abandon_job, [], []

    def abandoned(job, now):
        wrote = job.handle is not None and bool(leaf.any())
        abandon(job, now)
        assert be._job is None and job.handle is None
        if wrote:
            checked.append(job)
            dirty.append(len(job.batch.requests))
    loop._abandon_job = abandoned
    begin, zeroed = be._begin_job, []

    def begin_job(job):
        h = begin(job)
        if dirty:
            B = len(job.batch.requests)
            for slots in h["cache"]["groups"]:
                for slot in slots:
                    assert all(not t.any() for t in slot.values())
            assert not h["cache"]["pos"].any()
            zeroed.append(B)
            dirty.clear()
        return h
    be._begin_job = begin_job
    reqs = fault_workload("torch")
    eng.submit(reqs)
    eng.run(max_wall_s=300)
    assert checked, "no job was abandoned after writing the batch cache"
    assert zeroed, "no job started after an abandoned one"
    for r in reqs:
        assert (r.finished >= 0) != r.quarantined, r.rid
    assert be.free_blocks() == be.alloc.n_pages
    assert len(caches) == 1 and be._batch_cache["groups"][0][0]["k"] is leaf


def pool_pages(be):
    """Every leaf of the page pool as a (pages, ...) view."""
    return [leaf.transpose(0, 1) for group in be.pool_cache["groups"]
            for slot in group for leaf in slot.values()]


def test_evicted_slot_writes_no_live_page():
    """Decode-pool kills (a decode fault with no retry budget) evict
    every pooled request, and batches of two refill the four slots, so
    decode steps run beside dead slots whose requests' pages were freed
    and handed out again.  At every step the only pages written are the
    live requests' current pages and the trash page, and the ids equal
    the fault-free run's."""
    cfg = smoke_cfg("torch", max_seq_len=128)
    kw = dict(max_batch=2, paged=True, page=16, slice_tokens=2)
    want = serve_all(engine("torch", cfg, **kw),
                     fault_workload("torch", mnt=12))
    eng = engine("torch", cfg, fault_plan=dict(
        seed=11, rates={"decode_step": 0.2}),
        recovery=RecoveryPolicy(max_retries=0), **kw)
    be = eng.backend
    step = be.decode_iter

    def checked(pool, ctx):
        before = [p.clone() for p in pool_pages(be)]
        allowed = {be.trash_page}
        for r in pool:
            pos = be._decode_tokens(r) - 1
            allowed.add(be.alloc.table(r.rid)[pos // be.page_size])
        out = step(pool, ctx)
        for b, a in zip(before, pool_pages(be)):
            changed = (b != a).flatten(1).any(1).nonzero().flatten()
            assert set(changed.tolist()) <= allowed, (changed, allowed)
        return out
    be.decode_iter = checked
    got = serve_all(eng, fault_workload("torch", mnt=12))
    assert eng.result.fault_kills > 0 and eng.result.slice_yields > 0
    assert got == want
    assert be.free_blocks() == be.alloc.n_pages


def test_faulted_restores_write_no_reassigned_page():
    """Sessions over a spill tier with the restore channel stalling and
    failing: each copy is queued only for a page reserved by its restore,
    and when ``poll`` writes it the page is on no request's table and not
    free; ids equal the run without retention."""
    cfg = smoke_cfg("torch", max_seq_len=1024)

    def run(**kw):
        eng = engine("torch", cfg, paged=True, page=128,
                     pool_tokens=10 * 128, time_scale=50.0, **kw)
        reqs = [dataclasses.replace(r, arrival=0.0) for r in
                session_workload("torch", cfg, sessions=2, turns=4,
                                 utter=220, out=4)]
        return eng, reqs
    eng, reqs = run()
    want = serve_all(eng, reqs)
    eng, reqs = run(session_ttl=1e9, host_pool_tokens=64 * 128,
                    fault_plan=dict(seed=7, rates={"restore_stall": 0.5,
                                                   "restore_error": 0.3}))
    checks = {"restore": 0, "poll": 0}
    be = eng.backend
    alloc, cp = be.alloc, be.retention.copier
    restore, poll = cp.restore, cp.poll

    def queued(hslot, page):
        assert alloc._restoring.get(hslot) == page
        checks["restore"] += 1
        restore(hslot, page)

    def landed():
        tables = {p for rid in alloc._tables for p in alloc._tables[rid]}
        for hslot, page in cp._pending:
            assert page not in alloc._free and page not in tables
            checks["poll"] += 1
        poll()
    cp.restore, cp.poll = queued, landed
    got = serve_all(eng, reqs)
    res = eng.result
    assert res.restore_stalls > 0
    assert res.restore_failures + res.restore_sheds > 0
    assert checks["restore"] > 0 and checks["poll"] == checks["restore"]
    assert got == want
    assert alloc.free_pages() + alloc.live_pages() == alloc.n_pages


# ---------------------------------------------------------- launcher -----
def test_jax_written_trace_replays_through_the_port_launcher(tmp_path,
                                                             capsys):
    """A trace recorded by the JAX engine (every request at t = 0, so
    batch formation is slot-bound) replays through the port's launcher
    with the same formed-batch log; a trace the port writes reads back in
    the JAX package."""
    jcfg = smoke_cfg("jax", max_seq_len=256)
    rec = JaxRecorder()
    sched = jcore.BucketServeScheduler(jcfg, jcore.MemoryBudget(**BUDGET),
                                       jcore.SchedulerConfig(max_batch=4))
    eng = JaxEngine(jcfg, jax_params(), sched, max_slots=4,
                    cache_len=256, chunk_tokens=64, recorder=rec)
    reqs = fault_workload("jax", n=10)
    eng.submit(reqs)
    assert len(eng.run(max_wall_s=300)) == len(reqs)
    path = tmp_path / "jax.jsonl"
    rec.save(str(path))
    out_path = tmp_path / "port.jsonl"
    tserve.main(["--smoke", "--device", "cpu", "--dtype", "f32",
                 "--slots", "4", "--chunk", "64", "--trace-replay",
                 str(path), "--trace-record", str(out_path)])
    out = capsys.readouterr().out
    log = re.search(r"^batch log: (.*)$", out, re.MULTILINE)
    assert log and log[1] == str(rec.batch_log), out
    assert re.search(r"served 10/10 requests", out), out
    back = JaxTraceWorkload(str(out_path)).requests()
    assert [(r.rid, r.prompt_len, r.max_new_tokens, r.tokens.tolist())
            for r in back] == \
        [(r.rid, r.prompt_len, r.max_new_tokens, r.tokens.tolist())
         for r in TraceWorkload(str(path)).requests()]


def test_launcher_prints_fault_line_and_a_valid_timeline(tmp_path, capsys):
    """``--sched goodput --slice-tokens 4 --fault-plan ... --trace-out``
    on the CPU, replaying a trace of ``TestGoodputBackendParity``'s
    workload written by the port over a 5-page pool: slice yields, the
    fault line, and a timeline that the reference's schema check also
    accepts."""
    cfg = smoke_cfg("torch", max_seq_len=128)
    reqs = goodput_workload("torch")
    for r in reqs:
        r.materialize_tokens(cfg.vocab_size)
    trace = tmp_path / "goodput.jsonl"
    write_trace(str(trace), reqs)
    path = tmp_path / "timeline.json"
    spec = "seed=7,decode_step=0.05,prefill_chunk=0.05,maintain_tick=0.1"
    tserve.main(["--smoke", "--device", "cpu", "--dtype", "f32",
                 "--max-seq-len", "128", "--trace-replay", str(trace),
                 "--paged", "--page-size", "32", "--pool-tokens",
                 str(5 * 32), "--slots", "4", "--sched", "goodput",
                 "--slice-tokens", "4", "--fault-plan", spec,
                 "--trace-out", str(path)])
    out = capsys.readouterr().out
    assert re.search(r"served 6/6 requests", out), out
    yields = re.search(r"slice yields (\d+)", out)
    assert yields and int(yields[1]) > 0, out
    faults = re.search(r"^faults\[seed=7,.*\]: (\d+) injected", out,
                       re.MULTILINE)
    assert faults and int(faults[1]) > 0, out
    assert re.search(r"^\[trace\] \d+ events on \d+ tracks", out,
                     re.MULTILINE), out
    doc = json.loads(path.read_text())
    assert validate_perfetto(doc) == []
    cats = {e.get("cat") for e in doc["traceEvents"]}
    assert {"prefill", "decode", "preempt", "fault"} <= cats, cats


def test_launcher_refuses_drain_after(capsys):
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--smoke", "--device", "cpu", "--drain-after", "1"])
    assert exc.value.code not in (0, None)
    assert "--backend sim" in str(exc.value.code)
