"""KV retention in the port's engine: the prefix cache and multi-turn
session resume, against the JAX engine and against the port's own cold
runs.

The port's counterparts of ``tests/test_prefix_cache.py``'s
``TestPrefixCacheEngine`` and ``tests/test_session_reuse.py``'s
``TestSessionResumeEngine``, with the reference's assertions: token ids
of a run with retention equal the cold run's, turns that resume prefill
at most 40% of the cold prompt tokens, and the allocator balances (free
+ live == total; after ``clear`` everything is free).  Where the
reference holds its engine against its cost model
(``TestPrefixBackendParity``, ``TestSessionBackendParity``), the port is
held against the JAX engine on the same workload and weights (f32): the
same formed batches, hit counts and token ids.  ``_seed_prefix`` is held
bit for bit against the pool it copies from.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.engine import ServingEngine as JaxEngine
from repro.data.workload import WorkloadSpec as JaxSpec
from repro.data.workload import generate as jax_generate
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import ServingEngine as TorchEngine
from repro_torch.data.workload import WorkloadSpec, generate
from repro_torch.models import transformer as ttfm

PAGE = 128


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke model's ops are tiny: torch's intra-op threads only
    contend with the other test workers for the cores (a run here took
    minutes instead of seconds under ``-n 6``).  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recording(base):
    class Recording(base):
        """Records every formed batch (request-id tuples)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.formed = []

        def next_prefill_batch(self, now):
            batch = super().next_prefill_batch(now)
            if batch is not None:
                self.formed.append(tuple(r.rid for r in batch.requests))
            return batch
    return Recording


RECORDING = {"jax": _recording(jcore.BucketServeScheduler),
             "torch": _recording(tcore.BucketServeScheduler)}
CORE = {"jax": jcore, "torch": tcore}


@functools.lru_cache(maxsize=None)
def jax_params():
    return jtfm.init_params(jax_smoke_config("qwen3-14b"),
                            jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def torch_model():
    cfg = get_smoke_config("qwen3-14b")
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jax_params()),
                                    cfg, device="cpu")


def smoke_cfg(side, **kw):
    return (jax_smoke_config if side == "jax" else get_smoke_config)(
        "qwen3-14b", **kw)


@dataclasses.dataclass
class Run:
    eng: object
    reqs: list
    formed: list
    dispatched: list
    outs: dict          # rid -> token ids
    prompts: dict       # rid -> prompt ids (composed at run time)

    @property
    def res(self):
        return self.eng.result

    @property
    def be(self):
        return self.eng.backend


def serve(side, cfg, reqs, *, slots=4, page_size=PAGE, pool_tokens=None,
          chunk=None, **retention):
    """Serve ``reqs`` on the paged pool of one engine ("jax" or "torch",
    the port on the CPU) with the reference's test weights; every request
    must finish with its full output."""
    core = CORE[side]
    sched = RECORDING[side](cfg, core.MemoryBudget(
        hbm_bytes_per_device=2 ** 30, n_devices=1, weight_bytes=0),
        core.SchedulerConfig(max_batch=slots, memory_model="paged",
                             page_size=page_size))
    kw = dict(max_slots=slots, cache_len=cfg.max_seq_len, paged=True,
              page_size=page_size, kv_pool_tokens=pool_tokens,
              chunk_tokens=chunk, **retention)
    if side == "jax":
        eng = JaxEngine(cfg, jax_params(), sched, **kw)
    else:
        eng = TorchEngine(cfg, torch_model(), sched, device="cpu", **kw)
    dispatched = []
    orig = eng.backend.prefill_chunk

    def record(job, idx):
        if idx == 0:
            dispatched.append(tuple(r.rid for r in job.batch.requests))
        return orig(job, idx)
    eng.backend.prefill_chunk = record
    eng.submit(reqs)
    done = eng.run(max_wall_s=300)
    assert len(done) == len(reqs)
    for r in reqs:
        assert len(eng.outputs[r.rid]) == r.max_new_tokens, r.rid
    return Run(eng, reqs, sched.formed, dispatched,
               {r.rid: list(eng.outputs[r.rid]) for r in reqs},
               {r.rid: r.tokens.tolist() for r in reqs})


def check_pages_balance(run, retained: bool):
    """free + unique-live == total; at the end only the retention layer's
    pins are live, and ``clear`` frees them all."""
    a = run.be.alloc
    assert a.free_pages() + a.live_pages() == a.n_pages
    if retained:
        assert a.live_pages() > 0
        assert run.be.retention.clear(a) > 0
        assert a.free_pages() == a.n_pages
    else:
        assert a.live_pages() == 0


def prefix_workload(side, cfg, n, pre, groups=2, seed=3, max_new=4):
    """``tests/test_prefix_cache.py:_prefix_workload``."""
    core = CORE[side]
    spec_cls, gen = (JaxSpec, jax_generate) if side == "jax" else \
        (WorkloadSpec, generate)
    reqs = gen(spec_cls(dataset="alpaca", rps=1e6, n_requests=n, seed=seed,
                        max_model_len=cfg.max_seq_len,
                        task_type=core.TaskType.OFFLINE,
                        prefix_groups=groups, prefix_tokens=pre,
                        vocab_size=cfg.vocab_size))
    for r in reqs:
        r.max_new_tokens = min(r.max_new_tokens, max_new)
    return reqs


def session_workload(side, cfg, *, sessions=2, turns=4, utter=250, out=6,
                     seed=7):
    """``tests/test_session_reuse.py:_session_workload``."""
    core = CORE[side]
    spec_cls, gen = (JaxSpec, jax_generate) if side == "jax" else \
        (WorkloadSpec, generate)
    return gen(spec_cls(dataset="alpaca", rps=1e6, sessions=sessions,
                        turns=turns, utterance_tokens=utter,
                        max_new_tokens=out, seed=seed,
                        task_type=core.TaskType.OFFLINE,
                        max_model_len=cfg.max_seq_len,
                        vocab_size=cfg.vocab_size))


def at_zero(reqs):
    """Every request (session head) queued up front: the first ticks of
    the two engines see the same queue."""
    for r in reqs:
        r.arrival = 0.0
    return reqs


# ------------------------------------------------------- prefix cache ----
def test_prefix_hit_equals_cold_and_prefills_40pct_less():
    """``TestPrefixCacheEngine``'s acceptance: on the shared-prefix
    workload (page 128, same pool) the cached run's ids equal the cold
    run's while it prefills at most 60% of the cold prompt tokens."""
    cfg = smoke_cfg("torch", max_seq_len=1024)
    runs = {}
    for cached in (False, True):
        runs[cached] = serve("torch", cfg,
                             prefix_workload("torch", cfg, 16, 512),
                             pool_tokens=8 * 1024, prefix_cache=cached)
        a = runs[cached].be.alloc
        if cached:
            assert a.free_pages() + a.live_pages() == a.n_pages
            assert a.live_pages() == len(runs[cached].be.prefix_cache)
            assert runs[cached].be.prefix_cache.clear(a) > 0
            assert a.free_pages() == a.n_pages
        else:
            check_pages_balance(runs[cached], retained=False)
    cold, hit = runs[False].res, runs[True].res
    assert runs[True].outs == runs[False].outs
    assert hit.prefill_tokens_processed <= 0.6 * cold.prefill_tokens_processed
    assert hit.prefill_tokens_processed + hit.prefill_tokens_skipped \
        == cold.prefill_tokens_processed
    assert cold.prefix_lookups == 0
    assert hit.prefix_hits > 0 and hit.prefix_hit_rate() > 0.5
    assert hit.prefix_pages_saved * PAGE == hit.prefix_hit_tokens
    assert hit.shared_pages_peak > 0


def test_prefix_monitor_sees_hits():
    cfg = smoke_cfg("torch", max_seq_len=256)
    run = serve("torch", cfg, prefix_workload("torch", cfg, 8, 128,
                                              max_new=2),
                prefix_cache=True)
    mon = run.eng.sched.monitor
    assert mon.prefix_lookups == 8
    assert mon.prefix_hits == run.res.prefix_hits > 0
    assert mon.prefix_hit_tokens == run.res.prefix_hit_tokens


def test_prefix_composes_with_chunked_prefill():
    """Chunk plans that start past a cached prefix slice their spans at
    absolute offsets: ids equal the cold chunked run's."""
    cfg = smoke_cfg("torch", max_seq_len=256)
    outs = {cached: serve("torch", cfg,
                          prefix_workload("torch", cfg, 8, 128, seed=9,
                                          max_new=3),
                          page_size=64, chunk=96,
                          prefix_cache=cached).outs
            for cached in (False, True)}
    assert outs[True] == outs[False]


def test_prefix_preemption_with_cache_still_correct():
    """A pool of 8 pages forces preemption and cache eviction: ids equal
    an ample cached run's."""
    cfg = smoke_cfg("torch", max_seq_len=256)
    runs = {pool: serve("torch", cfg,
                        prefix_workload("torch", cfg, 7, 128, seed=11,
                                        max_new=24),
                        page_size=64, pool_tokens=pool, prefix_cache=True)
            for pool in (None, 8 * 64)}
    assert runs[8 * 64].res.preempt_events > 0
    assert runs[None].outs == runs[8 * 64].outs


def test_prefix_parity_with_jax_engine():
    """``TestPrefixBackendParity``'s workload (12 requests, 128-token
    prefixes, ample pool) through the JAX engine and the port: the same
    formed batches, hit counts, skipped tokens and token ids."""
    runs = {}
    for side in ("jax", "torch"):
        cfg = smoke_cfg(side, max_seq_len=256)
        runs[side] = serve(side, cfg, at_zero(prefix_workload(
            side, cfg, 12, 128, max_new=3)), pool_tokens=64 * PAGE,
            prefix_cache=True)
    j, t = runs["jax"], runs["torch"]
    assert t.formed == j.formed
    assert t.res.prefix_lookups == j.res.prefix_lookups > 0
    assert t.res.prefix_hits == j.res.prefix_hits > 0
    assert t.res.prefix_hit_tokens == j.res.prefix_hit_tokens
    assert t.res.prefill_tokens_skipped == j.res.prefill_tokens_skipped > 0
    assert t.be.alloc.n_pages == j.be.alloc.n_pages
    assert t.outs == j.outs


# ---------------------------------------------------- session resume ----
def test_session_resume_equals_cold_and_prefills_40pct_less():
    """``TestSessionResumeEngine``'s acceptance: every turn's ids (and
    the prompts composed from them) equal the cold run's, and turns >= 2
    prefill at most 40% of the cold run's prompt tokens."""
    cfg = smoke_cfg("torch", max_seq_len=1024)
    runs = {}
    for ttl in (None, 1000.0):
        runs[ttl] = serve("torch", cfg, session_workload("torch", cfg),
                          pool_tokens=64 * PAGE, session_ttl=ttl)
        check_pages_balance(runs[ttl], retained=ttl is not None)
    cold, warm = runs[None], runs[1000.0]
    assert warm.outs == cold.outs and warm.prompts == cold.prompts

    def later(run):
        return sum(r.prefilled_tokens for r in run.reqs if r.turn >= 2)
    assert later(warm) <= 0.4 * later(cold), (later(warm), later(cold))
    r = warm.res
    assert r.session_hits == 6 and r.session_lookups == 8
    assert r.tail_pages_reused == 6
    assert r.sessions_retained == 8
    assert r.session_hit_tokens > 0
    assert cold.res.session_lookups == 0


def test_session_composes_with_chunked_prefill():
    """Resumed spans at offsets off the page grid stay positionally
    exact under chunking too."""
    cfg = smoke_cfg("torch", max_seq_len=1024)
    outs = {}
    for ttl in (None, 1000.0):
        run = serve("torch", cfg, session_workload(
            "torch", cfg, sessions=1, turns=3, utter=200, out=5),
            pool_tokens=64 * PAGE, chunk=96, session_ttl=ttl)
        outs[ttl] = run.outs
        if ttl:
            assert any(q.prefix_hit_tokens % PAGE for q in run.reqs)
    assert outs[1000.0] == outs[None]


def test_session_eviction_under_pressure_stays_correct():
    """An 18-page pool forces session and prefix eviction: ids equal the
    ample pool's resumed run."""
    cfg = smoke_cfg("torch", max_seq_len=1024)
    outs = {pool: serve("torch", cfg, session_workload(
        "torch", cfg, sessions=2, turns=3, utter=220, out=8),
        pool_tokens=pool, session_ttl=1000.0).outs
        for pool in (64 * PAGE, 18 * PAGE)}
    assert outs[64 * PAGE] == outs[18 * PAGE]


def test_first_token_only_turns_never_retained():
    """A max_new_tokens=1 row never reaches the pool, so retaining it
    would index pages that hold no transcript: such turns stay cold and
    their ids equal the cold run's."""
    cfg = smoke_cfg("torch", max_seq_len=1024)
    outs = {}
    for ttl in (None, 1000.0):
        run = serve("torch", cfg, session_workload(
            "torch", cfg, sessions=2, turns=2, out=1),
            pool_tokens=64 * PAGE, session_ttl=ttl)
        outs[ttl] = run.outs
        if ttl is not None:
            assert run.res.sessions_retained == 0
            assert run.res.session_hits == 0
            assert run.be.alloc.live_pages() == 0
    assert outs[1000.0] == outs[None]


def test_ttl_zero_disables_resume_but_not_radix():
    """session_ttl=0: every entry expires before the next turn, so no
    session hits, but the transcript's full pages still serve through
    the radix (page-aligned hits only)."""
    cfg = smoke_cfg("torch", max_seq_len=1024)
    run = serve("torch", cfg, session_workload("torch", cfg, sessions=1,
                                               turns=3),
                pool_tokens=64 * PAGE, session_ttl=0.0)
    r = run.res
    assert r.session_hits == 0 and r.tail_pages_reused == 0
    assert r.sessions_expired > 0
    assert r.prefix_hit_tokens > 0
    for q in run.reqs:
        assert q.prefix_hit_tokens % PAGE == 0


def test_session_parity_with_jax_engine():
    """``TestSessionBackendParity``'s workload (2 sessions x 3 turns)
    through the JAX engine and the port: the same formed batches,
    session and prefix counts, and token ids and composed prompts."""
    runs = {}
    for side in ("jax", "torch"):
        cfg = smoke_cfg(side, max_seq_len=1024)
        runs[side] = serve(side, cfg, at_zero(session_workload(
            side, cfg, sessions=2, turns=3, utter=220, out=4)),
            pool_tokens=64 * PAGE, session_ttl=1000.0)
    j, t = runs["jax"], runs["torch"]
    assert t.formed == j.formed
    for key in ("session_lookups", "session_hits", "tail_pages_reused",
                "prefill_tokens_skipped"):
        assert getattr(t.res, key) == getattr(j.res, key) > 0, key
    for key in ("session_hit_tokens", "sessions_retained",
                "prefix_hit_tokens", "prefix_hits"):
        assert getattr(t.res, key) == getattr(j.res, key), key
    assert t.outs == j.outs and t.prompts == j.prompts


# ------------------------------------------------------ engine pieces ----
def test_seed_prefix_copies_the_pool_bits():
    """``_seed_prefix`` copies positions [0, hit) of each row from its
    table's pages, hits off the page grid included, and leaves the rest
    of the batch cache as it was."""
    cfg = smoke_cfg("torch", max_seq_len=256)
    eng = TorchEngine(cfg, torch_model(), tcore.BucketServeScheduler(
        cfg, tcore.MemoryBudget(2 ** 30, 1, 0), tcore.SchedulerConfig()),
        max_slots=4, paged=True, page_size=32, prefix_cache=True,
        device="cpu")
    be = eng.backend
    gen = torch.Generator().manual_seed(0)
    for leaf in be.pool_cache["groups"][0][0].values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    hits = [0, 37, 64, 100]
    reqs = []
    for rid, n in enumerate(hits):
        r = tcore.Request(rid=rid, prompt_len=n + 5, max_new_tokens=2,
                          arrival=0.0)
        r.prefix_hit_tokens = n
        be.alloc.alloc(rid, n + 6)
        reqs.append(r)
    cache = ttfm.init_cache(cfg, len(reqs), cfg.max_seq_len, device="cpu")
    for leaf in cache["groups"][0][0].values():
        leaf.fill_(7.0)
    be._seed_prefix({"cache": cache}, reqs)
    for k, leaf in cache["groups"][0][0].items():
        pool = be.pool_cache["groups"][0][0][k]
        for i, (r, n) in enumerate(zip(reqs, hits)):
            pages = be.alloc.table(r.rid)
            want = torch.cat([pool[:, p] for p in pages], 1)[:, :n]
            assert torch.equal(leaf[:, i, :n], want)
            assert bool((leaf[:, i, n:] == 7.0).all())
