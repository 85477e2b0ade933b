"""The port's serving engine against the JAX engine, and its own
bit-identities.

One ``BucketServeScheduler`` configuration and one workload go through
``repro.core.engine.ServingEngine`` and ``repro_torch.core.engine.
ServingEngine`` with the same weights at f32 (the reference's
``init_params`` converted through ``repro_torch/bridge.py``).  The formed
batches (the ``_RecordingScheduler`` surface of ``tests/test_serving.py``)
must be equal and the emitted token ids identical.  Workloads: the
``TestEngine`` workload, a chunked run and the paged mixed workload at
reduced size, and the rwkv6-3b smoke config whole-prompt and chunked.
Inside the port: paged == contiguous, chunked == whole-prompt, and
engine == unbatched prefill + decode.
"""
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


JaxRecording = _recording(jcore.BucketServeScheduler)
TorchRecording = _recording(tcore.BucketServeScheduler)


@functools.lru_cache(maxsize=None)
def _params(arch):
    return jtfm.init_params(jax_smoke_config(arch), jax.random.PRNGKey(0))


def _model(cfg, arch="qwen3-14b"):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, _params(arch)),
                                    cfg, device="cpu")


def _run(side, cfg, params, reqs, *, slots, paged=False, page_size=128,
         pool_tokens=None, chunk=None, max_batch=None, **torch_only):
    """Serve ``reqs`` on one side ("jax" or "torch"); returns (formed
    batches, {rid: token ids}, engine).  ``torch_only`` goes to the
    port's engine alone."""
    core = jcore if side == "jax" else tcore
    sched_cls = JaxRecording if side == "jax" else TorchRecording
    budget = core.MemoryBudget(hbm_bytes_per_device=2 ** 30, n_devices=1,
                               weight_bytes=0)
    sched = sched_cls(cfg, budget, core.SchedulerConfig(
        max_batch=max_batch or slots,
        memory_model="paged" if paged else "sum", page_size=page_size))
    kw = dict(max_slots=slots, cache_len=cfg.max_seq_len, paged=paged,
              page_size=page_size, kv_pool_tokens=pool_tokens,
              chunk_tokens=chunk)
    if side == "jax":
        eng = JaxEngine(cfg, params, sched, **kw)
    else:
        eng = TorchEngine(cfg, params, sched, device="cpu", **kw,
                          **torch_only)
    eng.submit(reqs)
    done = eng.run(max_wall_s=300)
    assert len(done) == len(reqs)
    for r in reqs:
        assert len(eng.outputs[r.rid]) == r.max_new_tokens
    return sched.formed, {r.rid: list(eng.outputs[r.rid]) for r in reqs}, eng


def _uniform(core, n, seed, lo, hi, new_lo, new_hi, task):
    rng = np.random.default_rng(seed)
    return [core.Request(rid=i, prompt_len=int(rng.integers(lo, hi)),
                         max_new_tokens=int(rng.integers(new_lo, new_hi)),
                         arrival=0.0, task_type=getattr(core.TaskType, task))
            for i in range(n)]


def _both(cfg_args, make_reqs, arch="qwen3-14b", **run_kw):
    jcfg = jax_smoke_config(arch, **cfg_args)
    tcfg = get_smoke_config(arch, **cfg_args)
    model = _model(tcfg, arch)
    jf, jout, jeng = _run("jax", jcfg, _params(arch), make_reqs(jcore),
                          **run_kw)
    tf, tout, teng = _run("torch", tcfg, model, make_reqs(tcore), **run_kw)
    assert teng.n_prefill_shapes == jeng.n_prefill_shapes
    return (jf, jout), (tf, tout), tcfg, model, teng


def test_engine_workload_matches_jax_engine_and_unbatched():
    """The ``TestEngine`` workload: same formed batches and token ids as
    the JAX engine; and each request's ids equal a plain unbatched
    prefill + decode in the port (continuous batching is lossless)."""
    def reqs(core):
        return _uniform(core, 10, 0, 8, 48, 2, 8, "ONLINE")
    (jf, jout), (tf, tout), cfg, model, _ = _both(
        dict(max_seq_len=128), reqs, slots=4)
    assert tf == jf
    assert tout == jout
    for r in reqs(tcore)[:5]:
        r.materialize_tokens(cfg.vocab_size)
        logits, cache = ttfm.prefill(
            cfg, model, torch.from_numpy(r.tokens[None, :r.prompt_len]),
            torch.tensor([r.prompt_len]), cache_len=128)
        out = [int(logits.argmax(-1)[0])]
        for _ in range(r.max_new_tokens - 1):
            logits, cache = ttfm.decode_step(
                cfg, model, torch.tensor([out[-1]], dtype=torch.int32),
                cache)
            out.append(int(logits.argmax(-1)[0]))
        assert out == tout[r.rid], r.rid


def test_chunked_run_matches_jax_engine_and_whole_prompt():
    """Chunked prefill (32-token spans over 40-100-token prompts): same
    batches and ids as the JAX engine, and the port's chunked ids equal
    its whole-prompt ids."""
    def reqs(core):
        return _uniform(core, 4, 7, 40, 100, 5, 6, "OFFLINE")
    (jf, jout), (tf, tout), cfg, model, teng = _both(
        dict(max_seq_len=128), reqs, slots=4, chunk=32)
    assert tf == jf
    assert tout == jout
    assert teng.interleaved_decode_steps >= 0
    _, whole, _ = _run("torch", cfg, model, reqs(tcore), slots=4)
    assert whole == tout


def _mixed(core, spec_cls, gen, n, max_seq, max_new=6, seed=0):
    """The paged test's heterogeneous workload, clamped for CPU runs.
    Every request arrives at 0: the generator's microsecond gaps would
    let a busy host change which requests the first batch sees."""
    spec = spec_cls(dataset="mixed", rps=1e6, n_requests=n, seed=seed,
                    max_model_len=max_seq,
                    task_type=core.TaskType.OFFLINE)
    reqs = gen(spec)
    for r in reqs:
        r.max_new_tokens = min(r.max_new_tokens, max_new)
        r.prompt_len = min(r.prompt_len, max_seq - 16)
        r.arrival = 0.0
    return reqs


def test_paged_mixed_workload_matches_jax_engine_and_contiguous():
    """The paged mixed workload at reduced size (10 requests, 256-token
    window, 32-token pages): same batches and ids as the JAX paged
    engine with a pool of one window per slot.  Under page pressure (a
    10-page pool, 9 usable: ``TestPagedPreemption``'s checks) a decode
    runs out of pages and a request is preempted, re-prefilled and
    finished; batch formation then follows the wall clock, so only the
    ids are held: equal to the unconstrained runs (the port's contiguous
    pool and the ample paged pool), every page back, and each request's
    length counted once by the monitor despite the requeue."""
    def reqs(core):
        if core is jcore:
            return _mixed(core, JaxSpec, jax_generate, 10, 256)
        return _mixed(core, WorkloadSpec, generate, 10, 256)
    (jf, jout), (tf, tout), cfg, model, teng = _both(
        dict(max_seq_len=256), reqs, slots=6, paged=True, page_size=32)
    assert tf == jf
    assert tout == jout
    assert teng.backend.free_blocks() == teng.backend.alloc.n_pages
    _, tight, eng = _run("torch", cfg, model, reqs(tcore), slots=6,
                         paged=True, page_size=32, pool_tokens=10 * 32)
    assert eng.result.preempt_events > 0
    assert eng.backend.free_blocks() == eng.backend.alloc.n_pages
    assert len(eng.sched.monitor.seq_lens) == 10
    _, contig, _ = _run("torch", cfg, model, reqs(tcore), slots=6)
    assert tight == contig == tout


def test_paged_and_chunked_compose():
    """Chunked prefill writes a contiguous batch cache and the paged
    insert chops it into pages: ids equal the unchunked paged run."""
    cfg = get_smoke_config("qwen3-14b", max_seq_len=128)
    model = _model(cfg)

    def reqs():
        return _uniform(tcore, 5, 3, 20, 110, 3, 7, "OFFLINE")
    kw = dict(slots=4, paged=True, page_size=16)
    _, chunked, _ = _run("torch", cfg, model, reqs(), chunk=24, **kw)
    _, whole, _ = _run("torch", cfg, model, reqs(), **kw)
    assert chunked == whole


@pytest.mark.parametrize("chunk", [None, 16])
def test_rwkv_engine_matches_jax_engine(chunk):
    """rwkv6-3b smoke on the contiguous slot pool, whole-prompt and in
    16-token chunks (prompts of 8-60 tokens): same formed batches and
    token ids as the JAX engine; chunked ids equal whole-prompt ids."""
    def reqs(core):
        return _uniform(core, 8, 5, 8, 60, 2, 7, "OFFLINE")
    (jf, jout), (tf, tout), cfg, model, _ = _both(
        dict(max_seq_len=128), reqs, arch="rwkv6-3b", slots=4, chunk=chunk)
    assert tf == jf
    assert tout == jout
    if chunk:
        _, whole, _ = _run("torch", cfg, model, reqs(tcore), slots=4)
        assert whole == tout


def test_rwkv_paged_pool_is_refused():
    """An attention-free config has no K/V to page."""
    cfg = get_smoke_config("rwkv6-3b", max_seq_len=64)
    model = _model(cfg, "rwkv6-3b")
    sched = tcore.BucketServeScheduler(
        cfg, tcore.MemoryBudget(hbm_bytes_per_device=2 ** 30, n_devices=1,
                                weight_bytes=0), tcore.SchedulerConfig())
    with pytest.raises(ValueError, match="paged KV"):
        TorchEngine(cfg, model, sched, device="cpu", paged=True)


def test_retention_refusals_and_int8_pool():
    """What the port refuses, with the reason, as the reference does:
    KV retention off the paged pool, or on a config that cannot resume a
    prefill from cached pages (rwkv6-3b's recurrent carry).  An int8 KV
    cache builds a paged pool of int8 codes and f32 scale planes, with
    the pages ``paging.device_pool_pages`` gives its byte budget."""
    cfg = get_smoke_config("qwen3-14b", max_seq_len=64)
    model = _model(cfg)
    budget = tcore.MemoryBudget(hbm_bytes_per_device=2 ** 30, n_devices=1,
                                weight_bytes=0)

    def engine(cfg_, model_, **kw):
        sched = tcore.BucketServeScheduler(cfg_, budget,
                                           tcore.SchedulerConfig())
        return TorchEngine(cfg_, model_, sched, device="cpu", **kw)
    for kw in (dict(prefix_cache=True), dict(session_ttl=10.0)):
        with pytest.raises(ValueError, match="paged KV pool"):
            engine(cfg, model, **kw)
    rcfg = get_smoke_config("rwkv6-3b", max_seq_len=64)
    assert not rcfg.prefix_cacheable
    with pytest.raises(ValueError, match="chunk-resumable"):
        engine(rcfg, _model(rcfg, "rwkv6-3b"), paged=True, prefix_cache=True)
    with pytest.raises(ValueError, match="retention layer"):
        engine(cfg, model, paged=True, host_pool_tokens=1024)
    cfg8 = get_smoke_config("qwen3-14b", max_seq_len=64,
                            kv_cache_dtype="int8")
    be = engine(cfg8, model, paged=True, page_size=16,
                kv_pool_tokens=40 * 16).backend
    assert be.alloc.n_pages == \
        tcore.paging.device_pool_pages(cfg8, 40 * 16, 16) - 1
    assert be.alloc.n_pages >= 1.8 * (40 - 1)
    slot = be.pool_cache["groups"][0][0]
    assert slot["k"].dtype == torch.int8 and slot["v"].dtype == torch.int8
    assert slot["k_s"].shape == slot["k"].shape[:-1]
    assert slot["k_s"].dtype == torch.float32


@pytest.mark.parametrize("rows", [None, 4])
def test_chunked_prefill_cache_allocated_once_per_job(monkeypatch, rows):
    """The batch prefill cache is made once, on the engine's device: at
    construction with ``prefill_rows`` rows (the scheduler's cap, 4
    here), or with None at the first job, with that batch's rows (here
    the only batch: every request at once); never once per job or per
    chunk.  Every chunk of every job writes into its first rows."""
    cfg = get_smoke_config("qwen3-14b", max_seq_len=128)
    model = _model(cfg)
    made = []
    real = ttfm.init_cache

    def counting(cfg_, batch, cache_len, dtype=torch.float32,
                 device="cuda"):
        cache = real(cfg_, batch, cache_len, dtype, device)
        made.append((batch, cache["groups"][0][0]["k"].device.type))
        return cache
    monkeypatch.setattr(ttfm, "init_cache", counting)
    reqs = [tcore.Request(rid=i, prompt_len=100, max_new_tokens=3,
                          arrival=0.0, task_type=tcore.TaskType.OFFLINE)
            for i in range(3)]
    base = ttfm.prefill_chunk
    written = []

    def chunk(cfg_, model_, tokens, cache, *a, **kw):
        written.append(cache["groups"][0][0]["k"].data_ptr())
        return base(cfg_, model_, tokens, cache, *a, **kw)
    monkeypatch.setattr(ttfm, "prefill_chunk", chunk)
    formed, _, eng = _run("torch", cfg, model, reqs, slots=4, chunk=16,
                          prefill_rows=rows)
    # made[0] is the slot pool, made[1] the batch cache; then none (the
    # 100-token prompts are 7 chunks of 16 or more)
    assert [len(b) for b in formed] == [3]
    assert made == [(4, "cpu"), (rows or 3, "cpu")]
    assert eng.sched.formed and len(written) >= 7 * len(eng.sched.formed)
    bc = eng.backend._batch_cache["groups"][0][0]["k"]
    assert set(written) == {bc.data_ptr()}
