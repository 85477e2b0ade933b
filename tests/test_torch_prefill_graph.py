"""The port's compiled prefill: the chunk offset on the device, prefill
into a cache it is given, and ``PrefillGraph`` through the engine.

The reference engine ``jax.jit``s one prefill executable per
``(pad_to, B)`` and one chunk executable per ``(Tc, B)``, the chunk's
``start`` traced; the port captures one CUDA graph per such shape key
met twice (``core/engine.py:PrefillGraph``) and replays it.  A replay writes the
storage its capture saw and runs no Python, so:

- ``self_attn_chunk`` and ``prefill_chunk`` with ``start`` a 0-d int32
  tensor give the bits of an int ``start``, at aligned and unaligned
  offsets, on f32, bf16 and int8 caches; their logits against the
  reference's ``prefill_chunk`` with ``start`` traced, on the same
  weights (f32 cache: atol 2e-5, rtol 2e-4; int8 cache: atol 2e-3, as
  ``tests/test_torch_int8.py``, since a K/V value on a rounding
  boundary takes the neighbouring code in the other framework);
- ``flash_prefill_ref`` with a tensor offset gives the bits of an int
  one; ``prefill`` into a given zeroed cache gives the bits of
  ``prefill`` into a new one;
- ``PrefillGraph``'s bookkeeping, through a stand-in graph: a key's
  first call eager, its second captured, later ones replays, every
  graph held, the launch counts of one call a replay, unaligned
  launches counted from the replaying call's ``start``, the engine's
  input and cache storage kept across jobs, and a refusal on the CPU
  without a stand-in;
- the engine with a stand-in graph that replays gives the JAX engine's
  ids on the contiguous (chunked), paged, rwkv6-3b, int8 and prefix-hit
  (chunks resumed at offsets off the 64-row tile) workloads;
- on the card, smoke f32 engines with both graphs give the ids of the
  same engines run eagerly and of the CPU (``-k cuda``; skipped here).
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.engine import ServingEngine as JaxEngine
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.batcher import FormedBatch
from repro_torch.core.engine import (PrefillGraph, ServingEngine,
                                     TorchEngineBackend)
from repro_torch.core.serving_loop import PrefillJob
from repro_torch.kernels import ref, runtime
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm

from test_torch_prefix import one_torch_thread  # noqa: F401

needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA card (run on the H100: "
           "python -m pytest tests/test_torch_prefill_graph.py -k cuda)")

F32_TOL = dict(atol=2e-5, rtol=2e-4)
INT8_TOL = dict(atol=2e-3, rtol=0)
j_chunk = jax.jit(jtfm.prefill_chunk, static_argnums=0)


@functools.lru_cache(maxsize=None)
def _params(arch):
    return jtfm.init_params(jax_smoke_config(arch), jax.random.PRNGKey(0))


def _model(arch, cfg):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, _params(arch)),
                                    cfg, device="cpu")


def _prompts(vocab, lens, pad, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), pad), np.int32)
    for i, L in enumerate(lens):
        toks[i, :min(L, pad)] = rng.integers(0, vocab, min(L, pad))
    return toks, np.asarray(lens, np.int32)


def _leaves(cache):
    return [cache["pos"]] + [leaf for slots in cache["groups"]
                             for slot in slots for leaf in slot.values()]


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


# ------------------------------------------- start on the device ---------
CACHES = [("float32", ""), ("bfloat16", ""), ("float32", "int8")]


@pytest.mark.parametrize("dtype,kv", CACHES)
@pytest.mark.parametrize("start", [64, 37])
def test_chunk_start_tensor_gives_the_int_bits(dtype, kv, start):
    """A first chunk fills [0, start); then the chunk at ``start`` runs
    once with an int and once with a 0-d int32 tensor, from the same
    cache: logits and every cache leaf the same bits.  One layer's
    ``self_attn_chunk`` too."""
    dt = getattr(torch, dtype)
    cfg = get_smoke_config("qwen3-14b", max_seq_len=128, kv_cache_dtype=kv)
    model = ttfm.init_params(cfg, seed=0, dtype=dt, device="cpu")
    toks, lens = _prompts(cfg.vocab_size, [start + 20, start - 5, 100],
                          start + 24)
    toks, lens = torch.from_numpy(toks), torch.from_numpy(lens)
    base = ttfm.init_cache(cfg, 3, 128, dt, "cpu")
    ttfm.prefill_chunk(cfg, model, toks[:, :start], base, 0, lens)
    got = {}
    for label, s in (("int", start),
                     ("tensor", torch.tensor(start, dtype=torch.int32))):
        cache = copy.deepcopy(base)
        logits, out = ttfm.prefill_chunk(cfg, model, toks[:, start:], cache,
                                         s, lens)
        assert out is cache
        got[label] = (logits, cache)
    assert torch.equal(got["int"][0], got["tensor"][0])
    assert _same_bits(got["int"][1], got["tensor"][1])

    blk = model.groups[0][0][0]
    x = torch.randn((3, 24, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)).to(dt)
    outs = []
    for s in (start, torch.tensor(start, dtype=torch.int32)):
        kv_leaves = copy.deepcopy(ttfm.AttnBlock._kv(ttfm._slot(base, 0, 0,
                                                                0)))
        outs.append((tattn.self_attn_chunk(cfg, blk.attn, x, s, kv_leaves,
                                           lens > start), kv_leaves))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


@pytest.mark.parametrize("kv", ["", "int8"])
def test_chunk_tensor_start_matches_reference_traced_start(kv):
    """Chunks of 16 at offsets 0, 16, 32 and then 37 (off the grid),
    each from the reference's cache before it: the port's logits with a
    tensor ``start`` against ``jtfm.prefill_chunk`` jitted with ``start``
    traced, on the rows whose prompt ends in the chunk."""
    S = 64
    jcfg = jax_smoke_config("qwen3-14b", max_seq_len=S, kv_cache_dtype=kv)
    tcfg = get_smoke_config("qwen3-14b", max_seq_len=S, kv_cache_dtype=kv)
    params, model = _params("qwen3-14b"), _model("qwen3-14b", tcfg)
    toks, lens = _prompts(tcfg.vocab_size, [30, 11, 50, 45], 56)
    jc = jtfm.init_cache(jcfg, 4, S)
    tol = INT8_TOL if kv else F32_TOL
    checked = 0
    for start, clen in ((0, 16), (16, 16), (32, 5), (37, 19)):
        span = toks[:, start:start + clen]
        tc = bridge.cache_from_numpy(jax.tree.map(np.asarray, jc),
                                     device="cpu")
        tl, _ = ttfm.prefill_chunk(tcfg, model, torch.from_numpy(span), tc,
                                   torch.tensor(start, dtype=torch.int32),
                                   torch.from_numpy(lens))
        jl, jc = j_chunk(jcfg, params, jnp.asarray(span), jc,
                         jnp.int32(start), jnp.asarray(lens))
        fin = (lens - 1 >= start) & (lens - 1 < start + clen)
        np.testing.assert_allclose(tl.numpy()[fin], np.asarray(jl)[fin],
                                   **tol)
        checked += int(fin.sum())
    assert checked == 4


@pytest.mark.parametrize("window,causal", [(0, True), (24, True),
                                           (0, False)])
@pytest.mark.parametrize("offset", [0, 37, 64])
def test_flash_prefill_ref_tensor_offset_gives_the_int_bits(window, causal,
                                                            offset):
    gen = torch.Generator().manual_seed(offset + window)
    q = torch.randn((2, 20, 4, 16), generator=gen)
    k = torch.randn((2, 96, 2, 16), generator=gen)
    v = torch.randn((2, 96, 2, 16), generator=gen)
    lens = torch.tensor([96, 70], dtype=torch.int32)
    want = ref.flash_prefill_ref(q, k, v, lens, causal=causal,
                                 window=window, q_offset=offset)
    got = ref.flash_prefill_ref(q, k, v, lens, causal=causal, window=window,
                                q_offset=torch.tensor(offset,
                                                      dtype=torch.int32))
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch,kv", [("qwen3-14b", ""), ("qwen3-14b", "int8"),
                                     ("rwkv6-3b", ""),
                                     ("recurrentgemma-2b", "")])
def test_prefill_into_a_given_cache_gives_the_new_cache_bits(arch, kv):
    """``prefill`` writes into a zeroed cache it is given, ``pos``
    included, in place: the logits and every leaf equal those of
    ``prefill`` into a cache of its own; the caller's lengths are left
    alone."""
    extra = dict(n_layers=5) if arch == "recurrentgemma-2b" else {}
    cfg = get_smoke_config(arch, max_seq_len=64, kv_cache_dtype=kv, **extra)
    model = ttfm.init_params(cfg, seed=0, device="cpu")
    toks, lens = _prompts(cfg.vocab_size, [40, 17, 33], 40)
    toks, lens = torch.from_numpy(toks), torch.from_numpy(lens)
    want_logits, want = ttfm.prefill(cfg, model, toks, lens, cache_len=64)
    given = ttfm.init_cache(cfg, 3, 64, device="cpu")
    ptrs = [t.data_ptr() for t in _leaves(given)]
    logits, out = ttfm.prefill(cfg, model, toks, lens, cache_len=64,
                               cache=given)
    assert out is given and [t.data_ptr() for t in _leaves(out)] == ptrs
    assert torch.equal(logits, want_logits)
    assert _same_bits(out, want)
    assert out["pos"].tolist() == [40, 17, 33] == lens.tolist()


# ------------------------------------------------- bookkeeping -----------
class StandIn:
    """``torch.cuda.CUDAGraph``'s surface: capture and replay record."""

    def __init__(self, key, log):
        self.key, self.log = key, log

    def capture_begin(self, pool=None):
        self.log.append(("begin", self.key))

    def capture_end(self):
        self.log.append(("end", self.key))

    def replay(self):
        self.log.append(("replay", self.key))


def test_prefill_graph_runs_eagerly_then_captures_then_replays():
    """The first call of a key runs the step eagerly (counted) and
    captures nothing; the second runs it (counted) and captures it (the
    capture's counts put back); each later call replays and adds the
    capture's counts without running the step.  Every key's graph is
    held: a key comes back after others and replays, never captured
    again; ``clear`` drops the graphs and the meetings."""
    log, ran = [], []
    runtime.reset_launch_counts()

    def step_of(key, n):
        def step():
            ran.append(key)
            runtime.launch_counts["flash_prefill"] += n
            runtime.prefill_body_counts["tensor_core"] += n
            runtime.launch_counts["wkv6"] += 1
        return step
    try:
        g = PrefillGraph("cpu", graph=lambda key: StandIn(key, log))
        a, b, c = ("chunk", 16, 2), ("chunk", 8, 2), ("prefill", 32, 1)
        assert g.run(a, step_of(a, 3)) == {"tensor_core": 3, "cuda_core": 0}
        assert ran == [a] and log == [] and len(g) == 0
        assert g.eager_runs == 1 and g.captures == 0
        assert g.run(a, step_of(a, 3)) == {"tensor_core": 3, "cuda_core": 0}
        assert ran == [a, a, a] and log == [("begin", a), ("end", a)]
        assert runtime.launch_counts["flash_prefill"] == 6
        for k in range(3, 6):
            assert g.run(a, step_of(a, 3))["tensor_core"] == 3
            assert runtime.launch_counts["flash_prefill"] == 3 * k
            assert runtime.launch_counts["wkv6"] == k
            assert runtime.prefill_body_counts["tensor_core"] == 3 * k
        assert ran == [a, a, a] and g.replays == 3 and g.captures == 1
        for key, n in ((b, 5), (c, 7), (b, 5), (c, 7), (a, 3)):
            g.run(key, step_of(key, n))
        assert (g.captures, g.replays, g.eager_runs, len(g)) == (3, 4, 3, 3)
        assert g.met == {a: 6, b: 2, c: 2}
        assert [e for e in log if e[0] == "begin"] == [
            ("begin", k) for k in (a, b, c)]
        assert runtime.launch_counts["flash_prefill"] == 3 * 6 + 5 * 2 + 7 * 2
        assert g.pool_bytes == 0 and g.capture_seconds >= 0
        assert runtime.prefill_unaligned_counts == {"tensor_core": 0,
                                                    "cuda_core": 0}
        g.clear()
        assert len(g) == 0 and g.met == {}
        g.run(a, step_of(a, 3))
        assert g.eager_runs == 4 and g.captures == 3
    finally:
        runtime.reset_launch_counts()


def test_prefill_graph_refused_on_the_cpu_without_a_stand_in():
    cfg = get_smoke_config("qwen3-14b", max_seq_len=64)
    model = ttfm.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        PrefillGraph("cpu")
    with pytest.raises(ValueError, match="prefill_graph=True"):
        TorchEngineBackend(cfg, model, device="cpu", prefill_graph=True)
    sched = tcore.BucketServeScheduler(
        cfg, tcore.MemoryBudget(2 ** 30, 1, 0), tcore.SchedulerConfig())
    with pytest.raises(ValueError, match="prefill_graph=True"):
        ServingEngine(cfg, model, sched, device="cpu", prefill_graph=True)
    for flag in (None, False):
        be = TorchEngineBackend(cfg, model, device="cpu", prefill_graph=flag)
        assert be.prefill_graph is None


class ReplayingPrefill(StandIn):
    """A stand-in graph of one shape key on the engine: the capture
    leaves the engine's state as it found it (a CUDA capture runs
    nothing), and a replay runs the engine's step of the key again with
    the launch counts left alone (a replay runs no Python) and checks
    that every tensor the capture saw keeps its storage."""

    def __init__(self, be, key, log):
        super().__init__(key, log)
        self.be = be

    def _state(self):
        return _leaves(self.be._batch_cache) + [self.be._pf_logits]

    def _storage(self):
        be = self.be
        return [t.data_ptr() for t in self._state() + [
            be._pf_toks, be._pf_lens, be._pf_start]]

    def capture_begin(self, pool=None):
        super().capture_begin(pool)
        self.saved = [t.clone() for t in self._state()]

    def capture_end(self):
        super().capture_end()
        for t, s in zip(self._state(), self.saved):
            t.copy_(s)
        self.seen = self._storage()

    def replay(self):
        super().replay()
        assert self._storage() == self.seen
        counts = runtime.count_state()
        self.be._prefill_step(self.key)()
        runtime.set_count_state(counts)


def graphs_ok(g, n_shapes):
    """One eager run for each of ``n_shapes`` keys, one capture for each
    key met twice, and every later call of a key a replay."""
    met = g.met.values()
    return (len(g.met) == n_shapes == g.eager_runs
            and g.captures == len(g) == sum(n >= 2 for n in met)
            and g.replays == sum(n - 2 for n in met if n > 2))


def attach(be, log=None):
    log = [] if log is None else log
    be.prefill_graph = PrefillGraph(
        "cpu", graph=lambda key: ReplayingPrefill(be, key, log))
    return be.prefill_graph


def test_unaligned_launches_counted_from_the_replaying_start(monkeypatch):
    """Three jobs of chunks (0, 64), (64, 27), (91, 27): the key ("chunk",
    27, 2) runs eagerly at offset 64 (on the tile), is captured at 91
    (off it) and then replays at 64 and at 91; each job's unaligned count
    is its launches at 91, however they ran.  The third job replays all
    three chunks: the inputs, lengths, start, logits and batch cache keep
    their storage (the stand-in checks it at each replay)."""
    cfg = get_smoke_config("qwen3-14b", max_seq_len=128)
    model = ttfm.init_params(cfg, seed=0, device="cpu")
    real = ttfm.prefill_chunk

    def counted(*a, **kw):          # the launches the card would count
        runtime.launch_counts["flash_prefill"] += cfg.n_layers
        runtime.prefill_body_counts["tensor_core"] += cfg.n_layers
        return real(*a, **kw)
    monkeypatch.setattr(ttfm, "prefill_chunk", counted)
    be = TorchEngineBackend(cfg, model, max_slots=4, device="cpu")
    g = attach(be)
    L = cfg.n_layers
    runtime.reset_launch_counts()
    try:
        for job_no in range(3):
            reqs = [tcore.Request(rid=10 * job_no + i, prompt_len=n,
                                  max_new_tokens=2, arrival=0.0)
                    for i, n in enumerate((118, 100))]
            be.begin(reqs)
            job = PrefillJob(FormedBatch(reqs, pad_to=118),
                             [(0, 64), (64, 27), (91, 27)])
            for idx in range(3):
                be.prefill_chunk(job, idx)
            assert runtime.launch_counts["flash_prefill"] == 3 * L * (
                job_no + 1)
            assert runtime.prefill_unaligned_counts["tensor_core"] == L * (
                job_no + 1)
            for r in reqs:
                be.release(r)
        assert (g.captures, g.replays, g.eager_runs) == (2, 5, 2)
        assert be.n_prefill_shapes == 2 and graphs_ok(g, 2)
    finally:
        runtime.reset_launch_counts()


# ------------------------------------------- the engine, against JAX -----
def _uniform(core, n, seed, lo, hi, new_lo, new_hi, task="OFFLINE"):
    rng = np.random.default_rng(seed)
    return [core.Request(rid=i, prompt_len=int(rng.integers(lo, hi)),
                         max_new_tokens=int(rng.integers(new_lo, new_hi)),
                         arrival=0.0, task_type=getattr(core.TaskType, task))
            for i in range(n)]


# workload -> (arch, config args, engine args, requests of a core module)
WORKLOADS = {
    "contiguous": ("qwen3-14b", dict(max_seq_len=128),
                   dict(slots=4, chunk=16),
                   lambda core: _uniform(core, 10, 0, 8, 48, 2, 8, "ONLINE")),
    # 16 requests: a whole-prompt shape comes a third time and replays
    "paged": ("qwen3-14b", dict(max_seq_len=128),
              dict(slots=4, paged=True, page_size=32),
              lambda core: _uniform(core, 16, 1, 8, 90, 2, 6)),
    "rwkv": ("rwkv6-3b", dict(max_seq_len=128), dict(slots=4, chunk=16),
             lambda core: _uniform(core, 8, 5, 8, 60, 2, 7)),
    "int8": ("qwen3-14b", dict(max_seq_len=128, kv_cache_dtype="int8"),
             dict(slots=4, paged=True, page_size=32, chunk=32),
             lambda core: _uniform(core, 6, 5, 8, 90, 3, 9)),
    # shared 96-token prefixes over 32-token pages: chunks resume at 96,
    # off the 64-row tile
    "prefix": ("qwen3-14b", dict(max_seq_len=256),
               dict(slots=4, paged=True, page_size=32, chunk=32,
                    prefix_cache=True),
               None),
}


def _prefix_requests(core, cfg):
    """8 requests, two groups behind shared 96-token prefixes, the first
    of each group alone in its batch so the others hit."""
    rng = np.random.default_rng(3)
    heads = [rng.integers(0, cfg.vocab_size, 96) for _ in range(2)]
    reqs = []
    for i in range(8):
        tail = rng.integers(0, cfg.vocab_size, int(rng.integers(10, 60)))
        toks = np.concatenate([heads[i % 2], tail]).astype(np.int32)
        r = core.Request(rid=i, prompt_len=len(toks), max_new_tokens=3,
                         arrival=0.0 if i < 2 else 0.5,
                         task_type=core.TaskType.OFFLINE)
        r.tokens = toks
        reqs.append(r)
    return reqs


def _serve(side, name, graph_log=None):
    """({rid: ids}, engine) of one engine on workload ``name``."""
    arch, cfg_args, eng_args, make = WORKLOADS[name]
    core = jcore if side == "jax" else tcore
    cfg = (jax_smoke_config if side == "jax" else get_smoke_config)(
        arch, **cfg_args)
    eng_args = dict(eng_args)
    slots, paged = eng_args.pop("slots"), eng_args.pop("paged", False)
    page = eng_args.pop("page_size", 128)
    sched = core.BucketServeScheduler(cfg, core.MemoryBudget(
        2 ** 30, 1, 0), core.SchedulerConfig(
            max_batch=slots, memory_model="paged" if paged else "sum",
            page_size=page))
    kw = dict(max_slots=slots, cache_len=cfg.max_seq_len, paged=paged,
              page_size=page, chunk_tokens=eng_args.pop("chunk", None),
              **eng_args)
    if side == "jax":
        eng = JaxEngine(cfg, _params(arch), sched, **kw)
    else:
        eng = ServingEngine(cfg, _model(arch, cfg), sched, device="cpu",
                            prefill_rows=slots, **kw)
        attach(eng.backend, graph_log)
    reqs = make(core) if make else _prefix_requests(core, cfg)
    eng.submit(reqs)
    assert len(eng.run(max_wall_s=300)) == len(reqs)
    for r in reqs:
        assert len(eng.outputs[r.rid]) == r.max_new_tokens
    if paged:
        be = eng.backend
        if be.retention is not None:
            be.retention.clear(be.alloc)
        assert be.free_blocks() == be.alloc.n_pages
    return {r.rid: list(eng.outputs[r.rid]) for r in reqs}, eng


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_engine_with_replaying_prefill_graph_matches_jax_engine(name):
    """Every prefill goes through the stand-in graphs: an eager run for
    a shape key's first call, a capture for its second, replays after,
    and the ids equal the JAX engine's."""
    want, _ = _serve("jax", name)
    log = []
    got, eng = _serve("torch", name, log)
    g = eng.backend.prefill_graph
    assert graphs_ok(g, eng.n_prefill_shapes) and g.replays > 0
    assert sum(e[0] == "begin" for e in log) == g.captures
    if name == "prefix":
        res = eng.result
        assert res.prefix_hits > 0 and res.prefill_tokens_skipped > 0
    assert got == want


# ------------------------------------------------------ on the card -----
@needs_cuda
@pytest.mark.parametrize("name", ["contiguous", "paged", "rwkv", "int8"])
def test_cuda_prefill_graph_ids_equal_eager_and_cpu(name):
    """Smoke f32: the engine with both graphs gives the ids of the same
    engine run eagerly on the card and of the CPU, the launch counts of
    the eager run, and its prefill graphs replay."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    arch, cfg_args, eng_args, make = WORKLOADS[name]
    eng_args = dict(eng_args)
    slots, paged = eng_args.pop("slots"), eng_args.pop("paged", False)
    page = eng_args.pop("page_size", 128)
    chunk = eng_args.pop("chunk", None)
    cfg = get_smoke_config(arch, **cfg_args)
    cpu_model = ttfm.init_params(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    ids, counts = {}, {}
    try:
        for label, model, kw in (
                ("cpu", cpu_model, dict(device="cpu")),
                ("eager", gpu_model, dict(device="cuda", decode_graph=False,
                                          prefill_graph=False)),
                ("graph", gpu_model, dict(device="cuda"))):
            sched = tcore.BucketServeScheduler(cfg, tcore.MemoryBudget(
                2 ** 30, 1, 0), tcore.SchedulerConfig(
                    max_batch=slots, memory_model="paged" if paged else "sum",
                    page_size=page))
            eng = ServingEngine(cfg, model, sched, max_slots=slots,
                                cache_len=cfg.max_seq_len, paged=paged,
                                page_size=page, chunk_tokens=chunk,
                                prefill_rows=slots, **kw)
            reqs = make(tcore)
            runtime.reset_launch_counts()
            eng.submit(reqs)
            assert len(eng.run(max_wall_s=300)) == len(reqs)
            torch.cuda.synchronize()
            counts[label] = runtime.count_state()
            ids[label] = {r.rid: list(eng.outputs[r.rid]) for r in reqs}
            g = eng.backend.prefill_graph
            assert (g is not None) == (label == "graph")
            if g is not None:
                assert graphs_ok(g, eng.n_prefill_shapes) and g.replays
        assert ids["graph"] == ids["eager"] == ids["cpu"]
        assert counts["graph"] == counts["eager"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
        runtime.reset_launch_counts()
