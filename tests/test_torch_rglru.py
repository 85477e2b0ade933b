"""The port's recurrentgemma path against the JAX reference, with the
same weights, and its ring caches through the engine.

At f32 on the smoke config with five layers (the ``("rec", "rec",
"attn")`` group and the ``("rec", "rec")`` remainder group that the full
config has), the reference's weights go through ``bridge.py`` and the
same numpy inputs run through ``repro.models.rglru`` /
``repro.models.transformer`` and their port:

- the RG-LRU ops: ``_conv1d``, the gates, ``rglru_scan`` (ragged
  lengths, a nonzero h0, T = 1 and T off any power of two),
  ``rglru_step``, ``rec_block_forward`` (the conv state of short rows)
  and ``rec_block_decode``, within atol 2e-5, rtol 2e-4;
- whole-model prefill then 8 decode steps on the contiguous and the
  paged cache, prompts longer than the 64-token local window so that the
  ring wraps in prefill and in decode: logits within atol 1e-4, K/V and
  the carries within the op tolerance; chunked prefill where the cache
  is positional (cache length at the window);
- the engine against the JAX engine on 6 requests of 20-200 prompt
  tokens and 4-80 new tokens, page 32, on both pools: formed batches and
  ids equal, and the port's paged ids equal its contiguous ids (the pool
  is given room for every slot's ring, so admission is slot-bound on
  both sides);
- the dense ring through the engine (the twin of
  ``tests/test_paged_serving.py:test_windowed_ring_cache_parity``):
  qwen3-14b with ``sliding_window=48`` over page 32, port paged == port
  contiguous == the JAX engine;
- the decode step over the carry as a captured graph, through a
  stand-in graph that replays the captured step: every leaf keeps its
  storage, ids equal to the eager run.
"""
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
from repro.models import rglru as jrglru
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.batcher import FormedBatch
from repro_torch.core.engine import (DecodeGraph, ServingEngine,
                                     TorchEngineBackend)
from repro_torch.models import rglru
from repro_torch.models import transformer as ttfm
from test_torch_graph import StandInGraph

ARCH = "recurrentgemma-2b"
N_LAYERS = 5
OP_TOL = dict(atol=2e-5, rtol=2e-4)
LOGIT_TOL = dict(atol=1e-4, rtol=0)

j_prefill = jax.jit(jtfm.prefill, static_argnums=0,
                    static_argnames=("cache_len",))
j_chunk = jax.jit(jtfm.prefill_chunk, static_argnums=0)
j_decode = jax.jit(jtfm.decode_step, static_argnums=0,
                   static_argnames=("page_size", "paged_len"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke model's ops are tiny: torch's intra-op threads only
    contend with the other test workers for the cores.  Restored
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params(arch=ARCH, n_layers=N_LAYERS):
    kw = dict(n_layers=n_layers) if arch == ARCH else {}
    return jtfm.init_params(jax_smoke_config(arch, **kw),
                            jax.random.PRNGKey(0))


def _pair(dtype=torch.float32, **overrides):
    kw = dict(n_layers=N_LAYERS, **overrides)
    jcfg, tcfg = jax_smoke_config(ARCH, **kw), get_smoke_config(ARCH, **kw)
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, _params()),
                                     tcfg, device="cpu", dtype=dtype)
    return jcfg, tcfg, _params(), model


def _np(x):
    return np.asarray(x, np.float32)


# ------------------------------------------------------------- the ops ---
def _op_params(cfg, seed=1):
    """The reference's ``rglru_init`` leaves and the port's module
    holding them."""
    jp = jrglru.rglru_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    tp = rglru.RecParams(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for k, v in jp.items():
            getattr(tp, k).copy_(torch.from_numpy(np.array(v, np.float32)))
    return jp, tp


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _state(cfg, B, rng):
    return {"h": _rand(rng, B, cfg.lru_width),
            "conv": _rand(rng, B, cfg.conv_width - 1, cfg.lru_width)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_conv1d_and_gates_match_reference():
    cfg = jax_smoke_config(ARCH)
    jp, tp = _op_params(cfg)
    rng = np.random.default_rng(0)
    B, T, w = 3, 9, cfg.lru_width
    x = _rand(rng, B, T, w)
    st = _state(cfg, B, rng)["conv"]
    jo, js = jrglru._conv1d(jnp.asarray(x), jp["conv"], jnp.asarray(st))
    to, ts = rglru._conv1d(torch.from_numpy(x), tp.conv,
                           torch.from_numpy(st))
    np.testing.assert_allclose(to.numpy(), _np(jo), **OP_TOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), **OP_TOL)
    ja, jb = jrglru._rglru_gates(jp, jnp.asarray(x))
    ta, tb = rglru._rglru_gates(tp, torch.from_numpy(x))
    assert ta.dtype == tb.dtype == torch.float32
    np.testing.assert_allclose(ta.numpy(), _np(ja), **OP_TOL)
    np.testing.assert_allclose(tb.numpy(), _np(jb), **OP_TOL)


@pytest.mark.parametrize("T", [1, 37, 64])
def test_rglru_scan_matches_reference(T):
    """Ragged lengths (a full row, half a row, one token), a nonzero h0;
    T = 1 takes no doubling step, 37 is off any power of two."""
    cfg = jax_smoke_config(ARCH)
    jp, tp = _op_params(cfg)
    rng = np.random.default_rng(T)
    B, w = 3, cfg.lru_width
    x = _rand(rng, B, T, w)
    h0 = _rand(rng, B, w)
    lens = np.array([T, (T + 1) // 2, 1], np.int32)
    jh, jl = jrglru.rglru_scan(jp, jnp.asarray(x), jnp.asarray(h0),
                               jnp.asarray(lens))
    th, tl = rglru.rglru_scan(tp, torch.from_numpy(x), torch.from_numpy(h0),
                              torch.from_numpy(lens))
    np.testing.assert_allclose(th.numpy(), _np(jh), **OP_TOL)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **OP_TOL)
    jh, _ = jrglru.rglru_scan(jp, jnp.asarray(x), jnp.asarray(h0))
    th, _ = rglru.rglru_scan(tp, torch.from_numpy(x), torch.from_numpy(h0))
    np.testing.assert_allclose(th.numpy(), _np(jh), **OP_TOL)


def test_linear_scan_equals_the_sequential_recurrence():
    """The doubling scan against a float64 loop over T (long enough that
    the products of a span several doubling steps)."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0.5, 1.0, (2, 200, 8))
    b = rng.standard_normal((2, 200, 8))
    want = np.zeros_like(b)
    h = np.zeros((2, 8))
    for t in range(200):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_rglru_step_and_block_decode_match_reference():
    cfg = jax_smoke_config(ARCH)
    jp, tp = _op_params(cfg)
    rng = np.random.default_rng(5)
    B, w, d = 3, cfg.lru_width, cfg.d_model
    x = _rand(rng, B, 1, w)
    h0 = _rand(rng, B, w)
    jh, jl = jrglru.rglru_step(jp, jnp.asarray(x), jnp.asarray(h0))
    th, tl = rglru.rglru_step(tp, torch.from_numpy(x), torch.from_numpy(h0))
    np.testing.assert_allclose(th.numpy(), _np(jh), **OP_TOL)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **OP_TOL)

    xd = _rand(rng, B, 1, d, scale=0.5)
    st = _state(cfg, B, rng)
    jo, js = jrglru.rec_block_decode(cfg, jp, jnp.asarray(xd), _j(st))
    ts = _t(st)
    ptrs = {k: v.data_ptr() for k, v in ts.items()}
    to, out = rglru.rec_block_decode(cfg, tp, torch.from_numpy(xd), ts)
    assert out is ts and {k: v.data_ptr() for k, v in ts.items()} == ptrs
    np.testing.assert_allclose(to.numpy(), _np(jo), **OP_TOL)
    for k in rglru.STATE_LEAVES:
        np.testing.assert_allclose(ts[k].numpy(), _np(js[k]), **OP_TOL)


def test_rec_block_forward_matches_reference():
    """Rows shorter than the conv width take their conv state partly from
    the incoming state."""
    cfg = jax_smoke_config(ARCH)
    jp, tp = _op_params(cfg)
    rng = np.random.default_rng(7)
    B, T = 3, 11
    x = _rand(rng, B, T, cfg.d_model, scale=0.5)
    st = _state(cfg, B, rng)
    lens = np.array([T, 2, 5], np.int32)
    jo, js = jrglru.rec_block_forward(cfg, jp, jnp.asarray(x), _j(st),
                                      jnp.asarray(lens))
    to, ts = rglru.rec_block_forward(cfg, tp, torch.from_numpy(x), _t(st),
                                     torch.from_numpy(lens))
    for b, L in enumerate(lens):
        np.testing.assert_allclose(to.numpy()[b, :L], _np(jo)[b, :L],
                                   **OP_TOL)
    for k in rglru.STATE_LEAVES:
        np.testing.assert_allclose(ts[k].numpy(), _np(js[k]), **OP_TOL)


# ------------------------------------------------- bridge and dtypes -----
def test_bridge_round_trip_keeps_f32_leaves_in_a_bf16_model():
    flat = bridge.flatten(jax.tree.map(np.asarray, _params()))
    assert "groups/1/1/rec/wr" in flat          # the remainder group
    _, tcfg, _, model = _pair()
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] != "groups":
            continue
        gi, j = int(parts[1]), int(parts[2])
        for rep, blk in enumerate(model.groups[gi][j]):
            got = blk.get_parameter(".".join(parts[3:]))
            assert np.array_equal(got.numpy(), arr[rep]), key
    _, _, _, m16 = _pair(torch.bfloat16)
    for _, _, _, blk in m16.blocks():
        if isinstance(blk, ttfm.RecBlock):
            for name in rglru.F32_LEAVES:
                assert getattr(blk.rec, name).dtype == torch.float32, name
            assert blk.rec.conv.dtype == torch.bfloat16
    for name in rglru.F32_LEAVES:
        ref = flat[f"groups/0/0/rec/{name}"][0]
        assert np.array_equal(
            getattr(m16.groups[0][0][0].rec, name).numpy(), ref)
    with pytest.raises(TypeError, match="stay float32"):
        m16.to(torch.float16)
    cache = ttfm.init_cache(tcfg, 2, 32, torch.bfloat16, "cpu")
    assert cache["groups"][0][0]["h"].dtype == torch.float32
    assert cache["groups"][0][0]["conv"].dtype == torch.bfloat16


# ------------------------------------------------------- whole model -----
def _prompts(cfg, lens, pad, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), pad), np.int32)
    for i, L in enumerate(lens):
        toks[i, :L] = rng.integers(0, cfg.vocab_size, L)
    return toks, np.asarray(lens, np.int32)


def _to_paged(cache, page, rng):
    """A contiguous cache (numpy) with its attention K/V scattered into a
    shuffled page pool; recurrent carries stay per slot."""
    pos = cache["pos"]
    B = pos.shape[0]
    S = next(s["k"].shape[2] for g in cache["groups"] for s in g if "k" in s)
    n_p = -(-S // page)
    n_pages = B * n_p + 2
    bt = rng.permutation(n_pages)[:B * n_p].reshape(B, n_p).astype(np.int32)
    groups = []
    for g in cache["groups"]:
        slots = []
        for slot in g:
            if "k" not in slot:
                slots.append(slot)
                continue
            out = {}
            for key, leaf in slot.items():      # (reps, B, S, Hkv, Dh)
                pad = np.zeros(leaf.shape[:2] + (n_p * page,)
                               + leaf.shape[3:], np.float32)
                pad[:, :, :S] = leaf
                pool = np.zeros((leaf.shape[0], n_pages, page)
                                + leaf.shape[3:], np.float32)
                for b in range(B):
                    for j in range(n_p):
                        pool[:, bt[b, j]] = pad[:, b, j * page:(j + 1) * page]
                out[key] = pool
            slots.append(out)
        groups.append(tuple(slots))
    return {"pos": pos, "block_tables": bt, "groups": tuple(groups)}, S


def _assert_cache(tc, jc):
    for gt, gj in zip(tc["groups"], jc["groups"]):
        for st, sj in zip(gt, gj):
            assert set(st) == set(sj)
            for k in st:
                np.testing.assert_allclose(st[k].float().numpy(), _np(sj[k]),
                                           **OP_TOL, err_msg=k)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
def test_prefill_and_decode_over_wrapped_rings_match_reference(pool):
    """Window 64 under a 128-slot cache: rows of 100 and 60 tokens wrap
    the ring in prefill and in decode, the 30-token row does not."""
    jcfg, tcfg, params, model = _pair(max_seq_len=128)
    toks, lens = _prompts(jcfg, [100, 60, 30], 100)
    jl, jc = j_prefill(jcfg, params, tokens=jnp.asarray(toks),
                       lengths=jnp.asarray(lens), cache_len=128)
    tl, tc = ttfm.prefill(tcfg, model, torch.from_numpy(toks),
                          torch.from_numpy(lens), cache_len=128)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    _assert_cache(tc, jc)
    kw = {}
    if pool == "paged":
        paged, S = _to_paged(jax.tree.map(np.asarray, jc), 16,
                             np.random.default_rng(2))
        assert S == tcfg.local_window
        jc = jax.tree.map(jnp.asarray, paged)
        tc = bridge.cache_from_numpy(paged, device="cpu")
        kw = dict(page_size=16, paged_len=S)
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    for _ in range(8):
        jl, jc = j_decode(jcfg, params, jnp.asarray(tok), jc, **kw)
        tl, tc = ttfm.decode_step(tcfg, model, torch.from_numpy(tok), tc,
                                  **kw)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
    _assert_cache(tc, jc)


def test_prefill_chunk_on_a_positional_cache_matches_reference():
    """With the cache at the window the attention cache is positional and
    a hybrid can take chunks (the engine never asks: its configs are ring
    configs); finished rows keep their carries."""
    jcfg, tcfg, params, model = _pair(max_seq_len=64)
    toks, lens = _prompts(jcfg, [48, 20], 48)
    jc = jtfm.init_cache(jcfg, 2, 64)
    tc = ttfm.init_cache(tcfg, 2, 64, device="cpu")
    for start in range(0, 48, 16):
        jl, jc = j_chunk(jcfg, params, jnp.asarray(toks[:, start:start + 16]),
                         jc, start, jnp.asarray(lens))
        tl, tc = ttfm.prefill_chunk(
            tcfg, model, torch.from_numpy(toks[:, start:start + 16]), tc,
            start, torch.from_numpy(lens))
        live = (lens - 1 >= start) & (lens - 1 < start + 16)
        np.testing.assert_allclose(tl.numpy()[live], _np(jl)[live],
                                   **LOGIT_TOL)
    _assert_cache(tc, jc)


# ------------------------------------------------------------ engine -----
def _recording(base):
    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.formed = []

        def next_prefill_batch(self, now):
            batch = super().next_prefill_batch(now)
            if batch is not None:
                self.formed.append(tuple(r.rid for r in batch.requests))
            return batch
    return Recording


def _workload(core, n, seed, lo, hi, new_lo, new_hi):
    rng = np.random.default_rng(seed)
    return [core.Request(rid=i, prompt_len=int(rng.integers(lo, hi)),
                         max_new_tokens=int(rng.integers(new_lo, new_hi)),
                         arrival=0.0, task_type=core.TaskType.OFFLINE)
            for i in range(n)]


SLOTS, PAGE = 4, 32
# recurrentgemma: 6 requests of 20-200 prompt tokens and 4-80 new tokens,
# window 64; the pool holds every slot's two-page ring
RG_RUN = dict(cfg=dict(n_layers=N_LAYERS, max_seq_len=256),
              reqs=(6, 0, 20, 200, 4, 80), pool_tokens=5 * 64)
# the dense ring: qwen3-14b, window 48 under a 128-slot cache
SWA_RUN = dict(cfg=dict(max_seq_len=128, sliding_window=48),
               reqs=(6, 9, 16, 100, 4, 30), pool_tokens=None)


def _serve(side, arch, run, paged, graph=None):
    """(formed batches, {rid: ids}, engine) of one engine on ``run``."""
    core = jcore if side == "jax" else tcore
    cfg = (jax_smoke_config if side == "jax" else get_smoke_config)(
        arch, **run["cfg"])
    sched = _recording(core.BucketServeScheduler)(
        cfg, core.MemoryBudget(2 ** 30, 1, 0), core.SchedulerConfig(
            max_batch=SLOTS, memory_model="paged" if paged else "sum",
            page_size=PAGE))
    kw = dict(max_slots=SLOTS, cache_len=cfg.max_seq_len, paged=paged,
              page_size=PAGE,
              kv_pool_tokens=run["pool_tokens"] if paged else None)
    params = _params(arch)
    if side == "jax":
        eng = JaxEngine(cfg, params, sched, **kw)
    else:
        model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                         cfg, device="cpu")
        eng = ServingEngine(cfg, model, sched, device="cpu",
                            decode_graph=False, **kw)
        if graph is not None:
            graph(eng.backend)
    reqs = _workload(core, *run["reqs"])
    eng.submit(reqs)
    assert len(eng.run(max_wall_s=300)) == len(reqs)
    for r in reqs:
        assert len(eng.outputs[r.rid]) == r.max_new_tokens
    if paged:
        assert eng.backend.free_blocks() == eng.backend.alloc.n_pages
    return sched.formed, {r.rid: list(eng.outputs[r.rid]) for r in reqs}, eng


@functools.lru_cache(maxsize=None)
def _port(arch, paged):
    run = RG_RUN if arch == ARCH else SWA_RUN
    formed, ids, _ = _serve("torch", arch, run, paged)
    return formed, ids


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
def test_engine_matches_jax_engine(pool):
    """recurrentgemma through the engine: the same formed batches and ids
    as the JAX engine on the pool, and paged ids == contiguous ids in the
    port.  Ring configs prefill whole prompts on both sides."""
    paged = pool == "paged"
    jf, jids, jeng = _serve("jax", ARCH, RG_RUN, paged)
    tf, tids = _port(ARCH, paged)
    assert tf == jf
    assert tids == jids
    assert tids == _port(ARCH, not paged)[1]


def test_dense_ring_engine_parity():
    """qwen3-14b with a 48-token sliding window over page 32 (the window
    does not divide the page): ids survive wraps on both pools and equal
    the JAX engine's."""
    _, jids, _ = _serve("jax", "qwen3-14b", SWA_RUN, False)
    assert _port("qwen3-14b", True)[1] == _port("qwen3-14b", False)[1] \
        == jids


def test_hybrid_refusals_and_whole_prompt_plan():
    """As the reference: KV retention needs chunk-resumable, purely
    attention-paged state, which a hybrid lacks; and a ring config
    prefills whole prompts whatever ``chunk_tokens`` is."""
    cfg = get_smoke_config(ARCH, n_layers=N_LAYERS, max_seq_len=256)
    assert not cfg.prefix_cacheable and not cfg.chunkable_prefill
    model = ttfm.init_params(cfg, seed=0, device="cpu")
    for kw in (dict(prefix_cache=True), dict(session_ttl=10.0)):
        with pytest.raises(ValueError, match="chunk-resumable"):
            TorchEngineBackend(cfg, model, device="cpu", paged=True,
                               page_size=PAGE, **kw)
        with pytest.raises(AssertionError, match="chunk-resumable"):
            JaxEngine(jax_smoke_config(ARCH, n_layers=N_LAYERS,
                                       max_seq_len=256), _params(),
                      jcore.BucketServeScheduler(
                          jax_smoke_config(ARCH), jcore.MemoryBudget(
                              2 ** 30, 1, 0), jcore.SchedulerConfig()),
                      paged=True, page_size=PAGE, **kw)
    be = TorchEngineBackend(cfg, model, device="cpu", paged=True,
                            page_size=PAGE, chunk_tokens=16)
    assert be.pages_per_seq == cfg.local_window // PAGE
    reqs = _workload(tcore, 2, 0, 100, 200, 4, 5)
    assert be.chunk_plan(FormedBatch(reqs, pad_to=200)) == [(0, 200)]


class ReplayingGraph(StandInGraph):
    """A stand-in CUDA graph whose replay runs the captured step again
    and checks that every tensor the capture saw keeps its storage (a
    real replay writes exactly that storage)."""

    def __init__(self, backend):
        super().__init__()
        self.backend = backend

    def _storage(self):
        be = self.backend
        ptrs = [be.next_tok.data_ptr(), be.pool_cache["pos"].data_ptr()]
        if "block_tables" in be.pool_cache:
            ptrs.append(be.pool_cache["block_tables"].data_ptr())
        for slots in be.pool_cache["groups"]:
            for slot in slots:
                ptrs += [leaf.data_ptr() for leaf in slot.values()]
        return ptrs

    def capture_end(self):
        super().capture_end()
        self.seen = self._storage()

    def replay(self):
        super().replay()
        self.backend._step()
        assert self._storage() == self.seen


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
def test_decode_graph_over_the_carry(pool):
    graphs = []

    def attach(be):
        g = ReplayingGraph(be)
        be.decode_graph = DecodeGraph(be._step, "cpu", graph=g)
        be._reset_pool()
        graphs.append(be.decode_graph)
    _, ids, eng = _serve("torch", ARCH, RG_RUN, pool == "paged",
                         graph=attach)
    assert graphs and graphs[0].replays > 0
    assert eng.backend.decode_graph is graphs[0]
    assert ids == _port(ARCH, pool == "paged")[1]
