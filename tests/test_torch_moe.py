"""The port's MoE family against the JAX reference, with the same
weights: the ops of ``repro.models.moe``, the model, the engine and the
launcher.

At f32 on the smoke configs of qwen3-moe-235b-a22b (4 experts, top-2,
the top-k re-normalized) and llama4-scout-17b-a16e (4 experts, top-1,
with its shared expert), the reference's weights go through
``bridge.py`` and the same numpy inputs run through both packages:

- the ops: ``router_topk`` (re-normalization on and off),
  ``load_balance_loss``, ``moe_dense_ref`` and ``moe_local`` (the port's
  through the plain grouped product) against both of the reference's
  paths, and the port's ``moe_local`` against its own ``moe_dense_ref``,
  within atol 2e-5, rtol 2e-4.  The smallest gap between the k-th and
  the (k+1)-th router probability over the inputs is printed: a gap
  within rounding would let the two frameworks pick different experts;
- the grouped product: the plain version against ``jax.lax.ragged_dot``
  with empty groups, and its CUDA route against the plain version on
  the card (skipped without one);
- whole-model prefill, chunked prefill and decode on the contiguous and
  the paged cache for both configs, with ``moe_impl`` "local" and
  "ref": logits within atol 1e-4;
- the engine against the JAX engine, 6 requests with chunked prefill,
  on both pools (slot-bound admission): formed batches and ids equal,
  and the port's paged ids equal its contiguous ids;
- the decode step over the MoE path through a stand-in CUDA graph that
  replays it: storage kept, ids equal to the eager run's;
- ``moe_impl="ep"`` refused; the launcher's ``--smoke --device cpu``
  run; the bridge's f32 router in a bf16 model; the memory budget's
  weight bytes counting every expert.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.engine import ServingEngine as JaxEngine
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.engine import (DecodeGraph, ServingEngine,
                                     TorchEngineBackend)
from repro_torch.kernels import runtime
from repro_torch.models import moe
from repro_torch.models import transformer as ttfm

ARCHS = ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]
OP_TOL = dict(atol=2e-5, rtol=2e-4)
LOGIT_TOL = dict(atol=1e-4, rtol=0)

needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA card (run on the H100: "
           "python -m pytest tests/test_torch_moe.py -k cuda)")

j_prefill = jax.jit(jtfm.prefill, static_argnums=0,
                    static_argnames=("cache_len", "moe_impl"))
j_chunk = jax.jit(jtfm.prefill_chunk, static_argnums=0,
                  static_argnames=("moe_impl",))
j_decode = jax.jit(jtfm.decode_step, static_argnums=0,
                   static_argnames=("page_size", "paged_len", "moe_impl"))


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
def _params(arch):
    return jtfm.init_params(jax_smoke_config(arch), jax.random.PRNGKey(0))


def _pair(arch, dtype=torch.float32, **overrides):
    jcfg = jax_smoke_config(arch, **overrides)
    tcfg = get_smoke_config(arch, **overrides)
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, _params(arch)),
                                     tcfg, device="cpu", dtype=dtype)
    return jcfg, tcfg, _params(arch), model


def _np(x):
    return np.asarray(x, np.float32)


# ------------------------------------------------------------- the ops ---
def _op_inputs(arch, N=37, seed=0):
    """The first layer's MoE leaves of both packages and (N, d) inputs."""
    jcfg, tcfg, params, model = _pair(arch)
    jp = jax.tree.map(lambda a: a[0], params["groups"][0][0]["moe"])
    tp = model.groups[0][0][0].moe
    x = np.random.default_rng(seed).standard_normal(
        (N, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _min_topk_gap(probs, k):
    """Smallest gap between the k-th and (k+1)-th probability of a row."""
    s = np.sort(probs, axis=-1)[:, ::-1]
    return float((s[:, k - 1] - s[:, k]).min())


@pytest.mark.parametrize("arch", ARCHS)
def test_router_topk_matches_reference(arch):
    """qwen3 re-normalizes the top-k gates, llama4-scout does not."""
    jcfg, tcfg, jp, tp, x = _op_inputs(arch)
    assert tcfg.router_norm_topk == (arch == ARCHS[0])
    jg, ji, jpr = jmoe.router_topk(jcfg, jp, jnp.asarray(x))
    tg, ti, tpr = moe.router_topk(tcfg, tp, torch.from_numpy(x))
    gap = _min_topk_gap(_np(jpr), tcfg.top_k)
    print(f"{arch}: smallest top-{tcfg.top_k} probability gap {gap:.3g}")
    assert gap > 1e-5
    assert tg.dtype == tpr.dtype == torch.float32
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), _np(jg), **OP_TOL)
    np.testing.assert_allclose(tpr.numpy(), _np(jpr), **OP_TOL)
    if tcfg.router_norm_topk:
        np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_load_balance_loss_matches_reference(arch):
    jcfg, tcfg, jp, tp, x = _op_inputs(arch)
    _, ji, jpr = jmoe.router_topk(jcfg, jp, jnp.asarray(x))
    want = float(jmoe.load_balance_loss(jcfg, jpr, ji))
    got = moe.load_balance_loss(tcfg, torch.from_numpy(np.array(jpr, np.float32)),
                                torch.from_numpy(np.asarray(ji, np.int64)))
    np.testing.assert_allclose(float(got), want, **OP_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_paths_match_reference(arch):
    """The port's dense oracle and its ``moe_local`` (the plain grouped
    product on the CPU) against the reference's ``moe_dense_ref`` and
    ``moe_local``, on a (3, 13, d) input (39 tokens, so some experts
    get few rows), and the port's two paths against each other."""
    jcfg, tcfg, jp, tp, x = _op_inputs(arch, N=39)
    x3 = x.reshape(3, 13, -1)
    jd = _np(jmoe.moe_dense_ref(jcfg, jp, jnp.asarray(x3)))
    jl = _np(jmoe.moe_local(jcfg, jp, jnp.asarray(x3)))
    td = moe.moe_dense_ref(tcfg, tp, torch.from_numpy(x3))
    tl = moe.moe_local(tcfg, tp, torch.from_numpy(x3))
    assert tl.shape == td.shape == x3.shape
    for got in (td.numpy(), tl.numpy()):
        np.testing.assert_allclose(got, jd, **OP_TOL)
        np.testing.assert_allclose(got, jl, **OP_TOL)
    np.testing.assert_allclose(tl.numpy(), td.numpy(), **OP_TOL)


def test_grouped_product_with_empty_groups_matches_ragged_dot():
    """Rows sorted by group with groups of size 0 (first, middle, last):
    the plain grouped product against ``jax.lax.ragged_dot``, and the
    offsets counted on the device against the sizes."""
    rng = np.random.default_rng(3)
    sizes = np.array([0, 5, 0, 9, 1, 0], np.int32)
    M, K, N = int(sizes.sum()), 32, 24
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((len(sizes), K, N)).astype(np.float32)
    want = _np(jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(sizes)))
    flat = torch.from_numpy(np.repeat(np.arange(len(sizes)), sizes))
    offs = moe.group_offsets(flat[torch.randperm(M)], len(sizes))
    assert offs.dtype == torch.int32
    assert offs.tolist() == np.cumsum(sizes).tolist()
    got = moe.grouped_mm(torch.from_numpy(x), torch.from_numpy(w), offs)
    np.testing.assert_allclose(got.numpy(), want, **OP_TOL)


def test_moe_ep_is_refused(tmp_path):
    """``moe_impl="ep"`` is refused without a mesh and by the engine (it
    serves ``"local"``, as the reference's engine, whose model calls pass
    no mesh, which its ``"ep"`` needs); under a one-rank gloo mesh it
    runs ``moe_ep`` (its all-to-all over one rank) and gives the local
    path's logits.  ``tests/test_torch_distributed.py`` runs it on 8."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    from repro_torch.sharding import partition
    cfg = get_smoke_config(ARCHS[0], max_seq_len=32)
    model = ttfm.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="runs under a mesh"):
        ttfm.prefill(cfg, model, toks, cache_len=32, moe_impl="ep")
    with pytest.raises(NotImplementedError, match="pass no mesh"):
        TorchEngineBackend(cfg, model, device="cpu", moe_impl="ep")
    with pytest.raises(ValueError, match="moe_impl"):
        ttfm.prefill(cfg, model, toks, cache_len=32, moe_impl="dense")
    want, _ = ttfm.prefill(cfg, model, toks, cache_len=32)
    tmesh.init_distributed(1, 1, "cpu", rank=0, world_size=1,
                           init_method=f"file://{tmp_path / 'store'}")
    try:
        mesh = tmesh.make_host_mesh(1, 1, device="cpu")
        partition.shard_model(cfg, model, mesh)
        got, _ = ttfm.prefill(cfg, model, toks, cache_len=32,
                              moe_impl="ep", mesh=mesh)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_bridge_router_stays_f32_and_budget_counts_every_expert():
    """A bf16 model keeps the router f32 with the reference's values and
    the experts in the reference's layout; casting it is refused.  The
    launcher's weight bytes (``param_count``) count all E experts, which
    is the model's parameter count up to the qk-norm vectors."""
    _, tcfg, params, m16 = _pair(ARCHS[0], torch.bfloat16)
    flat = bridge.flatten(jax.tree.map(np.asarray, params))
    blk = m16.groups[0][0][1]
    assert blk.moe.router.dtype == torch.float32
    assert np.array_equal(blk.moe.router.numpy(),
                          flat["groups/0/0/moe/router"][1])
    E, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff_expert
    assert blk.moe.w_gate.shape == blk.moe.w_up.shape == (E, d, f)
    assert blk.moe.w_down.shape == (E, f, d)
    assert blk.moe.w_gate.is_contiguous()
    assert blk.moe.w_gate.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="stay float32"):
        m16.to(torch.float16)
    _, scfg, _, scout = _pair(ARCHS[1])
    assert "groups/0/0/moe/shared/gate" in bridge.flatten(
        jax.tree.map(np.asarray, _params(ARCHS[1])))
    assert scout.groups[0][0][0].moe.shared.gate.shape == (scfg.d_model,
                                                           scfg.d_ff)
    for cfg, model in ((tcfg, m16), (scfg, scout)):
        qk = 2 * cfg.d_head * cfg.n_layers if cfg.qk_norm else 0
        assert sum(p.numel() for p in model.parameters()) == \
            cfg.param_count() + qk
    full = get_config(ARCHS[0])
    experts = full.n_layers * full.n_experts * 3 * full.d_model * \
        full.d_ff_expert
    assert full.param_count() > experts > 0.9 * full.param_count()
    assert full.active_param_count() < full.param_count() - 0.9 * experts


# ------------------------------------------------------- whole model -----
def _prompts(cfg, lens, pad, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), pad), np.int32)
    for i, L in enumerate(lens):
        toks[i, :L] = rng.integers(0, cfg.vocab_size, L)
    return toks, np.asarray(lens, np.int32)


def _to_paged(cache, page, rng):
    """A contiguous cache (numpy) with its K/V scattered into a shuffled
    page pool."""
    pos = cache["pos"]
    B = pos.shape[0]
    S = cache["groups"][0][0]["k"].shape[2]
    n_p = -(-S // page)
    n_pages = B * n_p + 2
    bt = rng.permutation(n_pages)[:B * n_p].reshape(B, n_p).astype(np.int32)
    slots = []
    for slot in cache["groups"][0]:
        out = {}
        for key, leaf in slot.items():          # (reps, B, S, Hkv, Dh)
            pad = np.zeros(leaf.shape[:2] + (n_p * page,) + leaf.shape[3:],
                           np.float32)
            pad[:, :, :S] = leaf
            pool = np.zeros((leaf.shape[0], n_pages, page) + leaf.shape[3:],
                            np.float32)
            for b in range(B):
                for j in range(n_p):
                    pool[:, bt[b, j]] = pad[:, b, j * page:(j + 1) * page]
            out[key] = pool
        slots.append(out)
    return {"pos": pos, "block_tables": bt, "groups": (tuple(slots),)}, S


@pytest.mark.parametrize("impl", ["local", "ref"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, impl):
    """Prefill of ragged prompts, then 4 decode steps on the contiguous
    cache and 4 on the same cache paged (page 16, shuffled)."""
    jcfg, tcfg, params, model = _pair(arch, max_seq_len=64)
    toks, lens = _prompts(jcfg, [40, 17, 29], 40)
    jl, jc = j_prefill(jcfg, params, tokens=jnp.asarray(toks),
                       lengths=jnp.asarray(lens), cache_len=64,
                       moe_impl=impl)
    tl, tc = ttfm.prefill(tcfg, model, torch.from_numpy(toks),
                          torch.from_numpy(lens), cache_len=64, moe_impl=impl)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    for b, L in enumerate(lens):
        np.testing.assert_allclose(
            tc["groups"][0][0]["k"][:, b, :L].numpy(),
            _np(jc["groups"][0][0]["k"])[:, b, :L], **OP_TOL)
    jc0 = jax.tree.map(np.asarray, jc)
    paged, S = _to_paged(jc0, 16, np.random.default_rng(2))
    for cache, kw in ((jc0, {}), (paged, dict(page_size=16, paged_len=S))):
        jcc = jax.tree.map(jnp.asarray, cache)
        tcc = bridge.cache_from_numpy(cache, device="cpu")
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        for _ in range(4):
            jo, jcc = j_decode(jcfg, params, jnp.asarray(tok), jcc,
                               moe_impl=impl, **kw)
            to, tcc = ttfm.decode_step(tcfg, model, torch.from_numpy(tok),
                                       tcc, moe_impl=impl, **kw)
            np.testing.assert_allclose(to.numpy(), _np(jo), **LOGIT_TOL)
            tok = np.array(jnp.argmax(jo, -1), np.int32)


@pytest.mark.parametrize("impl", ["local", "ref"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_matches_reference(arch, impl):
    jcfg, tcfg, params, model = _pair(arch, max_seq_len=64)
    lens = np.array([10, 37, 48], np.int32)
    toks, _ = _prompts(jcfg, lens, 48)
    jc = jtfm.init_cache(jcfg, 3, 64)
    tc = ttfm.init_cache(tcfg, 3, 64, device="cpu")
    for s in range(0, 48, 16):
        jl, jc = j_chunk(jcfg, params, jnp.asarray(toks[:, s:s + 16]), jc, s,
                         jnp.asarray(lens), moe_impl=impl)
        tl, tc = ttfm.prefill_chunk(tcfg, model,
                                    torch.from_numpy(toks[:, s:s + 16]), tc,
                                    s, torch.from_numpy(lens), moe_impl=impl)
        fin = ((lens - 1) >= s) & ((lens - 1) < s + 16)
        np.testing.assert_allclose(tl.numpy()[fin], _np(jl)[fin],
                                   **LOGIT_TOL)
    for b, L in enumerate(lens):
        np.testing.assert_allclose(
            tc["groups"][0][0]["v"][:, b, :L].numpy(),
            _np(jc["groups"][0][0]["v"])[:, b, :L], **OP_TOL)


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


SLOTS, PAGE, CHUNK = 4, 32, 64


def _serve(side, arch, paged, graph=None):
    """(formed batches, {rid: ids}) of one engine: 6 requests of 20-150
    prompt tokens and 3-24 new tokens, chunked prefill, 4 slots;
    ``graph`` is called with the port's backend before it serves."""
    core = jcore if side == "jax" else tcore
    cfg = (jax_smoke_config if side == "jax" else get_smoke_config)(
        arch, max_seq_len=256)
    sched = _recording(core.BucketServeScheduler)(
        cfg, core.MemoryBudget(2 ** 30, 1, 0), core.SchedulerConfig(
            max_batch=SLOTS, memory_model="paged" if paged else "sum",
            page_size=PAGE))
    kw = dict(max_slots=SLOTS, cache_len=cfg.max_seq_len, paged=paged,
              page_size=PAGE, chunk_tokens=CHUNK, moe_impl="local")
    if side == "jax":
        eng = JaxEngine(cfg, _params(arch), sched, **kw)
    else:
        model = bridge.params_from_numpy(
            jax.tree.map(np.asarray, _params(arch)), cfg, device="cpu")
        eng = ServingEngine(cfg, model, sched, device="cpu",
                            decode_graph=False, **kw)
        if graph is not None:
            graph(eng.backend)
    rng = np.random.default_rng(5)
    reqs = [core.Request(rid=i, prompt_len=int(rng.integers(20, 150)),
                         max_new_tokens=int(rng.integers(3, 24)),
                         arrival=0.0, task_type=core.TaskType.OFFLINE)
            for i in range(6)]
    eng.submit(reqs)
    assert len(eng.run(max_wall_s=300)) == len(reqs)
    for r in reqs:
        assert len(eng.outputs[r.rid]) == r.max_new_tokens
    if paged:
        assert eng.backend.free_blocks() == eng.backend.alloc.n_pages
    return sched.formed, {r.rid: list(eng.outputs[r.rid]) for r in reqs}


@functools.lru_cache(maxsize=None)
def _port(arch, paged):
    return _serve("torch", arch, paged)


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
def test_engine_matches_jax_engine(pool):
    """qwen3-moe through both engines with chunked prefill: the same
    formed batches and ids, and the port's paged ids equal its
    contiguous ids."""
    paged = pool == "paged"
    jf, jids = _serve("jax", ARCHS[0], paged)
    tf, tids = _port(ARCHS[0], paged)
    assert tf == jf
    assert tids == jids
    assert tids == _port(ARCHS[0], not paged)[1]


def test_decode_graph_over_the_moe_path():
    """llama4-scout's decode step (routing, grouped products, shared
    expert) captured through a stand-in graph that replays the step:
    every leaf keeps its storage and the ids equal the eager run's."""
    from test_torch_rglru import ReplayingGraph
    graphs = []

    def attach(be):
        be.decode_graph = DecodeGraph(be._step, "cpu",
                                      graph=ReplayingGraph(be))
        be._reset_pool()
        graphs.append(be.decode_graph)
    _, ids = _serve("torch", ARCHS[1], True, graph=attach)
    assert graphs and graphs[0].replays > 0
    assert ids == _port(ARCHS[1], True)[1]


def test_launcher_serves_qwen3_moe_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device",
                "cpu", "--dtype", "f32", "--requests", "4", "--paged",
                "--page-size", "32", "--chunk", "64", "--slots", "4"])
    out = capsys.readouterr().out
    assert re.search(r"served 4/4 requests, \d+ tokens in", out), out
    m = re.search(r"pages: (\d+) x 32 tok \(bf16 pool\), free (\d+)", out)
    assert m and m[1] == m[2], out
    assert "kernel launches: flash_prefill 0, paged_flash_decode 0" in out


# -------------------------------------------------------------- card -----
@needs_cuda
@pytest.mark.parametrize("rows", [64, 777])
def test_cuda_grouped_mm_routes(rows):
    """On the card a bf16 grouped product is one library call and an f32
    one the plain loop (each counted by route); both against the plain
    version on the CPU, with empty groups."""
    gen = torch.Generator().manual_seed(rows)
    E, K, N = 16, 256, 192
    ids = torch.sort(torch.randint(0, E - 4, (rows,), generator=gen))[0]
    offs = moe.group_offsets(ids, E)
    for dtype, route, tol in ((torch.bfloat16, "grouped_mm",
                               dict(atol=2e-2, rtol=2e-2)),
                              (torch.float32, "masked_loop",
                               dict(atol=1e-4, rtol=1e-4))):
        x = torch.randn(rows, K, generator=gen).to(dtype)
        w = (torch.randn(E, K, N, generator=gen) * K ** -0.5).to(dtype)
        want = moe.grouped_mm_plain(x.float(), w.float(), offs)
        runtime.reset_launch_counts()
        got = moe.grouped_mm(x.cuda(), w.cuda(), offs.cuda())
        assert runtime.grouped_counts[route] == 1
        assert got.dtype == dtype
        torch.testing.assert_close(got.float().cpu(), want, **tol)


def _grouped_backward_case(rows, E, K, N, seed, device):
    """bf16 x (rows, K) sorted into E groups (four empty), w (E, K, N)
    and a cotangent dy, on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.sort(torch.randint(0, E - 4, (rows,), generator=gen))[0]
    offs = moe.group_offsets(ids, E)
    x = torch.randn(rows, K, generator=gen).to(torch.bfloat16)
    w = (torch.randn(E, K, N, generator=gen) * K ** -0.5).to(torch.bfloat16)
    dy = torch.randn(rows, N, generator=gen).to(torch.bfloat16)
    return (t.to(device) for t in (x, w, offs, dy))


def _plain_grads(x, w, offs, dy):
    """dx, dw by autograd through ``grouped_mm_plain`` in f32."""
    xf = x.float().requires_grad_(True)
    wf = w.float().requires_grad_(True)
    y = moe.grouped_mm_plain(xf, wf, offs)
    return torch.autograd.grad(y, (xf, wf), dy.float())


def test_grouped_mm_backward_matches_plain_autograd():
    """``GroupedMM``'s backward (the reference's custom VJP of
    ``ragged_matmul``: dx by the grouped product with wᵀ, dw by the
    product contracted over each group's rows) against autograd through
    the plain masked loop, empty groups included (their dw is zero).
    The library's grouped product runs on the CPU too at these aligned
    widths."""
    x, w, offs, dy = _grouped_backward_case(96, 12, 64, 48, 3, "cpu")
    x.requires_grad_(True)
    w.requires_grad_(True)
    runtime.reset_launch_counts()
    dx, dw = torch.autograd.grad(moe.GroupedMM.apply(x, w, offs), (x, w),
                                 dy)
    assert runtime.autograd_counts["grouped_mm"] == 1
    want_dx, want_dw = _plain_grads(x.detach(), w.detach(), offs, dy)
    tol = dict(atol=5e-2, rtol=2e-2)
    torch.testing.assert_close(dx.float(), want_dx, **tol)
    torch.testing.assert_close(dw.float(), want_dw, **tol)
    empty = torch.diff(torch.cat([offs.new_zeros(1), offs])) == 0
    assert empty.any() and not dw[empty].any()


@needs_cuda
def test_cuda_grouped_mm_backward_under_autograd():
    """On the card a bf16 grouped product that autograd records goes
    through ``GroupedMM`` (one forward call counted by route, one
    backward pass counted in ``autograd_counts``), at one full-width
    qwen3-moe layer's down projection (512 tokens x top 8, d_ff_expert
    1536 -> d 4096, 128 experts), against autograd through the plain
    version."""
    cfg = get_config("qwen3-moe-235b-a22b")
    x, w, offs, dy = _grouped_backward_case(
        512 * cfg.top_k, cfg.n_experts, cfg.d_ff_expert, cfg.d_model, 5,
        "cuda")
    x.requires_grad_(True)
    w.requires_grad_(True)
    runtime.reset_launch_counts()
    y = moe.grouped_mm(x, w, offs)
    assert runtime.grouped_counts["grouped_mm"] == 1
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    assert runtime.autograd_counts["grouped_mm"] == 1
    want_dx, want_dw = _plain_grads(x.detach(), w.detach(), offs, dy)
    torch.testing.assert_close(dx.float(), want_dx, atol=5e-2, rtol=2e-2)
    torch.testing.assert_close(dw.float(), want_dw, atol=1e-1, rtol=2e-2)
