"""The port's compiled decode step: what a CUDA graph of it needs, and the
graph against eager steps.

The reference engine ``jax.jit``s its decode step once per engine; the
port captures one step as a CUDA graph (``core/engine.py:DecodeGraph``)
and replays it.  A replay writes the storage that the capture saw, so:

- ``decode_step`` advances ``pos`` in place on the contiguous, the paged
  and the RWKV cache, and a prefilled cache's ``pos`` is not the
  caller's ``lengths``;
- across a served workload on each pool, ``decode_iter`` keeps the
  storage of ``next_tok`` and of every pool leaf, and the token ids
  still equal the JAX engine's (the workloads of
  ``tests/test_torch_engine.py``);
- ``DecodeGraph`` puts the launch counts back after its capture and adds
  the capture's launches at every replay (driven here through a
  stand-in for ``torch.cuda.CUDAGraph``), with decode arrival counters
  of its own;
- on the card, smoke f32 engines with the graph give the ids of the
  same engines run eagerly and of the CPU (``-k cuda``; skipped here).
"""
import copy

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import (DecodeGraph, ServingEngine,
                                     TorchEngineBackend)
from repro_torch.data.workload import WorkloadSpec, generate
from repro_torch.kernels import runtime
from repro_torch.kernels.decode_attn import DecodePlan
from repro_torch.models import transformer as ttfm

needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA card (run on the H100: "
           "python -m pytest tests/test_torch_graph.py -k cuda)")

ARCH = {"contiguous": "qwen3-14b", "paged": "qwen3-14b",
        "rwkv": "rwkv6-3b"}


def _uniform(core, n, seed, lo, hi, new_lo, new_hi, task):
    rng = np.random.default_rng(seed)
    return [core.Request(rid=i, prompt_len=int(rng.integers(lo, hi)),
                         max_new_tokens=int(rng.integers(new_lo, new_hi)),
                         arrival=0.0, task_type=getattr(core.TaskType, task))
            for i in range(n)]


def _mixed(core, spec_cls, gen):
    """``tests/test_torch_engine.py``'s paged mixed workload: 10
    requests clamped to a 256-token window, all arriving at 0."""
    reqs = gen(spec_cls(dataset="mixed", rps=1e6, n_requests=10, seed=0,
                        max_model_len=256,
                        task_type=core.TaskType.OFFLINE))
    for r in reqs:
        r.max_new_tokens = min(r.max_new_tokens, 6)
        r.prompt_len = min(r.prompt_len, 256 - 16)
        r.arrival = 0.0
    return reqs


# pool -> (config args, engine args, workload of a core module); the
# workloads and engines of tests/test_torch_engine.py
WORKLOADS = {
    "contiguous": (dict(max_seq_len=128), dict(slots=4),
                   lambda core, *_: _uniform(core, 10, 0, 8, 48, 2, 8,
                                             "ONLINE")),
    "paged": (dict(max_seq_len=256), dict(slots=6, paged=True,
                                          page_size=32),
              _mixed),
    "rwkv": (dict(max_seq_len=128), dict(slots=4, chunk=16),
             lambda core, *_: _uniform(core, 8, 5, 8, 60, 2, 7, "OFFLINE")),
}


def _serve(core, engine_cls, cfg, model, reqs, *, slots, paged=False,
           page_size=128, chunk=None, **engine_kw):
    """Serve ``reqs``; returns ({rid: token ids}, engine)."""
    budget = core.MemoryBudget(hbm_bytes_per_device=2 ** 30, n_devices=1,
                               weight_bytes=0)
    sched = core.BucketServeScheduler(cfg, budget, core.SchedulerConfig(
        max_batch=slots, memory_model="paged" if paged else "sum",
        page_size=page_size))
    eng = engine_cls(cfg, model, sched, max_slots=slots,
                     cache_len=cfg.max_seq_len, paged=paged,
                     page_size=page_size, chunk_tokens=chunk, **engine_kw)
    eng.submit(reqs)
    assert len(eng.run(max_wall_s=300)) == len(reqs)
    for r in reqs:
        assert len(eng.outputs[r.rid]) == r.max_new_tokens
    return {r.rid: list(eng.outputs[r.rid]) for r in reqs}, eng


def _jax_ids(pool):
    """The JAX engine's ids on ``pool``'s workload, and the same weights
    for the port (JAX is imported here: the card's machine has none)."""
    import jax
    import repro.core as jcore
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core.engine import ServingEngine as JaxEngine
    from repro.data.workload import WorkloadSpec as JaxSpec
    from repro.data.workload import generate as jax_generate
    from repro.models import transformer as jtfm
    from repro_torch import bridge
    cfg_args, eng_args, make = WORKLOADS[pool]
    jcfg = jax_smoke_config(ARCH[pool], **cfg_args)
    params = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    ids, _ = _serve(jcore, JaxEngine, jcfg, params,
                    make(jcore, JaxSpec, jax_generate), **eng_args)
    tcfg = get_smoke_config(ARCH[pool], **cfg_args)
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                     device="cpu")
    return ids, tcfg, model


def _storage(be):
    """Addresses a capture holds: ``next_tok``, ``pos``, the block
    tables and every pool leaf."""
    ptrs = {"next_tok": be.next_tok.data_ptr(),
            "pos": be.pool_cache["pos"].data_ptr()}
    if "block_tables" in be.pool_cache:
        ptrs["block_tables"] = be.pool_cache["block_tables"].data_ptr()
    for gi, slots in enumerate(be.pool_cache["groups"]):
        for j, slot in enumerate(slots):
            for k, leaf in slot.items():
                ptrs[(gi, j, k)] = leaf.data_ptr()
    return ptrs


# ------------------------------------------------------ pos in place ------
def _cache(pool, cfg, B):
    if pool == "paged":
        cache = ttfm.init_paged_cache(cfg, B, 64, B * 4 + 1, 16,
                                      device="cpu")
        cache["block_tables"].copy_(
            torch.arange(B * 4, dtype=torch.int32).reshape(B, 4))
        return cache, dict(page_size=16, paged_len=64)
    return ttfm.init_cache(cfg, B, 64, device="cpu"), {}


@pytest.mark.parametrize("pool", ["contiguous", "paged", "rwkv"])
def test_decode_step_advances_pos_in_place(pool):
    """The step returns the dict it was given, ``pos`` the same tensor
    with the same storage and one more in every row; a prefilled cache's
    ``pos`` is a copy of ``lengths``, which the steps leave alone."""
    cfg = get_smoke_config(ARCH[pool], max_seq_len=64)
    model = ttfm.init_params(cfg, seed=0, device="cpu")
    cache, kw = _cache(pool, cfg, 3)
    cache["pos"].copy_(torch.tensor([5, 0, 17], dtype=torch.int32))
    pos = cache["pos"]
    ptr = pos.data_ptr()
    tok = torch.tensor([1, 2, 3], dtype=torch.int32)
    for step in range(1, 4):
        logits, out = ttfm.decode_step(cfg, model, tok, cache, **kw)
        assert out is cache and out["pos"] is pos
        assert pos.data_ptr() == ptr
        assert pos.tolist() == [5 + step, step, 17 + step]
        assert logits.shape == (3, cfg.vocab_size)
    lens = torch.tensor([7, 3, 5], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (3, 7), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    _, pre = ttfm.prefill(cfg, model, toks, lens, cache_len=64)
    assert pre["pos"].data_ptr() != lens.data_ptr()
    if pool != "paged":
        ttfm.decode_step(cfg, model, tok, pre)
        assert pre["pos"].tolist() == [8, 4, 6]
        assert lens.tolist() == [7, 3, 5]


# ------------------------------------------- engine storage and ids ------
@pytest.mark.parametrize("pool", ["contiguous", "paged", "rwkv"])
def test_decode_iter_keeps_storage_and_matches_jax_engine(pool):
    """Every decode iteration of a served workload leaves the pool's
    storage where the engine made it (so a captured graph stays valid),
    and the ids equal the JAX engine's."""
    want, cfg, model = _jax_ids(pool)
    cfg_args, eng_args, make = WORKLOADS[pool]
    seen, steps = [], []

    class Watched(ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            be = self.backend
            seen.append((be.pool_cache, _storage(be)))
            inner = be.decode_iter

            def decode_iter(*args):
                out = inner(*args)
                steps.append(_storage(be))
                assert be.pool_cache is seen[0][0]
                return out
            be.decode_iter = decode_iter
    ids, eng = _serve(tcore, Watched, cfg, model,
                      make(tcore, WorkloadSpec, generate), device="cpu",
                      **eng_args)
    assert eng.backend.decode_graph is None       # eager on the CPU
    assert steps and all(s == seen[0][1] for s in steps)
    assert ids == want


# ------------------------------------------------------ the keyword -----
def test_decode_graph_true_on_the_cpu_raises():
    cfg = get_smoke_config("qwen3-14b", max_seq_len=64)
    model = ttfm.init_params(cfg, seed=0, device="cpu")
    sched = tcore.BucketServeScheduler(
        cfg, tcore.MemoryBudget(2 ** 30, 1, 0), tcore.SchedulerConfig())
    with pytest.raises(ValueError, match="decode_graph=True"):
        ServingEngine(cfg, model, sched, device="cpu", decode_graph=True)
    with pytest.raises(ValueError, match="decode_graph=True"):
        TorchEngineBackend(cfg, model, device="cpu", paged=True,
                           page_size=16, decode_graph=True)
    with pytest.raises(ValueError, match="CUDA device"):
        DecodeGraph(lambda: None, "cpu")
    for flag in (None, False):
        be = TorchEngineBackend(cfg, model, device="cpu", decode_graph=flag)
        assert be.decode_graph is None


# ---------------------------------------------------- count bookkeeping --
class StandInGraph:
    """``torch.cuda.CUDAGraph``'s surface: a replay runs no Python."""

    def __init__(self):
        self.calls = []

    def capture_begin(self):
        self.calls.append("begin")

    def capture_end(self):
        self.calls.append("end")

    def replay(self):
        self.calls.append("replay")


def test_decode_graph_counts_each_replay_as_its_captured_launches():
    """The warm-up and the capture leave the counts and plans as they
    were; each replay adds the capture's launches and sets its plans;
    the steps use arrival counters of the graph's own."""
    dev = torch.device("cpu")
    plan = DecodePlan(4, 256, "tensor_core")
    runtime.reset_launch_counts()
    runtime.launch_counts["flash_prefill"] = 5
    runtime.prefill_body_counts["tensor_core"] = 5
    before = runtime.count_state()
    shared = runtime.arrival_counters(dev, 64)
    buffers = []

    def step():
        runtime.launch_counts["paged_flash_decode"] += 3
        runtime.launch_counts["wkv6"] += 2
        runtime.decode_plans["paged_flash_decode"] = plan
        buffers.append(runtime.arrival_counters(dev, 2048))

    try:
        g = DecodeGraph(step, dev, graph=StandInGraph())
        assert len(buffers) == DecodeGraph.WARMUP + 1
        assert g.graph.calls == ["begin", "end"]
        assert runtime.count_state() == before
        assert all(b is buffers[0] for b in buffers)
        assert buffers[0] is not shared and buffers[0].numel() >= 2048
        assert runtime.arrival_counters(dev, 64) is shared
        for k in range(1, 4):
            g.replay()
            assert runtime.launch_counts == {
                "flash_prefill": 5, "paged_flash_decode": 3 * k,
                "flash_decode": 0, "wkv6": 2 * k,
                "paged_flash_decode_int8": 0, "flash_decode_int8": 0,
                "wkv6_bwd": 0}
            assert runtime.prefill_body_counts == {"tensor_core": 5,
                                                   "cuda_core": 0}
            assert runtime.decode_plans == {
                "flash_decode": None, "paged_flash_decode": plan,
                "flash_decode_int8": None, "paged_flash_decode_int8": None}
        assert g.replays == 3 and len(buffers) == DecodeGraph.WARMUP + 1
        assert g.graph.calls == ["begin", "end"] + ["replay"] * 3
        assert g.pool_bytes == 0 and g.capture_seconds >= 0
    finally:
        runtime.reset_launch_counts()


def test_failed_capture_raises_and_ends_the_capture():
    """A step that fails under capture raises out of the constructor (no
    eager fallback) after the capture was ended, and leaves the counts as
    they were."""
    graph = StandInGraph()
    calls = []
    runtime.reset_launch_counts()
    runtime.launch_counts["wkv6"] = 7
    before = runtime.count_state()

    def step():
        calls.append(len(graph.calls))
        if graph.calls == ["begin"]:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
    with pytest.raises(RuntimeError, match="capturing"):
        DecodeGraph(step, "cpu", graph=graph)
    assert graph.calls == ["begin", "end"]
    assert calls == [0] * DecodeGraph.WARMUP + [1]
    assert runtime.count_state() == before
    runtime.reset_launch_counts()


# ------------------------------------------------------ on the card -----
@needs_cuda
@pytest.mark.parametrize("pool", ["contiguous", "paged", "rwkv"])
def test_cuda_graph_ids_equal_eager_and_cpu(pool):
    """Smoke f32: the engine with its decode graph gives the ids of the
    same engine run eagerly on the card and of the CPU, with the same
    launch counts as the eager run and one replay a decode step."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg_args, eng_args, make = WORKLOADS[pool]
        cfg = get_smoke_config(ARCH[pool], **cfg_args)
        cpu_model = ttfm.init_params(cfg, seed=0, device="cpu")
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
        ids, counts = {}, {}
        for label, model, kw in (
                ("cpu", cpu_model, dict(device="cpu")),
                ("eager", gpu_model, dict(device="cuda", decode_graph=False)),
                ("graph", gpu_model, dict(device="cuda"))):
            runtime.reset_launch_counts()
            ids[label], eng = _serve(tcore, ServingEngine, cfg, model,
                                     make(tcore, WorkloadSpec, generate),
                                     **kw, **eng_args)
            torch.cuda.synchronize()
            counts[label] = runtime.count_state()
            g = eng.backend.decode_graph
            assert (g is not None) == (label == "graph")
            if g is not None:
                decode = (counts[label][0][0]["flash_decode"]
                          + counts[label][0][0]["paged_flash_decode"]
                          + counts[label][0][0]["wkv6"])
                assert g.replays > 0 and decode > 0
        assert ids["graph"] == ids["eager"] == ids["cpu"]
        assert counts["graph"] == counts["eager"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
        runtime.reset_launch_counts()
