"""Rank bodies of the port's multi-rank tests: each rank of a (data,
model) mesh runs the port's sharded paths on inputs the parent wrote
(numpy, from a seed) and rank 0 writes the results back as ``.npy``
files.  ``tests/test_torch_distributed.py`` runs them on 8 CPU gloo
ranks (2, 4) against the JAX package; ``tests/test_torch_distributed_
cuda.py`` on 4 cards (2, 2) over NCCL against the port's own unsharded
runs.  The ``engine_*`` cases serve a workload through the engine under
a mesh (rank 0 drives, the other ranks answer its commands) on a mesh of
the case's own shape over the same ranks, and rank 0 writes the token
ids, the formed batches and the run's counters as JSON;
``tests/test_torch_serve_mesh.py`` runs them on 4 CPU gloo ranks.  This
module imports the port and torch only (never JAX or the reference
package): the spawned ranks import it by name."""
from __future__ import annotations

import json
import os
import sys
import time
import traceback

import numpy as np
import torch


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _cfg(arch, **kw):
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch, **kw)


class Json(dict):
    """A case's result written as JSON (token ids, batches, counters)."""


class Rank:
    """One rank's view: its mesh, its device and the inputs' directory."""

    def __init__(self, d, mesh, dev):
        self.d, self.mesh, self.dev = d, mesh, dev
        self.model_size = mesh.size("model")
        self._meshes = {tuple(mesh.shape.values()): mesh}

    def mesh_of(self, data, model, pod=1):
        """A (pod, data, model) host mesh over this run's ranks, made at
        its first use (every rank runs the cases in the same order)."""
        from repro_torch.launch.mesh import make_host_mesh
        key = (data, model) if pod == 1 else (pod, data, model)
        if key not in self._meshes:
            self._meshes[key] = make_host_mesh(data, model,
                                               device=self.dev.type, pod=pod)
        return self._meshes[key]

    def t(self, a):
        return torch.from_numpy(np.array(a)).to(self.dev)

    def npy(self, name):
        return self.t(np.load(os.path.join(self.d, name)))

    def model(self, cfg, name):
        from repro_torch import bridge
        flat = _load(os.path.join(self.d, name))
        return bridge.params_from_numpy(bridge.unflatten(flat), cfg,
                                        device=self.dev)


def forward_cfg(model_size):
    """yi-6b with Hkv not dividing over ``model`` but its projection
    cut (a kv head split across two ranks: the gather path)."""
    return _cfg("yi-6b", n_kv_heads=model_size // 2, n_heads=4)


def kv_cfg(model_size):
    """yi-6b with one kv head a ``model`` rank (a cache cut by head)."""
    return _cfg("yi-6b", n_kv_heads=model_size, n_heads=4, max_seq_len=64)


def seq_cfg(model_size):
    """yi-6b whose Hkv does not divide over ``model``, 2048 slots (a
    cache cut along the sequence)."""
    return _cfg("yi-6b", n_kv_heads=model_size // 2, max_seq_len=2048)


EP_CFG = dict(n_experts=4, top_k=2, capacity_factor=4.0)


def case_forward(r, out):
    """The gather path's forward, batch 4 over ``data``."""
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import partition
    cfg = forward_cfg(r.model_size)
    model = r.model(cfg, "forward_params.npz")
    tok = r.npy("forward_tok.npy")
    whole = tfm.forward(cfg, model, tok)
    partition.shard_model(cfg, model, r.mesh)
    out["forward"] = tfm.forward(cfg, model, tok, mesh=r.mesh)
    out["forward_port"] = whole


def _stacked(tree):
    from repro_torch import bridge
    return {k: bridge.stack(v) for k, v in tree.items()}


def case_ep_train(r, out):
    """qwen3-moe (4 experts, top 2, capacity 4): one EP train step under
    the mesh against the port's local step."""
    from repro_torch import bridge
    from repro_torch.sharding import partition
    from repro_torch.train import optimizer, train_loop
    cfg = _cfg("qwen3-moe-235b-a22b", **EP_CFG)
    batch = {"tokens": r.npy("ep_tok.npy")}
    opt_cfg = optimizer.AdamWConfig(lr=1e-3, total_steps=4)

    local = r.model(cfg, "ep_params.npz")
    step = train_loop.make_train_step(cfg, opt_cfg, moe_impl="local")
    local, _, m_local = step(local, optimizer.init(bridge.leaves(local)),
                             batch)

    model = partition.shard_model(cfg, r.model(cfg, "ep_params.npz"),
                                  r.mesh)
    step = train_loop.make_train_step(cfg, opt_cfg, moe_impl="ep",
                                      mesh=r.mesh)
    model, _, m_ep = step(model, optimizer.init(bridge.leaves(model)),
                          batch)
    whole = partition.unshard_leaves(bridge.leaves(model),
                                     model.shard_specs, r.mesh)
    out["ep_loss"] = torch.stack([m_ep["loss"], m_local["loss"]])
    out["ep_params"] = _stacked(whole)
    out["ep_params_port"] = _stacked(bridge.leaves(local))


def case_decode_kv(r, out):
    """A whole prefill's cache cut by kv head (``shard_cache``), one
    decode step under the mesh; and the mesh's own prefill (its cache
    the same slice)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import partition
    cfg = kv_cfg(r.model_size)
    tok = r.npy("kv_tok.npy")
    whole = r.model(cfg, "kv_params.npz")
    logits, cache = tfm.prefill(cfg, whole, tok, cache_len=64)
    nt = logits.argmax(-1).to(torch.int32)
    model = partition.shard_model(cfg, r.model(cfg, "kv_params.npz"),
                                  r.mesh)
    scache = partition.shard_cache(cfg, cache, r.mesh, tok.shape[0])
    plog, pcache = tfm.prefill(cfg, model, tok, cache_len=64, mesh=r.mesh)
    out["kv_cache_diff"] = torch.stack([
        (pcache["groups"][0][0][n] - scache["groups"][0][0][n]).abs().max()
        for n in ("k", "v")])
    out["kv_prefill"] = plog
    out["kv_prefill_port"] = logits
    out["kv_decode"] = tfm.decode_step(cfg, model, nt, scache,
                                       mesh=r.mesh)[0]
    out["kv_decode_port"] = tfm.decode_step(cfg, whole, nt, cache)[0]


def case_dist_decode(r, out):
    """``distributed_decode_attention`` over a sequence-cut (B 2, S 64)
    cache, pos [40, 17], and a ring with pos [130, 31]; the port's
    unsharded decode beside it."""
    from repro_torch.kernels import ops
    from repro_torch.sharding.rows import gather_rows, local_rows
    from repro_torch.models import attention
    from repro_torch.sharding import partition
    z = _load(os.path.join(r.d, "dd.npz"))
    q, kc, vc = (r.t(z[n]) for n in ("q", "kc", "vc"))
    B, S = q.shape[0], kc.shape[1]
    mesh = r.mesh
    spec = (partition.batch_axes(mesh, B), "model", None, None)
    k_loc, v_loc = (partition.shard(t, spec, mesh) for t in (kc, vc))
    for name, pos, window in (("dd", z["pos"], 0), ("dd_ring", z["pos2"], S)):
        pos = r.t(pos)
        got = attention.distributed_decode_attention(
            local_rows(q, mesh, B), k_loc, v_loc, local_rows(pos, mesh, B),
            mesh, window=window)
        out[name] = gather_rows(got, mesh, B)
        out[name + "_port"] = ops.flash_decode(q, kc, vc, pos,
                                               ring=bool(window))


def case_seq_decode(r, out):
    """A 2048-slot cache cut along the sequence (2048 / model slots a
    model rank); prefill and three decode steps under the mesh (fed the
    ids of ``seq_next.npy``), f32 and int8, and the port's unsharded
    runs."""
    import dataclasses
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import partition
    cfg = seq_cfg(r.model_size)
    tok, lens = r.npy("seq_tok.npy"), r.npy("seq_lens.npy")
    nexts = r.npy("seq_next.npy")
    for tag, c in (("seq", cfg),
                   ("seq_int8", dataclasses.replace(cfg,
                                                    kv_cache_dtype="int8"))):
        model = partition.shard_model(c, r.model(c, "seq_params.npz"),
                                      r.mesh)
        logits, cache = tfm.prefill(c, model, tok, lens, cache_len=2048,
                                    mesh=r.mesh)
        assert cache["seq_sharded"], "the 2048-slot cache is not seq-cut"
        assert cache["groups"][0][0]["k"].shape[2] == 2048 // r.model_size
        steps = [logits]
        for nt in nexts:
            lg, cache = tfm.decode_step(c, model, nt, cache, mesh=r.mesh)
            steps.append(lg)
        out[tag] = torch.stack(steps)
        whole = r.model(c, "seq_params.npz")
        logits, cache = tfm.prefill(c, whole, tok, lens, cache_len=2048)
        steps = [logits]
        for nt in nexts:
            lg, cache = tfm.decode_step(c, whole, nt, cache)
            steps.append(lg)
        out[tag + "_port"] = torch.stack(steps)


# the recurrent, cross-attention and encoder families under model > 1:
# each one's forward (ragged lengths; the VLM with its cross gates set)
FAMILY_ARCHS = ("rwkv6-3b", "recurrentgemma-2b", "llama-3.2-vision-90b",
                "hubert-xlarge")
FAMILY_B, FAMILY_T = 4, 24
FAMILY_LENS = np.array([24, 19, 13, 22], np.int32)
# recurrentgemma's prefill over a 96-slot cache (its 64-slot local ring
# wrapped by the longer rows) and three decode steps
REC_ARCH, REC_LEN = "recurrentgemma-2b", 96
REC_LENS = np.array([80, 70, 33, 12], np.int32)
# one train step (loss and every gradient) of each family under the mesh
TRAIN_ARCHS = (REC_ARCH,) + tuple(a for a in FAMILY_ARCHS if a != REC_ARCH)
# qwen3-moe (4 experts, top 2) and llama4-scout (4 experts, top 1, a
# shared expert) at the configs' capacity factor 1.25: rows cut over
# data (B 4) and whole on every data rank (B 3)
MOE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e")
MOE_BS, MOE_T = (4, 3), 16


def family_inputs(cfg, rng):
    """A family case's numpy inputs, keyed as ``forward`` takes them:
    token ids (an encoder's frame embeddings instead, normal times
    0.02), a VLM's vision embeddings, ragged lengths."""
    B, T = FAMILY_B, FAMILY_T
    x = {"lengths": FAMILY_LENS}
    if cfg.is_encoder:
        x["embeds"] = (rng.standard_normal((B, T, cfg.d_model))
                       * 0.02).astype(np.float32)
    else:
        x["tokens"] = rng.integers(0, cfg.vocab_size, (B, T)).astype(
            np.int32)
    if cfg.arch_type == "vlm":
        x["vision_embeds"] = (rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_vision)) * 0.02).astype(
                np.float32)
    return x


def case_families(r, out):
    """Each family's forward under the mesh, and the port's unsharded
    forward on the same weights and inputs."""
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import partition
    for arch in FAMILY_ARCHS:
        cfg, name = _cfg(arch), "family_" + arch
        x = {k: r.t(v) for k, v in
             _load(os.path.join(r.d, name + "_in.npz")).items()}
        model = r.model(cfg, name + ".npz")
        out[name + "_port"] = tfm.forward(cfg, model, **x)
        partition.shard_model(cfg, model, r.mesh)
        out[name] = tfm.forward(cfg, model, mesh=r.mesh, **x)
        layout = {"cut": sorted(k for k, spec in model.shard_specs.items()
                                if "model" in spec)}
        if cfg.has_decode:
            cache = tfm.init_cache(cfg, FAMILY_B, 32, device=r.dev,
                                   mesh=r.mesh)
            layout["leaves"] = [{k: list(v.shape) for k, v in slot.items()}
                                for slot in cache["groups"][0]]
        out[name + "_layout"] = Json(layout)


def case_rec_decode(r, out):
    """recurrentgemma's prefill and three decode steps (fed the ids of
    ``rec_next.npy``) under the mesh and unsharded."""
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import partition
    cfg = _cfg(REC_ARCH)
    tok, lens = r.npy("rec_tok.npy"), r.t(REC_LENS)
    nexts = r.npy("rec_next.npy")
    whole = r.model(cfg, "rec_params.npz")
    model = partition.shard_model(cfg, r.model(cfg, "rec_params.npz"),
                                  r.mesh)
    for tag, m, mesh in (("rec", model, r.mesh), ("rec_port", whole, None)):
        logits, cache = tfm.prefill(cfg, m, tok, lens, cache_len=REC_LEN,
                                    mesh=mesh)
        steps = [logits]
        for nt in nexts:
            logits, cache = tfm.decode_step(cfg, m, nt, cache, mesh=mesh)
            steps.append(logits)
        out[tag] = torch.stack(steps)


def _loss_and_grads(cfg, model, batch, mesh=None):
    """The train step's loss and gradients (before the optimizer): under
    a mesh summed over the batch axes as the step sums them, and
    gathered whole."""
    from repro_torch import bridge
    from repro_torch.sharding import partition
    from repro_torch.train import train_loop
    model.requires_grad_(True)
    loss, metrics = train_loop.lm_loss(cfg, model, batch, mesh=mesh)
    loss.backward()

    def grad(p):        # zeros where the loss never reached (an encoder's
        return torch.zeros_like(p) if p.grad is None else p.grad  # embed)
    grads = {k: [grad(p) for p in v] if isinstance(v, list) else grad(v)
             for k, v in bridge.leaves(model).items()}
    if mesh is not None:
        cut = {k: {a for e in spec if e is not None
                   for a in ((e,) if isinstance(e, str) else e)}
               for k, spec in model.shard_specs.items()}
        train_loop.sum_grads_over_batch(grads, cut, mesh)
        grads = partition.unshard_leaves(grads, model.shard_specs, mesh)
    return metrics["loss"], _stacked(grads)


def case_train(r, out):
    """Each family's train-step loss and every gradient under the mesh,
    and unsharded."""
    from repro_torch.sharding import partition
    for arch in TRAIN_ARCHS:
        cfg, name = _cfg(arch), "train_" + arch
        batch = {k: r.t(v) for k, v in
                 _load(os.path.join(r.d, name + "_batch.npz")).items()}
        out[name + "_loss"], out[name + "_grads"] = _loss_and_grads(
            cfg, partition.shard_model(cfg, r.model(cfg, name + ".npz"),
                                       r.mesh), batch, r.mesh)
        out[name + "_loss_port"], out[name + "_grads_port"] = \
            _loss_and_grads(cfg, r.model(cfg, name + ".npz"), batch)


POD_MESH = dict(pod=2, data=2, model=2)


def case_pod_train(r, out):
    """The train step's loss and every gradient on a (pod 2, data 2,
    model 2) mesh over the same ranks: recurrentgemma-2b, and qwen3-moe
    (4 experts, top 2) whose experts are cut over ``data`` and replicated
    over ``pod``; the batch of 4 rows one a (pod, data) rank."""
    from repro_torch.sharding import partition
    mesh = r.mesh_of(**POD_MESH)
    cfg, name = _cfg(REC_ARCH), "train_" + REC_ARCH
    batch = {k: r.t(v) for k, v in
             _load(os.path.join(r.d, name + "_batch.npz")).items()}
    out["pod_" + name + "_loss"], out["pod_" + name + "_grads"] = \
        _loss_and_grads(cfg, partition.shard_model(
            cfg, r.model(cfg, name + ".npz"), mesh), batch, mesh)
    cfg = _cfg("qwen3-moe-235b-a22b", **EP_CFG)
    batch = {"tokens": r.npy("ep_tok.npy")}
    out["pod_ep_loss"], out["pod_ep_grads"] = _loss_and_grads(
        cfg, partition.shard_model(cfg, r.model(cfg, "ep_params.npz"),
                                   mesh), batch, mesh)
    out["pod_ep_loss_port"], out["pod_ep_grads_port"] = _loss_and_grads(
        cfg, r.model(cfg, "ep_params.npz"), batch)


def case_moe_drop(r, out):
    """``moe_ep`` at capacity 1.25 and the dropless ``"local"`` route of
    ``moe.apply`` on one MoE layer whose experts are cut over data, on
    rows cut over data (B 4) and whole on every data rank (B 3)."""
    from repro_torch.models import moe
    from repro_torch.sharding import partition
    from repro_torch.sharding.rows import gather_rows, local_rows
    for arch in MOE_ARCHS:
        cfg = _cfg(arch)
        model = partition.shard_model(
            cfg, r.model(cfg, f"moe_{arch}.npz"), r.mesh)
        p = model.groups[0][0][0].moe
        assert p.w_gate.shape[0] * r.mesh.size("data") == cfg.n_experts
        for B in MOE_BS:
            x = r.npy(f"moe_{arch}_x{B}.npy")
            xl = local_rows(x, r.mesh, B)
            name = f"moe_{arch}_{B}"
            out[name + "_ep"] = gather_rows(moe.moe_ep(cfg, p, xl, r.mesh),
                                            r.mesh, B)
            out[name + "_local"] = gather_rows(
                moe.apply(cfg, p, xl, "local", r.mesh), r.mesh, B)


CASES = {"forward": case_forward, "ep_train": case_ep_train,
         "decode_kv": case_decode_kv, "dist_decode": case_dist_decode,
         "seq_decode": case_seq_decode, "families": case_families,
         "rec_decode": case_rec_decode, "train": case_train,
         "pod_train": case_pod_train, "moe_drop": case_moe_drop}
# the cases the four cards run against the port's own unsharded runs
CUDA_CASES = ["forward", "ep_train", "decode_kv", "dist_decode",
              "seq_decode"]


# ------------------------------------------------- the engine under a mesh --
# the engine cases' smoke configs: ``kv4`` has one kv head a rank of a
# 4-wide ``model`` axis (kv-head-cut pools), ``kv2`` two kv heads (the
# paged pool whole on each of 4 ``model`` ranks), ``kv1`` one kv head over
# 2048 slots (a contiguous pool cut along the sequence), ``moe``
# qwen3-moe with four kv heads (its 4 experts cut over data > 1),
# ``rwkv`` rwkv6-3b (4 heads) and ``rglru`` recurrentgemma-2b (4 query
# heads over one kv head, a 64-slot local ring)
ENGINE_CFGS = {"kv4": ("qwen3-14b", dict(n_kv_heads=4, max_seq_len=256)),
               "kv2": ("qwen3-14b", dict(n_kv_heads=2, max_seq_len=256)),
               "kv1": ("qwen3-14b", dict(n_kv_heads=1, max_seq_len=2048)),
               "moe": ("qwen3-moe-235b-a22b",
                       dict(n_kv_heads=4, max_seq_len=256)),
               "rwkv": ("rwkv6-3b", dict(max_seq_len=256)),
               "rglru": ("recurrentgemma-2b", dict(max_seq_len=256))}


def engine_cfg(name, get_smoke_config=None):
    """An engine case's config from ``get_smoke_config`` (the port's by
    default; the parent passes the JAX package's)."""
    arch, kw = ENGINE_CFGS[name]
    if get_smoke_config is None:
        return _cfg(arch, **kw)
    return get_smoke_config(arch, **kw)


def _uniform(n, seed, lo, hi, new_lo, new_hi):
    rng = np.random.default_rng(seed)
    return [(i, int(rng.integers(lo, hi)), int(rng.integers(new_lo, new_hi)))
            for i in range(n)]


# (rid, prompt tokens, new tokens) at t = 0, slot-bound on 4 slots; the
# long prompts cross the 512-slot shards of a 2048-slot cache cut four
# ways
ENGINE_LOADS = {"short": _uniform(8, 0, 20, 200, 3, 7),
                "long": [(0, 1100, 4), (1, 340, 5), (2, 760, 3),
                         (3, 560, 4)]}


def load_requests(core, name):
    return [core.Request(rid=rid, prompt_len=p, max_new_tokens=n,
                         arrival=0.0, task_type=core.TaskType.OFFLINE)
            for rid, p, n in ENGINE_LOADS[name]]


def retention_requests(core, generate, spec_cls, cfg, kind):
    """The retention cases' workloads (the reference tests' shapes, cut
    to the smoke window): two shared 96-token system prompts over 8
    requests, or 2 sessions x 3 turns."""
    if kind == "prefix":
        reqs = generate(spec_cls(dataset="alpaca", rps=1e6, n_requests=8,
                                 seed=3, max_model_len=cfg.max_seq_len,
                                 task_type=core.TaskType.OFFLINE,
                                 prefix_groups=2, prefix_tokens=96,
                                 vocab_size=cfg.vocab_size))
        for r in reqs:
            r.max_new_tokens = min(r.max_new_tokens, 4)
            r.prompt_len = min(r.prompt_len, cfg.max_seq_len - 16)
    else:
        reqs = generate(spec_cls(dataset="alpaca", rps=1e6, sessions=2,
                                 turns=3, utterance_tokens=32,
                                 max_new_tokens=4, seed=7,
                                 task_type=core.TaskType.OFFLINE,
                                 max_model_len=cfg.max_seq_len,
                                 vocab_size=cfg.vocab_size))
    for r in reqs:
        r.arrival = 0.0
    return reqs


# case -> (config, workload, mesh, engine options); every case serves on
# 4 slots with the scheduler's batch cap 4 and no page pressure
ENGINE_CASES = {
    "engine_paged_kv_cut": ("kv4", "short", (1, 4),
                            dict(paged=True, page_size=32, chunk_tokens=64)),
    "engine_paged_whole": ("kv2", "short", (1, 4),
                           dict(paged=True, page_size=32, chunk_tokens=64)),
    "engine_contig_data": ("kv4", "short", (2, 2), dict(chunk_tokens=64)),
    "engine_seq_cut": ("kv1", "long", (1, 4), dict(chunk_tokens=256)),
    "engine_prefix": ("kv4", "prefix", (1, 4),
                      dict(paged=True, page_size=32, chunk_tokens=64,
                           prefix_cache=True)),
    "engine_sessions": ("kv4", "sessions", (1, 4),
                        dict(paged=True, page_size=32, chunk_tokens=64,
                             session_ttl=1000.0)),
    "engine_spill": ("kv4", "sessions", (1, 4),
                     dict(paged=True, page_size=32, chunk_tokens=64,
                          session_ttl=0.0, host_pool_tokens=64 * 32)),
    "engine_int8": ("kv4", "short", (1, 4),
                    dict(paged=True, page_size=32, chunk_tokens=64,
                         int8=True)),
    "engine_moe": ("moe", "short", (1, 4),
                   dict(paged=True, page_size=32, chunk_tokens=64)),
    # the paged pool replicated over data, prefill rows cut over data
    "engine_paged_data": ("kv4", "short", (2, 2),
                          dict(paged=True, page_size=32, chunk_tokens=64)),
    "engine_paged_data4": ("kv2", "short", (4, 1),
                           dict(paged=True, page_size=32, chunk_tokens=64)),
    "engine_prefix_data": ("kv4", "prefix", (2, 2),
                           dict(paged=True, page_size=32, chunk_tokens=64,
                                prefix_cache=True)),
    "engine_sessions_data": ("kv4", "sessions", (2, 2),
                             dict(paged=True, page_size=32, chunk_tokens=64,
                                  session_ttl=1000.0)),
    "engine_spill_data": ("kv4", "sessions", (2, 2),
                          dict(paged=True, page_size=32, chunk_tokens=64,
                               session_ttl=0.0, host_pool_tokens=64 * 32)),
    "engine_int8_data": ("kv4", "short", (2, 2),
                         dict(paged=True, page_size=32, chunk_tokens=64,
                              int8=True)),
    # four cards: the sequence-cut pool with its slots over data too
    "engine_seq_cut_22": ("kv1", "long", (2, 2), dict(chunk_tokens=256)),
    # MoE experts cut over data (2 and 1 a rank), served with
    # moe_impl="local" through the dispatch that drops nothing
    "engine_moe_data": ("moe", "short", (2, 2),
                        dict(paged=True, page_size=32, chunk_tokens=64)),
    "engine_moe_data4": ("moe", "short", (4, 1), dict(chunk_tokens=64)),
    # the recurrent blocks tensor-parallel over model
    "engine_rwkv_model": ("rwkv", "short", (1, 4), dict(chunk_tokens=64)),
    "engine_rglru_model": ("rglru", "short", (2, 2),
                           dict(paged=True, page_size=32, chunk_tokens=64)),
}
# the 4 CPU gloo ranks' cases (tests/test_torch_serve_mesh.py) and the
# four cards' (tests/test_torch_distributed_cuda.py: the kv-head-cut
# paged pool, the sequence-cut pool, the contiguous pool and the paged
# pool with sessions, both with prefill rows cut over data, qwen3-moe's
# experts cut over data and rwkv6-3b over model)
CPU_ENGINE_CASES = [c for c in ENGINE_CASES if c != "engine_seq_cut_22"]
CUDA_ENGINE_CASES = ["engine_paged_kv_cut", "engine_seq_cut_22",
                     "engine_contig_data", "engine_sessions_data",
                     "engine_moe_data", "engine_rwkv_model"]
# the cases whose paged pool is replicated over data > 1
DATA_PAGED_CASES = [c for c, (_, _, shape, opts) in ENGINE_CASES.items()
                    if shape[0] > 1 and opts.get("paged")]


def engine_requests(core, cfg, load, generate=None, spec_cls=None):
    if load in ENGINE_LOADS:
        return load_requests(core, load)
    return retention_requests(core, generate, spec_cls, cfg, load)


def serve_engine(core, engine_cls, cfg, model, reqs, *, mesh=None,
                 device="cpu", slots=4, on_engine=None, **opts):
    """Serve ``reqs`` through ``engine_cls`` (the port's or, in the
    parent, the JAX package's) under the BucketServe scheduler, recording
    its formed batches; ``on_engine`` is called with the engine before
    it runs.  Returns (engine, formed) on the driver (or without a
    mesh), (engine, None) on a worker rank."""
    paged = opts.get("paged", False)
    opts = {k: v for k, v in opts.items() if k != "int8"}

    class Recording(core.BucketServeScheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.formed = []

        def next_prefill_batch(self, now):
            batch = super().next_prefill_batch(now)
            if batch is not None:
                self.formed.append([r.rid for r in batch.requests])
            return batch
    sched = Recording(cfg, core.MemoryBudget(
        hbm_bytes_per_device=2 ** 30, n_devices=1, weight_bytes=0),
        core.SchedulerConfig(max_batch=slots,
                             memory_model="paged" if paged else "sum",
                             page_size=opts.get("page_size", 128)))
    kw = dict(max_slots=slots, cache_len=cfg.max_seq_len, **opts)
    if mesh is not None:
        kw["mesh"] = mesh
    if device is not None:
        kw["device"] = device
    eng = engine_cls(cfg, model, sched, **kw)
    if on_engine is not None:
        on_engine(eng)
    eng.submit(reqs)
    done = eng.run(max_wall_s=120)
    if getattr(eng.backend, "worker", False):
        return eng, None
    assert len(done) == len(reqs), f"served {len(done)}/{len(reqs)}"
    return eng, sched.formed


def engine_summary(eng, reqs, formed) -> dict:
    """What the tests hold: ids, formed batches, retention counters and
    the pool's balance."""
    be, res = eng.backend, eng.result
    out = {"ids": {str(r.rid): [int(t) for t in eng.outputs[r.rid]]
                   for r in reqs},
           "formed": formed,
           "counts": {k: getattr(res, k) for k in (
               "prefix_hits", "session_hits", "spilled_pages",
               "restored_pages", "preempt_events")}}
    if be.paged:
        a = be.alloc
        out["pages"] = [a.free_pages(), a.live_pages(), a.n_pages]
        if be.retention is not None:
            be.retention.clear(a)
        out["pages_after_clear"] = [a.free_pages(), a.n_pages,
                                    a.free_host_slots(), a.host_pages]
    return out


def record_job_rows(be, log):
    """Append (B, rows of the batch cache the job's prefill writes on
    this rank, read off the first block's first leaf) to ``log`` at
    each job's start (``_d_begin_job``, which every rank runs)."""
    begin = be._d_begin_job

    def wrapped(toks, lens, seed):
        got = begin(toks, lens, seed)
        B = toks.shape[0]
        leaf = next(iter(be._batch_view(B)["groups"][0][0].values()))
        log.append([B, leaf.shape[1]])
        return got
    be._d_begin_job = wrapped


def pool_checksums(be):
    """A checksum of each attention leaf of the paged pool over every
    page but the trash page (two dead rows may write one place of it,
    whose winner a card does not fix): its bits as integers, weighted by
    position, summed in int64."""
    from repro_torch.models.config import BLOCK_ATTN, BLOCK_MOE
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    sums = []
    for (pattern, _), slots in zip(be.cfg.block_groups(),
                                   be.pool_cache["groups"]):
        for btype, slot in zip(pattern, slots):
            if btype not in (BLOCK_ATTN, BLOCK_MOE):
                continue
            for k in sorted(slot):
                x = slot[k][:, :be.n_pages].contiguous()
                x = x.view(bits[x.element_size()]).flatten().long().cpu()
                w = torch.arange(x.numel()) % 65521 + 1
                sums.append(int((x * w).sum()))
    return sums


def replica_checksums(be, mesh):
    """Every rank's pool checksums (``pool_checksums``) by its ``model``
    coordinate, in ``data`` order: all-gathered over the run's ranks."""
    import torch.distributed as dist
    mine = (mesh.coord("data"), mesh.coord("model"), pool_checksums(be))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    by_model = {}
    for d, m, sums in sorted(every):
        by_model.setdefault(str(m), []).append(sums)
    return by_model


def _kv_shape(cache):
    """The shape of the first attention block's K leaf (None for a
    config with none)."""
    for slots in cache["groups"]:
        for slot in slots:
            if "k" in slot:
                return list(slot["k"].shape)
    return None


def case_engine(name):
    def run(r, out):
        import dataclasses
        import repro_torch.core as tcore
        from repro_torch.core.engine import ServingEngine
        from repro_torch.data.workload import WorkloadSpec, generate
        from repro_torch.sharding import partition
        cname, load, shape, opts = ENGINE_CASES[name]
        cfg = engine_cfg(cname)
        if opts.get("int8"):
            cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        mesh = r.mesh_of(*shape)
        model = partition.shard_model(
            cfg, r.model(cfg, f"engine_{cname}.npz"), mesh)
        reqs = engine_requests(tcore, cfg, load, generate, WorkloadSpec)
        jobs = []
        eng, formed = serve_engine(
            tcore, ServingEngine, cfg, model, reqs, mesh=mesh, device=r.dev,
            on_engine=lambda e: record_job_rows(e.backend, jobs), **opts)
        replicas = replica_checksums(eng.backend, mesh) \
            if name in DATA_PAGED_CASES else None
        if formed is not None:
            be = eng.backend
            summary = engine_summary(eng, reqs, formed)
            summary["layout"] = {
                "k": _kv_shape(be.pool_cache),
                "batch_k": _kv_shape(be._batch_cache),
                "seq_sharded": bool(be.pool_cache.get("seq_sharded")),
                "slots": [be._slot_lo, be._slot_n], "jobs": jobs}
            summary["commands"] = dict(be.channel.sent)
            if replicas is not None:
                summary["replicas"] = replicas
            out[name] = Json(summary)
    return run


ENGINE = {name: case_engine(name) for name in ENGINE_CASES}


def _reference_opts(case) -> dict:
    """The engine options of ``case``'s run without a mesh: its own,
    its retention off where the case compares against a cold run."""
    _, load, _, opts = ENGINE_CASES[case]
    if load in ("prefix", "sessions"):
        opts = {k: v for k, v in opts.items() if k not in (
            "prefix_cache", "session_ttl", "host_pool_tokens")}
    return opts


def port_reference_key(case) -> tuple:
    """What ``port_engine_reference`` runs for ``case``: cases with the
    same key share one run."""
    cname, load = ENGINE_CASES[case][:2]
    return cname, load, sorted(_reference_opts(case).items())


def port_engine_reference(d, case, device="cpu") -> dict:
    """The port's engine without a mesh on ``case``'s config, weights
    (``engine_<config>.npz`` in ``d``) and workload, its retention off
    where the case compares against a cold run."""
    import dataclasses
    import repro_torch.core as tcore
    from repro_torch import bridge
    from repro_torch.core.engine import ServingEngine
    from repro_torch.data.workload import WorkloadSpec, generate
    cname, load = ENGINE_CASES[case][:2]
    opts = _reference_opts(case)
    cfg = engine_cfg(cname)
    if opts.get("int8"):
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    model = bridge.params_from_numpy(
        bridge.unflatten(_load(os.path.join(d, f"engine_{cname}.npz"))),
        cfg, device=device)
    reqs = engine_requests(tcore, cfg, load, generate, WorkloadSpec)
    eng, formed = serve_engine(tcore, ServingEngine, cfg, model, reqs,
                               device=device, **opts)
    return engine_summary(eng, reqs, formed)


def write_port_inputs(d, model_size: int) -> None:
    """The cases' inputs made by the port alone (seeded ``init_params``
    weights, numpy tokens), for runs where JAX is not installed."""
    from repro_torch import bridge
    from repro_torch.models import transformer as tfm
    rng = np.random.default_rng(0)

    def params(cfg, name, seed=0):
        flat = bridge.flatten(bridge.params_to_numpy(
            tfm.init_params(cfg, seed, device="cpu")))
        np.savez(os.path.join(d, name), **flat)

    def tokens(name, shape):
        np.save(os.path.join(d, name),
                rng.integers(0, 512, shape).astype(np.int32))
    params(forward_cfg(model_size), "forward_params.npz")
    tokens("forward_tok.npy", (4, 32))
    params(_cfg("qwen3-moe-235b-a22b", **EP_CFG), "ep_params.npz")
    tokens("ep_tok.npy", (4, 24))
    params(kv_cfg(model_size), "kv_params.npz")
    tokens("kv_tok.npy", (4, 16))
    B, S, H, Hkv, Dh = 2, 64, 8, 2, 64     # a head dim the kernels take
    np.savez(os.path.join(d, "dd.npz"),
             q=rng.standard_normal((B, 1, H, Dh)).astype(np.float32),
             kc=rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32),
             vc=rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32),
             pos=np.array([40, 17], np.int32),
             pos2=np.array([130, 31], np.int32))
    params(seq_cfg(model_size), "seq_params.npz", seed=1)
    tokens("seq_tok.npy", (4, 600))
    np.save(os.path.join(d, "seq_lens.npy"),
            np.array([600, 100, 530, 20], np.int32))
    tokens("seq_next.npy", (3, 4))
    for name in ENGINE_CFGS:
        params(engine_cfg(name), f"engine_{name}.npz")


def spawn(d, cases, data: int, model: int, device: str,
          seconds: float) -> str:
    """Run ``main`` on ``data * model`` spawned ranks; returns the error
    text of a failed or hung run ("" when every rank finished)."""
    return wait(start(d, cases, data, model, device), d, seconds)


def start(d, cases, data: int, model: int, device: str):
    """Start ``main`` on ``data * model`` spawned ranks (``wait`` joins
    them), so that the parent can work meanwhile."""
    return torch.multiprocessing.start_processes(
        main, args=(d, cases, data, model, device), nprocs=data * model,
        join=False, start_method="spawn")


def wait(ctx, d, seconds: float) -> str:
    """Join the ranks ``start`` spawned; returns the error text of a
    failed or hung run ("" when every rank finished)."""
    deadline = time.monotonic() + seconds
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {seconds} s")
    except Exception as e:          # a rank failed or hung: every rank ends
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        errs = [open(os.path.join(d, f)).read() for f in sorted(os.listdir(d))
                if f.startswith("error_")]
        return f"{e}\n" + "\n".join(errs)
    return ""


def load_output(d, name, err=""):
    """Rank 0's result ``name`` (an array, or a dict of arrays)."""
    path = os.path.join(d, f"out_{name}")
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            return json.load(f)
    if os.path.exists(path + ".npz"):
        return _load(path + ".npz")
    assert os.path.exists(path + ".npy"), f"no {name} from the ranks:\n{err}"
    return np.load(path + ".npy")


def _save(d, name, val):
    if isinstance(val, Json):
        with open(os.path.join(d, f"out_{name}.json"), "w") as f:
            json.dump(val, f)
    elif isinstance(val, dict):
        np.savez(os.path.join(d, f"out_{name}.npz"), **val)
    else:
        np.save(os.path.join(d, f"out_{name}.npy"),
                val.detach().float().cpu().numpy())


def main(rank: int, d: str, cases, data: int = 2, model: int = 4,
         device: str = "cpu") -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    dev = init_distributed(data, model, device, rank=rank,
                           world_size=data * model,
                           init_method="file://" + os.path.join(d, "store"))
    mesh = make_host_mesh(data, model, device=device)
    r = Rank(d, mesh, dev)
    try:
        for name in cases:
            out = {}
            try:
                (CASES.get(name) or ENGINE[name])(r, out)
            except Exception:
                with open(os.path.join(d, f"error_{name}_{rank}.txt"),
                          "w") as f:
                    f.write(traceback.format_exc())
                raise
            if rank == 0:
                for key, val in out.items():
                    _save(d, key, val)
        bad = sorted(m for m in sys.modules if m == "jax"
                     or m.startswith("jax.") or m == "repro"
                     or m.startswith("repro."))
        if bad:
            raise AssertionError(f"rank {rank} imported {bad}")
    finally:
        dist.destroy_process_group()
