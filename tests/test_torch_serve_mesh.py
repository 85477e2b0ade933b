"""The port's engine under a mesh against the JAX engine and the port's
engine without a mesh.

The reference serves under a mesh through the same ``ServingEngine``
(GSPMD keeps the unsharded engine's semantics), so the parent computes
the JAX package's engine on the unsharded smoke weights and the port's
engine without a mesh, f32, with the same scheduler and budget, while 4
gloo ranks of ``tests/torch_dist_ranks.py`` (spawned once for the
module, a ``file://`` store, one torch thread a rank, no JAX imported)
serve the same workloads through the port's engine under meshes (1, 4),
(2, 2) and (4, 1): rank 0 drives and the other ranks answer its
commands.  The cases make each layout occur: a paged pool cut by kv
head, a paged pool whole on every ``model`` rank, a contiguous pool with
its slots over ``data``, a contiguous pool of 2048 slots cut along the
sequence under chunked prefill, prefix hits, session resumes, the spill
tier, an int8 paged pool and qwen3-moe; the paged pool replicated
over ``data`` (plain at (2, 2) and (4, 1), with prefix hits, session
resumes, the spill tier and int8 at (2, 2)), whose replicas must hold
the same bits after the run, with prefill rows cut over ``data``;
qwen3-moe with its experts cut over ``data`` at (2, 2) (paged) and
(4, 1) (contiguous, one expert a rank), served with ``moe_impl="local"``
through the dispatch that drops nothing, on jobs cut over ``data`` and
whole on every data rank; rwkv6-3b at (1, 4) and recurrentgemma-2b at
(2, 2) (paged), their blocks tensor-parallel over ``model``.
Token ids must be equal, and the formed batches where batch formation
does not follow the wall clock (every request at t = 0, bound by 4
slots, no page pressure).  Also: the launcher at ``--data 2 --model 2``
on both pools and with sessions at ``--data 2``, qwen3-moe at ``--data
2`` and rwkv6-3b at ``--model 2``, and the engine's refusals.
"""
import json
import os
import re
import threading

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import torch_dist_ranks as ranks
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.engine import ServingEngine as JaxEngine
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.core import driver
from repro_torch.core.engine import TorchEngineBackend
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve
from repro_torch.sharding import partition

SPAWN_SECONDS = 240
# the JAX engine's runs, by (config, workload, int8): without retention
# (the port's retention cases are held to equal cold runs) and on the
# contiguous pool (its ids do not depend on the pool kind)
JAX_CHUNK = {"kv1": 256}


def _jax_key(case):
    cname, load, _, opts = ranks.ENGINE_CASES[case]
    return cname, load, bool(opts.get("int8"))


JAX_RUNS = sorted({_jax_key(c) for c in ranks.CPU_ENGINE_CASES})


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory, one_torch_thread):
    d = str(tmp_path_factory.mktemp("ranks"))
    params = {}
    for name in ranks.ENGINE_CFGS:
        params[name] = jtfm.init_params(
            ranks.engine_cfg(name, jax_smoke_config), jax.random.PRNGKey(0))
        np.savez(os.path.join(d, f"engine_{name}.npz"),
                 **bridge.flatten(jax.tree.map(np.asarray, params[name])))
    ctx = ranks.start(d, ranks.CPU_ENGINE_CASES, 1, 4, "cpu")
    jax_out = {}
    # the JAX engines (mostly compilation, outside the GIL) in two
    # threads beside the port's runs: the file's time is the longest
    jax_runs = [threading.Thread(target=_jax_runs,
                                 args=(params, jax_out, JAX_RUNS[i::2]))
                for i in range(2)]
    for t in jax_runs:
        t.start()
    try:
        port = {}
        for case in ranks.CPU_ENGINE_CASES:
            key = ranks.port_reference_key(case)
            same = [c for c in port if ranks.port_reference_key(c) == key]
            port[case] = port[same[0]] if same else \
                ranks.port_engine_reference(d, case)
    finally:
        for t in jax_runs:
            t.join()
        err = ranks.wait(ctx, d, SPAWN_SECONDS)
    return port, jax_out, lambda name: ranks.load_output(d, name, err)


def _jax_runs(params, out, keys):
    import dataclasses
    from repro.data.workload import WorkloadSpec, generate
    for key in keys:
        cname, load, int8 = key
        cfg = ranks.engine_cfg(cname, jax_smoke_config)
        if int8:
            cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        reqs = ranks.engine_requests(jcore, cfg, load, generate,
                                     WorkloadSpec)
        eng, formed = ranks.serve_engine(
            jcore, JaxEngine, cfg, params[cname], reqs, device=None,
            chunk_tokens=JAX_CHUNK.get(cname, 64))
        out[key] = {"formed": formed, "ids": {
            str(r.rid): [int(t) for t in eng.outputs[r.rid]]
            for r in reqs}}


MESH_VS_JAX = ["engine_paged_kv_cut", "engine_paged_whole",
               "engine_contig_data", "engine_seq_cut", "engine_moe",
               "engine_paged_data", "engine_paged_data4",
               "engine_int8_data", "engine_moe_data", "engine_moe_data4",
               "engine_rwkv_model", "engine_rglru_model"]
MOE_DATA = ["engine_moe_data", "engine_moe_data4"]
# recurrentgemma's paged runs form their batches under the paged memory
# model, which forms a batch again while the decode slots it needs are
# taken: their formed batches are held against the port's paged run
# without a mesh only (the JAX runs are on the contiguous pool)
PAGED_FORMATION = ["engine_rglru_model"]


@pytest.mark.parametrize("case", MESH_VS_JAX)
def test_mesh_engine_ids_and_batches_equal_jax_and_no_mesh(run, case):
    """Token ids and formed batches of the engine under the mesh equal
    the port's engine without a mesh and the JAX engine's (slot-bound,
    every request at t = 0, no page pressure)."""
    port, jax_out, got = run
    mesh = got(case)
    want = jax_out[_jax_key(case)]
    assert mesh["ids"] == port[case]["ids"] == want["ids"]
    assert mesh["formed"] == port[case]["formed"]
    if case not in PAGED_FORMATION:
        assert mesh["formed"] == want["formed"]


@pytest.mark.parametrize("case", ["engine_prefix_data",
                                  "engine_sessions_data",
                                  "engine_spill_data"])
def test_mesh_data_retention_ids_equal_jax_and_cold(run, case):
    """Prefix hits, session resumes and the spill tier on the paged pool
    replicated over data (2, 2): ids equal the port's cold run without a
    mesh and the JAX engine's cold run, with the case's hits, spills and
    restores; ``clear`` frees every page and host slot."""
    port, jax_out, got = run
    mesh = got(case)
    assert mesh["ids"] == port[case]["ids"] == jax_out[_jax_key(case)]["ids"]
    c = mesh["counts"]
    if case == "engine_prefix_data":
        assert c["prefix_hits"] > 0
    else:
        assert c["session_hits"] > 0
    if case == "engine_spill_data":
        assert c["spilled_pages"] > 0 and c["restored_pages"] > 0
        assert mesh["ids"] == got("engine_sessions_data")["ids"]
    free, total, hfree, htotal = mesh["pages_after_clear"]
    assert free == total and hfree == htotal


@pytest.mark.parametrize("case", ranks.DATA_PAGED_CASES)
def test_mesh_data_pool_replicas_hold_the_same_bits(run, case):
    """After the run, each leaf of the paged pool has the same checksum
    on every data rank that shares a ``model`` coordinate (every page
    but the trash page), and every page and host slot is back after
    ``clear``."""
    _, _, got = run
    mesh = got(case)
    data, model = ranks.ENGINE_CASES[case][2]
    reps = mesh["replicas"]
    assert sorted(reps) == [str(m) for m in range(model)]
    for m, sums in reps.items():
        assert len(sums) == data and len(sums[0]) > 0
        assert all(s == sums[0] for s in sums), (m, sums)
    free, live, total = mesh["pages"]
    assert free + live == total
    free, total, hfree, htotal = mesh["pages_after_clear"]
    assert free == total and hfree == htotal


@pytest.mark.parametrize("case", ranks.DATA_PAGED_CASES
                         + ["engine_contig_data"])
def test_mesh_data_prefill_rows_cut_over_data(run, case):
    """Each prefill job whose rows ``data`` divides writes B / data rows
    of the batch cache on each rank (all B where it does not divide)."""
    _, _, got = run
    data = ranks.ENGINE_CASES[case][2][0]
    jobs = got(case)["layout"]["jobs"]
    assert jobs and any(B % data == 0 for B, _ in jobs)
    for B, rows in jobs:
        assert rows == (B // data if B % data == 0 else B), jobs


@pytest.mark.parametrize("case", MOE_DATA)
def test_mesh_moe_data_jobs_take_both_row_layouts(run, case):
    """With the experts cut over data, the run has a prefill job cut
    over data and one whole on every data rank (B not divisible), both
    through the dropless dispatch (the ids equal above)."""
    _, _, got = run
    data = ranks.ENGINE_CASES[case][2][0]
    jobs = got(case)["layout"]["jobs"]
    assert any(B % data == 0 for B, _ in jobs), jobs
    assert any(B % data for B, _ in jobs), jobs
    for B, rows in jobs:
        assert rows == (B // data if B % data == 0 else B), jobs


def test_mesh_engine_pools_have_the_layout_of_their_case(run):
    """Each case's pool is cut as its case names: by kv head (one a rank
    of 4), whole on every ``model`` rank, slots over ``data`` (2 of 4 a
    rank) with the kv heads over ``model`` (2 of 4), and 2048 slots
    along the sequence (512 a rank); the batch prefill cache holds a
    job's rows (its cut over ``data``: half of each even job under (2,
    2)), with the pool's cut of the K/V; one decode command a decode
    step, every command counted on the driver."""
    _, _, got = run
    kv, whole = got("engine_paged_kv_cut"), got("engine_paged_whole")
    assert kv["layout"]["k"][3] == 1 and whole["layout"]["k"][3] == 2
    assert kv["layout"]["batch_k"][1] == 4 and kv["layout"]["batch_k"][3] == 1
    assert whole["layout"]["batch_k"][3] == 2
    contig = got("engine_contig_data")["layout"]
    assert contig["slots"][1] == 2 and contig["k"][1] == 2
    assert contig["k"][3] == 2 and contig["batch_k"][3] == 2
    assert contig["jobs"] and all(
        n == (B // 2 if B % 2 == 0 else B) for B, n in contig["jobs"])
    seq = got("engine_seq_cut")["layout"]
    assert seq["seq_sharded"] and seq["k"][2] == 2048 // 4
    assert seq["batch_k"][2] == 2048 // 4
    for case in ranks.CPU_ENGINE_CASES:
        c = got(case)["commands"]
        assert c["hello"] == 1 and c["decode"] > 0 and c["chunk"] > 0


@pytest.mark.parametrize("case", ["engine_paged_kv_cut",
                                  "engine_paged_whole", "engine_moe",
                                  "engine_int8"])
def test_mesh_engine_paged_runs_return_every_page(run, case):
    _, _, got = run
    free, live, total = got(case)["pages"]
    assert free == total and live == 0


@pytest.mark.parametrize("case", ["engine_prefix", "engine_sessions"])
def test_mesh_retention_hit_equals_cold(run, case):
    """Prefix hits and session resumes under (1, 4): ids equal the cold
    run's (the port's engine without a mesh or retention), with hits;
    the pool balances and ``clear`` frees every page."""
    port, _, got = run
    mesh = got(case)
    assert mesh["ids"] == port[case]["ids"]
    hits = "prefix_hits" if case == "engine_prefix" else "session_hits"
    assert mesh["counts"][hits] > 0
    free, total = mesh["pages_after_clear"][:2]
    assert free == total


def test_mesh_spill_equals_no_spill(run):
    """Session tails expired at once (TTL 0) go to each rank's host tier
    and come back: ids equal the run without spill (the mesh's own
    session run) and the cold run; pages spilled and restored; after
    ``clear`` every page and host slot is free."""
    port, _, got = run
    spill = got("engine_spill")
    assert spill["ids"] == got("engine_sessions")["ids"] == \
        port["engine_spill"]["ids"]
    assert spill["counts"]["spilled_pages"] > 0
    assert spill["counts"]["restored_pages"] > 0
    free, total, hfree, htotal = spill["pages_after_clear"]
    assert free == total and hfree == htotal > 0


def test_mesh_int8_paged_pool_equals_no_mesh_int8(run):
    port, _, got = run
    assert got("engine_int8")["ids"] == port["engine_int8"]["ids"]


def _ids(path):
    with open(path) as f:
        return json.load(f)


def test_launcher_serves_under_data_2_model_2(tmp_path, capsys):
    """``--data 2 --model 2`` on the CPU spawns 4 gloo ranks: rank 0
    prints the reference's mesh line and serves every request, with ids
    equal to the one-device run's."""
    flags = ["--backend", "torch", "--smoke", "--device", "cpu", "--dtype",
             "f32", "--requests", "6", "--chunk", "64"]
    serve.main(flags + ["--ids-out", str(tmp_path / "one.json")])
    one = capsys.readouterr().out
    serve.main(flags + ["--data", "2", "--model", "2", "--ids-out",
                        str(tmp_path / "mesh.json")])
    # the spawned ranks print to the inherited descriptor: read the ids
    assert re.search(r"served 6/6 requests", one), one
    mesh, base = _ids(tmp_path / "mesh.json"), _ids(tmp_path / "one.json")
    assert len(base) == 6 and mesh == base


@pytest.mark.parametrize("flags,mesh_flags", [
    (["--paged", "--chunk", "64"], ["--data", "2", "--model", "2"]),
    (["--sessions", "2"], ["--data", "2"])])
def test_launcher_serves_the_paged_pool_under_data_2(tmp_path, flags,
                                                     mesh_flags):
    """The paged pool, and with ``--sessions`` KV retention, under
    ``--data 2``: all 6 requests served (2 sessions of 3 turns), ids
    equal to the one-device run's."""
    flags = ["--backend", "torch", "--smoke", "--device", "cpu", "--dtype",
             "f32", "--requests", "6"] + flags
    serve.main(flags + ["--ids-out", str(tmp_path / "one.json")])
    serve.main(flags + mesh_flags + ["--ids-out",
                                     str(tmp_path / "mesh.json")])
    mesh, base = _ids(tmp_path / "mesh.json"), _ids(tmp_path / "one.json")
    assert len(base) == 6 and mesh == base


@pytest.mark.parametrize("flags,mesh_flags", [
    (["--arch", "llama-3.2-vision-90b"], ["--model", "2"]),
    (["--arch", "hubert-xlarge"], ["--model", "2"])])
def test_launcher_refuses_what_the_mesh_engine_does_not_serve(
        flags, mesh_flags):
    """The engine serves neither the VLM nor the encoder, as the
    reference's does not (``check_servable``), under a mesh as without
    one: the launcher exits with its reason before building a model.
    (Under a mesh they run through ``forward`` / ``prefill`` /
    ``decode_step`` and the train launcher.)"""
    with pytest.raises(SystemExit) as exc:
        serve.main(["--backend", "torch", "--smoke", "--device", "cpu"]
                   + flags + mesh_flags)
    assert "encoder-only" in str(exc.value.code) or \
        "prefills token ids only" in str(exc.value.code)


@pytest.mark.parametrize("flags,mesh_flags", [
    (["--arch", "rwkv6-3b"], ["--model", "2"]),
    (["--arch", "qwen3-moe-235b-a22b"], ["--data", "2"])])
def test_launcher_serves_moe_over_data_and_rwkv_over_model(
        tmp_path, flags, mesh_flags):
    """What the launcher refused before the recurrent blocks ran
    tensor-parallel and the engine ran experts cut over data, it now
    serves: rwkv6-3b at ``--model 2`` and qwen3-moe at ``--data 2``
    (``moe_impl="local"`` through the dispatch that drops nothing), all 6
    requests, ids equal to the one-device run's."""
    flags = ["--backend", "torch", "--smoke", "--device", "cpu", "--dtype",
             "f32", "--requests", "6", "--chunk", "64"] + flags
    serve.main(flags + ["--ids-out", str(tmp_path / "one.json")])
    serve.main(flags + mesh_flags + ["--ids-out",
                                     str(tmp_path / "mesh.json")])
    mesh, base = _ids(tmp_path / "mesh.json"), _ids(tmp_path / "one.json")
    assert len(base) == 6 and mesh == base


def test_engine_refusals_under_a_mesh(tmp_path):
    """Under a one-rank gloo mesh: a model not cut for the mesh and a
    graph asked for are refused, the paged pool is served;
    ``moe_impl="ep"`` is refused with or without a mesh, for the
    reference engine's reason (its model calls pass no mesh)."""
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as ttfm
    cfg = get_smoke_config("qwen3-14b")
    model = ttfm.init_params(cfg, seed=0, device="cpu")
    tmesh.init_distributed(1, 1, "cpu", rank=0, world_size=1,
                           init_method=f"file://{tmp_path / 'store'}")
    try:
        mesh = tmesh.make_host_mesh(1, 1, device="cpu")
        with pytest.raises(ValueError, match="not sharded for mesh"):
            TorchEngineBackend(cfg, model, device="cpu", mesh=mesh)
        partition.shard_model(cfg, model, mesh)
        for flag in ("decode_graph", "prefill_graph"):
            with pytest.raises(ValueError, match="under a mesh"):
                TorchEngineBackend(cfg, model, device="cpu", mesh=mesh,
                                   **{flag: True})
        with pytest.raises(NotImplementedError, match="pass no mesh"):
            TorchEngineBackend(cfg, model, device="cpu", mesh=mesh,
                               moe_impl="ep")
        be = TorchEngineBackend(cfg, model, device="cpu", mesh=mesh,
                                paged=True, page_size=32)
        assert be.decode_graph is None and be.prefill_graph is None
        assert not be.worker and be.channel.is_driver
    finally:
        dist.destroy_process_group()


class _Channel:
    def __init__(self, commands):
        self.commands, self.rank = list(commands), 1

    def recv(self):
        return self.commands.pop(0)


class _Worker:
    """A backend stand-in whose device halves record their calls; its
    ``command`` is the backend's."""
    DEVICE_OPS = TorchEngineBackend.DEVICE_OPS
    command = TorchEngineBackend.command

    def __init__(self, commands):
        self.channel, self.ran = _Channel(commands), []

    def _d_decode(self, bt=None):
        self.ran.append("decode")

    def _d_poll(self, pending):
        self.ran.append(("poll", pending))


def test_row_gathers_skip_axes_of_one_rank(monkeypatch):
    """A batch axis of one rank cuts no rows, so ``gather_rows`` returns
    its input and issues no collective: a (1, M) mesh's decode step and
    slot insertion gather nothing over ``data``."""
    from repro_torch.sharding import collectives, rows
    calls = []
    monkeypatch.setattr(collectives, "all_gather",
                        lambda *a, **k: calls.append(a))
    x = torch.arange(24.).reshape(4, 3, 2)
    for shape in ({"data": 1, "model": 4}, {"data": 1, "model": 1}):
        mesh = tmesh.Mesh(shape)
        assert rows.batch_tuple(mesh, 4) == ("data",)
        assert rows.gather_rows(x, mesh, 4) is x
        assert rows.gather_rows(x, mesh, 4, dim=1) is x
    assert calls == []


def test_worker_loop_stops_and_aborts():
    """``serve_worker`` runs each command until ``stop``; ``abort`` (the
    driver raised) and an unknown command raise on the worker, so no
    rank waits on a run that has failed."""
    w = _Worker([("decode", {"bt": None}), ("poll", {"pending": [(0, 3)]}),
                 ("stop", {})])
    assert driver.serve_worker(w) == 2
    assert w.ran == ["decode", ("poll", [(0, 3)])]
    with pytest.raises(RuntimeError, match="aborted the run: boom"):
        driver.serve_worker(_Worker([("abort", {"reason": "boom"})]))
    with pytest.raises(ValueError, match="unknown engine command"):
        driver.serve_worker(_Worker([("format_disk", {})]))
