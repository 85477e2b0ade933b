"""The port's distribution against the JAX package: twins of
``tests/test_distributed.py`` and the port's own cases.

The reference runs its sharded programs on 8 fake XLA devices; the port
runs 8 ``torch.distributed`` gloo ranks on a (2, 4) (data, model) mesh,
spawned once for the module (``tests/torch_dist_ranks.py``, which
imports no JAX) with a ``file://`` store in a temporary directory.  The
parent computes the JAX package's single-device results from numpy made
from a seed and writes the inputs as ``.npy``; the ranks write theirs
back.  Each twin is held at its reference test's tolerance against the
JAX result and at atol 1e-5 / rtol 1e-4 against the port's own unsharded
run (made inside the ranks).
"""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

import torch_dist_ranks as ranks
from repro.configs import get_smoke_config as j_smoke
from repro.configs import list_archs
from repro.models import attention as j_attention
from repro.models import transformer as jtfm
from repro.sharding import partition as j_partition
from repro.train import optimizer as j_opt
from repro.train import train_loop as j_train
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention
from repro_torch.models import transformer as ttfm
from repro_torch.sharding import partition

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TOL = dict(atol=1e-5, rtol=1e-4)
# logits over int8 codes: a K/V value a rounding boundary away takes the
# neighbouring code (tests/test_torch_int8.py's INT8_LOGIT_TOL)
INT8_LOGIT_TOL = dict(atol=2e-3, rtol=0)
SPAWN_SECONDS = 240


def _np_params(params):
    return bridge.flatten(jax.tree.map(np.asarray, params))


def _write_inputs(d):
    """The ranks' inputs and the JAX package's results, by case."""
    want = {}
    rng = np.random.default_rng(0)

    # twin of test_sharded_forward_matches_single_device
    cfg = j_smoke("yi-6b", n_kv_heads=2, n_heads=4)
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    tok = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    np.savez(os.path.join(d, "forward_params.npz"), **_np_params(params))
    np.save(os.path.join(d, "forward_tok.npy"), tok)
    want["forward"] = np.asarray(jtfm.forward(cfg, params,
                                              tokens=jnp.asarray(tok)))

    # twin of test_moe_ep_train_step_grads_match (the oracle: the local
    # step)
    cfg = j_smoke("qwen3-moe-235b-a22b", n_experts=4, top_k=2,
                  capacity_factor=4.0)
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    tok = rng.integers(0, cfg.vocab_size, (4, 24)).astype(np.int32)
    np.savez(os.path.join(d, "ep_params.npz"), **_np_params(params))
    np.save(os.path.join(d, "ep_tok.npy"), tok)
    opt_cfg = j_opt.AdamWConfig(lr=1e-3, total_steps=4)
    p_ref, _, m_ref = jax.jit(j_train.make_train_step(
        cfg, opt_cfg, moe_impl="local"))(params, j_opt.init(params),
                                         {"tokens": jnp.asarray(tok)})
    want["ep_loss"] = float(m_ref["loss"])
    want["ep_params"] = _np_params(p_ref)

    # twin of test_decode_with_sharded_cache_matches
    cfg = j_smoke("yi-6b", n_kv_heads=4, n_heads=4, max_seq_len=64)
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    tok = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    np.savez(os.path.join(d, "kv_params.npz"), **_np_params(params))
    np.save(os.path.join(d, "kv_tok.npy"), tok)
    logits, cache = jtfm.prefill(cfg, params, tokens=jnp.asarray(tok),
                                 cache_len=64)
    nt = logits.argmax(-1).astype(jnp.int32)
    want["kv_prefill"] = np.asarray(logits)
    want["kv_decode"] = np.asarray(jtfm.decode_step(cfg, params, nt,
                                                    cache)[0])

    # twin of test_distributed_flash_decode_matches_oracle
    B, S, H, Hkv, Dh = 2, 64, 8, 2, 32
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    pos = np.array([40, 17], np.int32)
    pos2 = np.array([130, 31], np.int32)
    np.savez(os.path.join(d, "dd.npz"), q=q, kc=kc, vc=vc, pos=pos,
             pos2=pos2)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc)
    want["dd"] = np.asarray(j_attention.decode_attention(
        jq, jk, jv, jnp.asarray(pos)))
    want["dd_ring"] = np.asarray(j_attention.decode_attention(
        jq, jk, jv, jnp.asarray(pos2), window=S))

    # the port's own: a decode over a cache cut along the sequence
    cfg = j_smoke("yi-6b", max_seq_len=2048)
    params = jtfm.init_params(cfg, jax.random.PRNGKey(1))
    lens = np.array([600, 100, 530, 20], np.int32)
    tok = rng.integers(0, cfg.vocab_size, (4, 600)).astype(np.int32)
    np.savez(os.path.join(d, "seq_params.npz"), **_np_params(params))
    np.save(os.path.join(d, "seq_tok.npy"), tok)
    np.save(os.path.join(d, "seq_lens.npy"), lens)
    logits, cache = jtfm.prefill(cfg, params, tokens=jnp.asarray(tok),
                                 lengths=jnp.asarray(lens), cache_len=2048)
    steps, nexts = [np.asarray(logits)], []
    for _ in range(3):
        nt = jnp.argmax(logits, -1).astype(jnp.int32)
        nexts.append(np.asarray(nt))
        logits, cache = jtfm.decode_step(cfg, params, nt, cache)
        steps.append(np.asarray(logits))
    np.save(os.path.join(d, "seq_next.npy"), np.stack(nexts))
    want["seq"] = np.stack(steps)
    return want


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ranks"))
    want = _write_inputs(d)
    err = ranks.spawn(d, list(ranks.CASES), 2, 4, "cpu", SPAWN_SECONDS)
    return want, lambda name: ranks.load_output(d, name, err)


def test_sharded_forward_matches_single_device(run):
    """Dense GQA forward under TP+DP (a kv head split over two model
    ranks: the gather path) == the JAX single-device result."""
    want, got = run
    np.testing.assert_allclose(got("forward"), want["forward"], atol=2e-4,
                               rtol=2e-3)
    np.testing.assert_allclose(got("forward"), got("forward_port"),
                               **PORT_TOL)


def test_moe_ep_train_step_grads_match(run):
    """EP train step (all-to-all over data, expert d_ff over model) ==
    the local train step, loss and every updated parameter."""
    want, got = run
    loss_ep, loss_port = got("ep_loss")
    np.testing.assert_allclose(loss_ep, want["ep_loss"], rtol=1e-4)
    np.testing.assert_allclose(loss_ep, loss_port, **PORT_TOL)
    ep, port = got("ep_params"), got("ep_params_port")
    assert set(ep) == set(want["ep_params"])
    for k, w in want["ep_params"].items():
        np.testing.assert_allclose(ep[k], w, atol=5e-4, rtol=5e-3,
                                   err_msg=k)
        np.testing.assert_allclose(ep[k], port[k], **PORT_TOL, err_msg=k)


def test_decode_with_sharded_cache_matches(run):
    """A decode step with a kv-head-sharded cache == unsharded; the
    mesh's own prefill gives the same logits and cache slice."""
    want, got = run
    np.testing.assert_allclose(got("kv_decode"), want["kv_decode"],
                               atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(got("kv_decode"), got("kv_decode_port"),
                               **PORT_TOL)
    np.testing.assert_allclose(got("kv_prefill"), want["kv_prefill"],
                               atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(got("kv_prefill"), got("kv_prefill_port"),
                               **PORT_TOL)
    assert got("kv_cache_diff").max() < 1e-5


def test_production_mesh_shapes():
    m1 = tmesh.make_production_mesh()
    assert dict(m1.shape) == {"data": 16, "model": 16}
    m2 = tmesh.make_production_mesh(multi_pod=True)
    assert dict(m2.shape) == {"pod": 2, "data": 16, "model": 16}
    assert tmesh.batch_axes(m2, 256) == ("pod", "data")
    assert tmesh.batch_axes(m2, 16) is None or \
        tmesh.batch_axes(m2, 16) == "pod"
    assert tmesh.batch_axes(m1, 1) is None


def test_distributed_flash_decode_matches_oracle(run):
    """Segmented-softmax decode over a sequence-cut cache == local
    decode, and on a ring cache with pos beyond S."""
    want, got = run
    for name in ("dd", "dd_ring"):
        np.testing.assert_allclose(got(name), want[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(got(name), got(name + "_port"),
                                   **PORT_TOL, err_msg=name)


def test_sequence_sharded_decode_step_matches_jax(run):
    """yi-6b smoke, Hkv 2 on model 4, a 2048-slot cache: the cache is
    cut along the sequence (512 slots a rank, rows of 600 / 530 tokens
    spanning two shards, rows of 100 / 20 leaving three shards empty);
    the prefill and three decode steps' logits == the JAX package's, and
    the int8 cache's == the port's unsharded int8 run (the projections
    cut over model round the K/V a little differently, so a code may
    flip)."""
    want, got = run
    np.testing.assert_allclose(got("seq"), want["seq"], atol=2e-4,
                               rtol=2e-3)
    np.testing.assert_allclose(got("seq"), got("seq_port"), **PORT_TOL)
    np.testing.assert_allclose(got("seq_int8"), got("seq_int8_port"),
                               **INT8_LOGIT_TOL)


def _flat_specs(tree, prefix=""):
    """Key path -> tuple of a spec tree (the port's or the reference's)."""
    if isinstance(tree, (partition.P, JP)):
        return {prefix: tuple(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        raise TypeError(type(tree))
    out = {}
    for k, v in items:
        out.update(_flat_specs(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


MESHES = {"2x4": (2, 4), "16x16": (16, 16)}


@pytest.mark.parametrize("shape", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_partition_specs_equal_the_reference(arch, shape):
    """param/cache/batch/logits specs == the reference's, leaf for leaf,
    on an abstract (no devices) mesh of the same shape."""
    dims = MESHES[shape]
    jmesh = AbstractMesh(dims, ("data", "model"))
    tmesh_ = tmesh.Mesh({"data": dims[0], "model": dims[1]})
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    jparams = jax.eval_shape(lambda: jtfm.init_params(
        jcfg, jax.random.PRNGKey(0)))
    model = ttfm.Transformer(tcfg, torch.float32, "meta")
    want = _flat_specs(j_partition.param_specs(jcfg, jparams, jmesh))
    got = {k: tuple(v) for k, v in
           partition.param_specs(tcfg, model, tmesh_).items()}
    assert got == want
    if jcfg.has_decode:
        for B, S in ((4, 4096), (32, 64)):
            jc = jax.eval_shape(lambda: jtfm.init_cache(jcfg, B, S))
            tc = ttfm.init_cache(tcfg, B, S, device="meta")
            assert _flat_specs(partition.cache_specs(tcfg, tc, tmesh_, B)) \
                == _flat_specs(j_partition.cache_specs(jcfg, jc, jmesh, B))
    batch = {"tokens": np.zeros((4, 32), np.int32),
             "loss_mask": np.zeros((32, 8), np.float32)}
    assert _flat_specs(partition.batch_specs(tcfg, batch, tmesh_)) == \
        _flat_specs(j_partition.batch_specs(jcfg, batch, jmesh))
    for B, t in ((4, False), (32, True), (3, False)):
        assert tuple(partition.logits_spec(tcfg, tmesh_, B, t)) == \
            tuple(j_partition.logits_spec(jcfg, jmesh, B, t))


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("m", [2, 4, 8])
def test_lse_combine_of_in_process_shards_matches_plain(m, ring):
    """The decode over a cache cut into m slot ranges, each through the
    plain version with its log-sum-exp at the shard's local positions,
    combined by ``combine_decode_partials`` over the shard axis == the
    plain decode over the whole cache; rows whose live slots all lie in
    one shard and a wrapped ring included."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(m)
    B, S, H, Hkv, Dh = 6, 128, 8, 2, 32
    q = torch.randn(B, 1, H, Dh, generator=g)
    k = torch.randn(B, S, Hkv, Dh, generator=g)
    v = torch.randn(B, S, Hkv, Dh, generator=g)
    pos = torch.tensor([0, 5, S // m - 1, S // m, 100, 300 if ring else 127],
                       dtype=torch.int32)
    want = ref.flash_decode_ref(q, k, v, pos, ring=ring)
    Sl = S // m
    outs, lses = [], []
    for r in range(m):
        lse = torch.empty(B, H)
        lpos = attention.seq_local_pos(pos, r * Sl, S, ring)
        outs.append(ref.flash_decode_ref(
            q, k[:, r * Sl:(r + 1) * Sl], v[:, r * Sl:(r + 1) * Sl], lpos,
            ring=ring, lse_out=lse))
        lses.append(lse[:, None])
    got = attention.combine_decode_partials(
        torch.stack(outs), torch.stack(lses), lambda t: t.amax(0),
        lambda t: t.sum(0))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **PORT_TOL)


def test_plain_lse_out_matches_logsumexp():
    """``lse_out`` of the plain version is the log-sum-exp of the scaled
    scores over the live slots, -inf for a row with none."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(3)
    B, S, H, Hkv, Dh = 3, 40, 4, 2, 16
    q = torch.randn(B, H, Dh, generator=g)
    k = torch.randn(B, S, Hkv, Dh, generator=g)
    v = torch.randn(B, S, Hkv, Dh, generator=g)
    pos = torch.tensor([-1, 7, 39], dtype=torch.int32)
    lse = torch.empty(B, H)
    out = ref.flash_decode_ref(q, k, v, pos, lse_out=lse)
    assert torch.equal(out, ref.flash_decode_ref(q, k, v, pos))
    assert torch.isneginf(lse[0]).all()
    for b in (1, 2):
        n = int(pos[b]) + 1
        kk = k[b, :n].repeat_interleave(H // Hkv, dim=1)      # (n, H, Dh)
        s = torch.einsum("hd,nhd->hn", q[b], kk) * Dh ** -0.5
        np.testing.assert_allclose(lse[b].numpy(),
                                   torch.logsumexp(s, -1).numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_train_launcher_trains_on_a_gloo_mesh():
    """``--data 2 --model 4`` on the CPU spawns 8 gloo ranks itself;
    rank 0 prints the reference's lines, once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--data", "2", "--model", "4", "--steps", "3",
         "--batch", "4", "--seq", "16"],
        env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "mesh: {'data': 2, 'model': 4}" in r.stdout, r.stdout
    assert len(re.findall(r"^step    0 loss=\d+\.\d{4} lr=", r.stdout,
                          re.M)) == 1, r.stdout
    m = re.search(r"3 steps in [\d.]+s \(\d+ tok/s\); loss ([\d.]+) -> "
                  r"([\d.]+)", r.stdout)
    assert m and np.isfinite(float(m.group(2))), r.stdout
