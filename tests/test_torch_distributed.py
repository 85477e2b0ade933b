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
from repro.data import tokens as jtokens
from repro.models import attention as j_attention
from repro.models import moe as jmoe
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
    """The ranks' inputs and the JAX package's results, by case; and the
    functions that compute the later cases' results (``want`` is filled
    by them while the ranks run)."""
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
    return want, _write_family_inputs(d, rng)


def _write_family_inputs(d, rng):
    """The inputs of the families', recurrentgemma's and the MoE layer's
    cases; returns the functions that compute the JAX package's results
    for them, each filling a dict (run while the ranks run)."""
    refs = []

    # the recurrent, cross-attention and encoder families under model 4
    for arch in ranks.FAMILY_ARCHS:
        cfg, name = j_smoke(arch), "family_" + arch
        tree = _cross_gates(cfg, jax.tree.map(
            np.array, jtfm.init_params(cfg, jax.random.PRNGKey(0))))
        x = ranks.family_inputs(cfg, rng)
        np.savez(os.path.join(d, name + ".npz"), **bridge.flatten(tree))
        np.savez(os.path.join(d, name + "_in.npz"), **x)
        refs.append(lambda want, cfg=cfg, name=name, tree=tree, x=x:
                    want.update({name: np.asarray(jtfm.forward(
                        cfg, jax.tree.map(jnp.asarray, tree),
                        **{k: jnp.asarray(v) for k, v in x.items()}))}))

    # recurrentgemma: prefill over a wrapped ring, three decode steps fed
    # the same ids on both sides
    cfg = j_smoke(ranks.REC_ARCH)
    params = jtfm.init_params(cfg, jax.random.PRNGKey(2))
    B = len(ranks.REC_LENS)
    tok = rng.integers(0, cfg.vocab_size, (B, int(ranks.REC_LENS.max())))
    nexts = rng.integers(0, cfg.vocab_size, (3, B)).astype(np.int32)
    np.savez(os.path.join(d, "rec_params.npz"), **_np_params(params))
    np.save(os.path.join(d, "rec_tok.npy"), tok.astype(np.int32))
    np.save(os.path.join(d, "rec_next.npy"), nexts)

    def rec(want, cfg=cfg, params=params):
        logits, cache = jtfm.prefill(cfg, params, tokens=jnp.asarray(tok),
                                     lengths=jnp.asarray(ranks.REC_LENS),
                                     cache_len=ranks.REC_LEN)
        steps = [np.asarray(logits)]
        for nt in nexts:
            logits, cache = jtfm.decode_step(cfg, params, jnp.asarray(nt),
                                             cache)
            steps.append(np.asarray(logits))
        want["rec"] = np.stack(steps)
    refs.append(rec)

    # each family's train-step loss and gradients (norm scales set, so
    # that their gradients are not those of zero scales; the VLM's cross
    # gates set); a batch of the reference's token stream, masked
    for arch in ranks.TRAIN_ARCHS:
        cfg, name = j_smoke(arch), "train_" + arch
        tree = _cross_gates(cfg, jax.tree.map(
            np.array, jtfm.init_params(cfg, jax.random.PRNGKey(3))))
        _norm_scales(tree, np.random.default_rng(7))
        batch = {k: np.asarray(v) for k, v in
                 next(jtokens.batches(cfg, 4, 16)).items()}
        if not cfg.is_encoder:
            batch["loss_mask"] = np.ones((4, 16), np.float32)
            batch["loss_mask"][1, 11:] = 0
        np.savez(os.path.join(d, name + ".npz"), **bridge.flatten(tree))
        np.savez(os.path.join(d, name + "_batch.npz"), **batch)

        def train(want, cfg=cfg, tree=tree, batch=batch, name=name):
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p: j_train.lm_loss(cfg, p, jax.tree.map(
                    jnp.asarray, batch), "local"), has_aux=True))(
                        jax.tree.map(jnp.asarray, tree))
            want[name + "_loss"] = float(loss)
            want[name + "_grads"] = _np_params(grads)
        refs.append(train)

    # one MoE layer at capacity 1.25: inputs leaning towards data rank
    # 0's experts, so that moe_ep drops pairs; the reference's moe_local
    for arch in ranks.MOE_ARCHS:
        cfg = j_smoke(arch)
        params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
        np.savez(os.path.join(d, f"moe_{arch}.npz"), **_np_params(params))
        layer = _moe_layer(params)
        lean = layer["router"][:, 0] + layer["router"][:, 1]
        lean = lean / np.linalg.norm(lean) * 0.15 * np.sqrt(cfg.d_model)
        for B in ranks.MOE_BS:
            x = (rng.standard_normal((B, ranks.MOE_T, cfg.d_model))
                 + lean).astype(np.float32)
            name = f"moe_{arch}_{B}"
            np.save(os.path.join(d, f"moe_{arch}_x{B}.npy"), x)
            refs.append(lambda want, cfg=cfg, layer=layer, x=x, name=name:
                        want.update({
                            name + "_local": np.asarray(jmoe.moe_local(
                                cfg, layer, jnp.asarray(x))),
                            name + "_dropped": _ep_dropped(cfg, layer, x,
                                                           2)}))
    return refs


def _cross_gates(cfg, tree):
    """Each cross layer's gate set to ``0.5 + 0.1 * rep`` (zero at init,
    where a cross layer adds nothing)."""
    for gi, (pattern, reps) in enumerate(cfg.block_groups()):
        for j, btype in enumerate(pattern):
            if btype == "cross":
                tree["groups"][gi][j]["attn"]["gate"] = np.asarray(
                    0.5 + 0.1 * np.arange(reps), np.float32)
    return tree


def _norm_scales(tree, rng):
    """Every norm scale set to ``0.1 * normal``, in place."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            _norm_scales(v, rng)
        elif k in ("ln1", "ln2", "ln_f", "q_norm", "k_norm", "ln_x"):
            tree[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)


def _moe_layer(params):
    """The first MoE block's leaves (repetition 0), numpy."""
    return jax.tree.map(lambda a: np.asarray(a[0]),
                        params["groups"][0][0]["moe"])


def _ep_dropped(cfg, layer, x, dp: int) -> int:
    """The (token, expert) pairs the reference's ``moe_ep`` drops over
    ``dp`` data ranks: each source's pairs past the capacity of each
    destination; every source routes the same rows where ``dp`` does
    not divide the batch."""
    B, T, d = x.shape
    sources = np.split(x, dp) if B % dp == 0 else [x] * dp
    E_loc, dropped = cfg.n_experts // dp, 0
    for xs in sources:
        N = xs.shape[0] * T
        _, idx, _ = jmoe.router_topk(cfg, layer, jnp.asarray(
            xs.reshape(N, d)))
        dest = np.asarray(idx).reshape(-1) // E_loc
        cap = int(max(8, round(cfg.capacity_factor * N * cfg.top_k / dp)))
        dropped += sum(max(0, int((dest == j).sum()) - cap)
                       for j in range(dp))
    return dropped


# the reference's moe_ep under shard_map on 8 fake devices, (2, 4), in a
# subprocess (JAX fixes its device count at its first use)
MOE_EP_REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.configs import get_smoke_config
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as tfm
d, archs, bs = sys.argv[1], sys.argv[2].split(","), sys.argv[3].split(",")
mesh = make_host_mesh(2, 4)
for arch in archs:
    cfg = get_smoke_config(arch)
    params = tfm.init_params(cfg, jax.random.PRNGKey(0))
    layer = jax.tree.map(lambda a: a[0], params["groups"][0][0]["moe"])
    fn = jax.jit(lambda p, x: tfm._apply_moe(cfg, p, x, "ep", mesh))
    for B in bs:
        x = np.load(os.path.join(d, f"moe_{arch}_x{B}.npy"))
        np.save(os.path.join(d, f"moe_{arch}_{B}_ref_ep.npy"),
                np.asarray(fn(layer, x)))
"""


def _start_moe_ep_reference(d):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-c", MOE_EP_REFERENCE, d,
         ",".join(ranks.MOE_ARCHS), ",".join(map(str, ranks.MOE_BS))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ranks"))
    want, refs = _write_inputs(d)
    ctx = ranks.start(d, list(ranks.CASES), 2, 4, "cpu")
    ref = _start_moe_ep_reference(d)
    try:
        for compute in refs:              # while the ranks run
            compute(want)
    finally:
        err = ranks.wait(ctx, d, SPAWN_SECONDS)
        _, ref_err = ref.communicate(timeout=SPAWN_SECONDS)
    assert ref.returncode == 0, ref_err[-3000:]
    for arch in ranks.MOE_ARCHS:
        for B in ranks.MOE_BS:
            name = f"moe_{arch}_{B}"
            want[name + "_ep"] = np.load(os.path.join(d, name
                                                      + "_ref_ep.npy"))
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


@pytest.mark.parametrize("arch", ranks.FAMILY_ARCHS)
def test_family_forward_under_model_4_matches_single_device(run, arch):
    """rwkv6-3b (its heads one a model rank), recurrentgemma-2b (one
    query head a rank over the one kv head; the RG-LRU width cut four
    ways), llama-3.2-vision (cross gates set; ``vis_proj`` cut) and
    hubert-xlarge (non-causal, frame embeddings) under (2, 4) == the
    JAX package's single-device forward on every valid row."""
    want, got = run
    name = "family_" + arch
    valid = np.arange(ranks.FAMILY_T)[None] < ranks.FAMILY_LENS[:, None]
    np.testing.assert_allclose(got(name)[valid], want[name][valid],
                               atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(got(name)[valid], got(name + "_port")[valid],
                               **PORT_TOL)


# the leaves the reference's rules cut over ``model`` (``partition.py``),
# by family, and each cache leaf's shape on a rank of (2, 4), batch 4:
# (reps, rows, ...) with the rows cut over data
FAMILY_CUT = {
    "rwkv6-3b": {"wr", "wk", "wv", "wg", "wo", "ck", "cr", "cv"},
    "recurrentgemma-2b": {"wx", "wg", "wr", "wi", "conv", "wo", "gate",
                          "up", "down", "wq"},
    "llama-3.2-vision-90b": {"vis_proj", "wq", "wk", "wv", "wo"},
    "hubert-xlarge": {"wq", "wk", "wv", "wo", "gate", "up", "down"}}
_REC = {"h": [1, 2, 64], "conv": [1, 2, 3, 64]}
FAMILY_LEAVES = {      # a dict a pattern slot of the first block group
    "rwkv6-3b": [{"s": [2, 2, 1, 64, 64], "x_tm": [2, 2, 64],
                  "x_cm": [2, 2, 64]}],
    "recurrentgemma-2b": [_REC, _REC, {"k": [1, 2, 32, 1, 64],
                                       "v": [1, 2, 32, 1, 64]}],
    "llama-3.2-vision-90b": [{"k": [1, 2, 32, 2, 64],
                              "v": [1, 2, 32, 2, 64]},
                             {"k": [1, 2, 16, 2, 64],
                              "v": [1, 2, 16, 2, 64]}]}


@pytest.mark.parametrize("arch", ranks.FAMILY_ARCHS)
def test_family_leaves_and_carries_cut_over_model(run, arch):
    """On a rank of (2, 4) the parameters the reference's rules cut over
    ``model`` are cut, and each cache leaf holds this rank's part: RWKV's
    state one head of 4 and its token-shift carries 64 of 256 columns,
    RG-LRU's carries 64 of 256 channels, the one kv head whole."""
    _, got = run
    layout = got(f"family_{arch}_layout")
    cut = {k.split("/")[-1] for k in layout["cut"]}
    assert FAMILY_CUT[arch] <= cut, FAMILY_CUT[arch] - cut
    assert layout.get("leaves") == FAMILY_LEAVES.get(arch), layout


def test_recurrent_prefill_and_decode_under_the_mesh(run):
    """recurrentgemma-2b under (2, 4): the prefill over a wrapped 64-slot
    ring and three decode steps (RG-LRU carries cut over the width, the
    local attention's query heads over model) == the JAX package's."""
    want, got = run
    np.testing.assert_allclose(got("rec"), want["rec"], atol=2e-4,
                               rtol=2e-3)
    np.testing.assert_allclose(got("rec"), got("rec_port"), **PORT_TOL)


def _train_step_matches(run, arch, port_tol, mesh=""):
    """The loss and every gradient under the mesh (the (2, 4) mesh, or
    ``mesh`` "pod_": the (pod, data, model) one) against the JAX
    package's, and against the port's unsharded step (at ``port_tol`` of
    the leaf's scale: the mesh sums in other orders)."""
    want, got = run
    name = "train_" + arch
    np.testing.assert_allclose(float(got(mesh + name + "_loss")),
                               want[name + "_loss"], rtol=1e-5)
    grads, port = got(mesh + name + "_grads"), got(name + "_grads_port")
    assert sorted(grads) == sorted(want[name + "_grads"])
    for key, w in want[name + "_grads"].items():
        scale = float(np.abs(w).max())
        assert grads[key].shape == w.shape, key
        assert float(np.abs(grads[key] - w).max()) <= 1e-4 * scale + 1e-12, \
            key
        np.testing.assert_allclose(grads[key], port[key],
                                   atol=port_tol * scale, rtol=0, err_msg=key)


def test_recurrent_train_step_under_the_mesh(run):
    """recurrentgemma-2b's train step under (2, 4): the loss and every
    gradient (summed over data, gathered over model) == the JAX
    package's single-device ``value_and_grad`` of ``lm_loss``."""
    _train_step_matches(run, ranks.REC_ARCH, 1e-5)


def test_train_step_on_a_pod_mesh_sums_over_pod_and_data(run):
    """On a (pod 2, data 2, model 2) mesh over the same 8 ranks the
    batch is cut over (pod, data) and the train step sums the loss and
    each gradient over both axes: recurrentgemma-2b's loss and every
    gradient equal the JAX package's and the unsharded step's; qwen3-moe's
    experts, cut over data and replicated over pod, are summed over pod
    alone, and its loss and every gradient equal the unsharded step's."""
    _train_step_matches(run, ranks.REC_ARCH, 1e-5, mesh="pod_")
    _, got = run
    np.testing.assert_allclose(got("pod_ep_loss"), got("pod_ep_loss_port"),
                               **PORT_TOL)
    grads, port = got("pod_ep_grads"), got("pod_ep_grads_port")
    assert sorted(grads) == sorted(port)
    for key, w in port.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(grads[key], w, atol=1e-5 * scale + 1e-12,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("arch", ranks.TRAIN_ARCHS[1:])
def test_family_train_step_under_the_mesh(run, arch):
    """The same for rwkv6-3b (its own heads: the decay LoRA's gradient
    summed over model), the VLM (cross gates set) and hubert (frame
    labels; its embedding's gradient zero on both sides).  Against the
    unsharded step at 5e-5 of the scale: RWKV's channel-mix gradient
    through relu² differs by 1.4e-5 of it in f32."""
    _train_step_matches(run, arch, 5e-5)


@pytest.mark.parametrize("B", ranks.MOE_BS)
@pytest.mark.parametrize("arch", ranks.MOE_ARCHS)
def test_moe_ep_drops_pairs_as_the_reference(run, arch, B):
    """At capacity 1.25, on rows cut over data (B 4) and whole on every
    data rank (B 3): the reference's ``moe_ep`` drops pairs here, and the
    port's ``moe_ep`` equals it under ``jax.shard_map``; the dropless
    ``"local"`` route on the same cut experts equals the reference's
    single-device ``moe_local``."""
    want, got = run
    name = f"moe_{arch}_{B}"
    assert want[name + "_dropped"] > 0
    np.testing.assert_allclose(got(name + "_ep"), want[name + "_ep"],
                               atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(got(name + "_local"), want[name + "_local"],
                               atol=2e-4, rtol=2e-3)
    assert np.abs(want[name + "_ep"] - want[name + "_local"]).max() > 1e-3


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
