"""The port's model path against the JAX reference, with the same weights.

For the qwen3-14b, llama2-13b, yi-6b and stablelm-1.6b smoke configs at
f32, the reference's
``init_params`` weights go through ``repro_torch/bridge.py``; the same
numpy inputs then run through ``repro.models.transformer`` and
``repro_torch.models.transformer``: ``prefill``, ``prefill_chunk`` at
several chunk sizes, and ``decode_step`` on the contiguous and the paged
cache, including a dead slot whose position runs past the cache.
Logits agree within atol 1e-4; caches within the kernel tolerance
(atol 2e-5, rtol 2e-4) on valid slots.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as ttfm

ARCHS = ["qwen3-14b", "llama2-13b", "yi-6b", "stablelm-1.6b"]
LOGIT_TOL = dict(atol=1e-4, rtol=0)
CACHE_TOL = dict(atol=2e-5, rtol=2e-4)


# jitted reference entry points (eager JAX is seconds per call)
j_prefill = jax.jit(jtfm.prefill, static_argnums=0,
                    static_argnames=("cache_len",))
j_chunk = jax.jit(jtfm.prefill_chunk, static_argnums=0)
j_decode = jax.jit(jtfm.decode_step, static_argnums=0,
                   static_argnames=("page_size", "paged_len"))


@functools.lru_cache(maxsize=None)
def _params(arch):
    """Reference weights (independent of max_seq_len and window)."""
    return jtfm.init_params(jax_smoke_config(arch), jax.random.PRNGKey(0))


def _pair(arch, **overrides):
    jcfg = jax_smoke_config(arch, **overrides)
    tcfg = get_smoke_config(arch, **overrides)
    params = _params(arch)
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                     device="cpu")
    return jcfg, tcfg, params, model


def _prompts(cfg, lens, pad, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), pad), np.int32)
    for i, L in enumerate(lens):
        toks[i, :L] = rng.integers(0, cfg.vocab_size, L)
    return toks, np.asarray(lens, np.int32)


def _kv_np(cache, key="k"):
    return np.asarray(cache["groups"][0][0][key], np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    jcfg, tcfg, params, model = _pair(arch, max_seq_len=128)
    toks, lens = _prompts(jcfg, [40, 17, 5], 40)
    jl, jc = j_prefill(jcfg, params, tokens=jnp.asarray(toks),
                          lengths=jnp.asarray(lens), cache_len=96)
    tl, tc = ttfm.prefill(tcfg, model, torch.from_numpy(toks),
                          torch.from_numpy(lens), cache_len=96)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert np.array_equal(tc["pos"].numpy(), lens)
    for key in ("k", "v"):
        kj, kt = _kv_np(jc, key), bridge.cache_to_numpy(tc)["groups"][0][0][key]
        assert kt.shape == kj.shape
        for b, L in enumerate(lens):
            np.testing.assert_allclose(kt[:, b, :L], kj[:, b, :L],
                                       **CACHE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_prefill_chunk_matches_reference(arch, chunk):
    jcfg, tcfg, params, model = _pair(arch, max_seq_len=128)
    lens = np.array([10, 37, 64], np.int32)
    toks, _ = _prompts(jcfg, lens, 64)
    B = len(lens)
    jc = jtfm.init_cache(jcfg, B, 128)
    tc = ttfm.init_cache(tcfg, B, 128, device="cpu")
    for s in range(0, 64, chunk):
        jl, jc = j_chunk(jcfg, params,
                                    jnp.asarray(toks[:, s:s + chunk]), jc, s,
                                    jnp.asarray(lens))
        tl, tc = ttfm.prefill_chunk(tcfg, model,
                                    torch.from_numpy(toks[:, s:s + chunk]),
                                    tc, s, torch.from_numpy(lens))
        fin = ((lens - 1) >= s) & ((lens - 1) < s + chunk)
        np.testing.assert_allclose(tl.numpy()[fin], np.asarray(jl)[fin],
                                   **LOGIT_TOL)
    for key in ("k", "v"):
        kj, kt = _kv_np(jc, key), bridge.cache_to_numpy(tc)["groups"][0][0][key]
        for b, L in enumerate(lens):
            np.testing.assert_allclose(kt[:, b, :L], kj[:, b, :L],
                                       **CACHE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_contiguous_with_dead_slot(arch):
    """Row 0 fills its cache and runs past it: JAX drops the write at
    slot S, the port masks it; every cache slot must still agree."""
    S = 24
    jcfg, tcfg, params, model = _pair(arch, max_seq_len=S)
    toks, lens = _prompts(jcfg, [S - 2, 6], S - 2)
    jl, jc = j_prefill(jcfg, params, tokens=jnp.asarray(toks),
                          lengths=jnp.asarray(lens), cache_len=S)
    tc = bridge.cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    for step in range(4):              # row 0: pos S-2, S-1, S, S+1
        jl, jc = j_decode(jcfg, params, jnp.asarray(tok), jc)
        tl, tc = ttfm.decode_step(tcfg, model, torch.from_numpy(tok), tc)
        live = np.asarray(jc["pos"]) <= S       # wrote inside the cache
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **LOGIT_TOL)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(tc["groups"][0][0][key].numpy(),
                                   _kv_np(jc, key), **CACHE_TOL)


def _to_paged(cache, lens, page, S, rng, dead=()):
    """Scatter a contiguous prefill cache (numpy) into a shuffled page
    pool with a trash page last; rows in ``dead`` point at the trash."""
    B = len(lens)
    n_p = -(-S // page)
    n_pages = B * n_p + 3
    perm = rng.permutation(n_pages - 1)[:B * n_p].reshape(B, n_p)
    trash = n_pages - 1
    bt = perm.astype(np.int32)
    for b in dead:
        bt[b] = trash
    groups = []
    for slot in cache["groups"][0]:
        out = {}
        for key, leaf in slot.items():          # (reps, B, S, Hkv, Dh)
            reps = leaf.shape[0]
            padded = np.zeros((reps, B, n_p * page) + leaf.shape[3:],
                              np.float32)
            padded[:, :, :S] = leaf
            pool = np.zeros((reps, n_pages, page) + leaf.shape[3:],
                            np.float32)
            for b in range(B):
                for j in range(n_p):
                    if b not in dead:
                        pool[:, bt[b, j]] = padded[:, b,
                                                   j * page:(j + 1) * page]
            out[key] = pool
        groups.append(out)
    return {"pos": np.asarray(cache["pos"]), "block_tables": bt,
            "groups": (tuple(groups),)}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_paged_matches_reference(arch):
    """Paged decode over a shuffled pool, a dead row on the trash page
    whose position runs past the tables: logits of live rows and the
    whole pool agree."""
    S, page = 40, 16
    jcfg, tcfg, params, model = _pair(arch, max_seq_len=S)
    toks, lens = _prompts(jcfg, [30, 9, S - 1], S - 1)
    jl, jc = j_prefill(jcfg, params, tokens=jnp.asarray(toks),
                          lengths=jnp.asarray(lens), cache_len=S)
    paged = _to_paged(jax.tree.map(np.asarray, jc), lens, page, S,
                      np.random.default_rng(3), dead=(2,))
    jp = jax.tree.map(jnp.asarray, paged)
    tp = bridge.cache_from_numpy(paged, device="cpu")
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    for _ in range(3):
        jl, jp = j_decode(jcfg, params, jnp.asarray(tok), jp,
                                  page_size=page, paged_len=S)
        tl, tp = ttfm.decode_step(tcfg, model, torch.from_numpy(tok), tp,
                                  page_size=page, paged_len=S)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   **LOGIT_TOL)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
    for key in ("k", "v"):
        np.testing.assert_allclose(tp["groups"][0][0][key].numpy(),
                                   _kv_np(jp, key), **CACHE_TOL)


def test_sliding_window_ring_prefill_and_decode():
    """A window below the cache length: prefill writes a ring
    (``_ring_from_prefill``) and decode wraps it."""
    jcfg, tcfg, params, model = _pair("qwen3-14b", max_seq_len=64,
                                      sliding_window=16)
    toks, lens = _prompts(jcfg, [30, 11], 30)
    jl, jc = j_prefill(jcfg, params, tokens=jnp.asarray(toks),
                          lengths=jnp.asarray(lens), cache_len=64)
    tl, tc = ttfm.prefill(tcfg, model, torch.from_numpy(toks),
                          torch.from_numpy(lens), cache_len=64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tc["groups"][0][0]["k"].numpy(),
                               _kv_np(jc), **CACHE_TOL)
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    for _ in range(8):
        jl, jc = j_decode(jcfg, params, jnp.asarray(tok), jc)
        tl, tc = ttfm.decode_step(tcfg, model, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = np.array(jnp.argmax(jl, -1), np.int32)


def test_out_of_range_token_ids_clamp():
    """``embed_apply`` clamps ids past the vocabulary instead of raising.
    (The reference's ``jnp.take`` fills such rows with NaN; no serving
    path feeds them, so the port's clamp is compared against the
    reference run on the clamped ids.)"""
    jcfg, tcfg, params, model = _pair("qwen3-14b", max_seq_len=32)
    toks = np.array([[3, jcfg.vocab_size + 7, 5, jcfg.vocab_size]], np.int32)
    clamped = np.minimum(toks, jcfg.vocab_size - 1)
    jl, _ = j_prefill(jcfg, params, tokens=jnp.asarray(clamped),
                      cache_len=32)
    tl, _ = ttfm.prefill(tcfg, model, torch.from_numpy(toks), cache_len=32)
    assert np.isfinite(tl.numpy()).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_bridge_round_trip_and_unported_blocks():
    jcfg, tcfg, params, model = _pair("qwen3-14b", max_seq_len=32)
    flat = bridge.flatten(jax.tree.map(np.asarray, params))
    assert "groups/0/0/attn/wq" in flat
    wq = flat["groups/0/0/attn/wq"]
    assert np.array_equal(model.groups[0][0][1].attn.wq.numpy(), wq[1])
    # the recurrent blocks run under a mesh with model > 1: the forward
    # reaches the check that the model was cut for it
    from repro_torch.launch.mesh import Mesh
    cfg = get_smoke_config("rwkv6-3b", max_seq_len=32)
    rwkv_model = ttfm.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="not sharded for mesh"):
        ttfm.forward(cfg, rwkv_model, torch.zeros((1, 4), dtype=torch.int32),
                     mesh=Mesh({"data": 1, "model": 2}))


def test_logits_f32_and_argmax_ties_take_the_first_index():
    """Greedy tokens come from f32 logits (also for a bf16 model) and,
    as ``jnp.argmax``, ``torch.argmax`` breaks ties by the first index."""
    jcfg, tcfg, params, model = _pair("qwen3-14b", max_seq_len=32)
    toks, lens = _prompts(tcfg, [7], 7)
    logits, _ = ttfm.prefill(tcfg, model.to(torch.bfloat16),
                             torch.from_numpy(toks), cache_len=32)
    assert logits.dtype == torch.float32
    tied = np.array([[0.5, 2.0, -1.0, 2.0], [3.0, 3.0, 3.0, 0.0]],
                    np.float32)
    assert torch.argmax(torch.from_numpy(tied), -1).tolist() == \
        np.asarray(jnp.argmax(jnp.asarray(tied), -1)).tolist() == [1, 0]
