"""The port's RWKV6 path against the JAX reference, with the same weights.

The reference's ``init_params`` weights for the rwkv6-3b smoke config go
through ``repro_torch/bridge.py``; the same numpy inputs then run through
the reference and the port at f32: the blocks (``time_mix``,
``channel_mix`` with ``lengths`` masking), ``prefill``,
``prefill_chunk`` at several chunk sizes with a row that finishes in an
earlier chunk (its carry must stay bit for bit), and ``decode_step``.
Logits agree within atol 1e-4, carries within the kernel tolerance
(atol 2e-5, rtol 2e-4).  Also: float32 leaves stay float32 in a bf16
model, through ``init_params``, the bridge and the cache conversion.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import rwkv as jrwkv
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import rwkv
from repro_torch.models import transformer as ttfm

ARCH = "rwkv6-3b"
LOGIT_TOL = dict(atol=1e-4, rtol=0)
CACHE_TOL = dict(atol=2e-5, rtol=2e-4)
LEAVES = ("s", "x_tm", "x_cm")

j_prefill = jax.jit(jtfm.prefill, static_argnums=0,
                    static_argnames=("cache_len",))
j_chunk = jax.jit(jtfm.prefill_chunk, static_argnums=0)
j_decode = jax.jit(jtfm.decode_step, static_argnums=0)


@functools.lru_cache(maxsize=None)
def _params():
    return jtfm.init_params(jax_smoke_config(ARCH), jax.random.PRNGKey(0))


def _pair(dtype=torch.float32):
    jcfg = jax_smoke_config(ARCH, max_seq_len=128)
    tcfg = get_smoke_config(ARCH, max_seq_len=128)
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, _params()),
                                     tcfg, device="cpu", dtype=dtype)
    return jcfg, tcfg, _params(), model


def _prompts(cfg, lens, pad, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), pad), np.int32)
    for i, L in enumerate(lens):
        toks[i, :L] = rng.integers(0, cfg.vocab_size, L)
    return toks, np.asarray(lens, np.int32)


def _assert_state(tc, jc):
    """Port cache vs reference cache: every carry leaf of every slot."""
    tn = bridge.cache_to_numpy(tc)
    for key in LEAVES:
        np.testing.assert_allclose(tn["groups"][0][0][key],
                                   np.asarray(jc["groups"][0][0][key]),
                                   **CACHE_TOL, err_msg=key)


# ----------------------------------------------------------- blocks ------
def _block_inputs(cfg, B=3, T=12, seed=1):
    rng = np.random.default_rng(seed)
    H, hs = rwkv.rwkv_n_heads(cfg), cfg.rwkv_head_size
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    x_prev = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hs, hs)) * 0.1).astype(np.float32)
    lens = np.array([T, 5, 0], np.int32)[:B]
    return x, x_prev, s0, lens


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def test_time_mix_with_lengths_matches_reference():
    """Rows of full, partial and zero length: output, token-shift input
    and carried state agree with the reference's ``time_mix``; a padded
    row's state equals that of its unpadded sequence exactly."""
    jcfg, tcfg, params, model = _pair()
    jp = jax.tree.map(lambda a: a[0], params["groups"][0][0]["rwkv"])
    tp = model.groups[0][0][0].rwkv
    x, x_prev, s0, lens = _block_inputs(tcfg)
    out, x_last, sT = rwkv.time_mix(tcfg, tp, *_t(x, x_prev, s0),
                                    torch.from_numpy(lens))
    jout, jlast, jsT = jrwkv.time_mix(jcfg, jp, jnp.asarray(x),
                                      jnp.asarray(x_prev), jnp.asarray(s0),
                                      jnp.asarray(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **CACHE_TOL)
    np.testing.assert_allclose(x_last.numpy(), np.asarray(jlast), atol=0)
    np.testing.assert_allclose(sT.numpy(), np.asarray(jsT), **CACHE_TOL)
    assert torch.equal(x_last[1], torch.from_numpy(x[1, lens[1] - 1]))
    assert torch.equal(sT[2], torch.from_numpy(s0[2]))     # length 0
    _, _, s_row = rwkv.time_mix(tcfg, tp, *_t(x[1:2, :lens[1]],
                                              x_prev[1:2], s0[1:2]))
    assert torch.equal(sT[1], s_row[0])


def test_channel_mix_with_lengths_matches_reference():
    jcfg, tcfg, params, model = _pair()
    jp = jax.tree.map(lambda a: a[0], params["groups"][0][0]["rwkv"])
    tp = model.groups[0][0][0].rwkv
    x, x_prev, _, lens = _block_inputs(tcfg, seed=2)
    out, x_last = rwkv.channel_mix(tcfg, tp, *_t(x, x_prev),
                                   torch.from_numpy(lens))
    jout, jlast = jrwkv.channel_mix(jcfg, jp, jnp.asarray(x),
                                    jnp.asarray(x_prev), jnp.asarray(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **CACHE_TOL)
    np.testing.assert_allclose(x_last.numpy(), np.asarray(jlast), atol=0)


# ------------------------------------------------------------ model ------
def test_prefill_and_decode_match_reference():
    jcfg, tcfg, params, model = _pair()
    toks, lens = _prompts(jcfg, [40, 17, 5], 40)
    jl, jc = j_prefill(jcfg, params, tokens=jnp.asarray(toks),
                       lengths=jnp.asarray(lens), cache_len=128)
    tl, tc = ttfm.prefill(tcfg, model, torch.from_numpy(toks),
                          torch.from_numpy(lens), cache_len=128)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert np.array_equal(tc["pos"].numpy(), lens)
    _assert_state(tc, jc)
    s = tc["groups"][0][0]
    assert s["s"].dtype == torch.float32 and s["x_tm"].dtype == torch.float32
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    for _ in range(4):
        jl, jc = j_decode(jcfg, params, jnp.asarray(tok), jc)
        tl, tc = ttfm.decode_step(tcfg, model, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        assert np.array_equal(tl.argmax(-1).numpy(),
                              np.asarray(jnp.argmax(jl, -1)))
        tok = np.array(jnp.argmax(jl, -1), np.int32)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    _assert_state(tc, jc)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_prefill_chunk_matches_reference_and_freezes_finished_rows(chunk):
    """Rows of 10, 37 and 64 tokens in chunks: logits of each row's last
    chunk and the final carries agree with the reference; a row's carry
    leaves stay bit for bit once its prompt has ended."""
    jcfg, tcfg, params, model = _pair()
    lens = np.array([10, 37, 64], np.int32)
    toks, _ = _prompts(jcfg, lens, 64)
    B = len(lens)
    jc = jtfm.init_cache(jcfg, B, 128)
    tc = ttfm.init_cache(tcfg, B, 128, device="cpu")
    frozen = {}
    for s in range(0, 64, chunk):
        jl, jc = j_chunk(jcfg, params, jnp.asarray(toks[:, s:s + chunk]), jc,
                         s, jnp.asarray(lens))
        tl, tc = ttfm.prefill_chunk(tcfg, model,
                                    torch.from_numpy(toks[:, s:s + chunk]),
                                    tc, s, torch.from_numpy(lens))
        fin = ((lens - 1) >= s) & ((lens - 1) < s + chunk)
        np.testing.assert_allclose(tl.numpy()[fin], np.asarray(jl)[fin],
                                   **LOGIT_TOL)
        for b in np.flatnonzero(fin):
            frozen[b] = {k: v[:, b].clone()
                         for k, v in tc["groups"][0][0].items()}
    _assert_state(tc, jc)
    assert len(frozen) == B
    for b, leaves in frozen.items():
        for k, v in leaves.items():
            assert torch.equal(tc["groups"][0][0][k][:, b], v), (b, k)
    # chunked == whole-prompt prefill, within the kernel tolerance
    _, whole = ttfm.prefill(tcfg, model, torch.from_numpy(toks),
                            torch.from_numpy(lens), cache_len=128)
    for k in LEAVES:
        np.testing.assert_allclose(tc["groups"][0][0][k].numpy(),
                                   whole["groups"][0][0][k].numpy(),
                                   **CACHE_TOL)


# ----------------------------------------------------------- dtypes ------
def test_bridge_keys_and_f32_leaves_in_a_bf16_model():
    """The bridge fills the rwkv leaves by their key paths; in a bf16
    model the decay path and bonus stay f32 and exact, the rest is bf16;
    casting the model wholesale is refused."""
    jcfg, tcfg, params, model = _pair(dtype=torch.bfloat16)
    flat = bridge.flatten(jax.tree.map(np.asarray, params))
    assert "groups/0/0/rwkv/w0" in flat and "groups/0/0/rwkv/u" in flat
    blk = model.groups[0][0][1].rwkv
    for name in rwkv.F32_LEAVES:
        leaf = getattr(blk, name)
        assert leaf.dtype == torch.float32, name
        assert np.array_equal(leaf.numpy(), flat[f"groups/0/0/rwkv/{name}"][1])
    assert blk.wr.dtype == blk.ln_x.dtype == model.embed.dtype == \
        torch.bfloat16
    with pytest.raises(TypeError, match="stay float32"):
        model.to(torch.bfloat16)
    assert blk.w0.dtype == torch.float32
    model.to("cpu")                                   # a move is fine
    toks, lens = _prompts(tcfg, [9, 4], 9)
    logits, cache = ttfm.prefill(tcfg, model, torch.from_numpy(toks),
                                 torch.from_numpy(lens), cache_len=32)
    assert torch.isfinite(logits).all()
    leaves = cache["groups"][0][0]
    assert leaves["s"].dtype == torch.float32
    assert leaves["x_tm"].dtype == leaves["x_cm"].dtype == torch.bfloat16


def test_init_params_and_caches_keep_f32_leaves():
    cfg = get_smoke_config(ARCH, max_seq_len=64)
    a = ttfm.init_params(cfg, seed=3, dtype=torch.bfloat16, device="cpu")
    b = ttfm.init_params(cfg, seed=3, dtype=torch.bfloat16, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    p = a.groups[0][0][0].rwkv
    assert all(getattr(p, n).dtype == torch.float32 for n in rwkv.F32_LEAVES)
    assert float(p.w0.max()) == float(p.w0.min()) == -0.5
    assert float(p.mix_r.max()) == 0.5
    assert abs(float(p.u.std()) - 0.1) < 0.02
    assert p.ck.shape == (cfg.d_model, rwkv.channel_mix_width(cfg))
    for cache in (ttfm.init_cache(cfg, 2, 64, torch.bfloat16, "cpu"),
                  ttfm.init_paged_cache(cfg, 2, 64, 5, 16, torch.bfloat16,
                                        "cpu")):
        leaves = cache["groups"][0][0]
        assert leaves["s"].shape == (cfg.n_layers, 2, 4, 64, 64)
        assert leaves["s"].dtype == torch.float32
        assert leaves["x_tm"].dtype == torch.bfloat16
    jc = jax.tree.map(np.asarray, jtfm.init_cache(
        jax_smoke_config(ARCH, max_seq_len=64), 2, 64))
    tc = bridge.cache_from_numpy(jc, device="cpu", dtype=torch.bfloat16)
    assert tc["groups"][0][0]["s"].dtype == torch.float32
    assert tc["groups"][0][0]["x_cm"].dtype == torch.bfloat16
    other = bridge.cache_from_numpy({"s": np.zeros(2, np.float32)},
                                    device="cpu", dtype=torch.bfloat16)
    assert other["s"].dtype == torch.bfloat16     # not an rwkv carry
