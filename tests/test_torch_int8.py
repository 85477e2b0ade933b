"""The port's int8 KV tier against the JAX package, and its own
bit-identities.

int8 caches are 4-tuples ``(k, v, k_s, v_s)``: int8 codes and one f32
scale per (token, kv head), from ``quantize_kv``.  On seeded numpy
inputs (f32):

- ``quantize_kv`` gives the reference's codes and scales bit for bit
  (f32 and bf16 inputs, rows of zeros), and the round trip keeps the
  error bound of ``tests/test_kv_quant.py``; the int8 decode kernels'
  conversion route (``ref.dequantize_kv_magic``) gives
  ``dequantize_kv``'s bits for all 256 codes over scales from 1e-8 to
  1e3;
- the four attention functions with an int8 cache (whole-prompt
  prefill, a prefill chunk, contiguous and paged decode, a ring) match
  the reference's at atol 2e-5 / rtol 2e-4; their caches too, on the
  valid slots: the K/V come from two frameworks' matmuls, so a value on
  a rounding boundary may take the neighbouring code (|delta| <= 1, on
  at most 0.1% of the codes) and the scales agree at the same
  tolerance;
- the plain int8 decode versions (``ref.flash_decode_int8_ref``,
  ``ref.paged_flash_decode_int8_ref``) against the reference's
  dequantize-then-``decode_attention``;
- prefill and 6 decode steps of qwen3-14b, yi-6b and qwen3-moe smoke in
  int8 (port logits against JAX logits), and mirrors of
  ``test_int8_decode_tracks_bf16`` and ``test_int8_with_sliding_window_
  ring``;
- the engine: token ids equal the JAX engine's on
  ``test_int8_kv_paged_parity``'s workload, paged == contiguous, pool
  page counts equal the JAX engine's, and an int8 pool through an int8
  spill tier gives the ids of the same pool without one
  (``test_int8_pool_spill_restore_lossless``, at ``time_scale`` 10).

The int8 decode kernels' cases on the card are in
``tests/test_torch_kernels.py``.
"""
import dataclasses
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
from repro.core.paging import device_pool_pages as jax_pool_pages
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.engine import ServingEngine as TorchEngine
from repro_torch.core.paging import device_pool_pages
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm

from test_torch_prefix import (PAGE, at_zero, one_torch_thread,  # noqa: F401
                               prefix_workload, serve, session_workload,
                               smoke_cfg)

TOL = dict(atol=2e-5, rtol=2e-4)
LOGIT_TOL = dict(atol=1e-4, rtol=0)
# Logits of steps that attend over dequantized codes (chunks, decode):
# the two frameworks' matmuls differ in the last f32 bits, and a K/V
# value within that of a rounding boundary takes the neighbouring code
# in one of them (one in 10^4 or so), which moves a smoke model's
# logits by a few 1e-4 (5.3e-4 on the ring test below, where the flipped
# code stays in the cache for every later step).  A wrong scale, page or
# dtype moves them by 1e-2 to 1.
INT8_LOGIT_TOL = dict(atol=2e-3, rtol=0)
TIME_SCALE = 10.0

j_prefill = jax.jit(jtfm.prefill, static_argnums=0,
                    static_argnames=("cache_len",))
j_chunk = jax.jit(jtfm.prefill_chunk, static_argnums=0)
j_decode = jax.jit(jtfm.decode_step, static_argnums=0,
                   static_argnames=("page_size", "paged_len"))


@functools.lru_cache(maxsize=None)
def _params(arch):
    return jtfm.init_params(jax_smoke_config(arch), jax.random.PRNGKey(0))


def _pair(arch, **overrides):
    """The reference's and the port's int8 smoke configs, the reference's
    weights and the same weights in the port."""
    overrides.setdefault("kv_cache_dtype", "int8")
    jcfg = jax_smoke_config(arch, **overrides)
    tcfg = get_smoke_config(arch, **overrides)
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, _params(arch)),
                                     tcfg, device="cpu")
    return jcfg, tcfg, _params(arch), model


def _prompts(cfg, lens, pad, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), pad), np.int32)
    for i, L in enumerate(lens):
        toks[i, :L] = rng.integers(0, cfg.vocab_size, L)
    return toks, np.asarray(lens, np.int32)


def _leaf(cache, key):
    return np.asarray(cache["groups"][0][0][key])


def assert_cache_close(tc, jc, valid=None):
    """Codes within one step of the reference's (at most 0.1% of them
    off), and the scales and the dequantized K/V of equal codes at the
    tolerance, on ``valid`` slots ((reps, B, S) mask) or all of them."""
    for key in ("k", "v"):
        t = tc["groups"][0][0][key].numpy()
        j = _leaf(jc, key)
        ts = tc["groups"][0][0][key + "_s"].numpy()
        js = _leaf(jc, key + "_s")
        assert t.dtype == np.int8 and j.dtype == np.int8
        if valid is not None:
            t, j, ts, js = t[valid], j[valid], ts[valid], js[valid]
        d = np.abs(t.astype(np.int32) - j.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (key, d.max())
        np.testing.assert_allclose(ts, js, **TOL)
        same = d == 0
        np.testing.assert_allclose((t * ts[..., None])[same],
                                   (j * js[..., None])[same], **TOL)


# ------------------------------------------------------------ quantize --
QUANT_SHAPES = [(2, 5, 3, 16), (1, 7, 2, 64), (3, 1, 4, 128)]


@pytest.mark.parametrize("shape", QUANT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_the_reference_bit_for_bit(shape, dtype):
    """Codes and scales equal the reference's exactly, with rows of zeros
    (scale 1e-8, codes 0) and a row with a value on a half step."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 50)).astype(
        np.float32)
    x[0, 0] = 0.0
    x[-1, -1, -1, :2] = [1.0, 127.5 / 127]        # 63.75 -> 64 (even)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    codes, scale = tattn.quantize_kv(xt)
    jcodes, jscale = jattn.quantize_kv(xj)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    assert np.array_equal(scale.numpy(), np.asarray(jscale))
    assert (scale[0, 0] == np.float32(1e-8)).all()
    assert (codes[0, 0] == 0).all()
    back = ref.dequantize_kv(codes, scale, xt.dtype)
    jback = jattn.dequantize_kv(jcodes, jscale, xj.dtype)
    assert np.array_equal(back.float().numpy(),
                          np.asarray(jback, np.float32))


@pytest.mark.parametrize("s,h,scale", [(1, 1, 0.01), (3, 2, 1.0),
                                       (8, 4, 100.0), (5, 3, 7.3)])
def test_quant_roundtrip_error_bound(s, h, scale):
    """``tests/test_kv_quant.py::test_quant_roundtrip_error_bound``:
    per-row error at most half a quantization step."""
    x = torch.from_numpy((np.random.default_rng(s * 7 + h)
                          .standard_normal((2, s, h, 16)) * scale)
                         .astype(np.float32))
    q, sc = tattn.quantize_kv(x)
    back = ref.dequantize_kv(q, sc)
    bound = x.abs().amax(-1, keepdim=True) / 127.0 * 0.51
    assert ((back - x).abs() <= bound + 1e-6).all()
    assert q.dtype == torch.int8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_kv_magic_route_is_bit_exact(dtype):
    """The int8 decode kernels' conversion route
    (``ref.dequantize_kv_magic``: the code's byte in the mantissa of
    2^23, 2^23 + 128 subtracted, the product with the scale rounded to
    f32 and then to ``dtype``) gives ``ref.dequantize_kv``'s and the
    reference's ``dequantize_kv``'s bits for all 256 byte values, over
    scales from ``quantize_kv``'s 1e-8 floor to 1e3: 2048 log-spaced,
    2048 drawn log-uniform (about 2^-16 of the f32 products fall on a
    bf16 rounding tie, so some do here) and a few exact powers of two."""
    rng = np.random.default_rng(34)
    lo, hi = np.log(1e-8), np.log(1e3)
    scales = np.concatenate([
        np.geomspace(1e-8, 1e3, 2048), np.exp(rng.uniform(lo, hi, 2048)),
        [1e-8, 2.0 ** -20, 1.0, 2.0, 1e3]]).astype(np.float32)
    codes = np.ascontiguousarray(np.broadcast_to(
        np.arange(-128, 128, dtype=np.int8), (len(scales), 256)))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ct, st = torch.from_numpy(codes), torch.from_numpy(scales)
    got = ref.dequantize_kv_magic(ct, st, tdt)
    want = ref.dequantize_kv(ct, st, tdt)
    jwant = np.asarray(jattn.dequantize_kv(jnp.asarray(codes),
                                           jnp.asarray(scales), jdt))
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    assert got.dtype == tdt
    assert torch.equal(got.view(bits), want.view(bits))
    assert np.array_equal(got.view(bits).numpy(),
                          jwant.view(got.view(bits).numpy().dtype))


# ------------------------------------------------- attention functions --
def _layer(arch, **overrides):
    """One attention layer's weights on both sides (group 0, rep 0)."""
    jcfg, tcfg, params, model = _pair(arch, **overrides)
    jp = jax.tree.map(lambda a: a[0], params["groups"][0][0]["attn"])
    return jcfg, tcfg, jp, model.groups[0][0][0].attn


def _x(cfg, B, T, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


def _port_cache(cfg, B, S):
    c = ttfm.init_cache(cfg, B, S, device="cpu")["groups"][0][0]
    return tuple(c[k][0] for k in ("k", "v", "k_s", "v_s"))


def _as_jax(cache):
    return tuple(jnp.asarray(c.numpy()) for c in cache)


def _check_cache(tc, jc, valid=None):
    """``assert_cache_close`` for (k, v, k_s, v_s) tuples."""
    keys = ("k", "v", "k_s", "v_s")
    assert_cache_close({"groups": ((dict(zip(keys, tc)),),)},
                       {"groups": ((dict(zip(keys, jc)),),)}, valid=valid)


@pytest.mark.parametrize("window", [0, 8])
def test_self_attn_forward_int8(window):
    """Whole-prompt prefill attends over the unquantized K/V and stores
    codes and scales; the reference quantizes the zero padding past T,
    so those slots hold scale 1e-8 in both."""
    jcfg, tcfg, jp, tp = _layer("qwen3-14b", max_seq_len=32)
    B, T, S = 2, 20, 32
    x = _x(jcfg, B, T, 1)
    lens = np.array([20, 13], np.int32)
    pos = np.arange(T, dtype=np.int32)
    jout, jc = jattn.self_attn_forward(
        jcfg, jp, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(lens),
        window=window, make_cache=True, cache_len=S)
    tc = _port_cache(tcfg, B, window or S)
    tout = tattn.self_attn_forward(
        tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos),
        torch.from_numpy(lens), window=window, cache=tc, cache_len=S)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    assert jc[0].shape == tuple(tc[0].shape)
    _check_cache(tc, jc)
    if not window:
        assert (tc[2][:, T:] == np.float32(1e-8)).all()


def test_self_attn_chunk_int8():
    """Chunks attend over the dequantized cache prefix, their own codes
    included; ``active`` freezes a finished row's codes and scales."""
    jcfg, tcfg, jp, tp = _layer("qwen3-14b", max_seq_len=48)
    B, S, Tc = 2, 48, 16
    tc = _port_cache(tcfg, B, S)
    jc = _as_jax(tc)
    for i, start in enumerate((0, 16, 32)):
        x = _x(jcfg, B, Tc, 10 + i)
        jout, jc = jattn.self_attn_chunk(jcfg, jp, jnp.asarray(x),
                                         jnp.int32(start), jc)
        active = torch.tensor([True, start < 16])
        before = [c.clone() for c in tc]
        tout = tattn.self_attn_chunk(tcfg, tp, torch.from_numpy(x), start,
                                     tc, active)
        # a frozen row's output is garbage (the reference writes the chunk
        # into its cache instead of freezing it)
        np.testing.assert_allclose(tout.numpy()[active.numpy()],
                                   np.asarray(jout)[active.numpy()], **TOL)
        if start >= 16:          # row 1 is frozen
            assert all(torch.equal(a[1], b[1]) for a, b in zip(tc, before))
    valid = np.zeros((B, S), bool)
    valid[0, :] = True
    valid[1, :16] = True
    _check_cache(tc, jc, valid)


@pytest.mark.parametrize("window", [0, 8])
def test_self_attn_decode_int8(window):
    """Contiguous decode, one row on a ring or past the cache: the
    token's codes and scales land under the dead-slot mask."""
    jcfg, tcfg, jp, tp = _layer("qwen3-14b", max_seq_len=16)
    B, S = 3, 16
    S_eff = window or S
    rng = np.random.default_rng(4)
    tc = _port_cache(tcfg, B, S_eff)
    codes = rng.integers(-127, 128, tuple(tc[0].shape)).astype(np.int8)
    for c, val in zip(tc, (codes, codes[:, ::-1].copy(),
                           rng.uniform(1e-3, 0.1, tuple(tc[2].shape)),
                           rng.uniform(1e-3, 0.1, tuple(tc[3].shape)))):
        c.copy_(torch.from_numpy(np.asarray(val)))
    jc = _as_jax(tc)
    for step in range(3):
        pos = np.array([S - 2 + step, 5 + step, 2 * S_eff + step],
                       np.int32)
        x = _x(jcfg, B, 1, 20 + step)
        jout, jc = jattn.self_attn_decode(jcfg, jp, jnp.asarray(x),
                                          jnp.asarray(pos), jc,
                                          window=window)
        tout = tattn.self_attn_decode(tcfg, tp, torch.from_numpy(x),
                                      torch.from_numpy(pos), tc,
                                      window=window)
        live = pos < S_eff if not window else np.ones(B, bool)
        np.testing.assert_allclose(tout.numpy()[live],
                                   np.asarray(jout)[live], **TOL)
    _check_cache(tc, jc)


@pytest.mark.parametrize("window", [0, 16])
def test_self_attn_decode_paged_int8(window):
    """Paged decode over a shuffled int8 pool with a trash page: codes
    and scales land in the table's page, a dead row on the trash page."""
    jcfg, tcfg, jp, tp = _layer("qwen3-14b", max_seq_len=64)
    B, page, s_len = 3, 8, 32
    n_p = s_len // page
    n_pages = B * n_p + 1
    rng = np.random.default_rng(5)
    cache = ttfm.init_paged_cache(tcfg, B, s_len, n_pages, page,
                                  device="cpu")["groups"][0][0]
    tc = tuple(cache[k][0] for k in ("k", "v", "k_s", "v_s"))
    tc[0].copy_(torch.from_numpy(rng.integers(
        -127, 128, tuple(tc[0].shape)).astype(np.int8)))
    tc[1].copy_(torch.from_numpy(rng.integers(
        -127, 128, tuple(tc[1].shape)).astype(np.int8)))
    for c in tc[2:]:
        c.copy_(torch.from_numpy(rng.uniform(
            1e-3, 0.1, tuple(c.shape)).astype(np.float32)))
    jc = _as_jax(tc)
    bt = rng.permutation(n_pages - 1)[:B * n_p].reshape(B, n_p).astype(
        np.int32)
    bt[2] = n_pages - 1                       # dead row: trash page
    for step in range(3):
        pos = np.array([11 + step, 30 + step, 40 + step], np.int32)
        if window:
            pos[1] = 2 * s_len + step
        x = _x(jcfg, B, 1, 30 + step)
        jout, jc = jattn.self_attn_decode_paged(
            jcfg, jp, jnp.asarray(x), jnp.asarray(pos), jc, jnp.asarray(bt),
            page_size=page, s_len=s_len, window=window)
        tout = tattn.self_attn_decode_paged(
            tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos), tc,
            torch.from_numpy(bt), page_size=page, s_len=s_len, window=window)
        np.testing.assert_allclose(tout.numpy()[:2], np.asarray(jout)[:2],
                                   **TOL)
    _check_cache(tc, jc)


# --------------------------------------------------- plain int8 decode --
DECODE_SHAPES = [(2, 256, 8, 2, 64, False), (1, 600, 4, 1, 128, False),
                 (2, 128, 4, 2, 64, True), (1, 512, 16, 2, 80, False)]
PAGED_SHAPES = [(2, 256, 8, 2, 64, 128, False), (1, 300, 4, 2, 64, 128,
                                                 False),
                (2, 96, 8, 2, 64, 64, True)]


def _int8_cache(rng, shape):
    codes = rng.integers(-127, 128, shape).astype(np.int8)
    scale = rng.uniform(1e-3, 0.05, shape[:-1]).astype(np.float32)
    return codes, scale


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_int8_ref_matches_reference(shape, dtype):
    B, S, H, Hkv, Dh, ring = shape
    rng = np.random.default_rng(S)
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    kc, ks = _int8_cache(rng, (B, S, Hkv, Dh))
    vc, vs = _int8_cache(rng, (B, S, Hkv, Dh))
    pos = np.array([S // 3, 2 * S + 5][:B] if ring else [S - 1, S // 2][:B],
                   np.int32)
    qt = torch.from_numpy(q).to(getattr(torch, dtype))
    qj = jnp.asarray(qt.float().numpy()).astype(getattr(jnp, dtype))
    got = ops.flash_decode_int8(qt, *(torch.from_numpy(a) for a in
                                      (kc, vc, ks, vs)),
                                torch.from_numpy(pos), ring=ring)
    want = jattn.decode_attention(
        qj, jattn.dequantize_kv(jnp.asarray(kc), jnp.asarray(ks), qj.dtype),
        jattn.dequantize_kv(jnp.asarray(vc), jnp.asarray(vs), qj.dtype),
        jnp.asarray(pos), window=S if ring else 0)
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("shape", PAGED_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_flash_decode_int8_ref_matches_reference(shape, dtype):
    """Gather, dequantize, decode: against the reference's
    ``gather_paged_kv`` + ``dequantize_kv`` + ``decode_attention`` (its
    ``vmem_fused:paged_flash_decode_int8`` scope), and against the
    contiguous int8 version on the gathered cache."""
    B, S, H, Hkv, Dh, page, ring = shape
    rng = np.random.default_rng(S + page)
    n_p = -(-S // page)
    n_pages = B * n_p + 3
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    kp, ks = _int8_cache(rng, (n_pages, page, Hkv, Dh))
    vp, vs = _int8_cache(rng, (n_pages, page, Hkv, Dh))
    bt = rng.permutation(n_pages)[:B * n_p].reshape(B, n_p).astype(np.int32)
    pos = np.array([2 * S + 5, S // 3][:B] if ring else [S - 1, S // 2][:B],
                   np.int32)
    qt = torch.from_numpy(q).to(getattr(torch, dtype))
    qj = jnp.asarray(qt.float().numpy()).astype(getattr(jnp, dtype))
    pool = [torch.from_numpy(a) for a in (kp, vp, ks, vs)]
    got = ops.paged_flash_decode_int8(qt, *pool, torch.from_numpy(bt),
                                      torch.from_numpy(pos), s_len=S,
                                      ring=ring)

    def deq(codes, scale):
        g = functools.partial(jattn.gather_paged_kv,
                              block_tables=jnp.asarray(bt), s_len=S)
        return jattn.dequantize_kv(g(jnp.asarray(codes)),
                                   g(jnp.asarray(scale)), qj.dtype)
    want = jattn.decode_attention(qj, deq(kp, ks), deq(vp, vs),
                                  jnp.asarray(pos), window=S if ring else 0)
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    btt = torch.from_numpy(bt)
    contig = ops.flash_decode_int8(
        qt, *(ref.gather_paged_kv(t, btt, S) for t in pool),
        torch.from_numpy(pos), ring=ring)
    assert torch.equal(got, contig)


# ---------------------------------------------------------------- model --
@pytest.mark.parametrize("arch", ["qwen3-14b", "yi-6b",
                                  "qwen3-moe-235b-a22b"])
def test_int8_prefill_and_decode_match_reference(arch):
    """Prefill and 6 decode steps in int8: port logits against JAX
    logits (prefill attends over the unquantized K/V: ``LOGIT_TOL``;
    decode over codes: ``INT8_LOGIT_TOL``), the caches on their valid
    slots."""
    S = 40
    jcfg, tcfg, params, model = _pair(arch, max_seq_len=S)
    toks, lens = _prompts(jcfg, [24, 13], 24)
    jl, jc = j_prefill(jcfg, params, tokens=jnp.asarray(toks),
                       lengths=jnp.asarray(lens), cache_len=S)
    tl, tc = ttfm.prefill(tcfg, model, torch.from_numpy(toks),
                          torch.from_numpy(lens), cache_len=S)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tc["groups"][0][0]["k"].dtype == torch.int8
    assert tc["groups"][0][0]["k_s"].shape == (jcfg.n_layers, 2, S,
                                               jcfg.n_kv_heads)
    assert_cache_close(tc, jc)
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    for _ in range(6):
        jl, jc = j_decode(jcfg, params, jnp.asarray(tok), jc)
        tl, tc = ttfm.decode_step(tcfg, model, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **INT8_LOGIT_TOL)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
    assert_cache_close(tc, jc)


@pytest.mark.parametrize("chunk", [8, 16])
def test_int8_prefill_chunk_matches_reference(chunk):
    """Chunked prefill over an int8 cache: each chunk's logits against
    the reference's ``prefill_chunk`` from the reference's cache before
    the chunk (``INT8_LOGIT_TOL``: a chunk attends over its own codes),
    and the port's own chunked cache against the reference's."""
    S = 40
    jcfg, tcfg, params, model = _pair("qwen3-14b", max_seq_len=S)
    toks, lens = _prompts(jcfg, [30, 11], 32)
    jc = jtfm.init_cache(jcfg, 2, S)
    tc = ttfm.init_cache(tcfg, 2, S, device="cpu")
    for start in range(0, 32, chunk):
        span = toks[:, start:start + chunk]
        step_in = bridge.cache_from_numpy(jax.tree.map(np.asarray, jc),
                                          device="cpu")
        jl, jc = j_chunk(jcfg, params, jnp.asarray(span), jc,
                         jnp.int32(start), jnp.asarray(lens))
        tl, _ = ttfm.prefill_chunk(tcfg, model, torch.from_numpy(span),
                                   step_in, start, torch.from_numpy(lens))
        _, tc = ttfm.prefill_chunk(tcfg, model, torch.from_numpy(span), tc,
                                   start, torch.from_numpy(lens))
        fin = (lens - 1 >= start) & (lens - 1 < start + chunk)
        np.testing.assert_allclose(tl.numpy()[fin], np.asarray(jl)[fin],
                                   **INT8_LOGIT_TOL)
    valid = np.arange(S)[None, None] < lens[None, :, None]   # (1, B, S)
    valid = np.broadcast_to(valid, (jcfg.n_layers, 2, S))
    assert_cache_close(tc, jc, valid)


@pytest.mark.parametrize("arch", ["qwen3-14b", "yi-6b"])
def test_int8_decode_tracks_bf16(arch):
    """``tests/test_kv_quant.py::test_int8_decode_tracks_bf16`` in the
    port: greedy ids of the int8 cache agree with the float cache's on
    at least 5 of 6 steps."""
    _, tcfg, _, model = _pair(arch, kv_cache_dtype="")
    cfg8 = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 24)).astype(np.int32))
    l1, c1 = ttfm.prefill(tcfg, model, tok, cache_len=40)
    l2, c2 = ttfm.prefill(cfg8, model, tok, cache_len=40)
    assert c2["groups"][0][0]["k"].dtype == torch.int8
    assert "k_s" in c2["groups"][0][0]
    agree = 0
    for _ in range(6):
        n1 = l1.argmax(-1).to(torch.int32)
        n2 = l2.argmax(-1).to(torch.int32)
        agree += int(torch.equal(n1, n2))
        l1, c1 = ttfm.decode_step(tcfg, model, n1, c1)
        l2, c2 = ttfm.decode_step(cfg8, model, n2, c2)
    assert agree >= 5


def test_int8_with_sliding_window_ring():
    """``tests/test_kv_quant.py::test_int8_with_sliding_window_ring``,
    held to the reference's logits at every step of the wrap."""
    jcfg, tcfg, params, model = _pair("yi-6b", sliding_window=16,
                                      max_seq_len=64)
    toks, lens = _prompts(jcfg, [24, 24], 24, seed=2)
    jl, jc = j_prefill(jcfg, params, tokens=jnp.asarray(toks), cache_len=64)
    tl, tc = ttfm.prefill(tcfg, model, torch.from_numpy(toks), cache_len=64)
    assert tc["groups"][0][0]["k"].shape[2] == 16          # ring-sized
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    for _ in range(8):                                     # wraps the ring
        jl, jc = j_decode(jcfg, params, jnp.asarray(tok), jc)
        tl, tc = ttfm.decode_step(tcfg, model, torch.from_numpy(tok), tc)
        assert torch.isfinite(tl).all()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **INT8_LOGIT_TOL)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
    assert_cache_close(tc, jc)


# --------------------------------------------------------------- engine --
def _engine(side, cfg, *, paged, slots=4, page_size=32, pool_tokens=None):
    core = jcore if side == "jax" else tcore
    sched = core.BucketServeScheduler(cfg, core.MemoryBudget(
        hbm_bytes_per_device=2 ** 30, n_devices=1, weight_bytes=0),
        core.SchedulerConfig(max_batch=slots,
                             memory_model="paged" if paged else "sum",
                             page_size=page_size))
    kw = dict(max_slots=slots, cache_len=cfg.max_seq_len, paged=paged,
              page_size=page_size, kv_pool_tokens=pool_tokens)
    if side == "jax":
        return JaxEngine(cfg, _params("qwen3-14b"), sched, **kw)
    return TorchEngine(cfg, _torch_model(), sched, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _torch_model():
    """The reference's qwen3-14b smoke weights in the port (the weights
    do not depend on the cache dtype or the cache length)."""
    return bridge.params_from_numpy(
        jax.tree.map(np.asarray, _params("qwen3-14b")),
        get_smoke_config("qwen3-14b"), device="cpu")


def _paged_parity_requests(core):
    rng = np.random.default_rng(5)
    return [core.Request(rid=i, prompt_len=int(rng.integers(8, 90)),
                         max_new_tokens=int(rng.integers(3, 9)),
                         arrival=0.0, task_type=core.TaskType.OFFLINE)
            for i in range(6)]


def test_int8_engine_ids_equal_jax_and_paged_equals_contiguous():
    """``tests/test_paged_serving.py::test_int8_kv_paged_parity``'s
    workload through both engines: the port's ids equal the JAX
    engine's on the paged pool, and the port's paged ids equal its
    contiguous ids (scales scattered to the wrong page would differ)."""
    outs = {}
    for side in ("jax", "torch"):
        core = jcore if side == "jax" else tcore
        cfg = (jax_smoke_config if side == "jax" else get_smoke_config)(
            "qwen3-14b", max_seq_len=128, kv_cache_dtype="int8")
        for paged in ((True,) if side == "jax" else (False, True)):
            reqs = _paged_parity_requests(core)
            eng = _engine(side, cfg, paged=paged)
            eng.submit(reqs)
            assert len(eng.run(max_wall_s=300)) == 6
            outs[side, paged] = {r.rid: list(eng.outputs[r.rid])
                                 for r in reqs}
            if paged and side == "torch":
                leaves = eng.backend.pool_cache["groups"][0][0]
                assert leaves["k"].dtype == torch.int8
                assert leaves["k_s"].dtype == torch.float32
                assert eng.backend.free_blocks() == eng.backend.alloc.n_pages
    assert outs["torch", True] == outs["jax", True]
    assert outs["torch", True] == outs["torch", False]


@pytest.mark.parametrize("pool_tokens", [None, 20 * 32, 4480])
def test_int8_pool_pages_equal_jax(pool_tokens):
    """The int8 pool's page count is the JAX engine's under the same
    ``kv_pool_tokens``, and about twice the bf16 pool's."""
    pages = {}
    for dtype in ("", "int8"):
        for side in ("jax", "torch"):
            cfg = (jax_smoke_config if side == "jax" else get_smoke_config)(
                "qwen3-14b", max_seq_len=128, kv_cache_dtype=dtype)
            pages[side, dtype] = _engine(side, cfg, paged=True,
                                         pool_tokens=pool_tokens
                                         ).backend.alloc.n_pages
    assert pages["torch", "int8"] == pages["jax", "int8"]
    assert pages["torch", ""] == pages["jax", ""]
    if pool_tokens is not None:
        assert pages["torch", "int8"] >= int(1.8 * pages["torch", ""])


def test_int8_pool_pages_at_full_width():
    """Qwen3-14B at full width: a token is 163840 B in bf16 and 84480 B
    in int8, and the recovery runs' 4480-token budget buys 34 bf16 pages
    and 66 int8 pages (each less the trash page)."""
    cfg = get_config("qwen3-14b")
    cfg8 = get_config("qwen3-14b", variant="int8")
    assert cfg.cache_bytes_per_token() == 163840
    assert cfg8.cache_bytes_per_token() == 84480
    assert device_pool_pages(cfg, 4480, 128) - 1 == 34
    assert device_pool_pages(cfg8, 4480, 128) - 1 == 66
    from repro.configs import get_config as jax_config
    assert device_pool_pages(cfg8, 4480, 128) == jax_pool_pages(
        jax_config("qwen3-14b", variant="int8"), 4480, 128)


def test_int8_pool_spill_restore_lossless():
    """``tests/test_kv_spill.py::TestQuantizedSpillEngine::
    test_int8_pool_spill_restore_lossless`` in the port: an int8 pool
    spills its own codes and scale planes raw to an int8 tier, so the
    ids equal the same pool's without a spill tier (engine clock at
    ``time_scale`` 10: the same decisions, a tenth of the wall time)."""
    cfg = smoke_cfg("torch", max_seq_len=1024, kv_cache_dtype="int8")
    runs = {}
    for host in (None, 64 * PAGE):
        runs[host] = serve(
            "torch", cfg, session_workload("torch", cfg, sessions=3,
                                           turns=4, utter=200, out=8),
            pool_tokens=7 * PAGE, session_ttl=1000.0,
            host_pool_tokens=host,
            spill_dtype="int8" if host else "", time_scale=TIME_SCALE)
    spill = runs[64 * PAGE]
    assert spill.be.pool_cache["groups"][0][0]["k"].dtype == torch.int8
    assert spill.res.spilled_pages > 0 and spill.res.restored_pages > 0
    assert spill.outs == runs[None].outs
    assert spill.prompts == runs[None].prompts
    copier = spill.be.retention.copier
    assert not copier._scales           # every leaf passed raw
    assert {lk[2] for lk in copier._host} == {"k", "v", "k_s", "v_s"}


@pytest.mark.parametrize("spill_dtype", ["int8", "int4"])
def test_int8_pool_copier_round_trip(spill_dtype):
    """A page of an int8 pool spilled and restored into another page: an
    int8 tier gives its codes and scales back bit for bit; an int4 tier
    packs the codes and re-expands them to int8 codes on restore (the
    reference's round trip), the scale planes raw."""
    cfg = get_smoke_config("qwen3-14b", max_seq_len=256,
                           kv_cache_dtype="int8")
    eng = TorchEngine(cfg, _torch_model(), tcore.BucketServeScheduler(
        cfg, tcore.MemoryBudget(2 ** 30, 1, 0), tcore.SchedulerConfig()),
        max_slots=2, paged=True, page_size=32, session_ttl=10.0,
        host_pool_tokens=8 * 32, spill_dtype=spill_dtype, device="cpu")
    cp = eng.backend.retention.copier
    leaves = dict((lk[2], leaf) for lk, leaf in cp._attn_leaves())
    gen = torch.Generator().manual_seed(3)
    for key, leaf in leaves.items():
        leaf[:, 0] = (torch.randint(-127, 128, leaf[:, 0].shape,
                                    generator=gen).to(leaf.dtype)
                      if leaf.dtype == torch.int8 else
                      torch.rand(leaf[:, 0].shape, generator=gen))
    want = {k: leaf[:, 0].clone() for k, leaf in leaves.items()}
    cp.spill(0, 0)
    for leaf in leaves.values():
        leaf[:, 0] = 0
    cp.poll()
    cp.restore(0, 1)
    cp.poll()
    for key, leaf in leaves.items():
        got = leaf[:, 1]
        if spill_dtype == "int8" or key.endswith("_s"):
            assert torch.equal(got, want[key]), key
        else:
            x = want[key].float().numpy()
            packed, sc = tattn.quantize_kv_int4(x)
            back = tattn.dequantize_kv_int4(packed, sc, x.shape[-1])
            exp = np.clip(np.rint(back), -127, 127).astype(np.int8)
            assert np.array_equal(got.numpy(), exp), key


@pytest.mark.parametrize("workload", ["prefix", "sessions"])
def test_int8_retention_hit_equals_cold(workload):
    """Prefix hits and session resumes over an int8 pool give the cold
    run's ids.  Both runs use 64-token chunked prefill: a prefill resumed
    from cached pages attends over their dequantized codes, and so does
    every chunk of a chunked cold run (a whole-prompt prefill attends
    over the unquantized K/V, in the reference too)."""
    cfg = smoke_cfg("torch", max_seq_len=1024, kv_cache_dtype="int8")
    runs = {}
    for on in (False, True):
        if workload == "prefix":
            reqs = prefix_workload("torch", cfg, 16, 512)
            kw = dict(pool_tokens=8 * 1024, prefix_cache=on)
        else:
            reqs = at_zero(session_workload("torch", cfg))
            kw = dict(pool_tokens=64 * 128,
                      session_ttl=1000.0 if on else None)
        runs[on] = serve("torch", cfg, reqs, chunk=64, **kw)
    hit = runs[True].res
    assert (hit.prefix_hits if workload == "prefix" else
            hit.session_hits) > 0
    assert hit.prefill_tokens_skipped > 0
    assert runs[True].outs == runs[False].outs
    assert runs[True].prompts == runs[False].prompts
