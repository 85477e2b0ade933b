"""The port's kernels: the three attention kernels and the RWKV6
recurrence.

CPU cases: each plain PyTorch version (``repro_torch/kernels/ref.py``)
against the reference run as the reference's own kernel tests run it —
the jnp oracle in both dtypes, and the Pallas kernel in interpret mode
in f32 (interpretation costs seconds a case; ``wkv6`` in both dtypes) —
at the reference sweeps, plus ``Tq < Tk`` with a query offset against
``full_attention(q_offset=...)`` and two decay extremes for ``wkv6``.
Tolerances are the reference's (``_tol``, ``_wkv_tol``); only valid
query rows are compared.  The decode kernels' split-KV algebra
(``ref.split_kv_decode_ref``: partials over ranges of L slots merged in
range order) is held against the same references at several L, and the
host-side split rule (``decode_attn.plan``) against its invariants,
and ``kernels/ptxas.py``'s count of SASS opcodes on a listing.
Likewise the ``wkv6`` kernel's arithmetic order (``ref.wkv6_tiled_ref``:
the hoisted bonus, row-group partials folded halves first), also for
its weak-decay accuracy against float64, and its tile rule
(``wkv6.plan``, ``wkv6.valid``).

The kernels under autograd (``kernels/autograd.py``): a
``KernelFunction`` built with the plain version as its forward has the
plain version's gradients, and ``gradcheck`` holds it at f64 (causal,
windowed and non-causal attention with Tq != Tk and key lengths;
``wkv6``); on the card the kernels' own ``KernelFunction``s launch the
kernel once (counted) with the plain version's backward (counted),
against autograd through the plain versions.

CUDA cases (skipped without a card): each hand-written kernel against
its plain version on the card, at the same sweeps and at the main
path's widths (decode also at rows of every length, on wrapped rings,
with more than one split and bit-identical over two calls; the int8
decode kernels also over caches of every code from -128 to 127 at scales
from the 1e-8 floor to 1e3, at each head dim's V unit and the serve
step's shape, bit for bit the float kernels over the dequantized cache;
``wkv6`` also at ragged T, through every built tile, bit-identical over
two calls, with the C launch's tile rule the wrapper's; the prefill
wrapper's count of launches at a ``q_offset`` off the 64-row tile, which
a resumed chunk takes).  Run them on the
H100 with ``python -m pytest tests/test_torch_kernels.py -k cuda``.
The JAX reference is imported inside the CPU cases only: the machine
with the card has no JAX.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attn as decode_kernel
from repro_torch.kernels import flash_prefill as prefill_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import runtime
from repro_torch.kernels import wkv6 as wkv6_kernel
from repro_torch.kernels.autograd import KernelFunction

needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA card (run on the H100: "
           "python -m pytest tests/test_torch_kernels.py -k cuda)")

PREFILL_SHAPES = [
    # (B, T, H, Hkv, Dh, window, causal) — tests/test_kernels.py
    (1, 128, 4, 4, 64, 0, True),
    (2, 200, 8, 2, 64, 0, True),
    (2, 384, 4, 1, 128, 0, True),
    (1, 300, 4, 2, 64, 128, True),
    (2, 256, 4, 4, 80, 0, False),
    (1, 64, 2, 2, 256, 0, True),
]
DECODE_SHAPES = [
    # (B, S, H, Hkv, Dh, ring)
    (2, 256, 8, 2, 64, False),
    (1, 600, 4, 1, 128, False),
    (2, 256, 8, 8, 64, False),
    (2, 128, 4, 2, 64, True),
    (1, 512, 16, 2, 80, False),
    # recurrentgemma's local attention: G = 10 at Dh 256 (G * Dh 2560)
    (2, 256, 10, 1, 256, False),
    (2, 256, 10, 1, 256, True),
    # qwen3-moe-235b-a22b: G = 16 at Dh 128 (G * Dh 2048, the cap)
    (1, 300, 16, 1, 128, False),
    (2, 256, 16, 1, 128, True),
]
PAGED_SHAPES = [
    # (B, S, H, Hkv, Dh, page, ring)
    (2, 256, 8, 2, 64, 128, False),
    (2, 256, 8, 8, 64, 128, False),
    (1, 600, 4, 1, 128, 128, False),
    (1, 300, 4, 2, 64, 128, False),
    (2, 128, 4, 2, 64, 64, True),
    (2, 96, 8, 2, 64, 64, True),
    (1, 512, 16, 2, 80, 256, False),
    (2, 256, 10, 1, 256, 128, True),
    (1, 300, 16, 1, 128, 128, False),     # qwen3-moe: G = 16 at Dh 128
    (2, 256, 16, 1, 128, 128, True),
]
WKV_SHAPES = [
    # (B, T, H, hs) — tests/test_kernels.py
    (1, 64, 2, 64),
    (2, 100, 4, 64),                  # ragged T (padding in Pallas)
    (1, 128, 1, 32),
    (2, 48, 8, 16),
]
# constant decays at both ends: w = exp(-exp(3)) (the state forgets at
# once) and w = exp(-exp(-6)) (it keeps almost everything), the case that
# overflows a chunked cumulative-decay form
WKV_DECAYS = {"strong": float(np.exp(-np.exp(3.0))),
              "weak": float(np.exp(-np.exp(-6.0)))}
# chunked prefill: (B, Tq, Tk, H, Hkv, Dh, q_offset)
CHUNK_SHAPES = [
    (2, 64, 192, 4, 2, 64, 0),
    (2, 64, 192, 4, 2, 64, 37),
    (1, 64, 256, 8, 2, 128, 128),
    (2, 96, 256, 4, 1, 80, 37),
    (1, 64, 300, 16, 1, 128, 100),        # qwen3-moe: G = 16 at Dh 128
]
# the tensor-core prefill body (bf16, every head dim) off its 64-row,
# 64-key tile grid: (B, Tq, Tk, H, Hkv, causal, window, q_offset, lengths)
TENSOR_CORE_CASES = {
    "ragged": (1, 100, 230, 4, 2, True, 0, 130, None),
    "offset": (2, 77, 300, 8, 2, True, 0, 37, None),
    "lengths": (2, 150, 150, 4, 1, True, 0, 0, (150, 91)),
    "window": (1, 300, 300, 4, 2, True, 100, 0, None),
    "window_offset_lengths": (2, 70, 333, 4, 2, True, 64, 200, (333, 250)),
    "noncausal_lengths": (2, 96, 200, 4, 4, False, 0, 0, (200, 75)),
}
DTYPES = ["float32", "bfloat16"]
# nemotron-4-340b's attention: H 96, Hkv 8 (G = 12) at Dh 192, two
# warpgroups a block in the prefill body and G * Dh 2304 in the decode
# body; added to the card sweeps (the int8 decode kernels' too), held on
# the CPU against the reference's oracle by
# test_dh192_plain_versions_match_oracle
DH192_PREFILL = [
    # (B, T, H, Hkv, Dh, window, causal)
    (2, 150, 96, 8, 192, 0, True),
    (1, 200, 96, 8, 192, 64, True),
    (2, 96, 96, 8, 192, 0, False),
]
DH192_DECODE = [
    # (B, S, H, Hkv, Dh, ring)
    (2, 300, 96, 8, 192, False),
    (2, 256, 96, 8, 192, True),
]
DH192_PAGED = [
    # (B, S, H, Hkv, Dh, page, ring)
    (2, 300, 96, 8, 192, 128, False),
    (2, 256, 96, 8, 192, 64, True),
]


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-4)


def _cuda_tol(dtype):
    # summation order differs between the kernel and the plain version
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=1e-4, rtol=1e-3)


def _normal(rng, shape, dtype):
    """Seeded normal data, rounded to ``dtype`` and returned as f32 numpy
    (both frameworks then start from the same values)."""
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


def _t(x, dtype, device="cpu"):
    return torch.from_numpy(np.asarray(x)).to(device=device,
                                              dtype=getattr(torch, dtype))


def _j(x, dtype):
    import jax.numpy as jnp
    return jnp.asarray(np.asarray(x, np.float32)).astype(getattr(jnp, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


def _prefill_inputs(shape, dtype, seed=0):
    B, T, H, Hkv, Dh, window, causal = shape
    rng = np.random.default_rng(seed)
    q = _normal(rng, (B, T, H, Dh), dtype)
    k = _normal(rng, (B, T, Hkv, Dh), dtype)
    v = _normal(rng, (B, T, Hkv, Dh), dtype)
    lens = np.array([T, max(T // 2, 1)][:B], np.int32)
    return q, k, v, lens


def _decode_inputs(shape, dtype, seed=1):
    B, S, H, Hkv, Dh, ring = shape
    rng = np.random.default_rng(seed)
    q = _normal(rng, (B, H, Dh), dtype)
    kc = _normal(rng, (B, S, Hkv, Dh), dtype)
    vc = _normal(rng, (B, S, Hkv, Dh), dtype)
    pos = np.array([S // 3, 2 * S + 5][:B], np.int32) if ring else \
        np.array([S - 1, S // 2][:B], np.int32)
    return q, kc, vc, pos


def _paged_inputs(shape, dtype, seed=4):
    """A contiguous cache scattered into a randomly permuted page pool
    (a few pages never used), as the reference's paged test builds it."""
    B, S, H, Hkv, Dh, page, ring = shape
    rng = np.random.default_rng(seed)
    q = _normal(rng, (B, H, Dh), dtype)
    kc = _normal(rng, (B, S, Hkv, Dh), dtype)
    vc = _normal(rng, (B, S, Hkv, Dh), dtype)
    pos = np.array([2 * S + 5, S // 3][:B], np.int32) if ring else \
        np.array([S - 1, S // 2][:B], np.int32)
    n_p = -(-S // page)
    n_pages = B * n_p + 3
    perm = rng.permutation(n_pages)[:B * n_p].reshape(B, n_p)

    def pool(c):
        cp = np.zeros((B, n_p * page, Hkv, Dh), np.float32)
        cp[:, :S] = c
        out = np.zeros((n_pages, page, Hkv, Dh), np.float32)
        out[perm.reshape(-1)] = cp.reshape(B * n_p, page, Hkv, Dh)
        return out
    return q, kc, vc, pos, pool(kc), pool(vc), perm.astype(np.int32)


def _wkv_inputs(shape, dtype, seed=5, decay=None):
    """r, k, v and w rounded to ``dtype`` (w = sigmoid(normal), or the
    constant ``decay``), u and s0 in f32, as numpy f32."""
    B, T, H, hs = shape
    rng = np.random.default_rng(seed)
    r, k, v = (_normal(rng, (B, T, H, hs), dtype) for _ in range(3))
    if decay is None:
        w = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, H, hs))))
    else:
        w = np.full((B, T, H, hs), decay)
    w = torch.from_numpy(w.astype(np.float32)).to(
        getattr(torch, dtype)).float().numpy()
    u = (rng.standard_normal((H, hs)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hs, hs)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _wkv_tol(dtype):
    # tests/test_kernels.py::test_wkv6
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else \
        dict(atol=1e-4, rtol=1e-3)


def _valid_rows(T, lens):
    return np.arange(T)[None, :, None, None] < lens[:, None, None, None]


def _live_rows(B, Tq, Tk, causal, window, q_offset, lens):
    """(B,Tq,1,1): query rows with at least one unmasked key (rows whose
    keys are all masked are garbage in both versions)."""
    qp = np.arange(Tq)[:, None] + q_offset
    kp = np.arange(Tk)[None, :]
    ok = np.ones((Tq, Tk), bool)
    if causal:
        ok &= qp >= kp
    if window:
        ok &= qp - kp < window
    live = ok[None] & (kp[None] < np.asarray(lens)[:, None, None])
    return live.any(-1)[:, :, None, None]


# ------------------------------------------------------------ CPU cases --
@pytest.mark.parametrize("shape", PREFILL_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_prefill_ref_matches_pallas(shape, dtype):
    from repro.kernels import ref as jref
    from repro.kernels.flash_prefill import flash_prefill as pallas_prefill
    B, T, H, Hkv, Dh, window, causal = shape
    q, k, v, lens = _prefill_inputs(shape, dtype)
    got = ref.flash_prefill_ref(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                torch.from_numpy(lens), causal=causal,
                                window=window)
    assert got.dtype == getattr(torch, dtype)
    jargs = (_j(q, dtype), _j(k, dtype), _j(v, dtype))
    import jax.numpy as jnp
    jl = jnp.asarray(lens)
    wants = [jref.flash_prefill_ref(*jargs, jl, causal=causal,
                                    window=window)]
    if dtype == "float32":
        wants.append(pallas_prefill(*jargs, jl, causal=causal, window=window,
                                    interpret=True))
    valid = _valid_rows(T, lens)
    for want in wants:
        np.testing.assert_allclose(np.where(valid, _f32(got), 0),
                                   np.where(valid, _f32(want), 0),
                                   **_tol(dtype))


@pytest.mark.parametrize("shape", CHUNK_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_prefill_ref_chunk_offset(shape, dtype):
    """Tq < Tk with a query offset — chunked prefill's call — against the
    reference's ``full_attention(q_offset=...)``."""
    from repro.models.attention import full_attention
    B, Tq, Tk, H, Hkv, Dh, off = shape
    rng = np.random.default_rng(2)
    q = _normal(rng, (B, Tq, H, Dh), dtype)
    k = _normal(rng, (B, Tk, Hkv, Dh), dtype)
    v = _normal(rng, (B, Tk, Hkv, Dh), dtype)
    got = ref.flash_prefill_ref(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                causal=True, q_offset=off)
    want = full_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                          causal=True, q_offset=off)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_ref_matches_pallas(shape, dtype):
    from repro.kernels import ref as jref
    from repro.kernels.decode_attn import flash_decode as pallas_decode
    import jax.numpy as jnp
    B, S, H, Hkv, Dh, ring = shape
    q, kc, vc, pos = _decode_inputs(shape, dtype)
    got = ref.flash_decode_ref(_t(q, dtype), _t(kc, dtype), _t(vc, dtype),
                               torch.from_numpy(pos), ring=ring)
    jargs = (_j(q, dtype), _j(kc, dtype), _j(vc, dtype), jnp.asarray(pos))
    wants = [jref.flash_decode_ref(*jargs, ring=ring)]
    if dtype == "float32":
        wants.append(pallas_decode(*jargs, ring=ring, blk_s=128,
                                   interpret=True))
    for want in wants:
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("shape", PAGED_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_flash_decode_ref_matches_pallas(shape, dtype):
    from repro.kernels import ref as jref
    from repro.kernels.paged_decode_attn import \
        paged_flash_decode as pallas_paged
    import jax.numpy as jnp
    B, S, H, Hkv, Dh, page, ring = shape
    q, kc, vc, pos, kp, vp, bt = _paged_inputs(shape, dtype)
    got = ref.paged_flash_decode_ref(
        _t(q, dtype), _t(kp, dtype), _t(vp, dtype), torch.from_numpy(bt),
        torch.from_numpy(pos), s_len=S, ring=ring)
    jargs = (_j(q, dtype), _j(kp, dtype), _j(vp, dtype), jnp.asarray(bt),
             jnp.asarray(pos))
    wants = [jref.paged_flash_decode_ref(*jargs, s_len=S, ring=ring),
             ref.flash_decode_ref(_t(q, dtype), _t(kc, dtype), _t(vc, dtype),
                                  torch.from_numpy(pos), ring=ring)]
    if dtype == "float32":
        wants.append(pallas_paged(*jargs, s_len=S, ring=ring,
                                  interpret=True))
    for want in wants:
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("kind", ["prefill", "decode", "paged"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dh192_plain_versions_match_oracle(kind, dtype):
    """The plain versions at nemotron-4-340b's attention shape (H 96, Hkv
    8, Dh 192) against the reference's jnp oracle
    (``repro/kernels/ref.py``), as the card sweeps run them."""
    from repro.kernels import ref as jref
    import jax.numpy as jnp
    if kind == "prefill":
        shape = DH192_PREFILL[0]
        B, T, H, Hkv, Dh, window, causal = shape
        q, k, v, lens = _prefill_inputs(shape, dtype)
        got = ref.flash_prefill_ref(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                    torch.from_numpy(lens), causal=causal,
                                    window=window)
        want = jref.flash_prefill_ref(_j(q, dtype), _j(k, dtype),
                                      _j(v, dtype), jnp.asarray(lens),
                                      causal=causal, window=window)
        valid = _valid_rows(T, lens)
        got, want = np.where(valid, _f32(got), 0), np.where(valid,
                                                             _f32(want), 0)
    elif kind == "decode":
        B, S, H, Hkv, Dh, ring = DH192_DECODE[1]
        q, kc, vc, pos = _decode_inputs(DH192_DECODE[1], dtype)
        got = ref.flash_decode_ref(_t(q, dtype), _t(kc, dtype), _t(vc, dtype),
                                   torch.from_numpy(pos), ring=ring)
        want = jref.flash_decode_ref(_j(q, dtype), _j(kc, dtype),
                                     _j(vc, dtype), jnp.asarray(pos),
                                     ring=ring)
    else:
        B, S, H, Hkv, Dh, page, ring = DH192_PAGED[0]
        q, kc, vc, pos, kp, vp, bt = _paged_inputs(DH192_PAGED[0], dtype)
        got = ref.paged_flash_decode_ref(
            _t(q, dtype), _t(kp, dtype), _t(vp, dtype), torch.from_numpy(bt),
            torch.from_numpy(pos), s_len=S, ring=ring)
        want = jref.paged_flash_decode_ref(
            _j(q, dtype), _j(kp, dtype), _j(vp, dtype), jnp.asarray(bt),
            jnp.asarray(pos), s_len=S, ring=ring)
    assert H // Hkv == 12 and Dh == 192
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


# split lengths of the split-KV algebra, from a cache of S slots: one
# that divides S, one that does not, one longer than S
SPLIT_LENGTHS = {"divides": lambda S: S // 4, "ragged": lambda S: S // 3 + 1,
                 "over": lambda S: S + 64}


@functools.lru_cache(maxsize=None)
def _pallas_decode(shape, pos=None):
    """The Pallas contiguous decode kernel in interpret mode, f32, at
    ``_decode_inputs(shape)`` (``pos`` replaces the inputs' positions)."""
    from repro.kernels.decode_attn import flash_decode as pallas_decode
    import jax.numpy as jnp
    q, kc, vc, p = _decode_inputs(shape, "float32")
    p = p if pos is None else np.array(pos, np.int32)
    return _f32(pallas_decode(_j(q, "float32"), _j(kc, "float32"),
                              _j(vc, "float32"), jnp.asarray(p),
                              ring=shape[-1], blk_s=128, interpret=True))


@functools.lru_cache(maxsize=None)
def _pallas_paged(shape):
    from repro.kernels.paged_decode_attn import \
        paged_flash_decode as pallas_paged
    import jax.numpy as jnp
    q, kc, vc, pos, kp, vp, bt = _paged_inputs(shape, "float32")
    return _f32(pallas_paged(_j(q, "float32"), _j(kp, "float32"),
                             _j(vp, "float32"), jnp.asarray(bt),
                             jnp.asarray(pos), s_len=shape[1],
                             ring=shape[-1], interpret=True))


@pytest.mark.parametrize("split", sorted(SPLIT_LENGTHS))
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_split_kv_decode_ref_matches_pallas(shape, split):
    """The split-and-merge algebra of the decode kernels, in f32, against
    the plain version and the Pallas kernel in interpret mode."""
    S, ring = shape[1], shape[-1]
    q, kc, vc, pos = (torch.from_numpy(x) for x in
                      _decode_inputs(shape, "float32"))
    got = ref.split_kv_decode_ref(q, kc, vc, pos, L=SPLIT_LENGTHS[split](S),
                                  ring=ring)
    for want in (ref.flash_decode_ref(q, kc, vc, pos, ring=ring),
                 _pallas_decode(shape)):
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))


@pytest.mark.parametrize("split", sorted(SPLIT_LENGTHS))
@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_split_kv_paged_ref_matches_pallas(shape, split):
    """The same algebra over the pages gathered from a shuffled pool,
    against the plain paged version and the Pallas paged kernel."""
    S, ring = shape[1], shape[-1]
    q, kc, vc, pos, kp, vp, bt = (torch.from_numpy(x) for x in
                                  _paged_inputs(shape, "float32"))
    got = ref.split_kv_decode_ref(q, ref.gather_paged_kv(kp, bt, S),
                                  ref.gather_paged_kv(vp, bt, S), pos,
                                  L=SPLIT_LENGTHS[split](S), ring=ring)
    for want in (ref.paged_flash_decode_ref(q, kp, vp, bt, pos, s_len=S,
                                            ring=ring),
                 _pallas_paged(shape)):
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))


# (shape, pos): every split but the first empty; a ring wrapped once and
# twice beside one not yet wrapped
SPLIT_EDGES = {"first_slot_only": ((2, 256, 8, 2, 64, False), (0, 0)),
               "wrapped_ring": ((3, 256, 8, 2, 64, True), (300, 767, 40))}


@pytest.mark.parametrize("split", sorted(SPLIT_LENGTHS))
@pytest.mark.parametrize("edge", sorted(SPLIT_EDGES))
def test_split_kv_decode_ref_edges(edge, split):
    shape, pos = SPLIT_EDGES[edge]
    S, ring = shape[1], shape[-1]
    L = SPLIT_LENGTHS[split](S)
    q, kc, vc, _ = (torch.from_numpy(x) for x in
                    _decode_inputs(shape, "float32"))
    pt = torch.tensor(pos, dtype=torch.int32)
    valid = ref.decode_valid(pt, S, ring)
    live = [int(valid[:, lo:lo + L].any(1).sum()) for lo in range(0, S, L)]
    if edge == "first_slot_only":
        assert sum(live) == len(pos) and live[0] == len(pos)
    got = ref.split_kv_decode_ref(q, kc, vc, pt, L=L, ring=ring)
    for want in (ref.flash_decode_ref(q, kc, vc, pt, ring=ring),
                 _pallas_decode(shape, pos)):
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))


def test_split_kv_decode_ref_no_live_slot_is_zero():
    """A row with no live slot (pos < 0) merges to 0, not NaN, as the
    kernels write it."""
    q, kc, vc, _ = (torch.from_numpy(x) for x in
                    _decode_inputs((2, 256, 8, 2, 64, False), "float32"))
    got = ref.split_kv_decode_ref(q, kc, vc, torch.tensor([-1, 100]), L=64)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    np.testing.assert_allclose(
        _f32(got[1]), _f32(ref.flash_decode_ref(
            q, kc, vc, torch.tensor([-1, 100]))[1]), **_tol("float32"))


@pytest.mark.parametrize("B,Hkv,s_len", [
    (8, 8, 4096), (1, 8, 4096), (2, 2, 256), (1, 1, 600), (1, 1, 96),
    (8, 8, 32768), (64, 8, 4096), (3, 5, 1), (1, 1, 10 ** 6)])
def test_decode_split_plan(B, Hkv, s_len):
    """The host-side split rule: whole quanta, every slot covered, no
    split wholly past the cache, at most MAX_SPLITS splits."""
    p = decode_kernel.plan(B, Hkv, s_len, torch.bfloat16, 128)
    assert p.L % decode_kernel.SPLIT_QUANTUM == 0
    assert 1 <= p.n_split <= decode_kernel.MAX_SPLITS
    assert p.n_split * p.L >= s_len > (p.n_split - 1) * p.L
    assert p.body == "tensor_core"
    if (B, Hkv, s_len) == (8, 8, 4096):     # the main shape splits
        assert p.n_split > 1


def test_prefill_tile_matches_the_source():
    """The unaligned-offset counter's tile is the tensor-core body's
    query rows a block."""
    src = (Path(ref.__file__).parent.parent / "csrc" /
           "flash_prefill.cu").read_text()
    assert int(re.search(r"constexpr int kRows = (\d+);", src)[1]) \
        == runtime.PREFILL_TILE
    runtime.prefill_unaligned_counts["tensor_core"] = 3
    runtime.reset_launch_counts()
    assert not any(runtime.prefill_unaligned_counts.values())


@needs_cuda
def test_cuda_unaligned_offset_is_counted():
    """A chunk at q_offset 1037 runs on the tensor-core body and counts
    as unaligned; one at 1024 does not."""
    dev = torch.device("cuda")
    q = torch.randn(1, 45, 8, 128, device=dev, dtype=torch.bfloat16)
    k = torch.randn(1, 2048, 2, 128, device=dev, dtype=torch.bfloat16)
    runtime.reset_launch_counts()
    ops.flash_prefill(q, k, k, q_offset=1037)
    ops.flash_prefill(q, k, k, q_offset=1024)
    assert runtime.prefill_unaligned_counts == {"tensor_core": 1,
                                                "cuda_core": 0}
    assert runtime.prefill_body_counts["tensor_core"] == 2


def test_decode_plan_constants_match_source():
    """The wrapper's quantum and split cap are the kernel's."""
    src = (Path(ref.__file__).parent.parent / "csrc" /
           "decode_common.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kDecQuantum") == decode_kernel.SPLIT_QUANTUM
    assert const("kDecMaxSplit") == decode_kernel.MAX_SPLITS


def test_ptxas_counts_sass_opcodes():
    """``kernels/ptxas.py:sass_counts`` counts, in each instance of
    ``cuobjdump -sass``'s listing, the instructions whose opcode starts
    with each name asked for, predicated ones too: the check that the
    int8 decode kernels' element path holds no I2F."""
    from repro_torch.kernels import ptxas
    text = """
        code for sm_90a
                Function : _Z1av
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   I2F.S8 R2, R3 ;
        /*0020*/               @!P0 PRMT R4, R5, 0x7540, R6 ;
        /*0030*/                   F2FP.BF16.F32.PACK_AB R7, R8, R9 ;
                Function : _Z1bv
        /*0000*/                   I2FP.F32.S32 R2, R3 ;
        /*0010*/                   FADD R1, R2, -8388736 ;
    """
    got = ptxas.sass_counts(text, ("I2F", "PRMT", "F2FP", "FADD"))
    assert got == {"_Z1av": {"I2F": 1, "PRMT": 1, "F2FP": 1, "FADD": 0},
                   "_Z1bv": {"I2F": 1, "PRMT": 0, "F2FP": 0, "FADD": 1}}


@pytest.mark.parametrize("dtype,Dh,want", [
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 80, "tensor_core"),
    (torch.bfloat16, 128, "tensor_core"), (torch.bfloat16, 256, "tensor_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 128, "cuda_core")])
def test_decode_body_rule(dtype, Dh, want):
    """bf16 at every head dim takes the tensor-core decode body, f32 the
    CUDA-core body (``csrc/decode_common.cuh``)."""
    assert decode_kernel.body(dtype, Dh) == want


def _wkv_cases():
    return [(shape, dtype, None) for shape in WKV_SHAPES
            for dtype in DTYPES] + \
        [((2, 100, 4, 64), "float32", name) for name in WKV_DECAYS]


@pytest.mark.parametrize("shape,dtype,decay", _wkv_cases())
def test_wkv6_ref_matches_pallas(shape, dtype, decay):
    """The plain recurrence against the Pallas kernel in interpret mode
    and the reference's ``lax.scan`` oracle, at the reference sweep in
    both dtypes and at the two decay extremes."""
    from repro.kernels import ref as jref
    from repro.kernels.wkv6 import wkv6 as pallas_wkv6
    import jax.numpy as jnp
    r, k, v, w, u, s0 = _wkv_inputs(shape, dtype,
                                    decay=WKV_DECAYS.get(decay))
    got_y, got_s = ref.wkv6_ref(*(_t(x, dtype) for x in (r, k, v, w)),
                                torch.from_numpy(u), torch.from_numpy(s0))
    assert got_y.dtype == got_s.dtype == torch.float32
    jargs = tuple(_j(x, dtype) for x in (r, k, v, w)) + \
        (jnp.asarray(u), jnp.asarray(s0))
    for want_y, want_s in (pallas_wkv6(*jargs, blk_t=32, interpret=True),
                           jref.wkv6_ref(*jargs)):
        np.testing.assert_allclose(_f32(got_y), _f32(want_y),
                                   **_wkv_tol(dtype))
        np.testing.assert_allclose(_f32(got_s), _f32(want_s),
                                   **_wkv_tol(dtype))


def test_wkv6_state_out_may_be_s0_and_dispatch_stays_on_cpu():
    """``state_out`` receives sT, also when it is s0 itself; CPU tensors
    take the plain version and count no launch."""
    runtime.reset_launch_counts()
    r, k, v, w, u, s0 = (torch.from_numpy(x) for x in
                         _wkv_inputs((2, 20, 3, 16), "float32"))
    y, sT = ref.wkv6_ref(r, k, v, w, u, s0)
    state = s0.clone()
    y2, s2 = ops.wkv6(r, k, v, w, u, state, state_out=state)
    assert s2 is state
    assert torch.equal(y2, y) and torch.equal(state, sT)
    assert all(n == 0 for n in runtime.launch_counts.values())
    y64, s64 = ref.wkv6_ref(*(x.double() for x in (r, k, v, w, u, s0)))
    assert y64.dtype == s64.dtype == torch.float64
    np.testing.assert_allclose(y64.numpy(), y.numpy(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("shape,dtype,decay", _wkv_cases())
def test_wkv6_tiled_ref_matches_references(shape, dtype, decay):
    """The kernel's arithmetic order (``ref.wkv6_tiled_ref`` at the rows a
    thread holds in the shape's plan: the hoisted bonus, row-group
    partials folded halves first) against the reference's ``lax.scan``
    oracle and the plain step-by-step recurrence, at the reference sweep
    and the two decay extremes."""
    from repro.kernels import ref as jref
    import jax.numpy as jnp
    r, k, v, w, u, s0 = _wkv_inputs(shape, dtype,
                                    decay=WKV_DECAYS.get(decay))
    B, T, H, hs = shape
    kr = wkv6_kernel.plan(B, H, hs, T).kr
    args = tuple(_t(x, dtype) for x in (r, k, v, w)) + \
        (torch.from_numpy(u), torch.from_numpy(s0))
    got_y, got_s = ref.wkv6_tiled_ref(*args, kr=kr)
    assert got_y.dtype == got_s.dtype == torch.float32
    plain_y, plain_s = ref.wkv6_ref(*args)
    np.testing.assert_allclose(_f32(got_y), _f32(plain_y),
                               **_cuda_tol("float32"))
    np.testing.assert_allclose(_f32(got_s), _f32(plain_s),
                               **_cuda_tol("float32"))
    jargs = tuple(_j(x, dtype) for x in (r, k, v, w)) + \
        (jnp.asarray(u), jnp.asarray(s0))
    want_y, want_s = jref.wkv6_ref(*jargs)
    np.testing.assert_allclose(_f32(got_y), _f32(want_y), **_wkv_tol(dtype))
    np.testing.assert_allclose(_f32(got_s), _f32(want_s), **_wkv_tol(dtype))


@pytest.mark.parametrize("kr", sorted({kr for kr, _ in wkv6_kernel.TILES}))
@pytest.mark.parametrize("dtype", DTYPES)
def test_wkv6_tiled_ref_keeps_weak_decay_accuracy(kr, dtype):
    """Weak decay over 512 steps (the card's weak-decay case): the state
    grows to ~400 steps of k v and y's sums cancel, so two f32 orders
    differ by more than atol 1e-4.  The kernel's order must be as exact
    as the plain one: its error against a float64 evaluation at most
    twice the plain version's, plus 1e-6."""
    r, k, v, w, u, s0 = (torch.from_numpy(x) for x in _wkv_inputs(
        (2, 512, 4, 64), dtype, decay=WKV_DECAYS["weak"]))
    exact, exact_s = ref.wkv6_ref(*(x.double() for x in (r, k, v, w, u, s0)))
    plain, _ = ref.wkv6_ref(r, k, v, w, u, s0)
    got, got_s = ref.wkv6_tiled_ref(r, k, v, w, u, s0, kr=kr)
    err_got = float((got.double() - exact).abs().max())
    err_plain = float((plain.double() - exact).abs().max())
    assert torch.isfinite(got).all()
    assert err_got <= 2 * err_plain + 1e-6, (err_got, err_plain)
    np.testing.assert_allclose(got_s.numpy(), exact_s.numpy(),
                               **_cuda_tol("float32"))


def test_wkv6_refs_take_an_empty_sequence():
    """T = 0: no output steps and the state passes through."""
    r, k, v, w, u, s0 = (torch.from_numpy(x) for x in
                         _wkv_inputs((2, 0, 3, 16), "float32"))
    for fn in (ref.wkv6_ref, functools.partial(ref.wkv6_tiled_ref, kr=4)):
        y, sT = fn(r, k, v, w, u, s0)
        assert y.shape == (2, 0, 3, 16)
        assert torch.equal(sT, s0)


@pytest.mark.parametrize("hs", wkv6_kernel.HEAD_SIZES)
@pytest.mark.parametrize("B,H", [(1, 1), (2, 4), (8, 40), (1, 40),
                                 (64, 40)])
def test_wkv6_plan_gives_a_valid_tile(hs, B, H):
    """The split rule: a built tile that divides the head, a column's
    threads adjacent in one warp, whole warps and at most 1024 threads a
    block, taken by the C launch in both dtypes, for a chunk and a decode
    step; the decode step's blocks hold at most the chunk's columns."""
    p1 = wkv6_kernel.plan(B, H, hs, 1)
    p = wkv6_kernel.plan(B, H, hs, 512)
    assert (p1.kr, p1.vc) == (p.kr, p.vc) and p1.cols <= p.cols
    for p in (p, p1):
        _check_wkv_tile(hs, p)


def _check_wkv_tile(hs, p):
    assert (p.kr, p.vc) in wkv6_kernel.TILES
    g = hs // p.kr
    assert hs % p.kr == 0 and hs % p.cols == 0 and p.cols % p.vc == 0
    assert 32 % g == 0 and p.vc <= g                # a column in one warp
    threads = p.threads(hs)
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert p.cols >= min(hs, wkv6_kernel.MIN_COLS)
    for dtype in (torch.float32, torch.bfloat16):
        assert wkv6_kernel.valid(hs, p, dtype)


def test_wkv6_plan_at_the_serving_shapes():
    """rwkv6-3b at B = 8 (40 heads of 64), 4 rows by 8 columns a thread:
    the chunk one block of 128 threads a head, the decode step two blocks
    of 64."""
    p = wkv6_kernel.plan(8, 40, 64, 512)
    assert p == wkv6_kernel.WkvPlan(kr=4, vc=8, cols=64)
    assert p.threads(64) == 128 and p.blocks(8, 40, 64) == 320
    p = wkv6_kernel.plan(8, 40, 64, 1)
    assert p == wkv6_kernel.WkvPlan(kr=4, vc=8, cols=32)
    assert p.threads(64) == 64 and p.blocks(8, 40, 64) == 640


@pytest.mark.parametrize("hs", [0, 8, 48, 96, 128])
def test_wkv6_plan_refuses_other_head_sizes(hs):
    with pytest.raises(ValueError, match="head size"):
        wkv6_kernel.plan(8, 40, hs, 512)


def test_wkv6_plan_refuses_negative_T():
    with pytest.raises(ValueError, match="T = -1"):
        wkv6_kernel.plan(8, 40, 64, -1)


@pytest.mark.parametrize("tile,dtype,ok", [
    ((4, 8, 64), torch.bfloat16, True), ((8, 4, 32), torch.float32, True),
    ((8, 8, 64), torch.bfloat16, True), ((4, 2, 16), torch.float32, True),
    ((16, 4, 64), torch.float32, False),        # not a built tile
    ((4, 8, 48), torch.float32, False),         # cols does not divide hs
    ((4, 8, 8), torch.float32, False),          # 16 threads: not a warp
    ((4, 2, 64), torch.float32, False),         # 512 threads
    ((8, 8, 8), torch.bfloat16, False),         # 8 threads
])
def test_wkv6_tile_rule(tile, dtype, ok):
    """``valid`` is the C launch's rule for a given tile at hs = 64."""
    assert wkv6_kernel.valid(64, wkv6_kernel.WkvPlan(*tile), dtype) == ok


def test_wkv6_plan_constants_match_source():
    """The wrapper's plan constants and tiles are the kernel's."""
    src = (Path(ref.__file__).parent.parent / "csrc" / "wkv6.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    for name, value in [("kWkvTileT", wkv6_kernel.TILE_T),
                        ("kWkvStages", wkv6_kernel.STAGES),
                        ("kWkvMaxThreads", wkv6_kernel.MAX_THREADS),
                        ("kWkvPlanRows", wkv6_kernel.PLAN_ROWS),
                        ("kWkvPlanCols", wkv6_kernel.PLAN_COLS),
                        ("kWkvMinCols", wkv6_kernel.MIN_COLS),
                        ("kWkvTargetBlocks", wkv6_kernel.TARGET_BLOCKS)]:
        assert const(name) == value, name
    built = set(re.findall(r"if_tile<T, HS, (\d+), (\d+)>", src))
    assert built == {(str(a), str(b)) for a, b in wkv6_kernel.TILES}


def test_paged_gather_is_exact_and_clips():
    """The gather reconstructs the contiguous cache bit for bit, and an
    out-of-range table entry reads the last page (JAX's clamp) instead
    of raising."""
    rng = np.random.default_rng(5)
    B, S, Hkv, Dh, page = 3, 200, 2, 64, 64
    n_p = -(-S // page)
    kc = rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32)
    perm = rng.permutation(B * n_p + 2)[:B * n_p].reshape(B, n_p)
    kp = np.zeros((B, n_p * page, Hkv, Dh), np.float32)
    kp[:, :S] = kc
    pool = np.zeros((B * n_p + 2, page, Hkv, Dh), np.float32)
    pool[perm.reshape(-1)] = kp.reshape(B * n_p, page, Hkv, Dh)
    got = ref.gather_paged_kv(torch.from_numpy(pool),
                              torch.from_numpy(perm.astype(np.int32)), S)
    assert np.array_equal(got.numpy(), kc)
    bad = np.full((1, n_p), 10_000, np.int32)
    far = ref.gather_paged_kv(torch.from_numpy(pool), torch.from_numpy(bad),
                              S)
    assert np.array_equal(far.numpy()[0, :page], pool[-1])


def test_ops_dispatch_cpu_goes_to_plain_version():
    """CPU tensors take the plain version and never touch the launch
    counters."""
    runtime.reset_launch_counts()
    q, k, v, lens = _prefill_inputs((2, 64, 4, 2, 64, 0, True), "float32")
    a = ops.flash_prefill(_t(q, "float32"), _t(k, "float32"),
                          _t(v, "float32"), torch.from_numpy(lens))
    b = ref.flash_prefill_ref(_t(q, "float32"), _t(k, "float32"),
                              _t(v, "float32"), torch.from_numpy(lens))
    assert torch.equal(a, b)
    assert all(n == 0 for n in runtime.launch_counts.values())


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "tensor_core"),
                                        (torch.float32, "cuda_core")])
@pytest.mark.parametrize("Dh", (64, 80, 128, 192, 256))
def test_flash_prefill_body_rule(dtype, Dh, want):
    """bf16 takes the tensor-core body at every head dim the kernel
    takes, f32 the CUDA-core body (``csrc/flash_prefill.cu``)."""
    assert prefill_kernel.body(dtype, Dh) == want
    assert want in runtime.PREFILL_BODIES


def test_flash_prefill_bodies_match_the_source():
    """The source's body rule is the dtype alone, its tensor-core
    instances are ``TENSOR_CORE_HEAD_DIMS`` and so are its CUDA-core
    ones, whose kernel takes f32 alone: no bf16 instance of the
    CUDA-core body is left."""
    src = (Path(ref.__file__).parent.parent / "csrc" /
           "flash_prefill.cu").read_text()
    rule = re.search(r'extern "C" int rt_flash_prefill_body\(int dtype, '
                     r'int Dh\) \{(.*?)\n\}', src, re.S)[1]
    assert re.fullmatch(r"\s*\(void\)Dh;\s*"
                        r"return dtype == rt::kBFloat16;\s*", rule), rule
    tc = sorted(int(d) for d in re.findall(r"tc::launch<(\d+)>", src))
    assert tc == sorted(prefill_kernel.TENSOR_CORE_HEAD_DIMS)
    cc = sorted(int(d) for d in re.findall(r"launch<(\d+), \d+>\(", src))
    assert cc == tc
    assert re.search(r"flash_prefill_kernel\(const float\* __restrict__ q,",
                     src)


# ----------------------------------------------------------- CUDA cases --
@pytest.fixture
def cuda_exact_f32():
    """f32 matmuls in full precision while kernels are held against
    their plain versions."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


@needs_cuda
@pytest.mark.parametrize("shape", PREFILL_SHAPES + DH192_PREFILL)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_flash_prefill(shape, dtype, cuda_exact_f32):
    dev = cuda_exact_f32
    B, T, H, Hkv, Dh, window, causal = shape
    q, k, v, lens = _prefill_inputs(shape, dtype)
    args = [_t(x, dtype, dev) for x in (q, k, v)]
    lt = torch.from_numpy(lens).to(dev)
    n0 = runtime.launch_counts["flash_prefill"]
    which = prefill_kernel.body(args[0].dtype, Dh)
    b0 = runtime.prefill_body_counts[which]
    got = ops.flash_prefill(*args, lt, causal=causal, window=window)
    torch.cuda.synchronize()
    assert runtime.launch_counts["flash_prefill"] == n0 + 1
    assert runtime.prefill_body_counts[which] == b0 + 1
    want = ref.flash_prefill_ref(*args, lt, causal=causal, window=window)
    valid = _valid_rows(T, lens)
    np.testing.assert_allclose(np.where(valid, _f32(got), 0),
                               np.where(valid, _f32(want), 0),
                               **_cuda_tol(dtype))


@needs_cuda
@pytest.mark.parametrize("shape", CHUNK_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_flash_prefill_chunk_offset(shape, dtype, cuda_exact_f32):
    dev = cuda_exact_f32
    B, Tq, Tk, H, Hkv, Dh, off = shape
    rng = np.random.default_rng(2)
    q = _t(_normal(rng, (B, Tq, H, Dh), dtype), dtype, dev)
    k = _t(_normal(rng, (B, Tk, Hkv, Dh), dtype), dtype, dev)
    v = _t(_normal(rng, (B, Tk, Hkv, Dh), dtype), dtype, dev)
    got = ops.flash_prefill(q, k, v, causal=True, q_offset=off)
    torch.cuda.synchronize()
    want = ref.flash_prefill_ref(q, k, v, causal=True, q_offset=off)
    np.testing.assert_allclose(_f32(got), _f32(want), **_cuda_tol(dtype))


@needs_cuda
@pytest.mark.parametrize("case", sorted(TENSOR_CORE_CASES))
@pytest.mark.parametrize("Dh", prefill_kernel.TENSOR_CORE_HEAD_DIMS)
def test_cuda_flash_prefill_tensor_core_body(case, Dh, cuda_exact_f32):
    """bf16 through the wgmma body at ragged Tq / Tk, offsets off the
    64-row grid, lengths, windows and no mask, against the plain
    version at the sweep tolerance."""
    dev = cuda_exact_f32
    B, Tq, Tk, H, Hkv, causal, window, off, lens = TENSOR_CORE_CASES[case]
    rng = np.random.default_rng(3)
    q, k, v = (_t(_normal(rng, shape, "bfloat16"), "bfloat16", dev)
               for shape in ((B, Tq, H, Dh), (B, Tk, Hkv, Dh),
                             (B, Tk, Hkv, Dh)))
    lens = np.array(lens if lens else (Tk,) * B, np.int32)
    lt = torch.from_numpy(lens).to(dev)
    b0 = runtime.prefill_body_counts["tensor_core"]
    got = ops.flash_prefill(q, k, v, lt, causal=causal, window=window,
                            q_offset=off)
    torch.cuda.synchronize()
    assert runtime.prefill_body_counts["tensor_core"] == b0 + 1
    want = ref.flash_prefill_ref(q, k, v, lt, causal=causal, window=window,
                                 q_offset=off)
    live = _live_rows(B, Tq, Tk, causal, window, off, lens)
    assert live.any()
    np.testing.assert_allclose(np.where(live, _f32(got), 0),
                               np.where(live, _f32(want), 0),
                               **_cuda_tol("bfloat16"))


@needs_cuda
def test_cuda_flash_prefill_body_rule_matches_c(cuda_exact_f32):
    """The wrapper's body rule is the one the C launch applies."""
    lib = runtime.library()
    for dtype, code in runtime.DTYPE_CODES.items():
        for Dh in (64, 80, 128, 192, 256):
            c_body = ("tensor_core" if lib.rt_flash_prefill_body(code, Dh)
                      else "cuda_core")
            assert c_body == prefill_kernel.body(dtype, Dh)


@needs_cuda
@pytest.mark.parametrize("shape", DECODE_SHAPES + DH192_DECODE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_flash_decode(shape, dtype, cuda_exact_f32):
    dev = cuda_exact_f32
    q, kc, vc, pos = _decode_inputs(shape, dtype)
    args = [_t(x, dtype, dev) for x in (q, kc, vc)]
    pt = torch.from_numpy(pos).to(dev)
    n0 = runtime.launch_counts["flash_decode"]
    got = ops.flash_decode(*args, pt, ring=shape[-1])
    torch.cuda.synchronize()
    assert runtime.launch_counts["flash_decode"] == n0 + 1
    want = ref.flash_decode_ref(*args, pt, ring=shape[-1])
    np.testing.assert_allclose(_f32(got), _f32(want), **_cuda_tol(dtype))


@needs_cuda
@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("shape", DECODE_SHAPES + DH192_DECODE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_flash_decode_lse_out(shape, dtype, kind, cuda_exact_f32):
    """``lse_out`` of the contiguous decode kernels (f32 and bf16, float
    and int8 caches, rings, a row with no live slot: -inf) against the
    plain version's log-sum-exp; the output the same bits with and
    without it, and the launch counted in ``lse_counts`` too."""
    dev = cuda_exact_f32
    B, S, H, Hkv, Dh, ring = shape
    rng = np.random.default_rng(S + Dh + 7)
    q = _t(_normal(rng, (B, H, Dh), dtype), dtype, dev)
    if kind == "int8":
        kc, ks = _int8(rng, (B, S, Hkv, Dh), dev)
        vc, vs = _int8(rng, (B, S, Hkv, Dh), dev)
        kv, name = (kc, vc, ks, vs), "flash_decode_int8"
        fn, plain = ops.flash_decode_int8, ref.flash_decode_int8_ref
    else:
        kv = tuple(_t(_normal(rng, (B, S, Hkv, Dh), dtype), dtype, dev)
                   for _ in range(2))
        name, fn, plain = "flash_decode", ops.flash_decode, \
            ref.flash_decode_ref
    rows = [2 * S + 5, -1] if ring else [S // 2, -1]
    pos = torch.tensor(rows[:B], dtype=torch.int32, device=dev)
    lse = torch.full((B, H), 7.0, device=dev)
    n0, l0 = runtime.launch_counts[name], runtime.lse_counts[name]
    got = fn(q, *kv, pos, ring=ring, lse_out=lse)
    torch.cuda.synchronize()
    assert runtime.launch_counts[name] == n0 + 1
    assert runtime.lse_counts[name] == l0 + 1
    assert torch.equal(got, fn(q, *kv, pos, ring=ring))
    want = torch.empty_like(lse)
    plain(q, *kv, pos, ring=ring, lse_out=want)
    if B > 1:
        assert torch.isneginf(lse[1]).all()
        assert not got[1].any()
    np.testing.assert_allclose(lse[0].cpu().numpy(), want[0].cpu().numpy(),
                               **_cuda_tol(dtype))


@needs_cuda
@pytest.mark.parametrize("shape", PAGED_SHAPES + DH192_PAGED)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_paged_flash_decode(shape, dtype, cuda_exact_f32):
    dev = cuda_exact_f32
    B, S, H, Hkv, Dh, page, ring = shape
    q, kc, vc, pos, kp, vp, bt = _paged_inputs(shape, dtype)
    qt, kpt, vpt = (_t(x, dtype, dev) for x in (q, kp, vp))
    btt = torch.from_numpy(bt).to(dev)
    pt = torch.from_numpy(pos).to(dev)
    n0 = runtime.launch_counts["paged_flash_decode"]
    got = ops.paged_flash_decode(qt, kpt, vpt, btt, pt, s_len=S, ring=ring)
    torch.cuda.synchronize()
    assert runtime.launch_counts["paged_flash_decode"] == n0 + 1
    want = ref.paged_flash_decode_ref(qt, kpt, vpt, btt, pt, s_len=S,
                                      ring=ring)
    contig = ops.flash_decode(qt, _t(kc, dtype, dev), _t(vc, dtype, dev), pt,
                              ring=ring)
    for w in (want, contig):
        np.testing.assert_allclose(_f32(got), _f32(w), **_cuda_tol(dtype))


# The main path at Qwen3-14B's attention widths (H=40, Hkv=8, Dh=128):
# prefill T=2048, a 512-token chunk at offset 1536 over 4096 slots, and
# decode of 8 rows at context 2048 over 4096 slots (page 128).
MAIN = dict(H=40, Hkv=8, Dh=128)


def _cuda_main_tol(dtype):
    # both sides accumulate in f32 and round the output to bf16 once, so
    # they differ by about one bf16 ulp (2**-7 relative) at most
    return dict(atol=2e-3, rtol=1e-2) if dtype == "bfloat16" else \
        dict(atol=1e-4, rtol=1e-3)


@needs_cuda
@pytest.mark.parametrize("case", ["prefill", "chunk", "decode", "paged"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_main_path_shapes(case, dtype, cuda_exact_f32):
    dev = cuda_exact_f32
    H, Hkv, Dh = MAIN["H"], MAIN["Hkv"], MAIN["Dh"]
    rng = np.random.default_rng(7)

    def rnd(*shape):
        return _t(_normal(rng, shape, dtype), dtype, dev)
    if case in ("prefill", "chunk"):
        Tq, Tk, off = (2048, 2048, 0) if case == "prefill" else \
            (512, 4096, 1536)
        q, k, v = rnd(1, Tq, H, Dh), rnd(1, Tk, Hkv, Dh), rnd(1, Tk, Hkv, Dh)
        got = ops.flash_prefill(q, k, v, q_offset=off)
        wants = [ref.flash_prefill_ref(q, k, v, q_offset=off)]
    else:
        B, S, page = 8, 4096, 128
        q, kc, vc = rnd(B, H, Dh), rnd(B, S, Hkv, Dh), rnd(B, S, Hkv, Dh)
        pos = torch.full((B,), 2047, dtype=torch.int32, device=dev)
        wants = [ref.flash_decode_ref(q, kc, vc, pos)]
        if case == "decode":
            got = ops.flash_decode(q, kc, vc, pos)
        else:
            n_p = S // page
            bt = torch.from_numpy(rng.permutation(B * n_p + 1)[:B * n_p]
                                  .reshape(B, n_p).astype(np.int32)).to(dev)
            kp = torch.zeros((B * n_p + 1, page, Hkv, Dh), dtype=q.dtype,
                             device=dev)
            vp = torch.zeros_like(kp)
            kp[bt.reshape(-1).long()] = kc.reshape(B * n_p, page, Hkv, Dh)
            vp[bt.reshape(-1).long()] = vc.reshape(B * n_p, page, Hkv, Dh)
            got = ops.paged_flash_decode(q, kp, vp, bt, pos, s_len=S)
            wants.append(ref.paged_flash_decode_ref(q, kp, vp, bt, pos,
                                                    s_len=S))
    torch.cuda.synchronize()
    for want in wants:
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   **_cuda_main_tol(dtype))


# decode rows the serve path gives: contexts spread over 0-4095, and a
# ring cache wrapped (or not) at each row
MAIN_DECODE_POS = {
    "mixed": ([0, 63, 255, 256, 1023, 2047, 3000, 4095], False),
    "ring": ([5000, 100, 4096, 8191, 0, 4095, 9000, 2047], True),
}


def _main_decode_inputs(dtype, dev, seed=11):
    """Qwen3-14B's decode widths, B = 8 over 4096 slots: q, the
    contiguous caches, and the same caches in a shuffled page-128 pool."""
    H, Hkv, Dh = MAIN["H"], MAIN["Hkv"], MAIN["Dh"]
    B, S, page = 8, 4096, 128
    rng = np.random.default_rng(seed)
    q, kc, vc = (_t(_normal(rng, shape, dtype), dtype, dev) for shape in
                 ((B, H, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh)))
    n_p = S // page
    bt = torch.from_numpy(rng.permutation(B * n_p + 1)[:B * n_p]
                          .reshape(B, n_p).astype(np.int32)).to(dev)
    kp = torch.zeros((B * n_p + 1, page, Hkv, Dh), dtype=q.dtype, device=dev)
    vp = torch.zeros_like(kp)
    kp[bt.reshape(-1).long()] = kc.reshape(B * n_p, page, Hkv, Dh)
    vp[bt.reshape(-1).long()] = vc.reshape(B * n_p, page, Hkv, Dh)
    return q, kc, vc, kp, vp, bt


def _decode_call(pool, q, kc, vc, kp, vp, bt, pos, ring=False):
    if pool == "contiguous":
        return ops.flash_decode(q, kc, vc, pos, ring=ring)
    return ops.paged_flash_decode(q, kp, vp, bt, pos, s_len=kc.shape[1],
                                  ring=ring)


@needs_cuda
@pytest.mark.parametrize("case", sorted(MAIN_DECODE_POS))
@pytest.mark.parametrize("pool", ["contiguous", "paged"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_decode_main_widths_mixed(case, pool, dtype, cuda_exact_f32):
    """Split-KV decode at the main widths with rows of every length (some
    in one split, some in all 8) and wrapped rings, against the plain
    version (and the paged kernel against the contiguous one), at the
    main path's tolerance."""
    dev = cuda_exact_f32
    q, kc, vc, kp, vp, bt = _main_decode_inputs(dtype, dev)
    posl, ring = MAIN_DECODE_POS[case]
    pos = torch.tensor(posl, dtype=torch.int32, device=dev)
    got = _decode_call(pool, q, kc, vc, kp, vp, bt, pos, ring)
    torch.cuda.synchronize()
    wants = [ref.flash_decode_ref(q, kc, vc, pos, ring=ring)]
    if pool == "paged":
        wants += [ref.paged_flash_decode_ref(q, kp, vp, bt, pos, s_len=4096,
                                             ring=ring),
                  ops.flash_decode(q, kc, vc, pos, ring=ring)]
    for want in wants:
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   **_cuda_main_tol(dtype))


@needs_cuda
@pytest.mark.parametrize("pool", ["contiguous", "paged"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_decode_split_grid_and_bits(pool, dtype, cuda_exact_f32):
    """At 4096 slots a call launches more than one split, with the plan
    and body the wrapper's rules name, once per call; two calls on the
    same inputs give the same bits (the merge runs in split order)."""
    dev = cuda_exact_f32
    q, kc, vc, kp, vp, bt = _main_decode_inputs(dtype, dev)
    pos = torch.tensor(MAIN_DECODE_POS["mixed"][0], dtype=torch.int32,
                       device=dev)
    kernel = "flash_decode" if pool == "contiguous" else "paged_flash_decode"
    runtime.reset_launch_counts()
    a = _decode_call(pool, q, kc, vc, kp, vp, bt, pos)
    b = _decode_call(pool, q, kc, vc, kp, vp, bt, pos)
    torch.cuda.synchronize()
    assert runtime.launch_counts[kernel] == 2
    used = runtime.decode_plans[kernel]
    assert used == decode_kernel.plan(8, MAIN["Hkv"], 4096, q.dtype,
                                      MAIN["Dh"])
    assert used.n_split > 1
    assert used.body == ("tensor_core" if dtype == "bfloat16"
                         else "cuda_core")
    assert torch.equal(a, b)


def _int8(rng, shape, dev):
    """int8 codes of ``shape`` and f32 scales of ``shape[:-1]`` on the
    card."""
    codes = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 0.05, shape[:-1])
                             .astype(np.float32))
    return codes.to(dev), scale.to(dev)


@needs_cuda
@pytest.mark.parametrize("shape", DECODE_SHAPES + DH192_DECODE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_flash_decode_int8(shape, dtype, cuda_exact_f32):
    """The int8 contiguous kernel against its plain version, and bit for
    bit against the float kernel over the dequantized cache (the same
    plan: the int8 body forms exactly dequantize_kv's values)."""
    dev = cuda_exact_f32
    B, S, H, Hkv, Dh, ring = shape
    rng = np.random.default_rng(S + Dh)
    q = _t(_normal(rng, (B, H, Dh), dtype), dtype, dev)
    kc, ks = _int8(rng, (B, S, Hkv, Dh), dev)
    vc, vs = _int8(rng, (B, S, Hkv, Dh), dev)
    pos = torch.tensor([S // 3, 2 * S + 5][:B] if ring else
                       [S - 1, S // 2][:B], dtype=torch.int32, device=dev)
    n0 = runtime.launch_counts["flash_decode_int8"]
    got = ops.flash_decode_int8(q, kc, vc, ks, vs, pos, ring=ring)
    torch.cuda.synchronize()
    assert runtime.launch_counts["flash_decode_int8"] == n0 + 1
    want = ref.flash_decode_int8_ref(q, kc, vc, ks, vs, pos, ring=ring)
    np.testing.assert_allclose(_f32(got), _f32(want), **_cuda_tol(dtype))
    same = ops.flash_decode(q, ref.dequantize_kv(kc, ks, q.dtype),
                            ref.dequantize_kv(vc, vs, q.dtype), pos,
                            ring=ring)
    assert torch.equal(got, same)


@needs_cuda
@pytest.mark.parametrize("shape", PAGED_SHAPES + DH192_PAGED)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_paged_flash_decode_int8(shape, dtype, cuda_exact_f32):
    """The int8 paged kernel against its plain version, bit for bit
    against the float paged kernel over the dequantized pool, and equal
    to the int8 contiguous kernel over the gathered cache."""
    dev = cuda_exact_f32
    B, S, H, Hkv, Dh, page, ring = shape
    rng = np.random.default_rng(S + page)
    n_p = -(-S // page)
    n_pages = B * n_p + 3
    q = _t(_normal(rng, (B, H, Dh), dtype), dtype, dev)
    kp, ks = _int8(rng, (n_pages, page, Hkv, Dh), dev)
    vp, vs = _int8(rng, (n_pages, page, Hkv, Dh), dev)
    bt = torch.from_numpy(rng.permutation(n_pages)[:B * n_p].reshape(
        B, n_p).astype(np.int32)).to(dev)
    pos = torch.tensor([2 * S + 5, S // 3][:B] if ring else
                       [S - 1, S // 2][:B], dtype=torch.int32, device=dev)
    n0 = runtime.launch_counts["paged_flash_decode_int8"]
    got = ops.paged_flash_decode_int8(q, kp, vp, ks, vs, bt, pos, s_len=S,
                                      ring=ring)
    torch.cuda.synchronize()
    assert runtime.launch_counts["paged_flash_decode_int8"] == n0 + 1
    want = ref.paged_flash_decode_int8_ref(q, kp, vp, ks, vs, bt, pos,
                                           s_len=S, ring=ring)
    np.testing.assert_allclose(_f32(got), _f32(want), **_cuda_tol(dtype))
    same = ops.paged_flash_decode(q, ref.dequantize_kv(kp, ks, q.dtype),
                                  ref.dequantize_kv(vp, vs, q.dtype), bt,
                                  pos, s_len=S, ring=ring)
    assert torch.equal(got, same)
    contig = ops.flash_decode_int8(
        q, *(ref.gather_paged_kv(t, bt, S).contiguous()
             for t in (kp, vp, ks, vs)), pos, ring=ring)
    np.testing.assert_allclose(_f32(got), _f32(contig), **_cuda_tol(dtype))


@needs_cuda
@pytest.mark.parametrize("case", sorted(MAIN_DECODE_POS))
@pytest.mark.parametrize("pool", ["contiguous", "paged"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_decode_int8_main_widths(case, pool, dtype, cuda_exact_f32):
    """Both int8 kernels at the main widths (B = 8 over 4096 slots, rows
    of every length, wrapped rings): against the plain version at the
    main path's tolerance, bit for bit against the float kernel over the
    dequantized cache with the same plan, and over two calls."""
    dev = cuda_exact_f32
    H, Hkv, Dh = MAIN["H"], MAIN["Hkv"], MAIN["Dh"]
    B, S, page = 8, 4096, 128
    rng = np.random.default_rng(12)
    q = _t(_normal(rng, (B, H, Dh), dtype), dtype, dev)
    kc, ks = _int8(rng, (B, S, Hkv, Dh), dev)
    vc, vs = _int8(rng, (B, S, Hkv, Dh), dev)
    posl, ring = MAIN_DECODE_POS[case]
    pos = torch.tensor(posl, dtype=torch.int32, device=dev)
    want = ref.flash_decode_int8_ref(q, kc, vc, ks, vs, pos, ring=ring)
    if pool == "contiguous":
        def call():
            return ops.flash_decode_int8(q, kc, vc, ks, vs, pos, ring=ring)
        same = ops.flash_decode(q, ref.dequantize_kv(kc, ks, q.dtype),
                                ref.dequantize_kv(vc, vs, q.dtype), pos,
                                ring=ring)
        kernel = "flash_decode_int8"
    else:
        n_p = S // page
        bt = torch.from_numpy(rng.permutation(B * n_p + 1)[:B * n_p]
                              .reshape(B, n_p).astype(np.int32)).to(dev)
        pools = []
        for t in (kc, vc, ks, vs):
            p = t.new_zeros((B * n_p + 1, page) + tuple(t.shape[2:]))
            p[bt.reshape(-1).long()] = t.reshape((B * n_p, page)
                                                 + tuple(t.shape[2:]))
            pools.append(p)

        def call():
            return ops.paged_flash_decode_int8(q, *pools, bt, pos, s_len=S,
                                               ring=ring)
        same = ops.paged_flash_decode(
            q, ref.dequantize_kv(pools[0], pools[2], q.dtype),
            ref.dequantize_kv(pools[1], pools[3], q.dtype), bt, pos,
            s_len=S, ring=ring)
        kernel = "paged_flash_decode_int8"
    got, again = call(), call()
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **_cuda_main_tol(dtype))
    assert torch.equal(got, same) and torch.equal(got, again)
    assert runtime.decode_plans[kernel] == decode_kernel.plan(
        B, Hkv, S, q.dtype, Dh)


# the int8 tensor-core body's conversion at its edges: caches holding
# every code from -128 to 127 (each in every kind of position), scales in
# bands from quantize_kv's 1e-8 floor up to 1e3, at each head dim's V unit
# (16 bytes at Dh 128 and 256, 8 at 64 and 192, 2 at 80), G > 16 (two
# 16-row tiles of heads) and the serve step's shape (Qwen3-14B's widths,
# B = 8 at context 1024 of 4096 slots: L 512, two live splits)
INT8_EDGE_SHAPES = {
    # (B, S, H, Hkv, Dh, pos)
    "serve_step": (8, 4096, 40, 8, 128, 1023),
    "dh64_g32": (2, 256, 64, 2, 64, 255),
    "dh80": (1, 512, 16, 2, 80, 500),
    "dh192": (2, 300, 96, 8, 192, 299),
    "dh256": (2, 256, 10, 1, 256, 200),
}
INT8_EDGE_SCALES = {"floor": (1e-8, 1e-7), "unit": (1e-3, 1e-2),
                    "high": (1e2, 1e3)}


@needs_cuda
@pytest.mark.parametrize("band", sorted(INT8_EDGE_SCALES))
@pytest.mark.parametrize("shape", sorted(INT8_EDGE_SHAPES))
@pytest.mark.parametrize("pool", ["contiguous", "paged"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_decode_int8_every_code(shape, band, pool, dtype,
                                     cuda_exact_f32):
    """Both int8 kernels over caches of every code at scales from the
    1e-8 floor to 1e3 (q scaled so the scores stay near 1 and every slot
    counts): finite, bit for bit the float kernel over the dequantized
    cache with the same plan, and the same bits over two calls."""
    dev = cuda_exact_f32
    B, S, H, Hkv, Dh, p = INT8_EDGE_SHAPES[shape]
    lo, hi = INT8_EDGE_SCALES[band]
    rng = np.random.default_rng(Dh + len(band))

    def cache(shape):
        codes = rng.permutation(np.resize(np.arange(-128, 128, dtype=np.int8),
                                          int(np.prod(shape))))
        scale = np.exp(rng.uniform(np.log(lo), np.log(hi), shape[:-1]))
        return (torch.from_numpy(codes.reshape(shape)).to(dev),
                torch.from_numpy(scale.astype(np.float32)).to(dev))
    q = _t(_normal(rng, (B, H, Dh), "float32") / (74 * hi), dtype, dev)
    pos = torch.full((B,), p, dtype=torch.int32, device=dev)
    deq = ref.dequantize_kv
    if pool == "contiguous":
        kc, ks = cache((B, S, Hkv, Dh))
        vc, vs = cache((B, S, Hkv, Dh))

        def call():
            return ops.flash_decode_int8(q, kc, vc, ks, vs, pos)
        same = ops.flash_decode(q, deq(kc, ks, q.dtype), deq(vc, vs, q.dtype),
                                pos)
        kernel = "flash_decode_int8"
    else:
        page = 128
        n_p = -(-S // page)
        kp, ks = cache((B * n_p + 1, page, Hkv, Dh))
        vp, vs = cache((B * n_p + 1, page, Hkv, Dh))
        bt = torch.from_numpy(rng.permutation(B * n_p + 1)[:B * n_p]
                              .reshape(B, n_p).astype(np.int32)).to(dev)

        def call():
            return ops.paged_flash_decode_int8(q, kp, vp, ks, vs, bt, pos,
                                               s_len=S)
        same = ops.paged_flash_decode(q, deq(kp, ks, q.dtype),
                                      deq(vp, vs, q.dtype), bt, pos, s_len=S)
        kernel = "paged_flash_decode_int8"
    got, again = call(), call()
    torch.cuda.synchronize()
    used = runtime.decode_plans[kernel]
    assert used == decode_kernel.plan(B, Hkv, S, q.dtype, Dh)
    if shape == "serve_step":
        assert (used.L, -(-(p + 1) // used.L)) == (512, 2)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, same) and torch.equal(got, again)


@needs_cuda
def test_cuda_decode_int8_refuses_bad_scales(cuda_exact_f32):
    """Scales must be f32 of the codes' shape without Dh, contiguous,
    on the card."""
    dev = cuda_exact_f32
    rng = np.random.default_rng(0)
    q = _t(_normal(rng, (1, 4, 64), "bfloat16"), "bfloat16", dev)
    kc, ks = _int8(rng, (1, 128, 2, 64), dev)
    pos = torch.tensor([5], dtype=torch.int32, device=dev)
    for bad in (ks.double(), ks[:, :64], ks.cpu(),
                ks.transpose(1, 2).contiguous().transpose(1, 2)):
        with pytest.raises(ValueError, match="scales"):
            ops.flash_decode_int8(q, kc, kc, bad, ks, pos)
    with pytest.raises(ValueError, match="codes"):
        ops.flash_decode_int8(q, kc.float(), kc, ks, ks, pos)


@needs_cuda
def test_cuda_decode_body_rule_matches_c(cuda_exact_f32):
    """The wrapper's decode body rule is the one the C launch applies."""
    lib = runtime.library()
    for dtype, code in runtime.DTYPE_CODES.items():
        for Dh in (64, 80, 128, 192, 256):
            c_body = ("tensor_core" if lib.rt_decode_body(code, Dh)
                      else "cuda_core")
            assert c_body == decode_kernel.body(dtype, Dh)


@needs_cuda
def test_cuda_flash_prefill_tensor_core_chunk_b4(cuda_exact_f32):
    """A 512-token chunk of four rows at Qwen3-14B's widths (rows of other
    lengths, offset 1024 over 2048 slots) through the wgmma body, at the
    main path's tolerance."""
    dev = cuda_exact_f32
    B, Tq, Tk, off = 4, 512, 2048, 1024
    H, Hkv, Dh = MAIN["H"], MAIN["Hkv"], MAIN["Dh"]
    rng = np.random.default_rng(8)
    q, k, v = (_t(_normal(rng, shape, "bfloat16"), "bfloat16", dev)
               for shape in ((B, Tq, H, Dh), (B, Tk, Hkv, Dh),
                             (B, Tk, Hkv, Dh)))
    lt = torch.tensor([1536, 1100, 2048, 700], dtype=torch.int32, device=dev)
    b0 = runtime.prefill_body_counts["tensor_core"]
    got = ops.flash_prefill(q, k, v, lt, q_offset=off)
    torch.cuda.synchronize()
    assert runtime.prefill_body_counts["tensor_core"] == b0 + 1
    want = ref.flash_prefill_ref(q, k, v, lt, q_offset=off)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **_cuda_main_tol("bfloat16"))


@needs_cuda
def test_cuda_unsupported_shapes_raise_without_launch(cuda_exact_f32):
    """The C launch holds each kernel's limits and refuses a shape outside
    them; the wrapper raises and counts no launch."""
    dev = cuda_exact_f32
    runtime.reset_launch_counts()
    pos = torch.zeros((1,), dtype=torch.int32, device=dev)
    q = torch.zeros((1, 8, 4, 96), device=dev)          # Dh = 96
    with pytest.raises(ValueError, match="not supported"):
        ops.flash_prefill(q, q, q)
    q = torch.zeros((1, 32, 256), device=dev)           # G * Dh = 8192
    kc = torch.zeros((1, 16, 1, 256), device=dev)
    with pytest.raises(ValueError, match="not supported"):
        ops.flash_decode(q, kc, kc, pos)
    q = torch.zeros((1, 4, 64), device=dev)
    kp = torch.zeros((4, 16, 2, 64), device=dev)
    bt = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="not supported"):    # 2 x 16 < 64
        ops.paged_flash_decode(q, kp, kp, bt, pos, s_len=64)
    assert all(n == 0 for n in runtime.launch_counts.values())


def _wkv_cuda(r, k, v, w, u, s0, dtype, dev):
    """Kernel operands on the card: r/k/v in ``dtype``, w/u/s0 f32."""
    return tuple(_t(x, dtype, dev) for x in (r, k, v)) + \
        tuple(_t(x, "float32", dev) for x in (w, u, s0))


def _wkv_main(T, dev, seed=9):
    """rwkv6-3b's widths at B = 8: bf16 r/k/v, the model's decay."""
    rng = np.random.default_rng(seed)
    B, H, hs = 8, 40, 64
    r, k, v = (_normal(rng, (B, T, H, hs), "bfloat16") for _ in range(3))
    w_hat = rng.standard_normal((B, T, H, hs)).astype(np.float32) - 0.5
    w = np.exp(-np.exp(w_hat)).astype(np.float32)
    u = (rng.standard_normal((H, hs)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((B, H, hs, hs)).astype(np.float32)
    return _wkv_cuda(r, k, v, w, u, s0, "bfloat16", dev)


@needs_cuda
@pytest.mark.parametrize("shape,dtype,decay", _wkv_cases())
def test_cuda_wkv6(shape, dtype, decay, cuda_exact_f32):
    """The kernel against its plain version on the card.  Both compute in
    f32 from exactly cast inputs, so the f32 tolerance holds in both
    dtypes."""
    dev = cuda_exact_f32
    args = _wkv_cuda(*_wkv_inputs(shape, dtype, decay=WKV_DECAYS.get(decay)),
                     dtype, dev)
    n0 = runtime.launch_counts["wkv6"]
    y, sT = ops.wkv6(*args)
    torch.cuda.synchronize()
    assert runtime.launch_counts["wkv6"] == n0 + 1
    want_y, want_s = ref.wkv6_ref(*args)
    np.testing.assert_allclose(_f32(y), _f32(want_y), **_cuda_tol("float32"))
    np.testing.assert_allclose(_f32(sT), _f32(want_s),
                               **_cuda_tol("float32"))


@needs_cuda
@pytest.mark.parametrize("T", [512, 1])
def test_cuda_wkv6_main_path_shapes(T, cuda_exact_f32):
    """rwkv6-3b serving: a 512-token chunk and a decode step of 8 rows,
    40 heads of 64, bf16 r/k/v, f32 decay; the state written in place
    over s0 as the model does."""
    args = _wkv_main(T, cuda_exact_f32)
    want_y, want_s = ref.wkv6_ref(*args)
    state = args[-1].clone()
    y, sT = ops.wkv6(*args[:-1], state, state_out=state)
    torch.cuda.synchronize()
    assert sT is state
    np.testing.assert_allclose(_f32(y), _f32(want_y), **_cuda_tol("float32"))
    np.testing.assert_allclose(_f32(state), _f32(want_s),
                               **_cuda_tol("float32"))


@needs_cuda
def test_cuda_wkv6_unsupported_raises_without_launch(cuda_exact_f32):
    dev = cuda_exact_f32
    runtime.reset_launch_counts()
    B, T, H, hs = 1, 4, 2, 48                         # hs = 48
    x = torch.zeros((B, T, H, hs), device=dev)
    with pytest.raises(ValueError, match="not supported"):
        ops.wkv6(x, x, x, x, torch.zeros((H, hs), device=dev),
                 torch.zeros((B, H, hs, hs), device=dev))
    x = torch.zeros((B, T, H, 64), device=dev)
    with pytest.raises(ValueError, match="float32"):  # bf16 decay
        ops.wkv6(x, x, x, x.bfloat16(), torch.zeros((H, 64), device=dev),
                 torch.zeros((B, H, 64, 64), device=dev))
    assert runtime.launch_counts["wkv6"] == 0


@needs_cuda
def test_cuda_wkv6_plan_matches_c(cuda_exact_f32):
    """The wrapper's split rule is the one the C launch applies
    (``rt_wkv6_plan``), and the C launch refuses other head sizes."""
    import ctypes
    lib = runtime.library()
    out = (ctypes.c_int * 3)()
    for hs in wkv6_kernel.HEAD_SIZES:
        for B, H in ((1, 1), (2, 4), (8, 40), (1, 40), (64, 40)):
            for T in (0, 1, 512):
                assert lib.rt_wkv6_plan(B, H, hs, T, out) == 0
                assert tuple(out) == tuple(wkv6_kernel.plan(B, H, hs, T))
    assert lib.rt_wkv6_plan(8, 40, 48, 512, out) == \
        runtime.CUDA_ERROR_INVALID_VALUE


@needs_cuda
def test_cuda_wkv6_two_calls_give_the_same_bits(cuda_exact_f32):
    """No atomics and a fixed fold order: the chunk is bit-identical
    over two calls."""
    args = _wkv_main(512, cuda_exact_f32)
    y1, s1 = ops.wkv6(*args)
    y2, s2 = ops.wkv6(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@needs_cuda
@pytest.mark.parametrize("T", [0, 17, 37])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_wkv6_ragged_T(T, dtype, cuda_exact_f32):
    """T off the 16-step tile (and T = 0), the state written over s0."""
    dev = cuda_exact_f32
    args = _wkv_cuda(*_wkv_inputs((2, T, 4, 64), dtype), dtype, dev)
    want_y, want_s = ref.wkv6_ref(*args)
    state = args[-1].clone()
    y, sT = ops.wkv6(*args[:-1], state, state_out=state)
    torch.cuda.synchronize()
    assert sT is state and y.shape == (2, T, 4, 64)
    np.testing.assert_allclose(_f32(y), _f32(want_y), **_cuda_tol("float32"))
    np.testing.assert_allclose(_f32(state), _f32(want_s),
                               **_cuda_tol("float32"))


def _wkv_tile_call(args, tile, y, sT):
    """One launch of the kernel with a given tile (``rt_wkv6_tile``): the
    timing sweep's entry, which counts no launch."""
    r, k, v, w, u, s0 = args
    B, T, H, hs = r.shape
    return runtime.library().rt_wkv6_tile(
        *(x.data_ptr() for x in (r, k, v, w, u, s0, y, sT)), B, T, H, hs,
        runtime.DTYPE_CODES[r.dtype], *tile, runtime.stream_ptr(r.device))


@needs_cuda
@pytest.mark.parametrize("tile", [(4, 8, 64), (4, 8, 32), (4, 2, 16),
                                  (8, 8, 64), (8, 4, 32)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_wkv6_every_tile(tile, dtype, cuda_exact_f32):
    """Each built tile, through the C entry the sweep times, agrees with
    the plain version; an unbuilt or invalid tile is refused."""
    dev = cuda_exact_f32
    args = _wkv_cuda(*_wkv_inputs((2, 100, 4, 64), dtype), dtype, dev)
    y = torch.empty(args[0].shape, dtype=torch.float32, device=dev)
    sT = torch.empty_like(args[-1])
    n0 = dict(runtime.launch_counts)
    assert _wkv_tile_call(args, tile, y, sT) == 0
    torch.cuda.synchronize()
    assert runtime.launch_counts == n0
    want_y, want_s = ref.wkv6_ref(*args)
    np.testing.assert_allclose(_f32(y), _f32(want_y), **_cuda_tol("float32"))
    np.testing.assert_allclose(_f32(sT), _f32(want_s),
                               **_cuda_tol("float32"))
    for bad in ((16, 4, 64), (4, 8, 48), (4, 8, 8)):
        assert _wkv_tile_call(args, bad, y, sT) == \
            runtime.CUDA_ERROR_INVALID_VALUE


# --------------------------------------------- wkv6's backward kernel --
def _wkv_bwd_tol(name, dtype):
    """Relative to a gradient's largest magnitude: f32 sums in another
    order (and the kernel's fused multiply-adds) over up to 512 steps,
    and one bf16 rounding of dr, dk, dv in bf16."""
    return 8e-3 if dtype == "bfloat16" and name in ("dr", "dk", "dv") \
        else 1e-4


def _wkv_bwd_check(args, dy, dsT, dtype, label=""):
    """``wkv6_bwd`` on the card (one launch counted) against
    ``ref.wkv6_bwd_ref`` on the same tensors."""
    n0 = runtime.launch_counts["wkv6_bwd"]
    got = ops.wkv6_bwd(*args, dy, dsT)
    torch.cuda.synchronize()
    assert runtime.launch_counts["wkv6_bwd"] == n0 + 1
    want = ref.wkv6_bwd_ref(*args, dy, dsT)
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (label, name)
        g, w = _f32(g).astype(np.float64), _f32(w).astype(np.float64)
        scale = float(np.abs(w).max()) if w.size else 0.0
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert np.isfinite(g).all(), (label, name)
        assert err <= _wkv_bwd_tol(name, dtype) * scale + 1e-30, \
            (label, name, err, scale)
    return got


def _wkv_bwd_grads(shape, dev, seed=13, dsT=True):
    B, T, H, hs = shape
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((B, T, H, hs)).astype(np.float32)
    ds = rng.standard_normal((B, H, hs, hs)).astype(np.float32)
    return (_t(dy, "float32", dev),
            _t(ds, "float32", dev) if dsT else None)


@needs_cuda
@pytest.mark.parametrize("with_dsT", [True, False])
@pytest.mark.parametrize("shape,dtype,decay", _wkv_cases() + [
    ((2, 100, 4, 64), "bfloat16", name) for name in WKV_DECAYS])
def test_cuda_wkv6_bwd(shape, dtype, decay, with_dsT, cuda_exact_f32):
    """The backward kernel against its plain version on the card over the
    ``WKV_SHAPES`` sweep in both dtypes and at both decay extremes, with
    dsT given and absent."""
    dev = cuda_exact_f32
    args = _wkv_cuda(*_wkv_inputs(shape, dtype, decay=WKV_DECAYS.get(decay)),
                     dtype, dev)
    _wkv_bwd_check(args, *_wkv_bwd_grads(shape, dev, dsT=with_dsT), dtype,
                   f"{shape} {dtype} {decay}")


@needs_cuda
@pytest.mark.parametrize("shape", [(2, 1, 4, 64), (2, 17, 4, 64),
                                   (2, 37, 10, 64), (1, 9, 10, 32),
                                   (3, 5, 1, 16), (2, 0, 4, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s0", ["random", "zero"])
def test_cuda_wkv6_bwd_ragged_T_and_heads(shape, dtype, s0, cuda_exact_f32):
    """T = 1, T off the 8-step checkpoint interval and T = 0, the 10
    heads of a ``--model 4`` rank, s0 present and zero, and padded
    steps (k = 0, w = 1, as ``models/rwkv.py`` sets past a row's
    length)."""
    dev = cuda_exact_f32
    r, k, v, w, u, s = _wkv_inputs(shape, dtype)
    if s0 == "zero":
        s = np.zeros_like(s)
    if shape[1] > 4:
        k[:, -3:], w[:, -3:] = 0.0, 1.0
    args = _wkv_cuda(r, k, v, w, u, s, dtype, dev)
    dr, dk, dv, dw, du, ds0 = _wkv_bwd_check(
        args, *_wkv_bwd_grads(shape, dev), dtype, f"{shape} {dtype} {s0}")
    if shape[1] == 0:
        assert not du.any()


@needs_cuda
def test_cuda_wkv6_bwd_main_path_shapes_and_bits(cuda_exact_f32):
    """rwkv6-3b's chunk (B = 8, T = 512, 40 heads of 64, bf16 r/k/v, the
    model's decay, dsT None as training drops sT): against the plain
    version, and bit-identical over two calls."""
    args = _wkv_main(512, cuda_exact_f32)
    dy, _ = _wkv_bwd_grads((8, 512, 40, 64), cuda_exact_f32)
    first = _wkv_bwd_check(args, dy, None, "bfloat16", "main")
    second = ops.wkv6_bwd(*args, dy, None)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@needs_cuda
def test_cuda_wkv6_bwd_unsupported_raises_without_launch(cuda_exact_f32):
    """A head size the kernel does not take is refused by the C launch
    before any launch; a bf16 dy is refused by the wrapper."""
    dev = cuda_exact_f32
    runtime.reset_launch_counts()
    B, T, H, hs = 1, 4, 2, 48
    x = torch.zeros((B, T, H, hs), device=dev)
    with pytest.raises(ValueError, match="not supported"):
        ops.wkv6_bwd(x, x, x, x, torch.zeros((H, hs), device=dev),
                     torch.zeros((B, H, hs, hs), device=dev), x)
    x = torch.zeros((B, T, H, 64), device=dev)
    with pytest.raises(ValueError, match="float32"):
        ops.wkv6_bwd(x, x, x, x, torch.zeros((H, 64), device=dev),
                     torch.zeros((B, H, 64, 64), device=dev), x.bfloat16())
    assert runtime.launch_counts["wkv6_bwd"] == 0


def _wkv_bwd_against_ref(args, dy, dsT, got, dtype, label):
    want = ref.wkv6_bwd_ref(*args, dy, dsT)
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (label, name)
        g, w = _f32(g).astype(np.float64), _f32(w).astype(np.float64)
        scale = float(np.abs(w).max()) if w.size else 0.0
        assert np.isfinite(g).all(), (label, name)
        assert float(np.abs(g - w).max()) <= \
            _wkv_bwd_tol(name, dtype) * scale + 1e-30, (label, name)


@needs_cuda
def test_cuda_wkv6_bwd_plan_matches_c(cuda_exact_f32):
    """The wrapper's cluster rule (``wkv6.bwd_plan``) is the one the C
    launch applies (``rt_wkv6_bwd_plan``), and the C launch refuses other
    head sizes."""
    import ctypes
    lib = runtime.library()
    out = (ctypes.c_int * 2)()
    for hs in wkv6_kernel.HEAD_SIZES:
        for B, H in ((1, 1), (2, 4), (2, 40), (8, 10), (8, 40), (1, 263),
                     (1, 264), (64, 40)):
            for T in (0, 1, 512, 4095):
                assert lib.rt_wkv6_bwd_plan(B, H, hs, T, out) == 0
                assert tuple(out) == tuple(
                    wkv6_kernel.bwd_plan(B, H, hs, T)), (B, H, hs, T)
    assert lib.rt_wkv6_bwd_plan(8, 40, 48, 512, out) == \
        runtime.CUDA_ERROR_INVALID_VALUE


@needs_cuda
@pytest.mark.parametrize("shape,nc", [((2, 19, 20, 64), 4),
                                      ((2, 19, 80, 32), 2),
                                      ((2, 19, 132, 32), 1),
                                      ((2, 21, 3, 16), 1)])
def test_cuda_wkv6_bwd_each_planned_cluster(shape, nc, cuda_exact_f32):
    """A shape for each cluster size the plan picks, through the
    wrapper (one launch counted), against the plain version in bf16."""
    B, T, H, hs = shape
    assert wkv6_kernel.bwd_plan(B, H, hs, T).nc == nc
    dev = cuda_exact_f32
    args = _wkv_cuda(*_wkv_inputs(shape, "bfloat16"), "bfloat16", dev)
    _wkv_bwd_check(args, *_wkv_bwd_grads(shape, dev), "bfloat16",
                   f"{shape} nc {nc}")


@needs_cuda
@pytest.mark.parametrize("shape", [(2, 37, 3, 32), (2, 37, 3, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_dsT", [True, False])
def test_cuda_wkv6_bwd_every_cluster_size(shape, dtype, with_dsT,
                                          cuda_exact_f32):
    """Each cluster size the head size takes (1, 2 and 4 at hs 32; 2 and
    4 at hs 64), forced through the sweep's entry, against the plain
    version; a cluster size outside ``bwd_valid`` is refused without a
    launch."""
    dev = cuda_exact_f32
    hs = shape[-1]
    args = _wkv_cuda(*_wkv_inputs(shape, dtype), dtype, dev)
    dy, dsT = _wkv_bwd_grads(shape, dev, dsT=with_dsT)
    n0 = dict(runtime.launch_counts)
    for nc in (1, 2, 3, 4, 8):
        if not wkv6_kernel.bwd_valid(hs, nc):
            with pytest.raises(ValueError, match="not supported"):
                wkv6_kernel.wkv6_bwd_nc(*args, dy, dsT, nc)
            continue
        got = wkv6_kernel.wkv6_bwd_nc(*args, dy, dsT, nc)
        torch.cuda.synchronize()
        _wkv_bwd_against_ref(args, dy, dsT, got, dtype, f"{shape} nc {nc}")
    assert runtime.launch_counts == n0


@needs_cuda
def test_cuda_wkv6_bwd_training_shape_and_bits(cuda_exact_f32):
    """rwkv6-3b's training shape (B 2, T 4095, 40 heads of 64: a
    cluster of 4 a head) against the plain version, bit-identical over
    two calls."""
    rng = np.random.default_rng(17)
    B, T, H, hs = 2, 4095, 40, 64
    dev = cuda_exact_f32
    r, k, v = (_normal(rng, (B, T, H, hs), "bfloat16") for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, hs)) - 0.5))
    u = rng.standard_normal((H, hs)) * 0.1
    args = _wkv_cuda(r, k, v, w.astype(np.float32), u.astype(np.float32),
                     np.zeros((B, H, hs, hs), np.float32), "bfloat16", dev)
    dy, _ = _wkv_bwd_grads((B, T, H, hs), dev)
    assert wkv6_kernel.bwd_plan(B, H, hs, T).nc == 4
    first = _wkv_bwd_check(args, dy, None, "bfloat16", "training")
    second = ops.wkv6_bwd(*args, dy, None)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# ------------------------------------------- the kernels under autograd --
PREFILL_GRAD_CASES = {
    # (B, Tq, Tk, H, Hkv, Dh, causal, window, q_offset, lengths)
    "causal": (2, 6, 6, 4, 2, 8, True, 0, 0, (6, 4)),
    "windowed": (1, 7, 7, 2, 1, 8, True, 3, 0, None),
    "non-causal Tq != Tk": (2, 5, 9, 4, 2, 8, False, 0, 0, (9, 6)),
    "causal offset Tq != Tk": (1, 4, 9, 2, 2, 8, True, 0, 5, None),
}


def _prefill_grad_inputs(case, dtype, device="cpu", Dh=None):
    """A case's inputs; ``Dh`` overrides its head dim (the kernel takes
    64, 80, 128, 192 and 256)."""
    B, Tq, Tk, H, Hkv, case_dh, causal, window, off, lens = \
        PREFILL_GRAD_CASES[case]
    Dh = Dh or case_dh
    gen = torch.Generator().manual_seed(len(case))
    q, k, v = (torch.randn(shape, generator=gen, dtype=torch.float64)
               .to(device=device, dtype=dtype).requires_grad_(True)
               for shape in ((B, Tq, H, Dh), (B, Tk, Hkv, Dh),
                             (B, Tk, Hkv, Dh)))
    lens = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                  device=device)
    return (q, k, v, lens), dict(causal=causal, window=window,
                                 q_offset=off)


def _wkv_grad_inputs(dtype, device="cpu", B=1, T=5, H=2, hs=4):
    gen = torch.Generator().manual_seed(9)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, dtype=torch.float64)
                * scale).to(device=device, dtype=dtype).requires_grad_(True)
    r, k, v = rnd(B, T, H, hs), rnd(B, T, H, hs), rnd(B, T, H, hs)
    w = torch.sigmoid(torch.randn((B, T, H, hs), generator=gen,
                                  dtype=torch.float64)).to(
        device=device, dtype=dtype).requires_grad_(True)
    return r, k, v, w, rnd(H, hs, scale=0.1), rnd(B, H, hs, hs, scale=0.1)


def _grads_of(out, inputs, seed=2):
    outs = out if isinstance(out, tuple) else (out,)
    gen = torch.Generator().manual_seed(seed)
    cot = [torch.randn(o.shape, generator=gen, dtype=torch.float64).to(o)
           for o in outs]
    wrt = [x for x in inputs if x is not None and x.requires_grad]
    return torch.autograd.grad(outs, wrt, cot)


@pytest.mark.parametrize("case", sorted(PREFILL_GRAD_CASES))
def test_kernel_function_prefill_grads_equal_plain_autograd(case):
    """A ``KernelFunction`` built with ``flash_prefill_ref`` as its
    forward: its gradients are autograd's through the plain version
    (f32), and ``gradcheck`` holds it at f64."""
    fn = KernelFunction("test_prefill", ref.flash_prefill_ref,
                        ref.flash_prefill_ref)
    args, kw = _prefill_grad_inputs(case, torch.float32)
    got = _grads_of(fn(*args, **kw), args)
    want = _grads_of(ref.flash_prefill_ref(*args, **kw), args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    args, kw = _prefill_grad_inputs(case, torch.float64)
    assert torch.autograd.gradcheck(lambda q, k, v: fn(q, k, v, args[3],
                                                       **kw), args[:3])


def test_kernel_function_wkv6_grads_equal_plain_autograd():
    fn = KernelFunction("test_wkv6", ref.wkv6_ref, ref.wkv6_ref)
    args = _wkv_grad_inputs(torch.float32)
    got = _grads_of(fn(*args), args)
    want = _grads_of(ref.wkv6_ref(*args), args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    assert torch.autograd.gradcheck(fn, _wkv_grad_inputs(torch.float64))


def test_kernel_function_counts_its_backward_passes():
    fn = KernelFunction("flash_prefill", ref.flash_prefill_ref,
                        ref.flash_prefill_ref)
    args, kw = _prefill_grad_inputs("causal", torch.float32)
    runtime.reset_launch_counts()
    _grads_of(fn(*args, **kw), args)
    assert runtime.autograd_counts["flash_prefill"] == 1
    with torch.no_grad():
        out = ops.flash_prefill(*args, **kw)    # the CPU: plain, no graph
    assert out.grad_fn is None


@needs_cuda
@pytest.mark.parametrize("case", sorted(PREFILL_GRAD_CASES))
def test_cuda_flash_prefill_under_autograd(case):
    """On the card a recorded ``flash_prefill`` launches the kernel once
    (counted) and its gradients are autograd's through the plain version
    on the same inputs."""
    args, kw = _prefill_grad_inputs(case, torch.float32, "cuda", Dh=64)
    runtime.reset_launch_counts()
    out = ops.flash_prefill(*args, **kw)
    assert runtime.launch_counts["flash_prefill"] == 1
    got = _grads_of(out, args)
    assert runtime.autograd_counts["flash_prefill"] == 1
    torch.testing.assert_close(out, ref.flash_prefill_ref(*args, **kw),
                               atol=1e-4, rtol=1e-3)
    want = _grads_of(ref.flash_prefill_ref(*args, **kw), args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-3)


@needs_cuda
def test_cuda_wkv6_under_autograd():
    """On the card a recorded ``wkv6`` launches the forward kernel once
    and, in the backward, the backward kernel once (no plain backward
    pass); its gradients are autograd's through the plain version."""
    args = _wkv_grad_inputs(torch.float32, "cuda", B=2, T=37, H=2, hs=64)
    runtime.reset_launch_counts()
    out = ops.wkv6(*args)
    assert runtime.launch_counts["wkv6"] == 1
    got = _grads_of(out, args)
    assert runtime.launch_counts["wkv6_bwd"] == 1
    assert not any(runtime.autograd_counts.values())
    want = _grads_of(ref.wkv6_ref(*args), args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-3)
    with pytest.raises(ValueError, match="state_out"):
        ops.wkv6(*args, state_out=torch.empty_like(args[5]))
