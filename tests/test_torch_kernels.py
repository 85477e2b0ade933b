"""The port's attention kernels.

CPU cases: each plain PyTorch version (``repro_torch/kernels/ref.py``)
against the reference run as the reference's own kernel tests run it —
the jnp oracle in both dtypes, and the Pallas kernel in interpret mode
in f32 (interpretation costs seconds a case) — at the reference sweeps,
plus ``Tq < Tk`` with a query offset against
``full_attention(q_offset=...)``.  Tolerances are the reference's
``_tol``; only valid query rows are compared.

CUDA cases (skipped without a card): each hand-written kernel against
its plain version on the card, at the same sweeps.  Run them on the
H100 with ``python -m pytest tests/test_torch_kernels.py -k cuda``.
The JAX reference is imported inside the CPU cases only: the machine
with the card has no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import runtime

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
]
# chunked prefill: (B, Tq, Tk, H, Hkv, Dh, q_offset)
CHUNK_SHAPES = [
    (2, 64, 192, 4, 2, 64, 0),
    (2, 64, 192, 4, 2, 64, 37),
    (1, 64, 256, 8, 2, 128, 128),
    (2, 96, 256, 4, 1, 80, 37),
]
DTYPES = ["float32", "bfloat16"]


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


def _valid_rows(T, lens):
    return np.arange(T)[None, :, None, None] < lens[:, None, None, None]


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
@pytest.mark.parametrize("shape", PREFILL_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_flash_prefill(shape, dtype, cuda_exact_f32):
    dev = cuda_exact_f32
    B, T, H, Hkv, Dh, window, causal = shape
    q, k, v, lens = _prefill_inputs(shape, dtype)
    args = [_t(x, dtype, dev) for x in (q, k, v)]
    lt = torch.from_numpy(lens).to(dev)
    n0 = runtime.launch_counts["flash_prefill"]
    got = ops.flash_prefill(*args, lt, causal=causal, window=window)
    torch.cuda.synchronize()
    assert runtime.launch_counts["flash_prefill"] == n0 + 1
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
@pytest.mark.parametrize("shape", DECODE_SHAPES)
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
@pytest.mark.parametrize("shape", PAGED_SHAPES)
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
