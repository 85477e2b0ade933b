"""Plain PyTorch versions of the kernels.

Each function computes exactly what its CUDA kernel computes, with the
reference's jnp math: for attention (``repro/models/attention.py``) f32
scores and softmax, masking by adding ``NEG_INF`` rather than ``-inf``;
for the RWKV6 recurrence (``repro/models/rwkv.py:wkv_scan``) a loop over
time of f32 rank-1 updates.  The CPU
path of the model runs these; ``chip_smoke.py`` and the card tests hold
each kernel against them.  Rows whose keys are all masked are garbage
here and in the kernels alike (finite, but not comparable).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _compute(x):
    """f32, or f64 for f64 operands (a yardstick for the tests'
    ``gradcheck``)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _gqa_scores(q, k):
    """q: (B,Tq,H,Dh), k: (B,Tk,Hkv,Dh) -> (B,Hkv,G,Tq,Tk) f32."""
    B, Tq, H, Dh = q.shape
    Hkv = k.shape[2]
    qg = _compute(q.reshape(B, Tq, Hkv, H // Hkv, Dh))
    return torch.einsum("bqhgd,bkhd->bhgqk", qg, _compute(k)) * (Dh ** -0.5)


def _gqa_out(p, v):
    """p: (B,Hkv,G,Tq,Tk) f32, v: (B,Tk,Hkv,Dh) -> (B,Tq,H,Dh) f32."""
    B, Hkv, G, Tq, Tk = p.shape
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, _compute(v))
    return out.reshape(B, Tq, Hkv * G, v.shape[-1])


def flash_prefill_ref(q, k, v, lengths=None, *, causal: bool = True,
                      window: int = 0, q_offset=0):
    """Exact GQA attention of Tq queries at positions ``q_offset + i``
    over Tk keys at positions ``0..Tk-1``.

    q: (B,Tq,H,Dh); k, v: (B,Tk,Hkv,Dh); lengths: (B,) valid key counts;
    ``q_offset``: an int or a 0-d integer tensor (the kernel's offset
    read from device memory), the same masks either way.  Generalises
    the reference ``flash_prefill`` (Tq == Tk, offset 0) to chunked
    prefill, where a chunk attends over the whole cache.  f64 operands
    are computed in f64, everything else in f32."""
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    s = _gqa_scores(q, k)
    qpos = torch.arange(Tq, device=q.device) + q_offset
    kpos = torch.arange(Tk, device=q.device)
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    zero = torch.zeros((), device=q.device)
    bias = torch.where(mask, zero, NEG_INF)[None, None, None]
    if lengths is not None:
        kvalid = kpos[None, :] < lengths.to(q.device)[:, None]   # (B,Tk)
        bias = bias + torch.where(kvalid, zero, NEG_INF)[
            :, None, None, None, :]
    p = torch.softmax(s + bias, dim=-1)
    return _gqa_out(p, v).to(q.dtype)


def decode_valid(pos, S: int, ring: bool):
    """(B,S) slot validity: ``slot <= pos``, or every slot of a ring
    cache once it has wrapped (``pos >= S``)."""
    slot = torch.arange(S, device=pos.device)
    valid = slot[None] <= pos[:, None]
    if ring:
        valid = valid | (pos[:, None] >= S)
    return valid


def flash_decode_ref(q, k_cache, v_cache, pos, *, ring: bool = False,
                     lse_out=None):
    """One query token per row over a contiguous cache.

    q: (B,H,Dh) or (B,1,H,Dh); caches: (B,S,Hkv,Dh); pos: (B,) index of
    the newest token (already written).  Returns q's shape.  ``lse_out``
    (B, H) f32, when given, takes the natural-log log-sum-exp of each
    (row, head)'s scaled scores over its live slots, -inf for a row with
    none (the kernel's ``lse_out``)."""
    squeeze = q.ndim == 3
    if squeeze:
        q = q[:, None]
    S = k_cache.shape[1]
    s = _gqa_scores(q, k_cache)                         # (B,Hkv,G,1,S)
    valid = decode_valid(pos.to(q.device), S, ring)[:, None, None, None, :]
    if lse_out is not None:
        B, Hkv, G = s.shape[:3]
        lse = torch.logsumexp(s.masked_fill(~valid, float("-inf")), -1)
        lse_out.copy_(lse.reshape(B, Hkv * G))
    zero = torch.zeros((), device=q.device)
    s = s + torch.where(valid, zero, NEG_INF)
    out = _gqa_out(torch.softmax(s, dim=-1), v_cache).to(q.dtype)
    return out[:, 0] if squeeze else out


def split_kv_decode_ref(q, k_cache, v_cache, pos, *, L: int,
                        ring: bool = False):
    """``flash_decode_ref`` computed as the split-KV decode kernels compute
    it: the slots cut into ranges of ``L``, a partial (m, l, acc) of each
    range over its live slots, and the partials merged in range order,
    ``out = sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i, 1e-30)``
    with ``M = max_i m_i``; a range with no live slot has m = -inf and
    l = 0 and weighs nothing, and a row with none at all gives 0.  The
    algebra's plain version, for the tests: nothing on the main path
    calls it.  Same arguments as ``flash_decode_ref``."""
    squeeze = q.ndim == 3
    if squeeze:
        q = q[:, None]
    S = k_cache.shape[1]
    s = _gqa_scores(q, k_cache)[:, :, :, 0]             # (B,Hkv,G,S)
    valid = decode_valid(pos.to(q.device), S, ring)[:, None, None]
    vf = v_cache.float()
    ms, ls, accs = [], [], []
    for lo in range(0, S, L):
        si = s[..., lo:lo + L].masked_fill(~valid[..., lo:lo + L],
                                           float("-inf"))
        m = si.amax(-1)                                 # (B,Hkv,G)
        p = torch.exp(si - torch.where(torch.isinf(m), 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgk,bkhd->bhgd", p, vf[:, lo:lo + L]))
    m = torch.stack(ms)                                 # (n_split,B,Hkv,G)
    M = m.amax(0)
    w = torch.exp(m - torch.where(torch.isinf(M), 0.0, M))
    l = (w * torch.stack(ls)).sum(0)
    acc = (w[..., None] * torch.stack(accs)).sum(0)     # (B,Hkv,G,Dh)
    out = acc / l.clamp_min(1e-30)[..., None]
    B, Hkv, G, Dh = out.shape
    out = out.reshape(B, 1, Hkv * G, Dh).to(q.dtype)
    return out[:, 0] if squeeze else out


def gather_paged_kv(pool, block_tables, s_len: int):
    """Reassemble per-request caches from a shared page pool.

    pool: (n_pages, page, ...); block_tables: (B, pages_per_seq).
    Returns (B, s_len, ...).  Table entries are clipped into range, as
    JAX's gather clamps them."""
    n_pages, page = pool.shape[:2]
    bt = block_tables.long().clamp(0, n_pages - 1)
    g = pool[bt]                                        # (B, n_p, page, ...)
    B, n_p = g.shape[:2]
    g = g.reshape((B, n_p * page) + tuple(g.shape[3:]))
    return g[:, :s_len]


def paged_flash_decode_ref(q, k_pool, v_pool, block_tables, pos, *,
                           s_len: int, ring: bool = False):
    """Paged decode: gather pages into the contiguous layout, then
    contiguous decode (page placement cannot change the result)."""
    k_cache = gather_paged_kv(k_pool, block_tables, s_len)
    v_cache = gather_paged_kv(v_pool, block_tables, s_len)
    return flash_decode_ref(q, k_cache, v_cache, pos, ring=ring)


def dequantize_kv(codes, scale, dtype=torch.float32):
    """int8 K/V codes (..., Dh) times their per-(token, head) f32 scales
    (...), rounded to ``dtype``: ``repro/models/attention.py:
    dequantize_kv``.  The int8 decode kernels form the same values in
    registers (the product in f32, then one rounding to q's dtype)."""
    return (codes.float() * scale[..., None]).to(dtype)


def dequantize_kv_magic(codes, scale, dtype=torch.float32):
    """``dequantize_kv`` by the route of the int8 decode kernels'
    tensor-core body (``csrc/decode_common.cuh:code_f32``, ``dequant2``),
    step by step: each code's byte xor 0x80 (u = code + 128) in the low
    mantissa bits of 2^23 (the f32 with bits 0x4B000000 | u is 2^23 + u,
    exactly), 2^23 + 128 subtracted (the code, exactly), the product with
    the slot's scale rounded to f32, then to ``dtype``.  Nothing on the
    main path calls it: the tests hold it bit for bit against
    ``dequantize_kv``."""
    u = (codes.view(torch.uint8) ^ 0x80).to(torch.int32)
    code = (u | 0x4B000000).view(torch.float32) - 8388736.0
    return (code * scale[..., None]).to(dtype)


def flash_decode_int8_ref(q, k_codes, v_codes, k_scale, v_scale, pos, *,
                          ring: bool = False, lse_out=None):
    """``flash_decode_ref`` over an int8 cache: codes (B,S,Hkv,Dh) and
    scales (B,S,Hkv) dequantized to q's dtype, then the plain decode (the
    reference's ``vmem_fused:flash_decode_int8`` scope)."""
    return flash_decode_ref(q, dequantize_kv(k_codes, k_scale, q.dtype),
                            dequantize_kv(v_codes, v_scale, q.dtype), pos,
                            ring=ring, lse_out=lse_out)


def paged_flash_decode_int8_ref(q, k_pool, v_pool, k_scale, v_scale,
                                block_tables, pos, *, s_len: int,
                                ring: bool = False):
    """``paged_flash_decode_ref`` over an int8 pool: codes
    (n_pages,page,Hkv,Dh) and scales (n_pages,page,Hkv) gathered through
    the block tables, dequantized to q's dtype, then the plain decode
    (the reference's ``vmem_fused:paged_flash_decode_int8`` scope)."""
    def gathered(codes, scale):
        return dequantize_kv(gather_paged_kv(codes, block_tables, s_len),
                             gather_paged_kv(scale, block_tables, s_len),
                             q.dtype)
    return flash_decode_ref(q, gathered(k_pool, k_scale),
                            gathered(v_pool, v_scale), pos, ring=ring)


def wkv6_ref(r, k, v, w, u, s0, *, state_out=None):
    """The RWKV6 recurrence, step by step, in f32 (the reference's
    ``wkv_scan``, which casts every input to f32), or in f64 when ``s0``
    is f64 (a yardstick for the f32 versions).

    r, k, v, w: (B,T,H,hs) (w the decay in (0, 1)); u: (H,hs); s0:
    (B,H,hs,hs).  Returns (y (B,T,H,hs), sT (B,H,hs,hs)) in the compute
    dtype; ``state_out`` receives sT when given (it may be ``s0``
    itself)."""
    ct = torch.promote_types(s0.dtype, torch.float32)
    r, k, v, w = (x.to(ct) for x in (r, k, v, w))
    u = u.to(ct)[..., None]                             # (H,hs,1)
    s = s0.to(ct)
    y = torch.empty(r.shape, dtype=ct, device=r.device)
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B,H,hs,hs)
        y[:, t] = torch.einsum("bhk,bhkv->bhv", r[:, t], s + u * kv)
        s = w[:, t, :, :, None] * s + kv
    if state_out is not None:
        return y, state_out.copy_(s)
    return y, s


def wkv6_bwd_ref(r, k, v, w, u, s0, dy, dsT=None):
    """The gradient of ``wkv6_ref`` by its closed-form reverse recurrence
    (not through autograd).  With S_{t-1} the state before step t (S_0 =
    s0) and G_t = dL/dS_t (G_T = ``dsT``, zero when None; ``dy`` None
    is zero too):

        dr_t = S_{t-1} dy_t + u * k_t (v_t . dy_t)
        dk_t = G_t v_t + u * r_t (v_t . dy_t)
        dv_t = G_t^T k_t + dy_t (r_t . (u * k_t))
        dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
        du = sum_{b, t} r_t * k_t (v_t . dy_t)
        G_{t-1} = diag(w_t) G_t + r_t dy_t^T,  ds0 = G_0

    Computed in f32, or in f64 when ``s0`` is f64, as ``wkv6_ref``; the
    states of the forward are kept, one a step.  Returns (dr, dk, dv, dw,
    du, ds0), each in its input's dtype, as autograd through
    ``wkv6_ref``'s casts gives them.  For the CPU and the tests: on the
    card ``kernels/wkv6.py:wkv6_bwd`` computes it."""
    ct = torch.promote_types(s0.dtype, torch.float32)
    rf, kf, vf, wf = (x.to(ct) for x in (r, k, v, w))
    uf = u.to(ct)
    B, T, H, hs = r.shape
    dyf = rf.new_zeros(r.shape) if dy is None else dy.to(ct)
    s = s0.to(ct)
    states = []
    for t in range(T):
        states.append(s)
        s = wf[:, t, :, :, None] * s + \
            kf[:, t, :, :, None] * vf[:, t, :, None, :]
    g = torch.zeros_like(s) if dsT is None else dsT.to(ct)
    dr, dk, dv, dw = (rf.new_empty(r.shape) for _ in range(4))
    for t in reversed(range(T)):
        st = states[t]
        dr[:, t] = torch.einsum("bhij,bhj->bhi", st, dyf[:, t])
        dk[:, t] = torch.einsum("bhij,bhj->bhi", g, vf[:, t])
        dv[:, t] = torch.einsum("bhij,bhi->bhj", g, kf[:, t])
        dw[:, t] = torch.einsum("bhij,bhij->bhi", g, st)
        g = wf[:, t, :, :, None] * g + \
            rf[:, t, :, :, None] * dyf[:, t, :, None, :]
    vd = (vf * dyf).sum(-1, keepdim=True)               # (B,T,H,1)
    c = (rf * uf * kf).sum(-1, keepdim=True)
    dr = dr + uf * kf * vd
    dk = dk + uf * rf * vd
    dv = dv + dyf * c
    du = (rf * kf * vd).sum((0, 1))
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype), g.to(s0.dtype))


def _fold_halves(x, dim):
    """Sum over ``dim`` (a power of two long) as the kernel's shuffles
    take it: the first half plus the second, repeated."""
    while x.shape[dim] > 1:
        a, b = x.chunk(2, dim=dim)
        x = a + b
    return x.squeeze(dim)


def _chain(x, dim):
    """Sum over ``dim`` in order, one term at a time."""
    acc = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def wkv6_tiled_ref(r, k, v, w, u, s0, *, kr: int = 8, state_out=None):
    """``wkv6_ref`` computed in the order of the CUDA kernel
    (``csrc/wkv6.cu``) whose threads hold ``kr`` state rows each: the
    bonus hoisted out of the state, ``c_t = sum_k (r_t[k] u[k]) k_t[k]``
    summed in order over 8-element groups whose sums are folded halves
    first, then ``y_t[v] = fold_g(sum_{i<kr} r[g kr + i] S[g kr + i, v])
    + c_t v_t[v]`` over the ``hs / kr`` row groups g, and ``S = w S +
    k v``.  The kernel fuses the multiply-adds; this plain version rounds
    each product, so the two agree to f32 rounding, not bit for bit.  For
    the tests: nothing on the main path calls it.  Same arguments and
    result as ``wkv6_ref`` (in f32)."""
    ct = torch.float32
    r, k, v, w = (x.to(ct) for x in (r, k, v, w))
    B, T, H, hs = r.shape
    g = hs // kr
    u = u.to(ct)                                        # (H,hs)
    s = s0.to(ct)
    y = torch.empty(r.shape, dtype=ct, device=r.device)
    for t in range(T):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]  # (B,H,hs)
        c = _fold_halves(_chain(((rt * u) * kt).reshape(B, H, hs // 8, 8),
                                3), 2)                  # (B,H)
        part = _chain((rt[..., None] * s).reshape(B, H, g, kr, hs), 3)
        y[:, t] = _fold_halves(part, 2) + c[..., None] * vt
        s = wt[..., None] * s + kt[..., None] * vt[..., None, :]
    if state_out is not None:
        return y, state_out.copy_(s)
    return y, s
