"""Attention: dense GQA self-attention for prefill, chunked prefill and
decode over a contiguous or a paged KV cache, and the VLM's tanh-gated
cross-attention over a request's vision K/V.

PyTorch counterpart of ``repro/models/attention.py``.  Every attention
product goes through
``kernels/ops.py``: the plain PyTorch version for tensors on the CPU,
the hand-written CUDA kernel for tensors on the card.  On the card the
prefill kernel covers every T, so the reference's ``blocked_attention``
(its memory workaround above T = 1024) has no counterpart.

Caches are updated in place: a decode step writes the new token's K/V
into the preallocated cache or page pool instead of returning a copy as
JAX's ``.at[].set`` does.  Where the reference relies on JAX dropping an
out-of-range write (a dead slot whose position ran past a contiguous
cache), the port masks the write; where it relies on JAX clamping a
gather, the port clips the index.

int8 KV caches (``cfg.kv_cache_dtype == "int8"``) are 4-tuples ``(k, v,
k_s, v_s)``: int8 codes and one f32 scale per (token, kv head), from
:func:`quantize_kv`, with the reference's arithmetic.  The three paths
attend over what the reference's do: whole-prompt prefill over the
unquantized K/V (it only stores codes), a prefill chunk over the
dequantized cache (the chunk's own codes included; the port dequantizes
the whole cache, a fixed size as in the reference, so that a CUDA graph
of the chunk serves every offset, and calls the prefill kernel
unchanged),
and decode through the int8 decode kernels, which dequantize in
registers (the reference gathers and dequantizes the whole cache in jnp
first).

Under a mesh (``sharding/partition.py:shard_model``), the projections
run tensor-parallel over ``model``.  ``wq/wk/wv`` are column-parallel:
when H and Hkv both divide over ``model`` each rank attends over its own
heads (its own GQA groups, its own kv heads of the cache); with one kv
head (Hkv = 1, recurrentgemma) and H dividing, each rank attends with
its own query heads over the one kv head, whole on every rank;
otherwise a cut projection's output is all-gathered before the reshape
and qk-norm and every rank attends over all heads.  ``wo`` is
row-parallel on this rank's heads (or its slice of the replicated
output), followed by an all-reduce.  The VLM's cross-attention takes
the same projections, its vision K/V cut by kv head where Hkv divides
(``partition.cache_rule``), as the self-attention K/V are.  A decode
cache cut along the sequence (Hkv does not divide, S >= 2048:
``partition.cache_rule``) holds slots [r S/m, (r+1) S/m) on model rank
r; :func:`distributed_decode_attention` runs the decode kernel over
them (every query head) with its log-sum-exp output and combines the
shards
(:func:`combine_decode_partials`); a prefill chunk over such a cache
all-gathers it over ``model``, attends over the whole prefix and keeps
its own slots of the result (:func:`self_attn_chunk`).  A paged pool
under a mesh is one replica a data rank, of this rank's kv heads when
they are local, else of all of them: each rank decodes its own slots'
rows and writes every row's token, gathered over the batch axes, into
its replica (:func:`self_attn_decode_paged`).

The int4 codecs of the host spill tier (``pack_int4`` ...
``dequantize_kv_int4``) are numpy, as in the reference: they run on the
host around the device-to-host copy of a spilled page.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import dequantize_kv
from repro_torch.sharding import collectives
from repro_torch.sharding.rows import gather_rows, local_rows

from . import layers
from .config import ModelConfig


def full_attention(q, k, v, *, causal: bool, lengths=None, window: int = 0,
                   q_offset=0):
    """Exact GQA attention; q_offset (an int or a 0-d int32 tensor) is
    the position of q[0].

    q: (B,Tq,H,Dh); k, v: (B,Tk,Hkv,Dh); lengths: (B,) valid keys."""
    return ops.flash_prefill(q, k, v, lengths, causal=causal, window=window,
                             q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0):
    """q: (B,1,H,Dh); caches: (B,S,Hkv,Dh); pos: (B,) index of the new
    token (already written).  A window marks a ring cache."""
    return ops.flash_decode(q, k_cache, v_cache, pos, ring=bool(window))


def paged_decode_attention(q, k_pool, v_pool, block_tables, pos, *,
                           s_len: int, window: int = 0):
    """Decode attention over a paged KV cache."""
    return ops.paged_flash_decode(q, k_pool, v_pool, block_tables, pos,
                                  s_len=s_len, ring=bool(window))


def quantize_kv(x):
    """Symmetric per-(token, head) int8: x (..., Dh) -> (codes int8,
    scale f32 (...)), as ``repro/models/attention.py:quantize_kv``: the
    scale is max |x| / 127 in f32, at least 1e-8, and the codes are x /
    scale rounded half to even and clipped to [-127, 127].
    ``dequantize_kv`` (``kernels/ref.py``) is its inverse."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1) / 127.0, min=1e-8)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def local_heads(cfg: ModelConfig, mesh) -> bool:
    """Whether each ``model`` rank attends over its own heads: H and Hkv
    both divide over the axis (always true without a mesh)."""
    m = mesh.size("model") if mesh is not None else 1
    return cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0


def local_q_heads(cfg: ModelConfig, mesh) -> bool:
    """Whether each ``model`` rank attends with its own query heads: the
    heads are local (:func:`local_heads`), or H divides and one kv head
    serves them all (Hkv = 1), which every rank then holds whole."""
    m = mesh.size("model") if mesh is not None else 1
    return local_heads(cfg, mesh) or (cfg.n_heads % m == 0
                                      and cfg.n_kv_heads == 1)


def _column(x, w, mesh, local: bool):
    """``x @ w``; a column-parallel ``w`` gives this rank's columns, made
    whole by an all-gather unless its heads are ``local``."""
    y = layers.column(x, w, mesh)
    return y if local else layers.whole(y, w, mesh)


def _head_norm(cfg: ModelConfig, x, w, proj, mesh, local: bool):
    """qk-norm; over this rank's heads (``local``), the replicated
    scale's gradient is all-reduced over ``model`` (its heads are a part
    of the sum)."""
    g = layers.model_group(mesh, proj, -1)
    if g is not None and local:
        w = collectives.copy_to(w, g)
    return layers.head_rms_norm(x, w, cfg.norm_eps)


def _project_q(cfg: ModelConfig, p, x, mesh=None):
    B, T, _ = x.shape
    local = local_q_heads(cfg, mesh)
    q = _column(x, p["wq"], mesh, local).reshape(B, T, -1, cfg.d_head)
    if cfg.qk_norm:
        q = _head_norm(cfg, q, p["q_norm"], p["wq"], mesh, local)
    return q


def _project_kv(cfg: ModelConfig, p, x, mesh=None):
    B, T, _ = x.shape
    local = local_heads(cfg, mesh)
    k = _column(x, p["wk"], mesh, local).reshape(B, T, -1, cfg.d_head)
    v = _column(x, p["wv"], mesh, local).reshape(B, T, -1, cfg.d_head)
    if cfg.qk_norm:
        k = _head_norm(cfg, k, p["k_norm"], p["wk"], mesh, local)
    if not local and local_q_heads(cfg, mesh) and mesh.size("model") > 1:
        # whole K/V that this rank's query heads alone read: their
        # gradients are parts of a sum over ``model``
        g = mesh.group("model")
        k, v = collectives.copy_to(k, g), collectives.copy_to(v, g)
    return k, v


def _project_out(cfg: ModelConfig, p, out, mesh=None):
    """(B,T,heads,Dh) attention output through ``wo``: row-parallel on
    this rank's heads (or its slice of all heads), then all-reduced."""
    B, T = out.shape[:2]
    o = out.reshape(B, T, -1)
    g = layers.model_group(mesh, p["wo"], 0)
    if g is None:
        return o @ p["wo"]
    if not local_q_heads(cfg, mesh):
        o = collectives.scatter_to(o, g, -1)
    return collectives.reduce_from(o @ p["wo"], g)


def _qkv_roped(cfg: ModelConfig, p, x, positions, mesh=None):
    """Projected, qk-normed and RoPE'd q, k, v; positions: (B,T)."""
    q = _project_q(cfg, p, x, mesh)
    k, v = _project_kv(cfg, p, x, mesh)
    cos, sin = layers.rope_angles(positions, cfg.d_head, cfg.rope_theta)
    return layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin), v


def _seq_base(cache, mesh, seq_sharded: bool):
    """(first global slot of this rank's cache, global slots): (0, S)
    unless the cache is cut along the sequence over ``model``."""
    S = cache[0].shape[1]
    if not seq_sharded:
        return 0, S
    return mesh.coord("model") * S, S * mesh.size("model")


def _quantized(cache) -> bool:
    return len(cache) == 4


def _store(cache, index, k, v, where=None) -> None:
    """Write ``k``/``v`` into ``cache`` at ``index`` (quantized first for
    an int8 cache, codes and scales alike); with ``where`` (a mask that
    broadcasts against the K/V), only where it is true."""
    vals = (*quantize_kv(k), *quantize_kv(v)) if _quantized(cache) \
        else (k, v)
    order = (0, 2, 1, 3) if _quantized(cache) else (0, 1)
    for leaf, j in zip(cache, order):
        val = vals[j]
        if where is not None:
            m = where if val.ndim == where.ndim else where[..., 0]
            val = torch.where(m, val, leaf[index])
        leaf[index] = val


def self_attn_forward(cfg: ModelConfig, p, x, positions, lengths=None, *,
                      window: int = 0, cache=None, cache_len: int = 0,
                      mesh=None, seq_sharded: bool = False):
    """Full-sequence self-attention (prefill).

    positions: (T,) or (B,T) absolute positions for RoPE.  With
    ``cache = (k_cache, v_cache)`` of shape (B,S,Hkv,Dh) the RoPE'd keys
    and values are written into it in place: the first S positions, or,
    when ``window`` is below ``cache_len`` (S == window then), a ring of
    each row's last ``window`` live positions.  The cache must be zeroed
    past what is written, as a fresh ``init_cache`` is.  An int8 cache
    ``(k, v, k_s, v_s)`` stores codes and scales and is written whole:
    the reference quantizes the zero padding past T too, so those slots
    get scale 1e-8.  Attention runs over the unquantized K/V either way.
    A cache cut along the sequence (``seq_sharded``) takes its own slots
    of that layout.  Returns the attention output (B,T,d)."""
    B, T, _ = x.shape
    if positions.ndim == 1:
        positions = positions[None].expand(B, T)
    q, k, v = _qkv_roped(cfg, p, x, positions, mesh)
    out = full_attention(q, k, v, causal=cfg.causal, lengths=lengths,
                         window=window)
    out = _project_out(cfg, p, out, mesh)
    if cache is not None:
        S = cache[0].shape[1]
        base, S_all = _seq_base(cache, mesh, seq_sharded)
        if window and window < (cache_len or T):
            kr, vr = _ring_from_prefill(k, v, lengths, window)
            _store(cache, slice(None), kr[:, base:base + S],
                   vr[:, base:base + S])
        else:
            n = max(0, min(T, S_all, base + S) - base)     # slots written
            _store(cache, (slice(None), slice(0, n)), k[:, base:base + n],
                   v[:, base:base + n])
            if _quantized(cache) and n < S:
                for leaf in cache[2:]:
                    leaf[:, n:] = 1e-8          # quantize_kv of the zeros
    return out


def _ring_from_prefill(k, v, lengths, W: int):
    """Gather the last W live positions of each sequence into ring
    layout (position p at slot p % W; slots never written stay 0)."""
    B, T = k.shape[:2]
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=k.device)
    last = lengths.to(k.device).long()[:, None] - 1               # (B,1)
    slots = torch.arange(W, device=k.device)[None]                 # (1,W)
    src = last - torch.remainder(last - slots, W)                  # (B,W)
    valid = src >= torch.clamp(lengths.to(k.device).long()[:, None] - W,
                               min=0)
    src_c = src.clamp(0, T - 1)
    idx = src_c[..., None, None].expand(B, W, k.shape[2], k.shape[3])
    kr = torch.gather(k, 1, idx)
    vr = torch.gather(v, 1, idx)
    m = valid[..., None, None]
    return torch.where(m, kr, 0), torch.where(m, vr, 0)


def self_attn_chunk(cfg: ModelConfig, p, x, start, cache, active=None,
                    mesh=None, seq_sharded: bool = False):
    """Chunked-prefill self-attention: Tc new tokens at absolute positions
    [start, start+Tc) attend causally over the cache prefix written by
    earlier chunks plus themselves.

    ``start`` is an int or a 0-d int32 tensor on x's device (the
    reference traces it): the positions, the K/V write and the kernel's
    query offset all read it on the device, so one CUDA graph of a chunk
    serves every offset.  An int is range-checked here; a tensor's range
    is the caller's to check (it knows the host value).  cache: (k_cache,
    v_cache) (B,S,Hkv,Dh), positional (non-ring), written in place at
    slots ``start + arange(Tc)``.  ``active`` (B,) bool freezes rows
    whose prompt ended before ``start``: their cache span is left as it
    was, which is what the reference's freeze of finished rows restores.
    An int8 cache ``(k, v, k_s, v_s)`` takes the chunk's codes and scales,
    and the chunk attends over the whole cache dequantized to q's dtype,
    as the reference does: a fixed size, whatever ``start``; the causal
    mask hides the slots past ``start + Tc``.  A cache cut along the
    sequence over ``model`` (``seq_sharded``; the heads are then not
    local) is all-gathered into the whole cache, the chunk runs over it
    as over an uncut one on every rank, and each rank keeps its slots of
    the result (the chunk's K/V that fall in its range, the rest as it
    was)."""
    if seq_sharded:
        g = mesh.group("model")
        S = cache[0].shape[1]
        base = mesh.coord("model") * S
        whole = tuple(collectives.all_gather(leaf, g, 1) for leaf in cache)
        out = self_attn_chunk(cfg, p, x, start, whole, active, mesh)
        for leaf, w in zip(cache, whole):
            leaf.copy_(w[:, base:base + S])
        return out
    B, Tc, _ = x.shape
    S = cache[0].shape[1]
    if not torch.is_tensor(start) and (start < 0 or start + Tc > S):
        raise ValueError(f"chunk [{start}, {start + Tc}) outside the "
                         f"cache of {S} slots")
    idx = start + torch.arange(Tc, device=x.device)
    q, k, v = _qkv_roped(cfg, p, x, idx[None].expand(B, Tc), mesh)
    _store(cache, (slice(None), idx), k, v,
           None if active is None else active[:, None, None, None])
    if _quantized(cache):
        kd = dequantize_kv(cache[0], cache[2], q.dtype)
        vd = dequantize_kv(cache[1], cache[3], q.dtype)
    else:
        kd, vd = cache
    # every slot past start+Tc is causally hidden (the kernel stops at
    # the last live tile), so no validity bookkeeping is needed
    out = full_attention(q, kd, vd, causal=True, q_offset=start)
    return _project_out(cfg, p, out, mesh)


def self_attn_decode(cfg: ModelConfig, p, x, pos, cache, *, window: int = 0,
                     mesh=None, seq_sharded: bool = False):
    """One-token decode over a contiguous cache. x: (B,1,d); pos: (B,)
    position of this token.  The new K/V are written in place; a slot
    past the cache (a dead row whose position ran on) is not written,
    as JAX drops that scatter.  An int8 cache ``(k, v, k_s, v_s)`` takes
    the token's codes and scales under the same mask, and the int8 decode
    kernel reads it.  A cache cut along the sequence (``seq_sharded``)
    takes the token only on the rank whose slots hold it, and attends
    through :func:`distributed_decode_attention`."""
    B = x.shape[0]
    q, k, v = _qkv_roped(cfg, p, x, pos[:, None], mesh)
    S = cache[0].shape[1]
    if seq_sharded:
        base, S_all = _seq_base(cache, mesh, seq_sharded)
        slot = (torch.remainder(pos, S_all) if window else pos) - base
        live = ((slot >= 0) & (slot < S))[:, None, None]
    else:
        slot = torch.remainder(pos, S) if window else pos
        live = (slot < S)[:, None, None]
    slot_c = slot.clamp(0, S - 1).long()
    bidx = torch.arange(B, device=x.device)
    _store(cache, (bidx, slot_c), k[:, 0], v[:, 0], live)
    if seq_sharded:
        # every query head over this rank's slots (gathered where the
        # rank holds its own), then this rank's heads of the combine
        m = mesh.size("model")
        own = m > 1 and local_q_heads(cfg, mesh)
        qa = collectives.all_gather(q, mesh.group("model"), 2) if own else q
        out = distributed_decode_attention(
            qa, cache[0], cache[1], pos, mesh, window=window,
            scales=cache[2:] if _quantized(cache) else None)
        if own:
            out = out.chunk(m, 2)[mesh.coord("model")]
    elif _quantized(cache):
        out = ops.flash_decode_int8(q, *cache, pos, ring=bool(window))
    else:
        out = decode_attention(q, *cache, pos, window=window)
    return _project_out(cfg, p, out, mesh)


def combine_decode_partials(out, lse, reduce_max, reduce_sum):
    """The attention output over every shard of the keys from each
    shard's normalized output ``out`` (..., H, Dh) and log-sum-exp
    ``lse`` (..., H) f32 (-inf: no live key): with ``M = max lse`` and
    ``w = exp(lse - M)`` (0 where lse is -inf), ``sum(w out) /
    max(sum w, 1e-30)`` in f32 — the reference's pmax and two psums
    (``repro/models/attention.py:distributed_decode_attention``) in
    normalized form.  ``reduce_max`` / ``reduce_sum`` reduce over the
    shards: all-reduces over the ``model`` group, or over a leading shard
    axis of partials held in one process."""
    M = reduce_max(lse)
    w = torch.where(lse == float("-inf"), 0.0, torch.exp(lse - M))
    num = reduce_sum(w[..., None] * out.float())
    return num / reduce_sum(w).clamp_min(1e-30)[..., None]


def seq_local_pos(pos, base: int, S_all: int, ring: bool):
    """The position a shard holding global slots [base, base + S/m) gives
    the decode kernel, so that its own validity rule (``slot <= pos``, or
    every slot once a ring has wrapped) marks the shard's live slots:
    ``pos - base``, or ``pos`` for a wrapped ring (``pos >= S``)."""
    local = pos - base
    return torch.where(pos >= S_all, pos, local) if ring else local


def distributed_decode_attention(q, k_cache, v_cache, pos, mesh, *,
                                 window: int = 0, scales=None):
    """Flash-decode over a SEQUENCE-sharded KV cache (the reference's
    distributed segmented softmax).  Each ``model`` rank holds slots
    [r S/m, (r+1) S/m) of the (B_loc, S, Hkv, Dh) cache as ``k_cache`` /
    ``v_cache`` (int8 codes with ``scales`` (k_s, v_s) for an int8
    cache); q: (B_loc,1,H,Dh), every head; pos: (B_loc,) global
    positions.  The local call is the decode kernel (the int8 one for an
    int8 cache) at the shard's local positions (:func:`seq_local_pos`)
    with its log-sum-exp output; one max and two sums over ``model``
    combine the shards (:func:`combine_decode_partials`).  Returns
    (B_loc,1,H,Dh) in q's dtype, the same on every rank of the group."""
    S = k_cache.shape[1]
    m = mesh.size("model")
    base = mesh.coord("model") * S
    ring = bool(window)
    lpos = seq_local_pos(pos, base, S * m, ring)
    lse = torch.empty(q.shape[0], q.shape[2], dtype=torch.float32,
                      device=q.device)
    if scales is not None:
        out = ops.flash_decode_int8(q, k_cache, v_cache, *scales, lpos,
                                    ring=ring, lse_out=lse)
    else:
        out = ops.flash_decode(q, k_cache, v_cache, lpos, ring=ring,
                               lse_out=lse)
    g = mesh.group("model")
    comb = combine_decode_partials(
        out, lse[:, None], lambda t: collectives.all_reduce(t, g, "max"),
        lambda t: collectives.all_reduce(t, g, "sum"))
    return comb.to(q.dtype)


def self_attn_decode_paged(cfg: ModelConfig, p, x, pos, cache, block_tables,
                           *, page_size: int, s_len: int, window: int = 0,
                           mesh=None):
    """One-token decode against the shared page pool: virtual slot
    ``pos`` (``pos % s_len`` for ring caches) lands in page
    ``block_tables[b, slot // page]`` offset ``slot % page``, written in
    place.  Dead slots walk past their table; the clip keeps their write
    in range (their tables point at the trash page).  An int8 pool
    ``(k, v, k_s, v_s)`` takes the token's codes and scales at the same
    place, and the int8 paged decode kernel reads it.

    Under a mesh the pool is one replica a data rank (this rank's kv
    heads over ``model``, all of them when the heads are not local), and
    ``pos`` and ``block_tables`` hold every slot on every rank (whole,
    not cut over ``data``: ``partition.paged_cache_specs``).  ``x`` is
    this rank's rows (its slots' cut over the batch axes), which the
    projections and the decode kernel run over; their K/V are
    all-gathered over the batch axes (``sharding.rows.gather_rows``, one
    gather of K and V together, in float: an int8 pool quantizes after,
    deterministically; none where ``data`` has one rank, whose rows are
    already every row), and every rank writes every row's token into
    its replica at the place the whole ``pos`` and tables give.  So the
    replicas hold the same bits after every step, except the trash page:
    two dead rows that write one place there are a duplicate index,
    whose winner the card does not fix, and no live row reads it."""
    n = block_tables.shape[0]
    lpos, lbt = pos, block_tables
    if mesh is not None:
        lpos, lbt = (local_rows(t, mesh, n) for t in (pos, block_tables))
    q, k, v = _qkv_roped(cfg, p, x, lpos[:, None], mesh)
    k, v = k[:, 0], v[:, 0]
    if mesh is not None:
        kv = gather_rows(torch.stack((k, v), 1), mesh, n)
        k, v = kv[:, 0], kv[:, 1]
    n_p = block_tables.shape[1]
    slot = torch.remainder(pos, s_len) if window else pos
    col = torch.clamp(torch.div(slot, page_size, rounding_mode="floor"),
                      0, n_p - 1).long()
    bidx = torch.arange(n, device=x.device)
    entry = block_tables[bidx, col].long().clamp(0, cache[0].shape[0] - 1)
    off = torch.remainder(slot, page_size).long()
    _store(cache, (entry, off), k, v)
    if _quantized(cache):
        out = ops.paged_flash_decode_int8(q, *cache, lbt, lpos,
                                          s_len=s_len, ring=bool(window))
    else:
        out = paged_decode_attention(q, *cache, lbt, lpos,
                                     s_len=s_len, window=window)
    return _project_out(cfg, p, out, mesh)


def cross_kv(cfg: ModelConfig, p, vis, mesh=None):
    """The vision K/V of a cross layer, once a request: ``vis`` (B, Nv,
    d_model), already through ``vis_proj``, projected by ``wk``/``wv``
    (and k-normed where the config has qk-norm); no RoPE.  Under a mesh,
    this rank's kv heads where they are local, else all of them."""
    return _project_kv(cfg, p, vis, mesh)


def _gated(p, out):
    """``tanh(gate)`` in f32, cast to the output's dtype, times out."""
    return torch.tanh(p["gate"].float()).to(out.dtype) * out


def cross_attn_forward(cfg: ModelConfig, p, x, vis_kv, mesh=None):
    """Cross-attention of (B,T,d) over fixed vision K/V ``vis_kv`` (k, v)
    (B,Nv,Hkv,Dh): every query sees every vision key (no mask, so query
    rows past a row's length are garbage, as in the reference)."""
    q = _project_q(cfg, p, x, mesh)
    out = full_attention(q, *vis_kv, causal=False)
    return _gated(p, _project_out(cfg, p, out, mesh))


def cross_attn_decode(cfg: ModelConfig, p, x, vis_kv, mesh=None):
    """``cross_attn_forward`` for one query token a row (x: (B,1,d)),
    through the decode kernel: with every row's ``pos`` the last vision
    slot and no ring, its live keys are all Nv of them, which is the
    reference's ``full_attention(causal=False)``."""
    B = x.shape[0]
    k, v = vis_kv
    q = _project_q(cfg, p, x, mesh)
    pos = torch.full((B,), k.shape[1] - 1, dtype=torch.int32,
                     device=x.device)
    out = decode_attention(q, k, v, pos)
    return _gated(p, _project_out(cfg, p, out, mesh))


# ------------------------------------------- int4 spill-tier compression --
# Host-side (numpy) helpers for the spill tier: pages crossing the host
# link may be packed two int4 values per byte with per-(token, head) f32
# scales.  Copied from the reference; they run on the host around the
# device-to-host copy, never on the card.

def pack_int4(q) -> np.ndarray:
    """Pack int8 values in [-8, 7] two-per-byte along the LAST axis.
    An odd tail is zero-padded — ``unpack_int4(p, n)`` restores the
    exact original length."""
    q = np.asarray(q, np.int8)
    if q.shape[-1] % 2:
        q = np.concatenate(
            [q, np.zeros(q.shape[:-1] + (1,), np.int8)], axis=-1)
    u = (q.astype(np.int16) & 0xF).astype(np.uint8)
    return (u[..., 0::2] | (u[..., 1::2] << 4)).astype(np.uint8)


def unpack_int4(p, n: int) -> np.ndarray:
    """Inverse of :func:`pack_int4`: bytes -> int8 values, trimmed to
    the original last-axis length ``n``."""
    p = np.asarray(p, np.uint8)
    assert n <= 2 * p.shape[-1], (n, p.shape)
    lo = (p & 0xF).astype(np.int16)
    hi = (p >> 4).astype(np.int16)
    out = np.empty(p.shape[:-1] + (2 * p.shape[-1],), np.int16)
    out[..., 0::2] = lo
    out[..., 1::2] = hi
    out = np.where(out >= 8, out - 16, out).astype(np.int8)
    return out[..., :n]


def quantize_kv_int4(x):
    """Symmetric per-(token, head) int4 for spilled pages:
    x (..., Dh) float -> (packed uint8 (..., ceil(Dh/2)), scale f32),
    on a 4-bit grid (limit 7)."""
    x = np.asarray(x, np.float32)
    scale = np.abs(x).max(axis=-1) / 7.0
    scale = np.maximum(scale, 1e-8).astype(np.float32)
    q = np.clip(np.rint(x / scale[..., None]), -7, 7).astype(np.int8)
    return pack_int4(q), scale


def dequantize_kv_int4(packed, scale, n: int, dtype=np.float32):
    """Inverse of :func:`quantize_kv_int4` (``n`` = original Dh)."""
    q = unpack_int4(packed, n)
    return (q.astype(np.float32) * scale[..., None]).astype(dtype)
