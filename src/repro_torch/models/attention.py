"""Attention: dense GQA self-attention for prefill, chunked prefill and
decode over a contiguous or a paged KV cache.

PyTorch counterpart of the dense-GQA subset of
``repro/models/attention.py``.  Every attention product goes through
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

The int4 codecs of the host spill tier (``pack_int4`` ...
``dequantize_kv_int4``) are numpy, as in the reference: they run on the
host around the device-to-host copy of a spilled page.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

from . import layers
from .config import ModelConfig


def full_attention(q, k, v, *, causal: bool, lengths=None, window: int = 0,
                   q_offset: int = 0):
    """Exact GQA attention; q_offset is the position of q[0].

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


def _project_q(cfg: ModelConfig, p, x):
    B, T, _ = x.shape
    q = (x @ p["wq"]).reshape(B, T, cfg.n_heads, cfg.d_head)
    if cfg.qk_norm:
        q = layers.head_rms_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_kv(cfg: ModelConfig, p, x):
    B, T, _ = x.shape
    k = (x @ p["wk"]).reshape(B, T, cfg.n_kv_heads, cfg.d_head)
    v = (x @ p["wv"]).reshape(B, T, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        k = layers.head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def _qkv_roped(cfg: ModelConfig, p, x, positions):
    """Projected, qk-normed and RoPE'd q, k, v; positions: (B,T)."""
    q = _project_q(cfg, p, x)
    k, v = _project_kv(cfg, p, x)
    cos, sin = layers.rope_angles(positions, cfg.d_head, cfg.rope_theta)
    return layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin), v


def _check_float_cache(cfg: ModelConfig):
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "int8 KV caches arrive with the int8 slice of the port")


def self_attn_forward(cfg: ModelConfig, p, x, positions, lengths=None, *,
                      window: int = 0, cache=None, cache_len: int = 0):
    """Full-sequence self-attention (prefill).

    positions: (T,) or (B,T) absolute positions for RoPE.  With
    ``cache = (k_cache, v_cache)`` of shape (B,S,Hkv,Dh) the RoPE'd keys
    and values are written into it in place: the first S positions, or,
    when ``window`` is below ``cache_len`` (S == window then), a ring of
    each row's last ``window`` live positions.  The cache must be zeroed
    past what is written, as a fresh ``init_cache`` is.  Returns the
    attention output (B,T,d)."""
    B, T, _ = x.shape
    if positions.ndim == 1:
        positions = positions[None].expand(B, T)
    q, k, v = _qkv_roped(cfg, p, x, positions)
    out = full_attention(q, k, v, causal=cfg.causal, lengths=lengths,
                         window=window)
    out = out.reshape(B, T, cfg.q_dim) @ p["wo"]
    if cache is not None:
        _check_float_cache(cfg)
        k_cache, v_cache = cache
        S = k_cache.shape[1]
        if window and window < (cache_len or T):
            kr, vr = _ring_from_prefill(k, v, lengths, window)
            k_cache.copy_(kr)
            v_cache.copy_(vr)
        else:
            n = min(T, S)
            k_cache[:, :n] = k[:, :n]
            v_cache[:, :n] = v[:, :n]
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


def self_attn_chunk(cfg: ModelConfig, p, x, start: int, cache, active=None):
    """Chunked-prefill self-attention: Tc new tokens at absolute positions
    [start, start+Tc) attend causally over the cache prefix written by
    earlier chunks plus themselves.

    cache: (k_cache, v_cache) (B,S,Hkv,Dh), positional (non-ring),
    written in place.  ``active`` (B,) bool freezes rows whose prompt
    ended before ``start``: their cache span is left as it was, which is
    what the reference's freeze of finished rows restores."""
    _check_float_cache(cfg)
    B, Tc, _ = x.shape
    k_cache, v_cache = cache
    S = k_cache.shape[1]
    if start < 0 or start + Tc > S:
        raise ValueError(f"chunk [{start}, {start + Tc}) outside the "
                         f"cache of {S} slots")
    positions = (start + torch.arange(Tc, device=x.device))[None].expand(
        B, Tc)
    q, k, v = _qkv_roped(cfg, p, x, positions)
    if active is None:
        k_cache[:, start:start + Tc] = k
        v_cache[:, start:start + Tc] = v
    else:
        m = active[:, None, None, None]
        k_cache[:, start:start + Tc] = torch.where(
            m, k, k_cache[:, start:start + Tc])
        v_cache[:, start:start + Tc] = torch.where(
            m, v, v_cache[:, start:start + Tc])
    # every slot past start+Tc is causally hidden (the kernel stops at
    # the last live tile), so no validity bookkeeping is needed
    out = full_attention(q, k_cache, v_cache, causal=True, q_offset=start)
    return out.reshape(B, Tc, cfg.q_dim) @ p["wo"]


def self_attn_decode(cfg: ModelConfig, p, x, pos, cache, *, window: int = 0):
    """One-token decode over a contiguous cache. x: (B,1,d); pos: (B,)
    position of this token.  The new K/V are written in place; a slot
    past the cache (a dead row whose position ran on) is not written,
    as JAX drops that scatter."""
    _check_float_cache(cfg)
    B = x.shape[0]
    q, k, v = _qkv_roped(cfg, p, x, pos[:, None])
    k_cache, v_cache = cache
    S = k_cache.shape[1]
    slot = torch.remainder(pos, S) if window else pos
    live = (slot < S)[:, None, None]
    slot_c = slot.clamp(max=S - 1).long()
    bidx = torch.arange(B, device=x.device)
    k_cache[bidx, slot_c] = torch.where(live, k[:, 0], k_cache[bidx, slot_c])
    v_cache[bidx, slot_c] = torch.where(live, v[:, 0], v_cache[bidx, slot_c])
    out = decode_attention(q, k_cache, v_cache, pos, window=window)
    return out.reshape(B, 1, cfg.q_dim) @ p["wo"]


def self_attn_decode_paged(cfg: ModelConfig, p, x, pos, cache, block_tables,
                           *, page_size: int, s_len: int, window: int = 0):
    """One-token decode against the shared page pool: virtual slot
    ``pos`` (``pos % s_len`` for ring caches) lands in page
    ``block_tables[b, slot // page]`` offset ``slot % page``, written in
    place.  Dead slots walk past their table; the clip keeps their write
    in range (their tables point at the trash page)."""
    _check_float_cache(cfg)
    B = x.shape[0]
    q, k, v = _qkv_roped(cfg, p, x, pos[:, None])
    k_pool, v_pool = cache
    n_p = block_tables.shape[1]
    slot = torch.remainder(pos, s_len) if window else pos
    col = torch.clamp(torch.div(slot, page_size, rounding_mode="floor"),
                      0, n_p - 1).long()
    bidx = torch.arange(B, device=x.device)
    entry = block_tables[bidx, col].long().clamp(0, k_pool.shape[0] - 1)
    off = torch.remainder(slot, page_size).long()
    k_pool[entry, off] = k[:, 0]
    v_pool[entry, off] = v[:, 0]
    out = paged_decode_attention(q, k_pool, v_pool, block_tables, pos,
                                 s_len=s_len, window=window)
    return out.reshape(B, 1, cfg.q_dim) @ p["wo"]


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
