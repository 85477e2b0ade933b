"""Wrapper of the hand-written CUDA paged decode kernel
(``csrc/paged_decode_attn.cu``).

Replaces ``repro/kernels/paged_decode_attn.py:paged_flash_decode``
(Pallas TPU).  The plain PyTorch version is
``kernels/ref.py:paged_flash_decode_ref``.

The same split-KV kernel as the contiguous one, with the same split and
body rules (``decode_attn.plan``, ``decode_attn.body``); the lanes that
copy a slot's K/V row look its page up in the block table.

``paged_flash_decode_int8`` takes an int8 pool: codes
(n_pages,page,Hkv,Dh) and f32 scales (n_pages,page,Hkv), paged through
the same tables, dequantized in the kernel as ``decode_attn.
flash_decode_int8`` does (the reference's jnp scope
``vmem_fused:paged_flash_decode_int8``, which gathers and dequantizes
the whole pool; plain version ``ref.paged_flash_decode_int8_ref``).
"""
from __future__ import annotations

import torch

from . import decode_attn, runtime


def _tables(bt, B: int):
    if bt.ndim != 2 or bt.shape[0] != B:
        raise ValueError(f"paged decode: block tables {tuple(bt.shape)} "
                         f"for B={B}")
    return bt.contiguous()


def paged_flash_decode(q, k_pool, v_pool, block_tables, pos, *,
                       s_len: int, ring: bool = False):
    """q: (B,H,Dh) or (B,1,H,Dh); pools: (n_pages,page,Hkv,Dh) on the
    card; block_tables: (B,pages_per_seq); pos: (B,).  ``s_len`` is the
    request-level cache length (validity bound and ring modulus).
    Returns q's shape."""
    squeeze = q.ndim == 4
    if squeeze:
        q = q[:, 0]
    q = q.contiguous()
    runtime.check_operands("paged_flash_decode", q, k_pool, v_pool,
                           dtype=q.dtype)
    B, H, Dh = q.shape
    n_pages, page, Hkv = k_pool.shape[:3]
    if (k_pool.shape != (n_pages, page, Hkv, Dh)
            or v_pool.shape != k_pool.shape
            or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype):
        raise ValueError("paged_flash_decode: pool shapes/dtypes do not "
                         "match q")
    bt = _tables(block_tables.to(device=q.device, dtype=torch.int32), B)
    n_p = bt.shape[1]
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    p, part, arrivals = decode_attn.scratch(q, Hkv, int(s_len))
    err = runtime.library().rt_paged_flash_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(),
        pos.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), arrivals.data_ptr(), B,
        n_pages, page, n_p, int(s_len), H, Hkv, Dh, int(ring), p.L,
        p.n_split, runtime.DTYPE_CODES[q.dtype],
        runtime.stream_ptr(q.device))
    runtime.check(err, "paged_flash_decode",
                  f"Dh={Dh}, H={H}, Hkv={Hkv}, s_len={s_len}, {n_p} pages "
                  f"of {page}")
    runtime.launch_counts["paged_flash_decode"] += 1
    runtime.decode_plans["paged_flash_decode"] = p
    return out[:, None] if squeeze else out


def paged_flash_decode_int8(q, k_pool, v_pool, k_scale, v_scale,
                            block_tables, pos, *, s_len: int,
                            ring: bool = False):
    """q: (B,H,Dh) or (B,1,H,Dh), f32 or bf16; pools: int8 codes
    (n_pages,page,Hkv,Dh) and f32 scales (n_pages,page,Hkv) on the card;
    block_tables, pos and ``s_len`` as for ``paged_flash_decode``.
    Returns q's shape."""
    squeeze = q.ndim == 4
    if squeeze:
        q = q[:, 0]
    q = q.contiguous()
    B, H, Dh = q.shape
    n_pages, page, Hkv = k_pool.shape[:3]
    decode_attn.check_int8_kv("paged_flash_decode_int8", q, k_pool, v_pool,
                              k_scale, v_scale, (n_pages, page, Hkv, Dh))
    bt = _tables(block_tables.to(device=q.device, dtype=torch.int32), B)
    n_p = bt.shape[1]
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    p, part, arrivals = decode_attn.scratch(q, Hkv, int(s_len))
    err = runtime.library().rt_paged_flash_decode_int8(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), bt.data_ptr(),
        pos.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), arrivals.data_ptr(), B,
        n_pages, page, n_p, int(s_len), H, Hkv, Dh, int(ring), p.L,
        p.n_split, runtime.DTYPE_CODES[q.dtype],
        runtime.stream_ptr(q.device))
    runtime.check(err, "paged_flash_decode_int8",
                  f"Dh={Dh}, H={H}, Hkv={Hkv}, s_len={s_len}, {n_p} pages "
                  f"of {page}")
    runtime.launch_counts["paged_flash_decode_int8"] += 1
    runtime.decode_plans["paged_flash_decode_int8"] = p
    return out[:, None] if squeeze else out
