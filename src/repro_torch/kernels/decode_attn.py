"""Wrapper of the hand-written CUDA contiguous decode kernel
(``csrc/decode_attn.cu``).

Replaces ``repro/kernels/decode_attn.py:flash_decode`` (Pallas TPU).
The plain PyTorch version is ``kernels/ref.py:flash_decode_ref``.
"""
from __future__ import annotations

import torch

from . import runtime


def flash_decode(q, k_cache, v_cache, pos, *, ring: bool = False):
    """q: (B,H,Dh) or (B,1,H,Dh); caches: (B,S,Hkv,Dh) on the card;
    pos: (B,).  Returns q's shape."""
    squeeze = q.ndim == 4
    if squeeze:
        q = q[:, 0]
    q = q.contiguous()
    runtime.check_operands("flash_decode", q, k_cache, v_cache,
                           dtype=q.dtype)
    B, H, Dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape != (B, S, Hkv, Dh) or v_cache.shape != k_cache.shape
            or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype):
        raise ValueError("flash_decode: cache shapes/dtypes do not match q")
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    err = runtime.library().rt_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, S, H, Hkv, Dh, int(ring),
        runtime.DTYPE_CODES[q.dtype], runtime.stream_ptr(q.device))
    runtime.check(err, "flash_decode", f"Dh={Dh}, H={H}, Hkv={Hkv}")
    runtime.launch_counts["flash_decode"] += 1
    return out[:, None] if squeeze else out
