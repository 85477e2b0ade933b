"""Wrapper of the hand-written CUDA RWKV6 recurrence (``csrc/wkv6.cu``).

Replaces ``repro/kernels/wkv6.py:wkv6`` (Pallas TPU).  The plain PyTorch
version is ``kernels/ref.py:wkv6_ref``; ``kernels/ops.py`` picks between
the two by the tensors' device.
"""
from __future__ import annotations

import torch

from . import runtime


def wkv6(r, k, v, w, u, s0, *, state_out=None):
    """r, k, v: (B,T,H,hs) f32 or bf16; w: (B,T,H,hs) f32 decay; u: (H,hs)
    f32; s0: (B,H,hs,hs) f32; all on the card.  Returns (y (B,T,H,hs) f32,
    sT (B,H,hs,hs) f32).  ``state_out`` receives sT when given; it may be
    ``s0`` itself (each (b, h) reads its state before writing it)."""
    r, k, v, w, u = (x.contiguous() for x in (r, k, v, w, u))
    runtime.check_operands("wkv6", r, k, v, w, u, s0, dtype=r.dtype)
    B, T, H, hs = r.shape
    if (k.shape != r.shape or v.shape != r.shape or w.shape != r.shape
            or k.dtype != r.dtype or v.dtype != r.dtype):
        raise ValueError(f"wkv6: r/k/v/w shapes {tuple(r.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)} "
                         f"{tuple(w.shape)}, dtypes {r.dtype} {k.dtype} "
                         f"{v.dtype}")
    if (w.dtype != torch.float32 or u.dtype != torch.float32
            or s0.dtype != torch.float32 or u.shape != (H, hs)
            or s0.shape != (B, H, hs, hs)):
        raise ValueError(f"wkv6: w {w.dtype}, u {tuple(u.shape)} {u.dtype}, "
                         f"s0 {tuple(s0.shape)} {s0.dtype}; w, u and s0 must "
                         f"be float32 of shapes (B,T,H,hs), (H,hs), "
                         f"(B,H,hs,hs)")
    if state_out is None:
        state_out = torch.empty_like(s0)
    else:
        runtime.check_operands("wkv6", s0, state_out)
        if state_out.shape != s0.shape or state_out.dtype != torch.float32:
            raise ValueError("wkv6: state_out must be float32 like s0")
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    err = runtime.library().rt_wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), state_out.data_ptr(), B, T, H, hs,
        runtime.DTYPE_CODES[r.dtype], runtime.stream_ptr(r.device))
    runtime.check(err, "wkv6", f"B={B}, T={T}, H={H}, hs={hs}")
    runtime.launch_counts["wkv6"] += 1
    return y, state_out
