"""Wrapper of the hand-written CUDA prefill kernel (``csrc/flash_prefill.cu``).

Replaces ``repro/kernels/flash_prefill.py:flash_prefill`` (Pallas TPU),
generalised to ``Tq != Tk`` with a query offset for chunked prefill.
The plain PyTorch version is ``kernels/ref.py:flash_prefill_ref``;
``kernels/ops.py`` picks between the two by the tensors' device.

The source has two bodies, chosen by dtype and head dim before the
launch (``body``): bf16 at Dh 64 or 128 runs on the tensor cores
(``wgmma``), everything else on the CUDA cores in f32.  The choice is
not a fallback: a failed build or launch of either body raises.
"""
from __future__ import annotations

import torch

from . import runtime

TENSOR_CORE_HEAD_DIMS = (64, 128)


def body(dtype: torch.dtype, Dh: int) -> str:
    """The body of ``csrc/flash_prefill.cu`` that takes a call, as its C
    dispatch (``rt_flash_prefill_body``) decides."""
    if dtype == torch.bfloat16 and Dh in TENSOR_CORE_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


def flash_prefill(q, k, v, lengths=None, *, causal: bool = True,
                  window: int = 0, q_offset: int = 0):
    """q: (B,Tq,H,Dh); k, v: (B,Tk,Hkv,Dh) on the card; lengths: (B,)
    valid key counts or None.  Queries sit at positions
    ``q_offset + i``.  Returns (B,Tq,H,Dh) in q's dtype."""
    runtime.check_operands("flash_prefill", q, k, v, dtype=q.dtype)
    B, Tq, H, Dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if (k.shape != (B, Tk, Hkv, Dh) or v.shape != k.shape
            or k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError(f"flash_prefill: shapes/dtypes q {tuple(q.shape)} "
                         f"{q.dtype}, k {tuple(k.shape)} {k.dtype}, "
                         f"v {tuple(v.shape)} {v.dtype}")
    lens_ptr = None
    if lengths is not None:
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
        if lengths.shape != (B,):
            raise ValueError("flash_prefill: lengths must be (B,)")
        lens_ptr = lengths.data_ptr()
    out = torch.empty_like(q)
    err = runtime.library().rt_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens_ptr, out.data_ptr(),
        B, Tq, Tk, H, Hkv, Dh, int(causal), int(window), int(q_offset),
        runtime.DTYPE_CODES[q.dtype], runtime.stream_ptr(q.device))
    runtime.check(err, "flash_prefill", f"Dh={Dh}, H={H}, Hkv={Hkv}")
    runtime.launch_counts["flash_prefill"] += 1
    b = body(q.dtype, Dh)
    runtime.prefill_body_counts[b] += 1
    if q_offset > 0 and q_offset % runtime.PREFILL_TILE:
        runtime.prefill_unaligned_counts[b] += 1
    return out
