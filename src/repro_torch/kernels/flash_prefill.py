"""Wrapper of the hand-written CUDA prefill kernel (``csrc/flash_prefill.cu``).

Replaces ``repro/kernels/flash_prefill.py:flash_prefill`` (Pallas TPU),
generalised to ``Tq != Tk`` with a query offset for chunked prefill.
The plain PyTorch version is ``kernels/ref.py:flash_prefill_ref``;
``kernels/ops.py`` picks between the two by the tensors' device.

The kernel reads its query offset from device memory (a null pointer
is offset 0): a CUDA graph of a prefill chunk captures the offset's
tensor once and serves every offset written into it
(``core/engine.py:PrefillGraph``).  The wrapper takes a 0-d int32 tensor
on the card or a Python int, which it writes into a device scalar.  The
launch, its grid and its body do not depend on the offset.

The source has two bodies, chosen by dtype before the launch (``body``):
bf16 runs on the tensor cores (``wgmma``) at every head dim the kernel
takes, f32 on the CUDA cores.  The choice is not a fallback: a failed
build or launch of either body raises.
"""
from __future__ import annotations

import torch

from . import runtime

# every head dim the kernel takes; bf16 runs all of them on the tensor
# cores (csrc/flash_prefill.cu: tc::dispatch)
TENSOR_CORE_HEAD_DIMS = (64, 80, 128, 192, 256)


def body(dtype: torch.dtype, Dh: int) -> str:
    """The body of ``csrc/flash_prefill.cu`` that takes a call, as its C
    dispatch (``rt_flash_prefill_body``) decides: bf16 at every head dim
    on the tensor cores, f32 on the CUDA cores (the decode kernels' rule,
    ``decode_attn.body``)."""
    return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"


def flash_prefill(q, k, v, lengths=None, *, causal: bool = True,
                  window: int = 0, q_offset=0):
    """q: (B,Tq,H,Dh); k, v: (B,Tk,Hkv,Dh) on the card; lengths: (B,)
    valid key counts or None.  Queries sit at positions
    ``q_offset + i``; ``q_offset`` is an int or a 0-d int32 tensor on
    q's device.  Returns (B,Tq,H,Dh) in q's dtype.

    A launch at an int offset off the 64-row tile adds to
    ``runtime.prefill_unaligned_counts``; at a tensor offset the host
    does not know it, and the caller counts (``runtime.count_unaligned``)."""
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
    host_offset = not torch.is_tensor(q_offset)
    if host_offset:
        q_offset = int(q_offset)
        off = torch.full((), q_offset, dtype=torch.int32,
                         device=q.device) if q_offset else None
    elif (q_offset.shape != () or q_offset.dtype != torch.int32
            or q_offset.device != q.device):
        raise ValueError(f"flash_prefill: a tensor q_offset is 0-d int32 "
                         f"on {q.device}, got {q_offset.dtype} "
                         f"{tuple(q_offset.shape)} on {q_offset.device}")
    else:
        off = q_offset
    out = torch.empty_like(q)
    err = runtime.library().rt_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens_ptr, out.data_ptr(),
        B, Tq, Tk, H, Hkv, Dh, int(causal), int(window),
        None if off is None else off.data_ptr(),
        runtime.DTYPE_CODES[q.dtype], runtime.stream_ptr(q.device))
    runtime.check(err, "flash_prefill", f"Dh={Dh}, H={H}, Hkv={Hkv}")
    runtime.launch_counts["flash_prefill"] += 1
    b = body(q.dtype, Dh)
    runtime.prefill_body_counts[b] += 1
    if host_offset:
        runtime.count_unaligned(q_offset, {b: 1})
    return out
