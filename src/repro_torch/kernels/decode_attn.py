"""Wrapper of the hand-written CUDA contiguous decode kernel
(``csrc/decode_attn.cu``), and the split rule and body rule that both
decode kernels share (``csrc/decode_common.cuh``).

Replaces ``repro/kernels/decode_attn.py:flash_decode`` (Pallas TPU).
The plain PyTorch version is ``kernels/ref.py:flash_decode_ref``; the
split-and-merge algebra of the kernel is ``ref.split_kv_decode_ref``.

``flash_decode_int8`` runs the same kernel over an int8 cache: int8
codes (B,S,Hkv,Dh) and one f32 scale per (slot, kv head) (B,S,Hkv), as
the reference's int8 KV variant stores them.  The block streams the
codes and scales and forms ``code * scale`` in f32, rounded to q's
dtype, which is ``dequantize_kv(codes, scale, q.dtype)``; the rest is the
body above, on the same plan.  The reference dequantizes in jnp under
the scope ``vmem_fused:flash_decode_int8`` (``repro/models/
attention.py:self_attn_decode``); its plain version is
``ref.flash_decode_int8_ref``.

Both take an optional ``lse_out`` (B, H) f32: the natural-log
log-sum-exp of each (row, head)'s scaled scores, which the kernel holds
anyway (in log2 units) when it writes the output.  The sequence-sharded
decode combines its shards' outputs with it
(``models/attention.py:distributed_decode_attention``).

The kernel is split-KV: block (i, kvh, b) streams slots ``[i L, (i+1)
L)`` of row b and the last live block of each (b, kvh) merges the
partials in split order, in the same launch.  ``plan`` picks ``L`` and
``n_split`` from the cache length and the grid alone (the live length
sits on the card); ``body`` names the body a call runs: bf16 on the
tensor cores (``mma.sync``), f32 on the CUDA cores.  Neither is a
fallback: a failed build or launch of either raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import runtime

# csrc/decode_common.cuh: kDecQuantum, kDecMaxSplit
SPLIT_QUANTUM = 128
MAX_SPLITS = 64
# blocks the grid aims at over the whole cache: at B = 8, Hkv = 8 and
# 4096 slots that is L = 512 and 8 splits, and at context 2048 the 256
# live blocks run as one wave at two blocks an SM (109 KB of shared memory
# a block); chip_smoke.py's split sweep times L a step either side
TARGET_BLOCKS = 512


class DecodePlan(NamedTuple):
    n_split: int
    L: int          # slots a split streams (a multiple of SPLIT_QUANTUM)
    body: str       # "tensor_core" or "cuda_core"


def body(dtype: torch.dtype, Dh: int) -> str:
    """The body of the decode kernels that takes a call, as their C
    dispatch (``rt_decode_body``) decides: bf16 at every head dim the
    kernels take (64, 80, 128, 192, 256, all multiples of the mma's 16)
    on the tensor cores, f32 on the CUDA cores."""
    return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"


def plan(B: int, Hkv: int, s_len: int, dtype: torch.dtype,
         Dh: int) -> DecodePlan:
    """The grid a decode call launches: the smallest power-of-two multiple
    ``L`` of ``SPLIT_QUANTUM`` that gives at most ``TARGET_BLOCKS`` blocks
    over ``s_len`` slots and at most ``MAX_SPLITS`` splits, and
    ``n_split = ceil(s_len / L)``."""
    if s_len <= 0:
        raise ValueError(f"decode: cache length {s_len}")
    want = -(-s_len * B * Hkv // TARGET_BLOCKS)
    L = SPLIT_QUANTUM
    while L < want or -(-s_len // L) > MAX_SPLITS:
        L *= 2
    return DecodePlan(-(-s_len // L), L, body(dtype, Dh))


def scratch(q: torch.Tensor, Hkv: int, s_len: int):
    """(plan, partials, arrival counters) of one call: the f32 partials
    ``(B, H, n_split, Dh + 2)`` when there is more than one split."""
    B, H, Dh = q.shape
    p = plan(B, Hkv, s_len, q.dtype, Dh)
    part = None
    if p.n_split > 1:
        part = torch.empty((B, H, p.n_split, Dh + 2), dtype=torch.float32,
                           device=q.device)
    return p, part, runtime.arrival_counters(q.device, B * Hkv)


def check_int8_kv(kernel: str, q, k_codes, v_codes, k_scale, v_scale,
                  shape) -> None:
    """int8 codes of ``shape`` (..., Hkv, Dh) and f32 scales of
    ``shape[:-1]``, contiguous, on q's card; the codes 16-byte aligned
    (``runtime.check_operands``)."""
    runtime.check_operands(kernel, q, k_codes, v_codes, dtype=q.dtype)
    if (tuple(k_codes.shape) != tuple(shape)
            or v_codes.shape != k_codes.shape
            or k_codes.dtype != torch.int8 or v_codes.dtype != torch.int8):
        raise ValueError(f"{kernel}: codes {tuple(k_codes.shape)} "
                         f"{k_codes.dtype} / {tuple(v_codes.shape)} "
                         f"{v_codes.dtype}, want int8 {tuple(shape)}")
    for s in (k_scale, v_scale):
        if (tuple(s.shape) != tuple(shape[:-1]) or s.dtype != torch.float32
                or s.device != q.device or not s.is_contiguous()):
            raise ValueError(f"{kernel}: scales {tuple(s.shape)} {s.dtype} "
                             f"on {s.device}, want contiguous float32 "
                             f"{tuple(shape[:-1])} on {q.device}")


def check_lse_out(kernel: str, lse_out, q) -> None:
    """``lse_out``: a contiguous (B, H) float32 tensor on q's card."""
    B, H = q.shape[:2]
    if (tuple(lse_out.shape) != (B, H) or lse_out.dtype != torch.float32
            or lse_out.device != q.device or not lse_out.is_contiguous()):
        raise ValueError(f"{kernel}: lse_out {tuple(lse_out.shape)} "
                         f"{lse_out.dtype} on {lse_out.device}, want "
                         f"contiguous float32 {(B, H)} on {q.device}")


def _lse(kernel: str, lse_out, q):
    """The lse pointer of a launch (None: not written)."""
    if lse_out is None:
        return None
    check_lse_out(kernel, lse_out, q)
    return lse_out.data_ptr()


def flash_decode(q, k_cache, v_cache, pos, *, ring: bool = False,
                 lse_out=None):
    """q: (B,H,Dh) or (B,1,H,Dh); caches: (B,S,Hkv,Dh) on the card;
    pos: (B,).  Returns q's shape.  ``lse_out`` (B, H) f32, when given,
    takes each (row, head)'s natural-log log-sum-exp of its scaled scores
    over the live slots (-inf for a row with none); the output is the
    same bits with or without it."""
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
    lse = _lse("flash_decode", lse_out, q)
    p, part, arrivals = scratch(q, Hkv, S)
    err = runtime.library().rt_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), lse, None if part is None else part.data_ptr(),
        arrivals.data_ptr(), B, S, H, Hkv, Dh, int(ring), p.L, p.n_split,
        runtime.DTYPE_CODES[q.dtype], runtime.stream_ptr(q.device))
    runtime.check(err, "flash_decode", f"Dh={Dh}, H={H}, Hkv={Hkv}")
    runtime.launch_counts["flash_decode"] += 1
    runtime.lse_counts["flash_decode"] += lse is not None
    runtime.decode_plans["flash_decode"] = p
    return out[:, None] if squeeze else out


def flash_decode_int8(q, k_codes, v_codes, k_scale, v_scale, pos, *,
                      ring: bool = False, lse_out=None):
    """q: (B,H,Dh) or (B,1,H,Dh), f32 or bf16; codes: (B,S,Hkv,Dh) int8
    and scales (B,S,Hkv) f32 on the card; pos: (B,).  Returns q's
    shape; ``lse_out`` as for ``flash_decode``."""
    squeeze = q.ndim == 4
    if squeeze:
        q = q[:, 0]
    q = q.contiguous()
    B, H, Dh = q.shape
    S, Hkv = k_codes.shape[1], k_codes.shape[2]
    check_int8_kv("flash_decode_int8", q, k_codes, v_codes, k_scale,
                  v_scale, (B, S, Hkv, Dh))
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = _lse("flash_decode_int8", lse_out, q)
    p, part, arrivals = scratch(q, Hkv, S)
    err = runtime.library().rt_flash_decode_int8(
        q.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), pos.data_ptr(),
        out.data_ptr(), lse, None if part is None else part.data_ptr(),
        arrivals.data_ptr(), B, S, H, Hkv, Dh, int(ring), p.L, p.n_split,
        runtime.DTYPE_CODES[q.dtype], runtime.stream_ptr(q.device))
    runtime.check(err, "flash_decode_int8", f"Dh={Dh}, H={H}, Hkv={Hkv}")
    runtime.launch_counts["flash_decode_int8"] += 1
    runtime.lse_counts["flash_decode_int8"] += lse is not None
    runtime.decode_plans["flash_decode_int8"] = p
    return out[:, None] if squeeze else out
