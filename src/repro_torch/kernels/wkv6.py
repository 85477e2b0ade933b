"""Wrappers of the hand-written CUDA RWKV6 recurrence (``csrc/wkv6.cu``)
and of its gradient (``csrc/wkv6_bwd.cu``), and the rule that splits the
forward's state over threads and blocks.

Replaces ``repro/kernels/wkv6.py:wkv6`` (Pallas TPU).  The plain PyTorch
version is ``kernels/ref.py:wkv6_ref``; the kernel's arithmetic order
(the hoisted bonus, row-group partials folded halves first) is
``ref.wkv6_tiled_ref``.  ``kernels/ops.py`` picks between the kernel and
``wkv6_ref`` by the tensors' device.  ``wkv6_bwd`` is the backward of a
``wkv6`` call that autograd records (``kernels/autograd.py``); its plain
version is ``ref.wkv6_bwd_ref``.

A thread of the kernel keeps a ``kr`` x ``vc`` register tile of one
(b, h)'s state; the ``hs / kr`` threads that share a column are adjacent
lanes of a warp; a block holds ``cols`` columns of one (b, h).  ``plan``
picks the tile from the shape alone, as the C launch does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import runtime

# csrc/wkv6.cu: kWkvTileT, kWkvStages, kWkvMaxThreads, kWkvPlanRows,
# kWkvPlanCols, kWkvMinCols, kWkvTargetBlocks
TILE_T = 16
STAGES = 3
MAX_THREADS = 256
PLAN_ROWS = 4
PLAN_COLS = 8
MIN_COLS = 16
# blocks the grid aims at, 2 an SM of the 132: at B = 8, H = 40, hs = 64
# one block of 128 threads a head (320 blocks) for a chunk, two blocks of
# 64 a head for a decode step; chip_smoke.py's tile sweep times the tiles
# around it
TARGET_BLOCKS = 264
# the (kr, vc) register tiles the C launch is built for
TILES = ((4, 8), (4, 2), (8, 8), (8, 4))
HEAD_SIZES = (16, 32, 64)
# csrc/wkv6_bwd.cu: kBwdChunk, the steps between the backward's state
# checkpoints (its workspace holds ceil(T / BWD_CHUNK) states a head)
BWD_CHUNK = 8


class WkvPlan(NamedTuple):
    kr: int         # state rows a thread
    vc: int         # state columns a thread
    cols: int       # state columns a block

    def threads(self, hs: int) -> int:
        return hs // self.kr * (self.cols // self.vc)

    def blocks(self, B: int, H: int, hs: int) -> int:
        return B * H * (hs // self.cols)


def valid(hs: int, p: WkvPlan, dtype: torch.dtype) -> bool:
    """Whether the C launch takes tile ``p`` (csrc/wkv6.cu:valid_tile):
    a built (kr, vc), ``cols`` dividing hs and a multiple of vc, 16-byte
    rows of v in a block, a column's threads inside one warp, and whole
    warps of at most ``MAX_THREADS`` threads a block."""
    esz = 2 if dtype == torch.bfloat16 else 4
    if hs not in HEAD_SIZES or (p.kr, p.vc) not in TILES:
        return False
    g = hs // p.kr
    if (p.kr > hs or g < p.vc or p.cols < 1 or hs % p.cols
            or p.cols % p.vc or p.cols * esz % 16):
        return False
    threads = p.threads(hs)
    return threads % 32 == 0 and threads <= MAX_THREADS


def plan(B: int, H: int, hs: int, T: int) -> WkvPlan:
    """The tile a call launches: ``PLAN_ROWS`` rows by ``PLAN_COLS``
    columns a thread (halved while a column's threads are fewer than
    the columns, or a head's threads fewer than a warp), and the widest
    block, from a whole head down to ``MIN_COLS`` columns and a warp,
    whose grid reaches ``TARGET_BLOCKS`` blocks (twice that for fewer
    steps than a tile: a decode step)."""
    if hs not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {hs} not supported by the "
                         f"kernel (16, 32 or 64)")
    if T < 0:
        raise ValueError(f"wkv6: T = {T}")
    kr = PLAN_ROWS
    g = hs // kr
    vc = PLAN_COLS
    while vc > 1 and (vc > g or g * hs // vc < 32):
        vc //= 2
    # a step shorter than a tile (decode) is bound by its state bytes:
    # twice the blocks keep more of them in flight
    target = TARGET_BLOCKS if T >= TILE_T else 2 * TARGET_BLOCKS
    cols = hs
    while (cols // 2 >= MIN_COLS and g * (cols // 2) // vc >= 32
           and B * H * (hs // cols) < target):
        cols //= 2
    return WkvPlan(kr, vc, cols)


def wkv6(r, k, v, w, u, s0, *, state_out=None):
    """r, k, v: (B,T,H,hs) f32 or bf16; w: (B,T,H,hs) f32 decay; u: (H,hs)
    f32; s0: (B,H,hs,hs) f32; all on the card.  Returns (y (B,T,H,hs) f32,
    sT (B,H,hs,hs) f32).  ``state_out`` receives sT when given; it may be
    ``s0`` itself (each thread reads its state elements before writing
    them)."""
    r, k, v, w, u = (x.contiguous() for x in (r, k, v, w, u))
    runtime.check_operands("wkv6", r, k, v, w, u, s0, dtype=r.dtype)
    _check_wkv6_operands("wkv6", r, k, v, w, u, s0)
    B, T, H, hs = r.shape
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


def _check_wkv6_operands(name, r, k, v, w, u, s0):
    """The shapes and dtypes ``wkv6`` and ``wkv6_bwd`` take (both on one
    card, contiguous: ``runtime.check_operands``)."""
    B, T, H, hs = r.shape
    if (k.shape != r.shape or v.shape != r.shape or w.shape != r.shape
            or k.dtype != r.dtype or v.dtype != r.dtype):
        raise ValueError(f"{name}: r/k/v/w shapes {tuple(r.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)} "
                         f"{tuple(w.shape)}, dtypes {r.dtype} {k.dtype} "
                         f"{v.dtype}")
    if (w.dtype != torch.float32 or u.dtype != torch.float32
            or s0.dtype != torch.float32 or u.shape != (H, hs)
            or s0.shape != (B, H, hs, hs)):
        raise ValueError(f"{name}: w {w.dtype}, u {tuple(u.shape)} "
                         f"{u.dtype}, s0 {tuple(s0.shape)} {s0.dtype}; w, u "
                         f"and s0 must be float32 of shapes (B,T,H,hs), "
                         f"(H,hs), (B,H,hs,hs)")


def wkv6_bwd(r, k, v, w, u, s0, dy, dsT=None):
    """The gradient of ``wkv6(r, k, v, w, u, s0)`` for the incoming ``dy``
    (B,T,H,hs) f32 (None: zero) and ``dsT`` (B,H,hs,hs) f32 (None: zero,
    as when training drops sT), on the card.  Returns (dr, dk, dv in r's
    dtype, dw (B,T,H,hs), du (H,hs), ds0 (B,H,hs,hs) f32).  Allocates the
    kernel's workspace: the state every ``BWD_CHUNK`` steps of each
    (b, h), and per-(b, h) partials of du."""
    r, k, v, w, u, s0 = (x.contiguous() for x in (r, k, v, w, u, s0))
    if dy is None:
        dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
    grads = [dy.contiguous()] + ([] if dsT is None else [dsT.contiguous()])
    runtime.check_operands("wkv6_bwd", r, k, v, w, u, s0, *grads,
                           dtype=r.dtype)
    _check_wkv6_operands("wkv6_bwd", r, k, v, w, u, s0)
    dy, dsT = grads[0], (grads[1] if len(grads) > 1 else None)
    B, T, H, hs = r.shape
    if (dy.shape, dy.dtype) != (r.shape, torch.float32) or (
            dsT is not None and (dsT.shape, dsT.dtype)
            != (s0.shape, torch.float32)):
        raise ValueError(f"wkv6_bwd: dy {tuple(dy.shape)} {dy.dtype}, dsT "
                         f"{None if dsT is None else tuple(dsT.shape)}; dy "
                         f"and dsT must be float32 of y's and sT's shapes")
    f32 = dict(dtype=torch.float32, device=r.device)
    ckpt = torch.empty(B * H * -(-T // BWD_CHUNK) * hs * hs, **f32)
    du_part = torch.empty(B * H * hs, **f32)
    dr, dk, dv = (torch.empty_like(x) for x in (r, k, v))
    dw = torch.empty(r.shape, **f32)
    du = torch.empty((H, hs), **f32)
    ds0 = torch.empty_like(s0)
    err = runtime.library().rt_wkv6_bwd(
        *(x.data_ptr() for x in (r, k, v, w, u, s0, dy)),
        None if dsT is None else dsT.data_ptr(),
        *(x.data_ptr() for x in (dr, dk, dv, dw, du, ds0, ckpt, du_part)),
        B, T, H, hs, runtime.DTYPE_CODES[r.dtype],
        runtime.stream_ptr(r.device))
    runtime.check(err, "wkv6_bwd", f"B={B}, T={T}, H={H}, hs={hs}")
    runtime.launch_counts["wkv6_bwd"] += 1
    return dr, dk, dv, dw, du, ds0
