"""The work of each hand-written kernel: its FLOPs and HBM bytes from
its shapes, one function a kernel, and the scope through which a count
of a whole step (``launch/op_analysis.py``) takes a kernel call.

The counterpart of the reference's ``vmem_fused:`` and ``grouped_mm:``
scopes, whose ops ``repro/launch/hlo_analysis.py`` counts as one fused
kernel.  Here the kernel's work is a formula:

* FLOPs: the multiply-adds of the products the inputs need (two FLOPs
  each; the softmax and an int8 code's dequantization are not counted):
  the (query, key) pairs the causal mask, the window and the key
  lengths leave, four FLOPs a pair a head a channel (``q.k`` and
  ``p.v``); the grouped product's ``2 M K N`` over its M rows; the
  RWKV6 recurrence's five a state element (``wkv6``) and its
  gradient's fourteen (``wkv6_bwd``).
* Bytes: each input read once and each output written once: the keys a
  row's queries reach,
  not the cache's whole span, and only the pages the tables name.

The functions of numbers (``prefill``, ``decode``, ``wkv6``,
``wkv6_bwd``, ``grouped_mm``, ``moe_ffn``) take what the data decides
(key lengths, live context, experts hit) where the caller knows it;
``chip_smoke.py`` prints each kernel's bound from them.  The ``*_call``
functions take a kernel entry's arguments and read shapes and host
scalars only, never a tensor's values: a fake tensor has none, and the
count of a step on real tensors must equal its count on fake ones.  The
live keys a row, which
sit in device tensors (``lengths``, ``pos``), come from the caller's
host state as ``context`` (``op_analysis.count(..., context=)``: an int
for every row or B ints, clamped to the span); without it a call's
live keys are its whole span (``Tk`` keys, ``s_len`` slots).  A query
offset held in a device tensor is taken as ``Tk - Tq``, the most keys
the chunk can reach.  ``wkv6_call``, ``wkv6_bwd_call`` and
``grouped_mm_call`` take ``context`` for the common signature and have
none to read.

``scope(name, formula, plain, like)`` wraps a kernel entry of
``kernels/ops.py`` (and ``models/moe.py:grouped_mm``).  Outside a count
it calls the entry and nothing else.  Under an active count
(``launch/op_analysis.py:OpCount``, found on the dispatch mode stack)
it asks the count what to do: add the formula and call the entry with
its ops unseen (real tensors: the kernel launches as outside a count),
add the formula and return ``like``'s output, an empty one of the
kernel's shape with the card's autograd route (fake tensors), or run the
plain version op by op (the unfused count, on fake or CPU tensors only).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

Lengths = Optional[Union[int, Sequence[int]]]


class Cost(NamedTuple):
    flops: float
    bytes: float


def _per_row(x: Lengths, B: int, default: int) -> np.ndarray:
    """(B,) int64: ``x`` an int for every row, a sequence of B ints, or
    None for ``default``."""
    if x is None:
        x = default
    a = np.asarray(x, dtype=np.int64)
    return np.broadcast_to(a, (B,)) if a.ndim == 0 else a


def attention_pairs(Tq: int, Tk: int, lengths: np.ndarray, *, causal: bool,
                    window: int, q_offset: int):
    """(pairs, keys) of each row: the (query, key) pairs the masks of
    ``ref.flash_prefill_ref`` leave (key ``j`` of a query at position
    ``p = q_offset + i``: ``j < length``, ``j <= p`` when causal,
    ``p - j < window`` when windowed), and the keys any query of the row
    reaches (a contiguous range)."""
    p = q_offset + np.arange(Tq, dtype=np.int64)[None]        # (1, Tq)
    L = np.minimum(lengths, Tk)[:, None]                     # (B, 1)
    hi = np.minimum(L, p + 1) if causal else np.broadcast_to(L, (len(L), Tq))
    lo = np.maximum(p - window + 1, 0) if window else np.zeros_like(p)
    n = np.maximum(hi - lo, 0)
    live = n > 0
    reach = np.where(live, hi, 0).max(axis=1) - np.where(
        live, lo, Tk).min(axis=1)
    return n.sum(axis=1), np.maximum(reach, 0)


def prefill(B: int, Tq: int, Tk: int, H: int, Hkv: int, Dh: int, esz: int,
            *, causal: bool = True, window: int = 0,
            q_offset: Optional[int] = 0, lengths: Lengths = None) -> Cost:
    """``flash_prefill`` of (B,Tq,H,Dh) queries over (B,Tk,Hkv,Dh) keys in
    ``esz``-byte elements: q read and the output written, K and V read
    over the keys each row's queries reach, the (B,) lengths read where
    given.  ``q_offset`` None: an offset the host does not know, taken
    as ``Tk - Tq``."""
    off = Tk - Tq if q_offset is None else q_offset
    pairs, keys = attention_pairs(Tq, Tk, _per_row(lengths, B, Tk),
                                  causal=causal, window=window, q_offset=off)
    return Cost(4.0 * H * Dh * float(pairs.sum()),
                esz * (2 * B * Tq * H * Dh + 2 * Hkv * Dh * int(keys.sum()))
                + (4 * B if lengths is not None else 0))


def decode(B: int, H: int, Hkv: int, Dh: int, esz: int, ctx: Lengths, *,
           int8: bool = False, page: int = 0, lse: bool = False) -> Cost:
    """A decode kernel over ``ctx`` live slots a row (an int for every
    row or B ints): K and V of those slots read (bf16/f32 in ``esz``
    bytes, or int8 codes and their f32 (slot, kv head) scales), q and
    ``pos`` read, the output (and the (B, H) f32 log-sum-exp with
    ``lse``) written; ``page`` > 0: the block-table entries of the live
    pages read.  The FLOPs are the products' (an int8 code's
    dequantization is elementwise, as the softmax, and not counted)."""
    c = _per_row(ctx, B, 0)
    slots = int(c.sum())
    kv = 2 * slots * Hkv * (Dh + 4 if int8 else esz * Dh)
    tables = 4 * int((-(-c // page)).sum()) if page else 0
    return Cost(4.0 * H * Dh * slots,
                kv + esz * 2 * B * H * Dh + 4 * B + tables
                + (4 * B * H if lse else 0))


def wkv6(B: int, T: int, H: int, hs: int, esz: int) -> Cost:
    """The RWKV6 recurrence over (B,T,H,hs): r, k, v read in ``esz``
    bytes, the f32 decay read and the f32 output written, u read, the
    f32 state read and written once.  Per (b, t, h) and state element:
    ``r.S`` (2 FLOPs), ``k v^T`` (1), ``w S + kv`` (2); the bonus term
    is rank 1, ``(sum_k r_k u_k k_k) v_t``, 5 FLOPs a channel."""
    elems = B * T * H * hs
    return Cost(5.0 * elems * (hs + 1),
                (3 * esz + 4 + 4) * elems + 4 * H * hs
                + 2 * 4 * B * H * hs * hs)


def wkv6_bwd(B: int, T: int, H: int, hs: int, esz: int, *,
             state_grad: bool = True) -> Cost:
    """The gradient of the RWKV6 recurrence over (B,T,H,hs)
    (``wkv6_bwd``).  Bytes: r, k, v read and dr, dk, dv written in
    ``esz`` bytes; the f32 decay and incoming dy read and dw written; u
    read and du written; the f32 s0 read, the incoming dsT read (with
    ``state_grad``) and ds0 written, once each.  FLOPs per (b, t, h) and
    state element: the state recomputed once, ``w S + k v`` (3); G's
    update ``w G + r dy^T`` (3); ``S dy``, ``G v``, ``G^T k`` and
    ``sum_j G S`` (2 each): 14.  The rank-1 terms, 16 a channel: ``v .
    dy`` (2) and ``r . (u k)`` (3) a step, ``u k (v . dy)`` into dr,
    ``u r (v . dy)`` into dk and ``r k (v . dy)`` into du (3 each), ``dy
    (r . (u k))`` into dv (2)."""
    elems = B * T * H * hs
    state = 4 * B * H * hs * hs
    return Cost(14.0 * elems * hs + 16.0 * elems,
                (6 * esz + 4 + 4 + 4) * elems + 2 * 4 * H * hs
                + (3 if state_grad else 2) * state)


def grouped_mm(M: int, K: int, N: int, E: int, esz: int,
               hit: Optional[int] = None) -> Cost:
    """The grouped product of M rows (K wide) by the (K, N) weights of
    their groups: ``2 M K N`` FLOPs; x read, the weights of the ``hit``
    groups that own rows (all E by default) read, the (M, N) output
    written, the (E,) int32 offsets read."""
    return Cost(2.0 * M * K * N,
                esz * (M * K + (E if hit is None else hit) * K * N + M * N)
                + 4 * E)


def moe_ffn(N: int, d: int, f: int, E: int, k: int, hit: int,
            d_ff_shared: int = 0) -> Cost:
    """One bf16 MoE layer (``models/moe.py:moe_local``) over N tokens, as
    the least work of the layer: the f32 router's product, the three
    grouped products of the N k pairs over the ``hit`` experts' weights
    (read once), and a shared expert's FFN; x read and the output
    written once, the sorted and gated intermediates not counted."""
    flops = (2.0 * N * d * E + 3 * 2.0 * N * k * d * f
             + 3 * 2.0 * N * d * d_ff_shared)
    return Cost(flops, hit * 3 * d * f * 2 + d * E * 4 + 2 * N * d * 2
                + 3 * d * d_ff_shared * 2)


# ------------------------------------------------- the kernel entries' calls
def _esz(t) -> int:
    return t.element_size()


def _host_offset(q_offset) -> Optional[int]:
    return None if torch.is_tensor(q_offset) else int(q_offset)


def _q3(q):
    return q.shape[0], q.shape[-2], q.shape[-1]


def _live(context: Lengths, span: int) -> Union[int, np.ndarray]:
    """The live slots a row: ``context`` clamped to the span, or the
    span."""
    return span if context is None else np.minimum(
        np.asarray(context, dtype=np.int64), span)


def prefill_call(q, k, v, lengths=None, *, causal: bool = True,
                 window: int = 0, q_offset=0, context: Lengths = None) -> Cost:
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    return prefill(B, Tq, Tk, H, k.shape[2], Dh, _esz(q),
                   causal=causal, window=window,
                   q_offset=_host_offset(q_offset),
                   lengths=None if lengths is None else _live(context, Tk))


def decode_call(q, k_cache, v_cache, pos, *, ring: bool = False,
                lse_out=None, context: Lengths = None) -> Cost:
    B, H, Dh = _q3(q)
    return decode(B, H, k_cache.shape[2], Dh, _esz(q),
                  _live(context, k_cache.shape[1]), lse=lse_out is not None)


def paged_decode_call(q, k_pool, v_pool, block_tables, pos, *, s_len: int,
                      ring: bool = False, context: Lengths = None) -> Cost:
    B, H, Dh = _q3(q)
    return decode(B, H, k_pool.shape[2], Dh, _esz(q),
                  _live(context, int(s_len)), page=k_pool.shape[1])


def decode_int8_call(q, k_codes, v_codes, k_scale, v_scale, pos, *,
                     ring: bool = False, lse_out=None,
                     context: Lengths = None) -> Cost:
    B, H, Dh = _q3(q)
    return decode(B, H, k_codes.shape[2], Dh, _esz(q),
                  _live(context, k_codes.shape[1]), int8=True,
                  lse=lse_out is not None)


def paged_decode_int8_call(q, k_pool, v_pool, k_scale, v_scale,
                           block_tables, pos, *, s_len: int,
                           ring: bool = False,
                           context: Lengths = None) -> Cost:
    B, H, Dh = _q3(q)
    return decode(B, H, k_pool.shape[2], Dh, _esz(q),
                  _live(context, int(s_len)), int8=True,
                  page=k_pool.shape[1])


def wkv6_call(r, k, v, w, u, s0, *, state_out=None,
              context: Lengths = None) -> Cost:
    B, T, H, hs = r.shape
    return wkv6(B, T, H, hs, _esz(r))


def wkv6_bwd_call(r, k, v, w, u, s0, dy, dsT=None, *,
                  context: Lengths = None) -> Cost:
    B, T, H, hs = r.shape
    return wkv6_bwd(B, T, H, hs, _esz(r), state_grad=dsT is not None)


def grouped_mm_call(x, w, offs, *, context: Lengths = None) -> Cost:
    return grouped_mm(x.shape[0], x.shape[1], w.shape[2], w.shape[0],
                      _esz(x))


# ------------------------------------------------------------- the scope
def active():
    """The innermost count on the dispatch mode stack (an object with
    ``kernel_call``), or None: outside a count every entry runs as
    without this module."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "kernel_call"):
            return mode
    return None


def scope(name: str, formula, plain, like, *, always: bool = False):
    """Wrap a kernel entry: under an active count, ``count.kernel_call``
    decides (module docstring); otherwise the entry itself runs.
    ``plain`` is the kernel's plain version with the entry's signature,
    ``like(*args, **kwargs)`` a fake call's output (empty, and recorded
    by autograd as the card's route records the entry).  ``always``: the
    formula counts in the unfused count too (the grouped product, as the
    reference's ``grouped_mm:`` scope)."""
    def wrap(entry):
        @functools.wraps(entry)
        def call(*args, **kwargs):
            count = active()
            if count is None:
                return entry(*args, **kwargs)
            return count.kernel_call(name, formula, entry, plain, like,
                                     args, kwargs, always=always)
        return call
    return wrap
