"""Dispatch between the CUDA kernels and their plain versions.

A tensor on the CPU goes to the plain PyTorch version (``ref.py``); a
tensor on the card goes to the hand-written kernel, whose wrapper raises
on what it cannot take.  There is no switch and no fallback: the device
of the operands decides.  On the card a ``flash_prefill`` or ``wkv6``
call that autograd records (training) launches the same kernel inside a
``KernelFunction`` (``kernels/autograd.py``): ``flash_prefill``'s
backward is its plain version's, ``wkv6``'s is ``wkv6_bwd``, its
hand-written backward kernel.  On the CPU autograd runs through the
plain ``flash_prefill`` itself, and a recorded ``wkv6`` goes through the
same ``KernelFunction``, whose forward and ``wkv6_bwd`` are there the
plain versions (``ref.wkv6_ref``, ``ref.wkv6_bwd_ref``).

Each entry is a scope of ``kernels/cost.py``: outside a count
(``launch/op_analysis.py``) it runs as above and nothing else; under a
count it adds its kernel's formula (``cost.*_call``), or runs its plain
version op by op in an unfused count.
"""
from __future__ import annotations

import torch

from . import cost, decode_attn, flash_prefill as _prefill, paged_decode_attn
from . import ref, wkv6 as _wkv6
from .autograd import KernelFunction, needs_grad


def _like_wkv6_bwd(r, k, v, w, u, s0, dy, dsT=None):
    """The empty gradients (dr, dk, dv, dw, du, ds0) of ``wkv6_bwd``'s
    fake call."""
    return tuple(x.new_empty(x.shape) for x in (r, k, v, w, u, s0))


@cost.scope("wkv6_bwd", cost.wkv6_bwd_call, ref.wkv6_bwd_ref,
            _like_wkv6_bwd)
def wkv6_bwd(r, k, v, w, u, s0, dy, dsT=None):
    """The gradient (dr, dk, dv, dw, du, ds0) of ``wkv6`` for the
    incoming ``dy`` and ``dsT`` (None: zero), the backward of a recorded
    ``wkv6`` call."""
    if r.device.type == "cpu":
        return ref.wkv6_bwd_ref(r, k, v, w, u, s0, dy, dsT)
    return _wkv6.wkv6_bwd(r, k, v, w, u, s0, dy, dsT)


def _wkv6_forward(r, k, v, w, u, s0):
    """``wkv6``'s forward under autograd: the kernel on the card, the
    plain version on the CPU."""
    if r.device.type == "cpu":
        return ref.wkv6_ref(r, k, v, w, u, s0)
    return _wkv6.wkv6(r, k, v, w, u, s0)


# the kernels under autograd: flash_prefill (on the card) with its plain
# version's gradient, wkv6 with its backward entry
_PREFILL_GRAD = KernelFunction("flash_prefill", _prefill.flash_prefill,
                               ref.flash_prefill_ref)
_WKV6_GRAD = KernelFunction("wkv6", _wkv6_forward, backward=wkv6_bwd)


def _like_q(q, *args, **kwargs):
    """The empty output of an attention kernel's fake call."""
    return q.new_empty(q.shape)


def _like_wkv6(r, k, v, w, u, s0, *, state_out=None):
    """The empty outputs (y, sT) of ``wkv6``'s fake call."""
    return (r.new_empty(r.shape, dtype=torch.float32),
            s0.new_empty(s0.shape) if state_out is None else state_out)


# the fake calls under a count, recorded as the card's route records them
_PREFILL_FAKE = KernelFunction("flash_prefill", _like_q,
                               ref.flash_prefill_ref)
_WKV6_FAKE = KernelFunction("wkv6", _like_wkv6, backward=wkv6_bwd)


@cost.scope("flash_prefill", cost.prefill_call, ref.flash_prefill_ref,
            _PREFILL_FAKE)
def flash_prefill(q, k, v, lengths=None, *, causal: bool = True,
                  window: int = 0, q_offset=0):
    """GQA flash attention of (B,Tq,H,Dh) queries at positions
    ``q_offset + i`` (an int, or a 0-d int32 tensor on q's device) over
    (B,Tk,Hkv,Dh) keys."""
    if q.device.type == "cpu":
        return ref.flash_prefill_ref(q, k, v, lengths, causal=causal,
                                     window=window, q_offset=q_offset)
    if needs_grad(q, k, v):
        return _PREFILL_GRAD(q, k, v, lengths, causal=causal, window=window,
                             q_offset=q_offset)
    return _prefill.flash_prefill(q, k, v, lengths, causal=causal,
                                  window=window, q_offset=q_offset)


@cost.scope("flash_decode", cost.decode_call, ref.flash_decode_ref,
            _like_q)
def flash_decode(q, k_cache, v_cache, pos, *, ring: bool = False,
                 lse_out=None):
    """One-token decode attention over a contiguous cache; ``lse_out``
    (B, H) f32 takes each (row, head)'s log-sum-exp."""
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k_cache, v_cache, pos, ring=ring,
                                    lse_out=lse_out)
    return decode_attn.flash_decode(q, k_cache, v_cache, pos, ring=ring,
                                    lse_out=lse_out)


@cost.scope("paged_flash_decode", cost.paged_decode_call,
            ref.paged_flash_decode_ref, _like_q)
def paged_flash_decode(q, k_pool, v_pool, block_tables, pos, *, s_len: int,
                       ring: bool = False):
    """One-token decode attention over a paged pool."""
    if q.device.type == "cpu":
        return ref.paged_flash_decode_ref(q, k_pool, v_pool, block_tables,
                                          pos, s_len=s_len, ring=ring)
    return paged_decode_attn.paged_flash_decode(
        q, k_pool, v_pool, block_tables, pos, s_len=s_len, ring=ring)


@cost.scope("flash_decode_int8", cost.decode_int8_call,
            ref.flash_decode_int8_ref, _like_q)
def flash_decode_int8(q, k_codes, v_codes, k_scale, v_scale, pos, *,
                      ring: bool = False, lse_out=None):
    """One-token decode attention over a contiguous int8 cache (codes
    and per-(slot, kv head) f32 scales)."""
    if q.device.type == "cpu":
        return ref.flash_decode_int8_ref(q, k_codes, v_codes, k_scale,
                                         v_scale, pos, ring=ring,
                                         lse_out=lse_out)
    return decode_attn.flash_decode_int8(q, k_codes, v_codes, k_scale,
                                         v_scale, pos, ring=ring,
                                         lse_out=lse_out)


@cost.scope("paged_flash_decode_int8", cost.paged_decode_int8_call,
            ref.paged_flash_decode_int8_ref, _like_q)
def paged_flash_decode_int8(q, k_pool, v_pool, k_scale, v_scale,
                            block_tables, pos, *, s_len: int,
                            ring: bool = False):
    """One-token decode attention over a paged int8 pool."""
    if q.device.type == "cpu":
        return ref.paged_flash_decode_int8_ref(
            q, k_pool, v_pool, k_scale, v_scale, block_tables, pos,
            s_len=s_len, ring=ring)
    return paged_decode_attn.paged_flash_decode_int8(
        q, k_pool, v_pool, k_scale, v_scale, block_tables, pos,
        s_len=s_len, ring=ring)


@cost.scope("wkv6", cost.wkv6_call, ref.wkv6_ref, _WKV6_FAKE)
def wkv6(r, k, v, w, u, s0, *, state_out=None):
    """The RWKV6 recurrence of (B,T,H,hs) r/k/v/w from state s0.  A call
    that autograd records writes no ``state_out`` (it returns sT)."""
    if needs_grad(r, k, v, w, u, s0):
        if state_out is not None:
            raise ValueError("wkv6: state_out is written in place, which "
                             "autograd cannot record")
        return _WKV6_GRAD(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return ref.wkv6_ref(r, k, v, w, u, s0, state_out=state_out)
    return _wkv6.wkv6(r, k, v, w, u, s0, state_out=state_out)
