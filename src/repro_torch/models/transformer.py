"""Model assembly: the full-sequence forward, prefill, chunked prefill
and decode over a contiguous or a paged cache, for every block type of
the reference.

PyTorch counterpart of ``repro/models/transformer.py``: ``BLOCK_ATTN``
(dense GQA decoders such as qwen3-14b, llama2-13b and nemotron-4-340b,
and the bidirectional encoder hubert-xlarge), ``BLOCK_MOE``
(qwen3-moe-235b-a22b, llama4-scout-17b-a16e: the same attention, a MoE
FFN run by ``moe_impl``), ``BLOCK_RWKV`` (rwkv6-3b), ``BLOCK_REC`` with
``BLOCK_ATTN`` (recurrentgemma-2b, whose attention layers are local:
ring caches of ``local_window`` slots) and ``BLOCK_CROSS`` with
``BLOCK_ATTN`` (llama-3.2-vision-90b: tanh-gated cross-attention over
the request's projected vision embeddings).  The reference stacks each
block group's parameters on a ``reps`` axis and runs ``lax.scan``; here
each block is an :class:`AttnBlock`, :class:`MoeBlock`,
:class:`CrossBlock`, :class:`RwkvBlock` or :class:`RecBlock` module in
``Transformer.groups[gi][j][rep]`` and a Python loop over reps replaces
the scan.  Caches keep the reference's pytree layout —
``{"pos", "block_tables", "groups"}`` with ``(reps, ...)`` leaves per
pattern slot: ``k``/``v`` for attention (and ``k_s``/``v_s``, the f32
scale planes of an int8 cache), ``k``/``v`` of the vision tokens for
cross-attention (always in the model's dtype, a per-slot leaf on the
paged pool too), ``s``/``x_tm``/``x_cm`` for RWKV, ``h``/``conv`` for
RG-LRU — so the engine's gather/scatter code ports line for line; they
are preallocated and updated in place.  Each block reads its own views
of its slot's leaves (``_slot``).

Under a mesh (``launch/mesh.py``; passed as ``mesh=`` or registered with
``sharding.context.set_mesh``) the model is explicit SPMD: each rank
holds the shard ``sharding.partition.shard_model`` cut for it, and the
entry points take the GLOBAL batch (the same inputs on every rank), run
this rank's rows (cut over ``data`` where ``sharding.rows`` says) and
return the global logits, as the reference's global arrays are; caches
are this rank's slice (its rows, and its kv heads or its sequence
slots: ``init_cache(mesh=...)``, ``partition.shard_cache``).
Every block type runs tensor-parallel over ``model`` with the
reference's specs (``layers.py``, ``attention.py``, ``rwkv.py``,
``rglru.py``; the encoder's non-causal attention and the VLM's cross
layers and ``vis_proj`` too); MoE experts cut over ``data`` run
``moe_impl="ep"``, or ``"local"`` through ``ep``'s dispatch at a
capacity that drops nothing (``moe.apply``), their d_ff cut over
``model`` through either path.  A recurrent block's carry is this
rank's cut of it (``partition.cache_rule``), in a cache and as the zero
carry of :func:`forward` alike.  A paged pool under a mesh is cut by
kv head over ``model`` where Hkv divides and whole otherwise
(``init_paged_cache(mesh=...)``), its pages never cut: one replica a
data rank, its ``pos`` and block tables whole on every rank, each rank
decoding its own slots and writing every slot's token; a prefill chunk
over a cache cut along the sequence attends over the whole prefix,
all-gathered.

Public API (functions of ``(cfg, model, ...)``):

    init_params(cfg, seed, dtype, device)   -> Transformer
    init_cache(cfg, batch, cache_len, ...)  -> zeroed cache pytree
    init_paged_cache(cfg, batch, cache_len, n_pages, page_size, ...)
    forward(cfg, model, tokens, embeds, vision_embeds, lengths, moe_impl,
            remat)          -> logits (B,T,V)   [encoder inference; training]
    prefill(cfg, model, tokens, lengths, cache_len, moe_impl, cache=None,
            embeds=None, vision_embeds=None) -> (last logits, cache)
    prefill_chunk(cfg, model, tokens, cache, start, lengths, moe_impl)
    decode_step(cfg, model, token, cache, page_size, paged_len, moe_impl)
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.sharding import context
from repro_torch.sharding.rows import gather_rows, local_rows

from . import attention, layers, moe, rglru, rwkv
from .layers import MLP, Params, frozen_param as _param
from .config import (BLOCK_ATTN, BLOCK_CROSS, BLOCK_MOE, BLOCK_REC,
                     BLOCK_RWKV, ModelConfig)

class Attention(Params):
    """Projections ``wq``, ``wk``, ``wv``, ``wo``, the qk-norm scales
    where the config has them, and a cross layer's 0-d ``gate`` (zero at
    init, as the reference's ``attn_init(cross=True)``)."""

    def __init__(self, cfg: ModelConfig, dtype, device, cross: bool = False):
        super().__init__()
        d = cfg.d_model
        e = dict(dtype=dtype, device=device)
        self.wq = _param(torch.empty(d, cfg.q_dim, **e))
        self.wk = _param(torch.empty(d, cfg.kv_dim, **e))
        self.wv = _param(torch.empty(d, cfg.kv_dim, **e))
        self.wo = _param(torch.empty(cfg.q_dim, d, **e))
        if cfg.qk_norm:
            self.q_norm = _param(torch.zeros(cfg.d_head, **e))
            self.k_norm = _param(torch.zeros(cfg.d_head, **e))
        if cross:
            self.gate = _param(torch.zeros((), **e))


class AttnBlock(nn.Module):
    """Pre-norm self-attention + MLP (``BLOCK_ATTN``).
    :class:`MoeBlock` keeps the attention and swaps the FFN
    (``_add_ffn``, ``_init_ffn``, ``_ffn``); :class:`CrossBlock` keeps the
    FFN and swaps the attention.

    Every block type's ``prefill`` with the cache views ``c`` None is
    its part of :func:`forward`: it writes no cache, and a recurrent
    block starts from a zero carry."""

    CROSS = False

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        e = dict(dtype=dtype, device=device)
        self.ln1 = _param(torch.zeros(cfg.d_model, **e))
        self.ln2 = _param(torch.zeros(cfg.d_model, **e))
        self.attn = Attention(cfg, dtype, device, cross=self.CROSS)
        self._add_ffn(cfg, dtype, device)

    def _add_ffn(self, cfg: ModelConfig, dtype, device) -> None:
        self.mlp = MLP(cfg, cfg.act, dtype, device)

    def _init_ffn(self, gen: torch.Generator) -> None:
        self.mlp.init_(gen)

    def _ffn(self, h, *, mesh=None, **_):
        return layers.mlp_apply(self.mlp, h, self.cfg.act, mesh)

    def _norm1(self, x):
        return layers.rms_norm(x, self.ln1, self.cfg.norm_eps)

    def _mlp_residual(self, x, **kw):
        h = layers.rms_norm(x, self.ln2, self.cfg.norm_eps)
        return x + self._ffn(h, **kw)

    def init_(self, gen: torch.Generator) -> None:
        for w in (self.attn.wq, self.attn.wk, self.attn.wv, self.attn.wo):
            w.copy_(layers.dense_init(gen, w.shape[0], w.shape[1], w.dtype))
        self._init_ffn(gen)

    # Each block type takes its cache views and the keyword context of
    # prefill / prefill_chunk / decode_step, and reads what it needs.
    @staticmethod
    def _kv(c):
        """The attention functions' cache tuple: (k, v), or (k, v, k_s,
        v_s) for an int8 cache."""
        return tuple(c[k] for k in _KV_KEYS if k in c)

    def prefill(self, x, c, *, positions, lengths, window: int,
                cache_len: int, mesh=None, seq_sharded: bool = False, **kw):
        a = attention.self_attn_forward(
            self.cfg, self.attn, self._norm1(x), positions, lengths,
            window=window, cache=None if c is None else self._kv(c),
            cache_len=cache_len, mesh=mesh, seq_sharded=seq_sharded)
        return self._mlp_residual(x + a, mesh=mesh, **kw)

    def chunk(self, x, c, *, start, active, mesh=None,
              seq_sharded: bool = False, **kw):
        a = attention.self_attn_chunk(self.cfg, self.attn, self._norm1(x),
                                      start, self._kv(c), active, mesh,
                                      seq_sharded)
        return self._mlp_residual(x + a, mesh=mesh, **kw)

    def decode(self, x, c, *, pos, window: int, block_tables=None,
               page_size: int = 0, paged_len: int = 0, mesh=None,
               seq_sharded: bool = False, **kw):
        h = self._norm1(x)
        kv = self._kv(c)
        if block_tables is not None:
            a = attention.self_attn_decode_paged(
                self.cfg, self.attn, h, pos, kv, block_tables,
                page_size=page_size, s_len=paged_len, window=window,
                mesh=mesh)
        else:
            a = attention.self_attn_decode(self.cfg, self.attn, h, pos, kv,
                                           window=window, mesh=mesh,
                                           seq_sharded=seq_sharded)
        return self._mlp_residual(x + a, mesh=mesh, **kw)


class MoeBlock(AttnBlock):
    """Pre-norm self-attention + MoE FFN (``BLOCK_MOE``): ``AttnBlock``'s
    attention, cache leaves and int8 tier on both pools; the FFN residual
    is ``moe.apply`` by ``moe_impl`` (the reference's ``_apply_block``
    and ``_apply_moe``)."""

    def _add_ffn(self, cfg: ModelConfig, dtype, device) -> None:
        self.moe = moe.Moe(cfg, dtype, device)

    def _init_ffn(self, gen: torch.Generator) -> None:
        self.moe.init_(gen)

    def _ffn(self, h, *, moe_impl: str = "local", mesh=None, **_):
        return moe.apply(self.cfg, self.moe, h, moe_impl, mesh)


class CrossBlock(AttnBlock):
    """Pre-norm tanh-gated cross-attention over the request's vision
    K/V + MLP (``BLOCK_CROSS``, the reference's ``_apply_block``).  Its
    cache views ``k``/``v`` (B, n_vision_tokens, Hkv, Dh) are written
    once, by ``prefill``, and read by every decode step.  A cross cache
    is not positional, so the config never prefills in chunks
    (``ModelConfig.chunkable_prefill``)."""

    CROSS = True

    def _vision_kv(self, vis, mesh):
        if vis is None:
            raise ValueError(f"{self.cfg.name}: a cross-attention block "
                             f"needs vision_embeds")
        return attention.cross_kv(self.cfg, self.attn, vis, mesh)

    def prefill(self, x, c, *, vis, mesh=None, **kw):
        kv = self._vision_kv(vis, mesh)
        if c is not None:
            c["k"].copy_(kv[0])
            c["v"].copy_(kv[1])
        a = attention.cross_attn_forward(self.cfg, self.attn,
                                         self._norm1(x), kv, mesh)
        return self._mlp_residual(x + a, mesh=mesh, **kw)

    def chunk(self, x, c, **_):
        raise ValueError(f"{self.cfg.name}: cross-attention prefills whole "
                         f"prompts only (chunkable_prefill is False)")

    def decode(self, x, c, *, mesh=None, **kw):
        a = attention.cross_attn_decode(self.cfg, self.attn, self._norm1(x),
                                        (c["k"], c["v"]), mesh)
        return self._mlp_residual(x + a, mesh=mesh, **kw)


def _zero_carry(btype: str, cfg: ModelConfig, x, mesh=None):
    """A recurrent block's zero carry for x's rows (``forward``): under a
    mesh this rank's cut of it, as a cache holds it."""
    st = _STATE_INIT[btype](cfg, x.shape[0], x.dtype, x.device)
    if mesh is None:
        return st
    from repro_torch.sharding import partition
    return {k: partition.shard(v[None], partition.cache_rule(
        k, (1,) + tuple(v.shape), mesh, None), mesh)[0]
        for k, v in st.items()}


def _write_carry(c, new, active=None) -> None:
    """Write a recurrent block's new carry into its cache views, in
    place; with ``active``, rows not active keep theirs bit for bit."""
    for key, val in new.items():
        if active is not None:
            m = active.reshape((-1,) + (1,) * (val.ndim - 1))
            val = torch.where(m, val, c[key])
        c[key].copy_(val)


class RwkvBlock(nn.Module):
    """Pre-norm RWKV6 time-mix + channel-mix (``BLOCK_RWKV``).  Its cache
    views are the carry ``s`` (B,H,hs,hs) f32 and the token-shift inputs
    ``x_tm``, ``x_cm`` (B,d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        e = dict(dtype=dtype, device=device)
        self.ln1 = _param(torch.zeros(cfg.d_model, **e))
        self.ln2 = _param(torch.zeros(cfg.d_model, **e))
        self.rwkv = rwkv.RwkvParams(cfg, dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        self.rwkv.init_(gen)

    def _forward(self, x, c, lengths, state_out, mesh):
        """Returns (x, {s, x_tm, x_cm}); sT lands in ``state_out`` when
        given."""
        eps = self.cfg.norm_eps
        tm, x_tm, s = rwkv.time_mix(self.cfg, self.rwkv,
                                    layers.rms_norm(x, self.ln1, eps),
                                    c["x_tm"], c["s"], lengths,
                                    state_out=state_out, mesh=mesh)
        x = x + tm
        cm, x_cm = rwkv.channel_mix(self.cfg, self.rwkv,
                                    layers.rms_norm(x, self.ln2, eps),
                                    c["x_cm"], lengths, mesh)
        return x + cm, {"s": s, "x_tm": x_tm, "x_cm": x_cm}

    def _carry(self, x, c, lengths, mesh):
        """Run the block and write its carry in place (the kernel writes
        sT over s0)."""
        x, new = self._forward(x, c, lengths, c["s"], mesh)
        c["x_tm"].copy_(new["x_tm"])
        c["x_cm"].copy_(new["x_cm"])
        return x

    def prefill(self, x, c, *, lengths, mesh=None, **_):
        if c is None:
            return self._forward(
                x, _zero_carry(BLOCK_RWKV, self.cfg, x, mesh), lengths,
                None, mesh)[0]
        return self._carry(x, c, lengths, mesh)

    def chunk(self, x, c, *, lengths, active, mesh=None, **_):
        """``lengths`` are the rows' valid tokens in this chunk; rows
        whose prompt ended in an earlier chunk (not ``active``) keep
        every carry leaf bit for bit."""
        x, new = self._forward(x, c, lengths, None, mesh)
        _write_carry(c, new, active)
        return x

    def decode(self, x, c, *, mesh=None, **_):
        return self._carry(x, c, None, mesh)


class RecBlock(nn.Module):
    """Pre-norm RG-LRU recurrent branch + gated GeLU MLP (``BLOCK_REC``).
    Its cache views are the carry ``h`` (B,w) f32 and the conv state
    ``conv`` (B,cw-1,w)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        e = dict(dtype=dtype, device=device)
        self.ln1 = _param(torch.zeros(cfg.d_model, **e))
        self.ln2 = _param(torch.zeros(cfg.d_model, **e))
        self.rec = rglru.RecParams(cfg, dtype, device)
        self.mlp = MLP(cfg, "gelu", dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        self.rec.init_(gen)
        self.mlp.init_(gen)

    def _mlp_residual(self, x, mesh):
        h = layers.rms_norm(x, self.ln2, self.cfg.norm_eps)
        return x + layers.mlp_apply(self.mlp, h, "gelu", mesh)

    def _forward(self, x, c, lengths, mesh):
        r, new = rglru.rec_block_forward(
            self.cfg, self.rec, layers.rms_norm(x, self.ln1,
                                                self.cfg.norm_eps),
            c, lengths, mesh)
        return self._mlp_residual(x + r, mesh), new

    def prefill(self, x, c, *, lengths, mesh=None, **_):
        if c is None:
            return self._forward(
                x, _zero_carry(BLOCK_REC, self.cfg, x, mesh), lengths,
                mesh)[0]
        x, new = self._forward(x, c, lengths, mesh)
        _write_carry(c, new)
        return x

    def chunk(self, x, c, *, lengths, active, mesh=None, **_):
        """As ``RwkvBlock.chunk``: rows not ``active`` keep their carry."""
        x, new = self._forward(x, c, lengths, mesh)
        _write_carry(c, new, active)
        return x

    def decode(self, x, c, *, mesh=None, **_):
        r, _ = rglru.rec_block_decode(
            self.cfg, self.rec, layers.rms_norm(x, self.ln1,
                                                self.cfg.norm_eps), c, mesh)
        return self._mlp_residual(x + r, mesh)


_BLOCKS = {BLOCK_ATTN: AttnBlock, BLOCK_MOE: MoeBlock,
           BLOCK_CROSS: CrossBlock, BLOCK_RWKV: RwkvBlock,
           BLOCK_REC: RecBlock}


class Transformer(Params):
    """Embedding, block groups and head, and a VLM's vision projector
    ``vis_proj`` (d_vision, d_model).  ``groups[gi][j][rep]`` is the
    block at pattern slot ``j`` of repetition ``rep`` in group ``gi`` —
    the reference's stacked ``params["groups"][gi][j]`` unstacked."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        e = dict(dtype=dtype, device=device)
        self.embed = _param(torch.empty(cfg.vocab_size, cfg.d_model, **e))
        self.ln_f = _param(torch.zeros(cfg.d_model, **e))
        if not cfg.tie_embeddings:
            self.unembed = _param(torch.empty(cfg.vocab_size, cfg.d_model,
                                              **e))
        if cfg.arch_type == "vlm":
            self.vis_proj = _param(torch.empty(cfg.d_vision, cfg.d_model,
                                               **e))
        self.groups = nn.ModuleList(
            nn.ModuleList(nn.ModuleList(_BLOCKS[btype](cfg, dtype, device)
                                        for _ in range(reps))
                          for btype in pattern)
            for pattern, reps in cfg.block_groups())

    @property
    def head(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.unembed

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def blocks(self):
        """(gi, j, rep, block) in execution order."""
        for gi, group in enumerate(self.groups):
            for rep in range(len(group[0])):
                for j, slot in enumerate(group):
                    yield gi, j, rep, slot[rep]


# ----------------------------------------------------------------- init ---
@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> Transformer:
    """Random weights from a seeded ``torch.Generator`` on ``device``,
    with the reference's shapes, scales and constants (``dense_init`` /
    ``embed_init``: normal times ``fan_in ** -0.5``; norms zero; the
    RWKV leaves as ``rwkv_init``, its decay path and bonus in f32; the
    RG-LRU leaves as ``rglru_init``, its gates and ``lam`` in f32; the
    MoE leaves as ``moe_init``, its router in f32, drawn expert by
    expert; a VLM's ``vis_proj`` as ``dense_init`` and its cross gates
    zero, so that a cross layer adds nothing until a gate is set).  The
    numbers differ from the reference's ``jax.random`` ones; parity tests
    convert the reference's weights through ``bridge.py``."""
    model = Transformer(cfg, dtype, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    model.embed.copy_(layers.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype))
    if not cfg.tie_embeddings:
        model.unembed.copy_(layers.embed_init(gen, cfg.vocab_size,
                                              cfg.d_model, dtype))
    if cfg.arch_type == "vlm":
        model.vis_proj.copy_(layers.dense_init(gen, cfg.d_vision,
                                               cfg.d_model, dtype))
    for _, _, _, blk in model.blocks():
        blk.init_(gen)
    return model


# ---------------------------------------------------------------- cache ---
_KV_KEYS = ("k", "v", "k_s", "v_s")
_KV_BLOCKS = (BLOCK_ATTN, BLOCK_MOE)        # blocks with self-attention K/V


def _kv_slot(leading, cfg: ModelConfig, dtype, device):
    """Zeroed K/V leaves ``leading + (Hkv, Dh)`` in ``dtype``; for an int8
    cache int8 codes and f32 scale planes ``leading + (Hkv,)``, as the
    reference's ``init_cache`` makes them."""
    shape = tuple(leading) + (cfg.n_kv_heads, cfg.d_head)
    if cfg.kv_cache_dtype != "int8":
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    codes = dict(dtype=torch.int8, device=device)
    scales = dict(dtype=torch.float32, device=device)
    return {"k": torch.zeros(shape, **codes),
            "v": torch.zeros(shape, **codes),
            "k_s": torch.zeros(shape[:-1], **scales),
            "v_s": torch.zeros(shape[:-1], **scales)}


_STATE_INIT = {BLOCK_RWKV: rwkv.init_state, BLOCK_REC: rglru.init_state}


def _state_slot(btype: str, reps: int, batch: int, cfg: ModelConfig, dtype,
                device):
    """A per-slot leaf with a leading ``reps`` axis: a recurrent carry
    (RWKV's or RG-LRU's, its f32 leaves f32), or the vision K/V of a
    cross layer ``(reps, batch, n_vision_tokens, Hkv, Dh)`` in ``dtype``
    (never int8, as the reference keeps them)."""
    if btype == BLOCK_CROSS:
        shape = (reps, batch, cfg.n_vision_tokens, cfg.n_kv_heads,
                 cfg.d_head)
        return {k: torch.zeros(shape, dtype=dtype, device=device)
                for k in ("k", "v")}
    st = _STATE_INIT[btype](cfg, batch, dtype, device)
    return {k: v.new_zeros((reps,) + v.shape) for k, v in st.items()}


def _local_zeros(whole, specs, mesh, device):
    """Zeroed leaves of this rank's slice of the ``meta`` tree ``whole``
    by ``specs``."""
    from repro_torch.sharding import partition
    dev = resolve_device(device)
    return partition.map_leaves(
        lambda t, spec: torch.zeros(partition.local_shape(t.shape, spec,
                                                          mesh),
                                    dtype=t.dtype, device=dev), whole, specs)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.float32, device="cuda", mesh=None, *,
               rows_cut: bool = True, seq_cut: bool = True):
    """Zeroed contiguous cache on ``device``; attention caches sized
    ``cfg.attn_cache_len(cache_len)`` (window-capped).  Under ``mesh``,
    this rank's slice of the cache of ``batch`` rows
    (``sharding.partition.cache_specs``, which ``rows_cut`` and
    ``seq_cut`` pass to), marked ``seq_sharded`` when its attention
    leaves are cut along the sequence."""
    if mesh is not None:
        from repro_torch.sharding import partition
        whole = init_cache(cfg, batch, cache_len, dtype, "meta")
        specs = partition.cache_specs(cfg, whole, mesh, batch,
                                      rows_cut=rows_cut, seq_cut=seq_cut)
        cache = _local_zeros(whole, specs, mesh, device)
        cache["seq_sharded"] = partition.cache_is_seq_sharded(specs)
        return cache
    device = resolve_device(device)
    S = cfg.attn_cache_len(cache_len)
    groups = tuple(
        tuple(_kv_slot((reps, batch, S), cfg, dtype, device)
              if btype in _KV_BLOCKS else
              _state_slot(btype, reps, batch, cfg, dtype, device)
              for btype in pattern)
        for pattern, reps in cfg.block_groups())
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "groups": groups}


def init_paged_cache(cfg: ModelConfig, batch: int, cache_len: int,
                     n_pages: int, page_size: int, dtype=torch.float32,
                     device="cuda", mesh=None):
    """Paged decode-pool cache: K/V live in a shared page pool
    ``(reps, n_pages, page_size, Hkv, Dh)`` per pattern slot (an int8
    pool adds its scale planes ``(reps, n_pages, page_size, Hkv)``), indexed
    through ``block_tables`` (batch, ceil(attn_cache_len / page_size));
    the caller owns the table contents.  A recurrent carry and a cross
    layer's vision K/V stay per-slot tensors, as in ``init_cache``.
    Under ``mesh``, this rank's slice (``partition.paged_cache_specs``:
    the pool by kv head over ``model`` where Hkv divides, else whole)."""
    if mesh is not None:
        from repro_torch.sharding import partition
        whole = init_paged_cache(cfg, batch, cache_len, n_pages, page_size,
                                 dtype, "meta")
        specs = partition.paged_cache_specs(cfg, whole, mesh, batch)
        return _local_zeros(whole, specs, mesh, device)
    device = resolve_device(device)
    S = cfg.attn_cache_len(cache_len)
    n_p = -(-S // page_size)
    groups = tuple(
        tuple(_kv_slot((reps, n_pages, page_size), cfg, dtype, device)
              if btype in _KV_BLOCKS else
              _state_slot(btype, reps, batch, cfg, dtype, device)
              for btype in pattern)
        for pattern, reps in cfg.block_groups())
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "block_tables": torch.zeros((batch, n_p), dtype=torch.int32,
                                        device=device),
            "groups": groups}


def effective_window(cfg: ModelConfig) -> int:
    if cfg.sliding_window:
        return cfg.sliding_window
    if cfg.arch_type == "hybrid":
        return cfg.local_window
    return 0


def supports_paged_decode(cfg: ModelConfig) -> bool:
    return cfg.has_decode and any(
        b in _KV_BLOCKS for pat, _ in cfg.block_groups() for b in pat)


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    return cfg.chunkable_prefill


def _slot(cache, gi: int, j: int, rep: int):
    """Views of one block's cache leaves (written in place)."""
    return {k: leaf[rep] for k, leaf in cache["groups"][gi][j].items()}


# -------------------------------------------------------------- drivers ---
def _embed_input(model: Transformer, tokens, embeds, mesh=None):
    """(B,T,d) inputs: ``embeds`` as given (an encoder's frame
    embeddings), else the embedding rows of ``tokens``."""
    if embeds is not None:
        return embeds
    return layers.embed_apply(model.embed, tokens, mesh)


def resolve_mesh(cfg: ModelConfig, model: Transformer, mesh=None):
    """The mesh an entry point runs under: ``mesh``, else the context's
    (``sharding.context.get_mesh``), else None.  The model must have been
    cut for it (``partition.shard_model``), and a sharded model needs
    its mesh."""
    mesh = mesh if mesh is not None else context.get_mesh()
    cut = getattr(model, "mesh_shape", None)
    if mesh is None:
        if cut is not None:
            raise ValueError(f"the model is sharded for mesh {cut}: run it "
                             f"under that mesh")
        return None
    if cut != mesh.shape:
        raise ValueError(f"the model is not sharded for mesh {mesh.shape}: "
                         f"call sharding.partition.shard_model first")
    return mesh


def _rows(mesh, B: int, *xs):
    """This rank's rows of each global batch tensor (None passes)."""
    if mesh is None:
        return xs
    return tuple(local_rows(x, mesh, B) for x in xs)


def _global_rows(mesh, B: int, x):
    return x if mesh is None else gather_rows(x, mesh, B)


def _project_vision(model: Transformer, vision_embeds, mesh=None):
    """(B, n_vision_tokens, d_vision) -> (B, n_vision_tokens, d_model):
    whole on every rank (all-gathered where ``vis_proj``'s columns are
    cut over ``model``), since the cross layers' projections read it
    whole."""
    if vision_embeds is None:
        return None
    return layers.whole(layers.column(vision_embeds, model.vis_proj, mesh),
                        model.vis_proj, mesh)


def forward(cfg: ModelConfig, model: Transformer, tokens=None, embeds=None,
            vision_embeds=None, lengths=None, moe_impl: str = "local",
            remat: bool = False, mesh=None, local_batch: bool = False):
    """Full-sequence forward with no cache (encoder inference; the
    training forward): logits (B,T,V) in f32.

    tokens: (B,T) int, or ``embeds`` (B,T,d) in the model's dtype (an
    encoder's frames); ``vision_embeds`` (B, n_vision_tokens, d_vision)
    for a VLM; lengths: (B,) valid tokens (keys past a row's length are
    masked; its query rows past it are garbage, as in the reference).
    Positions are ``arange(T)``; recurrent blocks start from a zero carry
    and keep nothing; window configs attend through their window.

    Unlike the serving entry points this one records a graph when a
    parameter requires a gradient (the trainer's ``requires_grad_``); a
    frozen model (``init_params``' default) records none.  ``remat``
    wraps each repetition of a block group's pattern in
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint(body,
    nothing_saveable)`` per scan body): the backward recomputes it from
    its input, so the kernels of its forward launch again there.

    Under a mesh the inputs and logits are the global batch, unless
    ``local_batch`` (the trainer's): the inputs are then this rank's rows
    and so are the logits."""
    mesh = resolve_mesh(cfg, model, mesh)
    B = (tokens if tokens is not None else embeds).shape[0]
    if not local_batch:
        tokens, embeds, vision_embeds, lengths = _rows(
            mesh, B, tokens, embeds, vision_embeds, lengths)
    x = _embed_input(model, tokens, embeds, mesh)
    T = x.shape[1]
    vis = _project_vision(model, vision_embeds, mesh)
    positions = torch.arange(T, device=x.device)
    kw = dict(positions=positions, lengths=lengths,
              window=effective_window(cfg), cache_len=0, vis=vis,
              moe_impl=moe_impl, mesh=mesh)
    for group in model.groups:
        for rep in range(len(group[0])):
            blocks = [slot[rep] for slot in group]

            def body(x, blocks=blocks):
                for blk in blocks:
                    x = blk.prefill(x, None, **kw)
                return x
            x = checkpoint(body, x, use_reentrant=False) if remat \
                else body(x)
    x = layers.rms_norm(x, model.ln_f, cfg.norm_eps)
    logits = layers.unembed_apply(model.head, x, mesh)
    return logits if local_batch else _global_rows(mesh, B, logits)


@torch.no_grad()
def prefill(cfg: ModelConfig, model: Transformer, tokens=None, lengths=None,
            cache_len: Optional[int] = None, moe_impl: str = "local",
            cache=None, *, embeds=None, vision_embeds=None, mesh=None):
    """Process full prompts; returns (last-token logits (B,V) f32, cache).

    tokens: (B,T) int, or ``embeds`` (B,T,d) (an encoder's frames);
    ``vision_embeds`` (B, n_vision_tokens, d_vision): a VLM's image,
    projected by ``vis_proj`` and written as each cross layer's K/V;
    lengths: (B,) prompt lengths (default T); moe_impl: the MoE blocks'
    path, ``"local"`` (grouped) or ``"ref"`` (the dense oracle).
    ``cache``: a cache of ``init_cache``'s layout for B rows and
    ``cache_len`` to write into, in place, its ``pos`` included: it must
    be zero where a fresh ``init_cache`` is (a CUDA graph of the prefill
    keeps its storage, ``core/engine.py:PrefillGraph``); by default a
    new one.  Under a mesh the inputs and logits are global and the
    cache is this rank's slice (``init_cache(mesh=...)``: its rows of
    the batch where an axis divides it, all of them where none does)."""
    mesh = resolve_mesh(cfg, model, mesh)
    B = (tokens if tokens is not None else embeds).shape[0]
    tokens, embeds, vision_embeds, lengths = _rows(
        mesh, B, tokens, embeds, vision_embeds, lengths)
    x = _embed_input(model, tokens, embeds, mesh)
    Bl, T, _ = x.shape
    vis = _project_vision(model, vision_embeds, mesh)
    if lengths is None:
        lengths = torch.full((Bl,), T, dtype=torch.int32, device=x.device)
    cache_len = cache_len or cfg.max_seq_len
    if cache is None:
        cache = init_cache(cfg, B, cache_len, x.dtype, x.device, mesh)
        # a copy: decode_step advances pos in place, never the caller's
        # lengths
        cache["pos"] = lengths.to(torch.int32, copy=True)
    else:
        cache["pos"].copy_(lengths)
    positions = torch.arange(T, device=x.device)
    win = effective_window(cfg)
    for gi, j, rep, blk in model.blocks():
        x = blk.prefill(x, _slot(cache, gi, j, rep), positions=positions,
                        lengths=lengths, window=win, cache_len=cache_len,
                        vis=vis, moe_impl=moe_impl, mesh=mesh,
                        seq_sharded=cache.get("seq_sharded", False))
    x = layers.rms_norm(x, model.ln_f, cfg.norm_eps)
    idx = (lengths.long() - 1).clamp(0, T - 1)
    last = x[torch.arange(Bl, device=x.device), idx]
    logits = layers.unembed_apply(model.head, last, mesh)
    return _global_rows(mesh, B, logits), cache


@torch.no_grad()
def prefill_chunk(cfg: ModelConfig, model: Transformer, tokens, cache,
                  start, lengths, moe_impl: str = "local", mesh=None):
    """One chunked-prefill step: prompt tokens at absolute positions
    [start, start+Tc) against ``cache`` (from ``init_cache``), written in
    place.  lengths: (B,) FULL prompt lengths.  ``start`` is an int or a
    0-d int32 tensor on the model's device, as the reference traces it:
    every use of it (the active rows, the rows' valid tokens, the K/V
    write, the positions, the kernel's query offset, the last-token
    index) is a device op, so one CUDA graph of the chunk serves every
    offset (``core/engine.py:PrefillGraph``); the caller checks a
    tensor's range.

    Returns (last_logits (B,V), cache); ``last_logits[b]`` is row b's
    next-token distribution only when its last prompt position lies in
    this chunk.  Rows already finished (length <= start) keep their
    cache bit for bit (K/V writes masked, recurrent carries frozen).  The
    caller sets ``cache['pos']`` to ``lengths`` after the final chunk.
    Under a mesh, as ``prefill``; over a cache cut along the sequence
    each rank writes the chunk's slots it holds and attends over the
    whole prefix, all-gathered over ``model``
    (``attention.self_attn_chunk``)."""
    mesh = resolve_mesh(cfg, model, mesh)
    B = tokens.shape[0]
    tokens, lengths = _rows(mesh, B, tokens, lengths)
    x = layers.embed_apply(model.embed, tokens, mesh)
    Bl, Tc, _ = x.shape
    lengths = lengths.to(x.device)
    active = lengths > start
    rel_len = (lengths - start).clamp(0, Tc)     # valid tokens per row
    seq = cache.get("seq_sharded", False)
    for gi, j, rep, blk in model.blocks():
        x = blk.chunk(x, _slot(cache, gi, j, rep), start=start,
                      active=active, lengths=rel_len, moe_impl=moe_impl,
                      mesh=mesh, seq_sharded=seq)
    x = layers.rms_norm(x, model.ln_f, cfg.norm_eps)
    idx = (lengths.long() - 1 - start).clamp(0, Tc - 1)
    last = x[torch.arange(Bl, device=x.device), idx]
    logits = layers.unembed_apply(model.head, last, mesh)
    return _global_rows(mesh, B, logits), cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: Transformer, token, cache,
                page_size: int = 0, paged_len: int = 0,
                moe_impl: str = "local", mesh=None):
    """token: (B,) int.  Returns (logits (B,V) f32, cache): the same
    dict, its K/V and carries written in place and ``pos`` advanced in
    place for every row (dead rows too, as in the reference).  Every
    tensor the step reads or writes keeps its storage, so the step can
    be captured once as a CUDA graph and replayed
    (``core/engine.py:DecodeGraph``).

    Caches from ``init_paged_cache`` (they carry ``block_tables``)
    decode against the page pool; ``page_size`` is then the pool's page
    size and ``paged_len`` the request-level cache length (default: the
    tables' full span).

    Under a mesh ``token`` and the logits are global and ``cache`` is
    this rank's slice (``init_cache(mesh=...)``, or
    ``init_paged_cache(mesh=...)``: a replica of the pool whose ``pos``
    and tables hold every row, ``attention.self_attn_decode_paged``)."""
    mesh = resolve_mesh(cfg, model, mesh)
    B = token.shape[0]
    bt = cache.get("block_tables")
    token, = _rows(mesh, B, token)
    x = layers.embed_apply(model.embed, token[:, None], mesh)
    pos = cache["pos"]
    if bt is not None:
        if page_size <= 0:
            raise ValueError("paged decode_step needs page_size")
        paged_len = paged_len or bt.shape[1] * page_size
    win = effective_window(cfg)
    seq = cache.get("seq_sharded", False)
    for gi, j, rep, blk in model.blocks():
        x = blk.decode(x, _slot(cache, gi, j, rep), pos=pos, window=win,
                       block_tables=bt, page_size=page_size,
                       paged_len=paged_len, moe_impl=moe_impl, mesh=mesh,
                       seq_sharded=seq)
    x = layers.rms_norm(x, model.ln_f, cfg.norm_eps)
    pos.add_(1)
    logits = layers.unembed_apply(model.head, x[:, 0], mesh)
    return _global_rows(mesh, B, logits), cache
