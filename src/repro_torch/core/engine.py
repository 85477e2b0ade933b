"""Real PyTorch execution backend — BucketServe policies driving the
model on one device (an H100, or the CPU in the tests).

Counterpart of ``repro/core/engine.py``: the same scheduler objects and
the same ``ServingLoop`` (``core/serving_loop.py``, copied from the
reference) drive real prefill and decode, token for token.  All
orchestration — arrivals, batch formation, OOM/slot re-queue, chunk
interleaving, timing — lives in the loop; this module only executes.

Models: the dense attention decoders (qwen3-14b, llama2-13b) and
rwkv6-3b.  For RWKV the per-slot cache leaves are the recurrent carry
(``s`` (reps, B, H, hs, hs) f32, ``x_tm`` and ``x_cm`` (reps, B, d)),
which prefill writes and slot insertion scatters exactly as it does K/V.

Continuous batching: the decode pool is a fixed-capacity slot pool — a
cache pytree with a leading slot axis and per-slot next-token ids.
Every iteration decodes all slots (dead slots compute garbage that is
masked); finished requests free their slot and prefilled requests are
scattered in with one batched index-put per cache leaf.  Unlike the
reference's functional ``.at[].set``, the pool is preallocated once and
every insert and decode step writes into it in place.

Paged decode pool (``paged=True``; an attention-free config raises
``ValueError``): self-attention K/V live in a shared page pool indexed
through per-slot block tables; a
:class:`~repro_torch.core.paging.BlockAllocator` hands out pages at
prefill insert, extends tables page by page as decode advances and
frees them on release.  Dead slots point at a dedicated trash page, so
their masked garbage writes never touch a live request's pages.

Chunked prefill: long prompts are split into ``chunk_tokens``-sized
spans and the loop interleaves decode iterations between spans.  The
batch's prefill cache is allocated on the device once per job.

Not in this slice (raise ``NotImplementedError``): the prefix cache,
session retention, the host spill tier and int8 KV caches.  The
reference engine's slice-boundary yield, fault injection and recovery,
trace recording and time scaling are not exposed either: the loop runs
with its defaults (no slicing, no faults, wall clock at scale 1) until a
slice holds those paths against the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from . import paging
from .batcher import FormedBatch
from .request import Request
from .serving_loop import (LoopConfig, PrefillJob, ServeResult, ServingLoop,
                           WallClock, plan_chunks)


class _BlockTableMirror:
    """Host mirror of the device block-table tensor.

    Tracks how many pages per rid are already uploaded and writes only
    the newly appended suffix, so a steady-state iteration where one
    request crosses a page boundary costs one cell write.  ``writes``
    counts int32 cells written.  (Copied from the reference.)"""

    def __init__(self, n_slots: int, pages_per_seq: int, trash: int):
        self.host = np.full((n_slots, pages_per_seq), trash, np.int32)
        self.trash = trash
        self.dirty = False
        self._uploaded: Dict[int, int] = {}     # rid -> pages uploaded
        self.writes = 0

    def insert(self, slot: int, rid: int, table: Sequence[int]) -> None:
        """A freshly prefilled request lands in ``slot``: full-row
        write (its pages are all new to the device tensor)."""
        self.host[slot] = self.trash
        self.host[slot, :len(table)] = table
        self.writes += self.host.shape[1]
        self._uploaded[rid] = len(table)
        self.dirty = True

    def clear(self, slot: int, rid: int) -> None:
        self.host[slot] = self.trash
        self._uploaded.pop(rid, None)
        self.writes += self.host.shape[1]
        self.dirty = True

    def forget(self, rid: int) -> None:
        self._uploaded.pop(rid, None)

    def sync(self, slot: int, rid: int, alloc) -> None:
        """Write only the pages appended since the last upload —
        O(growth), not O(table)."""
        n0 = self._uploaded.get(rid, 0)
        n1 = alloc.table_len(rid)
        if n1 > n0:
            self.host[slot, n0:n1] = alloc.table_tail(rid, n0)
            self.writes += n1 - n0
            self._uploaded[rid] = n1
            self.dirty = True


def _not_in_slice(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: it arrives with the next slice of the "
        f"port (prefix seeding and the spill copier)")


class TorchEngineBackend:
    """ExecutionBackend over eager PyTorch prefill/decode on one device."""

    prefill_needs_slots = True
    # armed by the ServingLoop when the scheduler is slack-aware
    slack_of = None

    def __init__(self, cfg: ModelConfig, model: tfm.Transformer, *,
                 max_slots: int = 8, cache_len: Optional[int] = None,
                 chunk_tokens: Optional[int] = None,
                 paged: bool = False, page_size: int = 128,
                 kv_pool_tokens: Optional[int] = None,
                 prefix_cache: bool = False,
                 session_ttl: Optional[float] = None,
                 host_pool_tokens: Optional[int] = None,
                 device="cuda"):
        if prefix_cache:
            raise _not_in_slice("prefix_cache")
        if session_ttl is not None:
            raise _not_in_slice("session_ttl")
        if host_pool_tokens:
            raise _not_in_slice("host_pool_tokens")
        tfm.check_supported(cfg)
        if model.device.type != resolve_device(device).type:
            raise ValueError(f"model lives on {model.device}, engine device "
                             f"is {device}")
        self.device = model.device
        self.dtype = model.dtype
        self.cfg = cfg
        self.model = model
        self.max_slots = max_slots
        self.cache_len = cache_len or cfg.max_seq_len
        self.chunk_tokens = chunk_tokens
        self.clock = WallClock()
        self.supports_decode = cfg.has_decode
        self.flops_per_token = 2.0 * cfg.active_param_count()
        self.paged = paged
        like_model = dict(dtype=self.dtype, device=self.device)

        if paged:
            if not tfm.supports_paged_decode(cfg):
                raise ValueError(f"{cfg.name}: paged KV needs "
                                 "self-attention decode")
            S = cfg.attn_cache_len(self.cache_len)
            self.page_size = page_size
            self.s_attn = S
            self.pages_per_seq = -(-S // page_size)
            total = kv_pool_tokens or max_slots * S
            n_pages = paging.device_pool_pages(cfg, total, page_size) - 1
            if kv_pool_tokens is not None and n_pages < self.pages_per_seq:
                raise ValueError(
                    f"kv_pool_tokens={kv_pool_tokens} too small: the "
                    f"paged pool needs at least "
                    f"{(self.pages_per_seq + 1) * page_size} tokens (one "
                    f"full request of {self.pages_per_seq} pages + the "
                    f"trash page)")
            n_pages = max(n_pages, self.pages_per_seq)
            self.alloc = paging.BlockAllocator(
                n_pages, page_size,
                page_bytes=page_size * max(cfg.cache_bytes_per_token(), 1))
            self.trash_page = n_pages            # pool index n_pages
            self.pool_cache = tfm.init_paged_cache(
                cfg, max_slots, self.cache_len, n_pages + 1, page_size,
                **like_model)
            self._bt = _BlockTableMirror(max_slots, self.pages_per_seq,
                                         self.trash_page)
            self.pool_cache["block_tables"].copy_(
                torch.from_numpy(self._bt.host))
        else:
            self.pool_cache = tfm.init_cache(cfg, max_slots, self.cache_len,
                                             **like_model)
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self._slot_of: Dict[int, int] = {}
        self.next_tok = torch.zeros((max_slots,), dtype=torch.int32,
                                    device=self.device)
        self.outputs: Dict[int, List[int]] = {}
        self._prefill_shapes: set = set()

    # ------------------------------------------------------- shapes -----
    def _note_shape(self, kind: str, length: int, bsz: int) -> None:
        """The reference compiles one executable per (pad_to, bsz) shape
        and counts them; eager PyTorch needs none, but the count is kept
        (serve.py prints it, the tests compare it)."""
        self._prefill_shapes.add((kind, length, bsz))

    @property
    def n_prefill_shapes(self) -> int:
        return len(self._prefill_shapes)

    # --------------------------------------------------------- protocol --
    def begin(self, requests: Sequence[Request]) -> None:
        for r in requests:
            r.materialize_tokens(self.cfg.vocab_size)
            self.outputs[r.rid] = []
        self.clock.start()

    def kv_budget_tokens(self) -> float:
        # slot caches are preallocated at cache_len: memory safety is
        # structural, the loop's admission control is slot-based
        return math.inf

    def free_slots(self) -> int:
        return sum(1 for r in self.slot_req if r is None)

    # ------------------------------------------------------ paged KV -----
    def _insert_tokens(self, r: Request) -> int:
        """Tokens a cache holds right after prefill: the prompt plus the
        first decode write (window-capped for ring caches)."""
        return min(r.prompt_len + 1, self.s_attn)

    def _decode_tokens(self, r: Request) -> int:
        return min(r.prompt_len + r.generated, self.s_attn)

    def free_blocks(self) -> int:
        return self.alloc.free_pages() if self.paged else 1 << 30

    def _prompt_tokens(self, r: Request):
        return r.tokens[:r.prompt_len]

    def admit_blocks(self, requests: Sequence[Request]) -> int:
        if not self.paged:
            return len(requests)
        return paging.admit_blocks(self.alloc, requests, self._insert_tokens,
                                   tokens_of=self._prompt_tokens)

    def decode_preempt(self, pool: Sequence[Request]) -> List[Request]:
        if not self.paged:
            return []
        victims = paging.extend_for_decode(self.alloc, pool,
                                           self._decode_tokens,
                                           slack_of=self.slack_of)
        for v in victims:
            slot = self._slot_of.pop(v.rid, None)
            if slot is not None:
                self.slot_req[slot] = None
                self._bt.clear(slot, v.rid)
            else:
                self._bt.forget(v.rid)
        for r in pool:                       # tables may have grown a page
            slot = self._slot_of.get(r.rid)
            if slot is not None:
                self._bt.sync(slot, r.rid, self.alloc)
        return victims

    def on_preempt_reset(self, req: Request) -> None:
        self.outputs[req.rid] = []       # regenerated after re-prefill

    def chunk_plan(self, batch: FormedBatch) -> List[Tuple[int, int]]:
        total = max(batch.pad_to, 8)     # min real-tensor prompt width
        c = self.chunk_tokens if tfm.supports_chunked_prefill(self.cfg) \
            else None
        return plan_chunks(total, c)

    def transfer_seconds(self, batch: FormedBatch) -> float:
        return 0.0            # prefill writes straight into the slot pool

    def prefill_chunk(self, job: PrefillJob, idx: int) -> float:
        reqs = job.batch.requests
        B = len(reqs)
        start, clen = job.chunks[idx]
        chunked = len(job.chunks) > 1 or job.chunks[0][0] > 0
        h = job.handle
        if h is None:
            total = job.chunks[-1][0] + job.chunks[-1][1]
            toks = np.zeros((B, total), np.int32)
            lens = np.zeros((B,), np.int32)
            for i, r in enumerate(reqs):
                L = min(r.prompt_len, total)
                toks[i, :L] = r.tokens[:L]
                lens[i] = L
            h = job.handle = {
                "toks": torch.from_numpy(toks).to(self.device),
                "lens": torch.from_numpy(lens).to(self.device),
                "np_lens": lens,
                # allocated on the device, once per job
                "cache": (tfm.init_cache(self.cfg, B, self.cache_len,
                                         self.dtype, self.device)
                          if chunked else None),
                "first": np.zeros((B,), np.int64),
            }
        if not chunked:
            self._note_shape("prefill", clen, B)
            logits, cache = tfm.prefill(self.cfg, self.model, h["toks"],
                                        h["lens"], cache_len=self.cache_len)
            h["first"][:] = torch.argmax(logits, -1).cpu().numpy()
            h["cache"] = cache
        else:
            self._note_shape("chunk", clen, B)
            logits, h["cache"] = tfm.prefill_chunk(
                self.cfg, self.model, h["toks"][:, start:start + clen],
                h["cache"], start, h["lens"])
            last = h["np_lens"] - 1
            fin = (last >= start) & (last < start + clen)
            if fin.any():
                h["first"][fin] = torch.argmax(logits, -1).cpu().numpy()[fin]
        if idx == len(job.chunks) - 1:
            if chunked:
                h["cache"]["pos"] = h["lens"].to(torch.int32)
            self._finish_prefill(job)
        return 0.0            # wall backend: the loop reads the clock

    def _finish_prefill(self, job: PrefillJob) -> None:
        """First tokens out; batched slot insertion for continuing rows."""
        h = job.handle
        slots, rows, firsts, tables = [], [], [], []
        free = iter(i for i, r in enumerate(self.slot_req) if r is None)
        for i, r in enumerate(job.batch.requests):
            tok = int(h["first"][i])
            self.outputs[r.rid].append(tok)
            if r.max_new_tokens <= 1 or not self.cfg.has_decode:
                if self.paged:
                    # done at first token: never scattered into the pool
                    self.alloc.release(r.rid)
                continue
            slot = next(free)
            self.slot_req[slot] = r
            self._slot_of[r.rid] = slot
            slots.append(slot)
            rows.append(i)
            firsts.append(tok)
            if self.paged:
                t = self.alloc.table(r.rid)      # reserved at admission
                self._bt.insert(slot, r.rid, t)
                tables.append(t)
        if slots:
            if self.paged:
                self._insert_slots_paged(h["cache"], slots, rows, firsts,
                                         tables)
            else:
                self._insert_slots(h["cache"], slots, rows, firsts)
        job.handle = None

    def _index(self, values: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int64),
                               device=self.device)

    def _insert_slots(self, batch_cache, slots: List[int], rows: List[int],
                      firsts: List[int]) -> None:
        """Scatter batch rows into pool slots, in place: one index-put
        per cache leaf (K/V, or the RWKV carry) for the whole batch."""
        sl, rw = self._index(slots), self._index(rows)
        self.pool_cache["pos"][sl] = batch_cache["pos"][rw]
        for gi, pattern_slots in enumerate(self.pool_cache["groups"]):
            for j, pool_slot in enumerate(pattern_slots):
                bc_slot = batch_cache["groups"][gi][j]
                for k, leaf in pool_slot.items():
                    leaf[:, sl] = bc_slot[k][:, rw]
        self.next_tok[sl] = torch.as_tensor(firsts, dtype=torch.int32,
                                            device=self.device)

    def _insert_slots_paged(self, batch_cache, slots: List[int],
                            rows: List[int], firsts: List[int],
                            tables: List[List[int]]) -> None:
        """Scatter prefilled caches into the page pool, in place: K/V rows
        are chopped into page-sized spans and written to each request's
        allocated pages (one index-put per leaf for the whole batch)."""
        sl, rw = self._index(slots), self._index(rows)
        self.pool_cache["pos"][sl] = batch_cache["pos"][rw]
        dst, srow, spg = [], [], []
        for row, t in zip(rows, tables):
            for j, pg in enumerate(t):
                dst.append(pg)
                srow.append(row)
                spg.append(j)
        dst, srow, spg = self._index(dst), self._index(srow), \
            self._index(spg)
        page, maxp = self.page_size, self.pages_per_seq

        for gi, pattern_slots in enumerate(self.pool_cache["groups"]):
            for j, pool_slot in enumerate(pattern_slots):
                bc_slot = batch_cache["groups"][gi][j]
                for k, pool_leaf in pool_slot.items():
                    bl = bc_slot[k]
                    pad = maxp * page - bl.shape[2]
                    if pad:
                        bl = torch.nn.functional.pad(
                            bl, (0, 0) * (bl.ndim - 3) + (0, pad))
                    bp = bl.reshape(bl.shape[:2] + (maxp, page)
                                    + bl.shape[3:])
                    pool_leaf[:, dst] = bp[:, srow, spg]
        self.pool_cache["block_tables"].copy_(torch.from_numpy(self._bt.host))
        self._bt.dirty = False
        self.next_tok[sl] = torch.as_tensor(firsts, dtype=torch.int32,
                                            device=self.device)

    def decode_iter(self, pool: Sequence[Request],
                    context_tokens: int) -> float:
        if self.paged and self._bt.dirty:
            # tables changed (extend/preempt/release): push the small host
            # mirror; steady-state iterations skip the transfer
            self.pool_cache["block_tables"].copy_(
                torch.from_numpy(self._bt.host))
            self._bt.dirty = False
        paged_kw = dict(page_size=self.page_size,
                        paged_len=self.s_attn) if self.paged else {}
        logits, self.pool_cache = tfm.decode_step(
            self.cfg, self.model, self.next_tok, self.pool_cache, **paged_kw)
        self.next_tok = torch.argmax(logits, -1).to(torch.int32)
        toks = self.next_tok.cpu().numpy()
        for slot, r in enumerate(self.slot_req):
            if r is not None:
                self.outputs[r.rid].append(int(toks[slot]))
        return 0.0

    def release(self, req: Request) -> None:
        slot = self._slot_of.pop(req.rid, None)
        if slot is not None:
            self.slot_req[slot] = None
        if self.paged:
            self.alloc.release(req.rid)
            if slot is not None:
                self._bt.clear(slot, req.rid)
            else:
                self._bt.forget(req.rid)

    def generated_tokens(self, req: Request) -> np.ndarray:
        return np.asarray(self.outputs.get(req.rid, ()), np.int32)


class ServingEngine:
    """Facade: schedule and serve a request set on the PyTorch backend.

    Thin wiring only — the run loop is ``ServingLoop`` in ``disagg``
    topology (prefill chunks interleave with slot decode).  ``device``
    defaults to ``"cuda"`` and raises when no card is present."""

    def __init__(self, cfg: ModelConfig, model: tfm.Transformer, scheduler,
                 *, max_slots: int = 8, cache_len: Optional[int] = None,
                 chunk_tokens: Optional[int] = None, paged: bool = False,
                 page_size: int = 128,
                 kv_pool_tokens: Optional[int] = None,
                 prefix_cache: bool = False,
                 session_ttl: Optional[float] = None,
                 host_pool_tokens: Optional[int] = None,
                 device="cuda"):
        self.cfg = cfg
        self.model = model
        self.sched = scheduler
        self.backend = TorchEngineBackend(
            cfg, model, max_slots=max_slots, cache_len=cache_len,
            chunk_tokens=chunk_tokens, paged=paged,
            page_size=page_size, kv_pool_tokens=kv_pool_tokens,
            prefix_cache=prefix_cache, session_ttl=session_ttl,
            host_pool_tokens=host_pool_tokens, device=device)
        self.loop = ServingLoop(scheduler, self.backend, LoopConfig(
            mode="disagg", decode_slot_cap=max_slots))
        self.result: Optional[ServeResult] = None
        self._pending: List[Request] = []

    @property
    def outputs(self) -> Dict[int, List[int]]:
        return self.backend.outputs

    @property
    def n_prefill_shapes(self) -> int:
        return self.backend.n_prefill_shapes

    @property
    def interleaved_decode_steps(self) -> int:
        return self.result.interleaved_decode_steps if self.result else 0

    def submit(self, requests: List[Request]) -> None:
        self._pending = list(requests)

    def run(self, max_wall_s: float = 600.0) -> List[Request]:
        self.result = self.loop.run(self._pending, time_limit=math.inf,
                                    max_wall_s=max_wall_s)
        return [r for r in self._pending
                if r.finished >= 0 and not r.dropped]
