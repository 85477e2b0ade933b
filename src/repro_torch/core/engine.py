"""Real PyTorch execution backend — BucketServe policies driving the
model on one device (an H100, or the CPU in the tests).

Counterpart of ``repro/core/engine.py``: the same scheduler objects and
the same ``ServingLoop`` (``core/serving_loop.py``, copied from the
reference) drive real prefill and decode, token for token.  All
orchestration — arrivals, batch formation, OOM/slot re-queue, chunk
interleaving, timing — lives in the loop; this module only executes.

Models: the dense attention decoders (qwen3-14b, llama2-13b), the MoE
decoders (qwen3-moe-235b-a22b, llama4-scout-17b-a16e: their K/V pool as
a dense decoder's, their FFN the MoE by ``moe_impl``, the reference
engine's option, in prefill, the chunk and the captured decode step),
rwkv6-3b and recurrentgemma-2b.  For RWKV the per-slot cache leaves are the
recurrent carry (``s`` (reps, B, H, hs, hs) f32, ``x_tm`` and ``x_cm``
(reps, B, d)), which prefill writes and slot insertion scatters exactly
as it does K/V.  recurrentgemma mixes both kinds: its RG-LRU blocks keep
a per-slot carry (``h`` (reps, B, w) f32, ``conv`` (reps, B, cw-1, w)),
its local-attention blocks ring caches of ``local_window`` slots, which
page like any K/V; ring configs prefill whole prompts (no chunk plan).

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
engine holds one batch prefill cache for its life, ``prefill_rows``
rows (the scheduler's batch cap, given at construction; else the first
batch's, grown if a larger one comes), and a batch of B rows uses its
first B; each job zeroes its rows first, as a
fresh cache would be, so nothing of one job reaches the next.  Token
ids, lengths, the chunk's ``start`` (a 0-d int32 tensor) and the logits
live in fixed buffers beside it.

KV retention (``prefix_cache``, ``session_ttl``, ``host_pool_tokens``;
paged pool and a ``prefix_cacheable`` config only):
:class:`~repro_torch.core.retention.KvRetention` makes every decision —
radix hits on full prompt pages, a finished turn's transcript pinned
under its session key, TTL expiry, spill to host and restore.  The
engine only moves bytes: ``_seed_prefix`` copies each row's cached
prefix (a session's partial tail page included) from the pool into the
batch prefill cache, chunked prefill resumes at the batch's smallest
hit (``batch_prefix_skip``, an offset that need not be page- or
tile-aligned), the insert skips the shared pages, full prompt pages are
registered once their K/V is in the pool, and ``release`` hands the
transcript (prompt + generated[:-1]) to the retention layer.

Host spill tier: ``_EngineCopier`` copies a spilled page to host memory
and back.  A torch slice of the pool is a view, and the freed page can
be handed out and written before the copy to host runs, so the copier
clones the page on the device at spill time (the reference may keep
the slice because a JAX array never changes).

Slice-boundary preemption, faults, recovery and drain (the reference
engine's hooks, driven by the copied ``ServingLoop``): with
``slice_tokens`` a preempted, killed or drained decode keeps its
generated tokens up to the last multiple of ``slice_tokens``
(``on_slice_yield`` truncates the outputs there; ``begin`` re-seeds them
for a request resumed cold from a checkpoint); ``abort_prefill`` frees
an abandoned prefill job's pages and drops the job (its rows of the
batch cache are zeroed when the next job starts), and
``evict_request`` tears a pooled request down without registering its
K/V with the retention layer, its block-table row pointed at the trash
page before the next in-place decode step.  ``fault_plan``,
``recovery``, ``restore_timeout``, ``recorder``, ``tracer`` and
``time_scale`` are passed to the loop and its clock as the reference
engine passes them.

Compiled decode step (``decode_graph``): the reference ``jax.jit``s its
decode step once per engine.  Here :class:`DecodeGraph` captures one
step (``decode_step`` and the argmax into ``next_tok``) as a CUDA graph
at construction, over the engine's own pool, and ``decode_iter``
replays it.  The slot count, cache length, page size and pool are fixed
for the engine's life, and every step reads and writes the same
tensors in place (the pool's leaves, ``pos``, the block tables and
``next_tok``), so one capture serves every step.

Compiled prefill (``prefill_graph``): the reference ``jax.jit``s one
prefill executable per ``("prefill", pad_to, B)`` and one chunk
executable per ``("chunk", Tc, B)``, its chunk ``start`` traced.  Here
:class:`PrefillGraph` runs a shape key's first prefill eagerly, captures
a CUDA graph at its second and replays it for every later prefill of
that shape: the graph reads the fixed input buffers, writes the batch
cache's first B rows and the logits buffer, and takes the chunk offset
from the device, so one graph serves every offset.

int8 KV caches (``cfg.kv_cache_dtype == "int8"``): every pool, batch
cache and page carries four leaves a block, int8 ``k``/``v`` codes and
f32 ``k_s``/``v_s`` scale planes (one per token and kv head).  Slot
insertion, the page scatter, ``_seed_prefix``, the spill copier and the
decode graph treat them as they treat any leaf.  Pool sizing is in
bytes (``paging.device_pool_pages``), so the same ``kv_pool_tokens``
buys about twice the pages of a bf16 pool.

Under a mesh (``mesh``, ``launch/mesh.py``; the model cut for it by
``sharding.partition.shard_model``): a single controller.  Rank 0 runs
the loop, the scheduler, the allocator and the retention layer; every
method here that writes device memory is a host half, which decides,
and a device half ``_d_<op>`` of explicit arguments, which rank 0
broadcasts (``core/driver.py``) and every rank runs on its own shards
(``_run``).  Without a mesh ``_run`` calls the device half directly: the
one-device path is the same code.  A worker rank builds the backend with
the same arguments, holds no allocator and no retention layer, and runs
``driver.serve_worker`` (``ServingEngine.run`` does on a worker rank).
The contiguous pool is ``init_cache(mesh=...)``: slots cut over
``data`` (each data rank inserts only the rows whose slot it holds),
K/V by kv head over ``model``, or along the sequence when Hkv does not
divide and S >= 2048.  The paged pool is one pool replicated over
``data``: every data rank holds every page, cut by kv head over
``model`` where Hkv divides, whole where it does not, with ``pos`` and
the block tables whole.  So the one allocator, radix index and
retention layer on rank 0 decide for every replica, and admission,
preemption and hits are those of the pool without a mesh.  Every
writer keeps the replicas equal: the insertion writes every row's
pages on every rank, a decode step gathers its rows' K/V over the batch
axes and writes every row's token
(``attention.self_attn_decode_paged``), and a restore writes each
rank's own spilled copy of a page that was equal when it left.  A
prefill job's rows are cut over the batch axes where they divide its B
(each data rank prefills its share, ``_job_rows``; the model's entry
points cut the global token ids and lengths and gather the logits),
whole on every rank where they do not; the insertion gathers the job's
rows of the batch cache over the batch axes one leaf at a time.  A
batch axis of one rank gathers nothing (``sharding.rows.gather_rows``),
so a (1, M) mesh pays for none of these gathers.
``next_tok`` is the argmax of the gathered logits on every rank; only
rank 0 reads it.  The spill tier is a rank's: each rank spills its shard
of a page into its own host slot.  Every config the engine serves
without a mesh it serves under one: MoE experts cut over ``data`` run
``moe_impl="local"`` through ``moe_ep``'s dispatch at a capacity that
drops nothing (``moe.apply``), on a job's rows cut over ``data`` or
whole on every data rank alike; the recurrent blocks run
tensor-parallel over ``model``.  The decode graph and the prefill
graphs are refused under a mesh (both graphs default to off there).
``moe_impl="ep"`` is refused with or without a mesh, as the reference's
engine cannot serve it (its model calls pass no mesh, which its
``_apply_moe("ep")`` needs).
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import runtime
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import dequantize_kv_int4, quantize_kv_int4
from repro_torch.models.config import BLOCK_ATTN, BLOCK_MOE, ModelConfig
from repro_torch.sharding.rows import axes_index, batch_tuple, gather_rows
from . import driver, paging
from .batcher import FormedBatch
from .faults import FaultInjector
from .prefix_cache import PrefixCache
from .request import Request
from .retention import KvRetention, maintain_backend
from .serving_loop import (LoopConfig, PrefillJob, ServeResult, ServingLoop,
                           WallClock, batch_prefix_skip, plan_chunks)

SPILL_DTYPES = ("", "bf16", "int8", "int4")


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


class _EngineCopier:
    """Host<->device KV page mover: the data half of the spill tier (the
    retention layer makes every decision; this object moves bytes).

    ``spill`` clones the page's K/V leaves on the device, on the compute
    stream, so the clone holds the page as it was even if the freed page
    is handed out and written before ``poll`` — the reference keeps a
    slice instead, which is safe only because a JAX array never changes.
    ``poll``, called by the retention tick between device steps, copies
    the staged clones to host memory, then writes every pending restore
    back into its reserved pool page with one index-put a leaf on the
    compute stream, so it lands before the held request's
    ``_seed_prefix`` reads it.

    Under a mesh the copier is a rank's: ``spill``, ``poll`` and
    ``drop`` are host halves that send their device halves (``_spill``,
    ``_poll``, ``_drop``) to every rank, each copying its shard of the
    page to its own host slot; ``restore`` only queues, and ``poll``
    carries the queue.  A poll with nothing staged and nothing queued
    sends nothing (every rank stages the same spills).  The replicas of
    a page over ``data`` are equal when it is spilled, so each rank's
    restore of its own copy leaves them equal; the host tier is thus
    held once a data rank.

    Host leaves are allocated at the first spill of each leaf and left
    uninitialised (a host slot is read only after it was written).  Raw
    leaves are CPU tensors in the pool's dtype (bf16 included, which
    numpy lacks); ``spill_dtype`` "int8" or "int4" compresses the float
    K/V payload ("k"/"v") to numpy codes with per-(token, head) f32
    scales, and the restore dequantizes to the pool's dtype.  An int8
    pool's leaves pass an int8 tier raw, codes and scale planes
    (requantizing integer codes does not round-trip), so its restore is
    lossless; an int4 tier packs an int8 pool's codes and re-expands
    them to int8 codes on restore, as the reference does.

    Restores under faults.  A restore's copy is queued and written at
    the next ``poll``, and it lands before its page can change owner:
    ``restore`` is called only for a run the retention layer dispatched
    (a run that hard-fails past its retries, or is shed, is cancelled
    before any call, ``KvRetention._restore_path``), and a queued page
    is RESTORING: reserved by ``restore_begin``, on no block table and
    not on the free list.  It leaves that state only through
    ``restore_commit``, and ``KvRetention.tick`` commits landed restores
    just before it calls ``poll``, in the same call, before any
    admission can attach the page.  A stall only moves the modelled
    ready time (the bytes land early, while the page is still
    reserved); a timed-out hold (``cancel_hold``) and a drain leave the
    restore in flight, owned by the layer; a lost maintain tick skips
    the commit and the poll together; no eviction rung takes a
    restoring page or tail; and the teardowns that commit and free one
    run after the poll (the expiry pass of ``tick``) or outside a run
    (``clear``)."""

    _Q_KEYS = ("k", "v")                    # payload leaves; scales raw

    def __init__(self, backend: "TorchEngineBackend", host_pages: int,
                 spill_dtype: str = ""):
        self.be = backend
        self.host_pages = host_pages
        self.spill_dtype = spill_dtype
        self._host: Dict[tuple, object] = {}     # tensor, or numpy codes
        self._scales: Dict[tuple, np.ndarray] = {}  # compressed leaves only
        self._staged: Dict[int, list] = {}      # hslot -> [(leafkey, clone)]
        self._pending: List[Tuple[int, int]] = []   # (hslot, dest page)

    def _attn_leaves(self):
        for gi, (pattern, _) in enumerate(self.be.cfg.block_groups()):
            for j, btype in enumerate(pattern):
                if btype in (BLOCK_ATTN, BLOCK_MOE):
                    slot = self.be.pool_cache["groups"][gi][j]
                    for k, leaf in slot.items():
                        yield (gi, j, k), leaf

    def _host_leaf(self, lk: tuple, like):
        h = self._host.get(lk)
        if h is None:
            shape = (like.shape[0], self.host_pages) + tuple(like.shape[1:])
            h = (np.empty(shape, like.dtype) if isinstance(like, np.ndarray)
                 else torch.empty(shape, dtype=like.dtype))
            self._host[lk] = h
        return h

    def _scale_leaf(self, lk: tuple, like: np.ndarray) -> np.ndarray:
        s = self._scales.get(lk)
        if s is None:
            s = np.empty((like.shape[0], self.host_pages) + like.shape[1:],
                         np.float32)
            self._scales[lk] = s
        return s

    def _quantizes(self, lk: tuple, dtype: torch.dtype) -> bool:
        """Does this leaf compress on spill?  Fixed per leaf for the run;
        the restore keys off the same rule."""
        if self.spill_dtype in ("", "bf16") or lk[2] not in self._Q_KEYS:
            return False
        if self.spill_dtype == "int8" and dtype == torch.int8:
            return False                    # int8 pool: lossless pass-through
        return True

    def _materialize(self, hslot: int, lk: tuple, page) -> None:
        if not self._quantizes(lk, page.dtype):
            self._host_leaf(lk, page)[:, hslot].copy_(page)
            return
        x = page.float().cpu().numpy()
        if self.spill_dtype == "int4":
            payload, scale = quantize_kv_int4(x)
        else:                               # int8 spill of a float pool
            scale = np.maximum(np.abs(x).max(axis=-1) / 127.0,
                               1e-8).astype(np.float32)
            payload = np.clip(np.rint(x / scale[..., None]),
                              -127, 127).astype(np.int8)
        self._host_leaf(lk, payload)[:, hslot] = payload
        self._scale_leaf(lk, scale)[:, hslot] = scale

    def _decompress(self, lk: tuple, hslots: List[int],
                    leaf: torch.Tensor) -> torch.Tensor:
        """The host copies of ``hslots`` in the pool leaf's dtype."""
        src = self._host[lk]
        if lk not in self._scales:
            return src[:, torch.as_tensor(hslots)]   # raw pass-through
        codes, scale = src[:, hslots], self._scales[lk][:, hslots]
        if self.spill_dtype == "int4":
            x = dequantize_kv_int4(codes, scale, leaf.shape[-1])
        else:
            x = codes.astype(np.float32) * scale[..., None]
        if leaf.dtype == torch.int8:
            return torch.from_numpy(
                np.clip(np.rint(x), -127, 127).astype(np.int8))
        return torch.from_numpy(x).to(leaf.dtype)

    def spill(self, page: int, hslot: int) -> None:
        self.be._run("spill", page=page, hslot=hslot)

    def _spill(self, page: int, hslot: int) -> None:
        self._staged[hslot] = [(lk, leaf[:, page].clone())
                               for lk, leaf in self._attn_leaves()]

    def poll(self) -> None:
        """Drain both directions: staged spills to host memory, then the
        pending restores into the pool."""
        if not self._staged and not self._pending:
            return
        pending, self._pending = self._pending, []
        self.be._run("poll", pending=pending)

    def _poll(self, pending: List[Tuple[int, int]]) -> None:
        for hslot, pages in self._staged.items():
            for lk, page in pages:
                self._materialize(hslot, lk, page)
        self._staged.clear()
        if not pending:
            return
        hslots = [h for h, _ in pending]
        dst = self.be._index([p for _, p in pending])
        for lk, leaf in self._attn_leaves():
            leaf[:, dst] = self._decompress(lk, hslots, leaf).to(leaf.device)

    def drop(self, hslot: int) -> None:
        self.be._run("drop", hslot=hslot)

    def _drop(self, hslot: int) -> None:
        self._staged.pop(hslot, None)   # host cells just become garbage

    def restore(self, hslot: int, page: int) -> None:
        self._pending.append((hslot, page))


def _on(stream):
    """Run on ``stream`` (None: the CPU's stand-in runs, no streams)."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _capture(graph, step: Callable[[], object], device: torch.device,
             side, pool=None) -> Tuple[tuple, float, int]:
    """Capture ``step`` into ``graph`` on the stream ``side`` (into the
    memory pool ``pool`` when given).  Returns the launch counts the
    capture made (``runtime.count_state``), the host seconds it took and
    the bytes the device's reserved memory grew by; the live counts are
    put back as they were.  A failed capture raises, after ending it.
    Work already queued on ``side`` keeps running during the capture,
    which records without running anything."""
    saved = runtime.count_state()
    try:
        if side is not None:
            reserved = torch.cuda.memory_reserved(device)
        runtime.reset_launch_counts()
        t0 = time.perf_counter()
        with _on(side):
            if pool is None:
                graph.capture_begin()
            else:
                graph.capture_begin(pool=pool)
            try:
                step()
            finally:
                graph.capture_end()
        grown = 0
        if side is not None:
            grown = torch.cuda.memory_reserved(device) - reserved
        return runtime.count_state(), time.perf_counter() - t0, grown
    finally:
        runtime.set_count_state(saved)


class DecodeGraph:
    """One decode step captured as a CUDA graph and replayed: the port's
    counterpart of the reference engine's ``jax.jit`` of ``decode_step``
    (``repro/core/engine.py``), compiled once per engine.

    ``step`` is a function of no arguments that runs one step on tensors
    it keeps (a replay writes the storage the capture saw).  At
    construction ``WARMUP`` eager steps run on the side stream ``stream``
    (the engine's, shared with its prefill graphs; a new one by default),
    as ``torch.cuda.graphs`` requires (they build and load the kernel
    library and set up cuBLAS and the allocator), then one step is
    captured on the same stream into the graph's private memory pool;
    ``replay`` runs it on the current stream.  A failed capture raises;
    nothing falls back to eager steps.  ``capture_seconds`` is the time
    the capture took and ``pool_bytes`` what the private pool reserved.

    The kernel wrappers count launches and record decode plans in
    Python, which a replay does not run.  The counts and plans are put
    back after the capture to what they were before the warm-up (neither
    ran a served step), and every replay adds the capture's launches and
    sets its plans (``runtime.add_counts``).  The decode kernels' arrival
    counters are the graph's own for its lifetime
    (``runtime.own_arrivals``).

    ``graph`` stands in for ``torch.cuda.CUDAGraph`` (an object with
    ``capture_begin``, ``capture_end`` and ``replay``); with one given,
    ``device`` may be the CPU, which has no streams."""

    WARMUP = 2

    def __init__(self, step: Callable[[], object], device, *, graph=None,
                 stream=None):
        device = torch.device(device)
        cuda = device.type == "cuda"
        if graph is None:
            if not cuda:
                raise ValueError(f"DecodeGraph: a CUDA graph is captured on "
                                 f"a CUDA device, not {device}")
            graph = torch.cuda.CUDAGraph()
        self.graph = graph
        self.replays = 0
        self._arrivals: dict = {}
        side = None
        if cuda:
            side = stream if stream is not None else torch.cuda.Stream(device)
        saved = runtime.count_state()
        try:
            with runtime.own_arrivals(self._arrivals):
                if cuda:
                    side.wait_stream(torch.cuda.current_stream(device))
                with _on(side):
                    for _ in range(self.WARMUP):
                        step()
                if cuda:
                    torch.cuda.synchronize(device)
                self._captured, self.capture_seconds, self.pool_bytes = \
                    _capture(graph, step, device, side)
                if cuda:
                    torch.cuda.synchronize(device)
        finally:
            runtime.set_count_state(saved)

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        runtime.add_counts(self._captured)


def _eager_bodies(step: Callable[[], object]) -> Dict[str, int]:
    """Run ``step`` eagerly; returns its ``flash_prefill`` launches by
    body (``runtime.prefill_body_counts``)."""
    before = dict(runtime.prefill_body_counts)
    step()
    return {b: n - before[b] for b, n in runtime.prefill_body_counts.items()}


class PrefillGraph:
    """Prefill captured as CUDA graphs, one per shape key, and replayed:
    the port's counterpart of the reference engine's ``jax.jit`` of its
    prefill (one executable per ``("prefill", pad_to, B)``) and of its
    chunk (one per ``("chunk", Tc, B)``, ``start`` traced).

    ``run(key, step)`` runs one prefill of shape ``key``; ``step`` is a
    function of no arguments over storage the engine keeps for its life
    (the fixed input buffers, the batch cache and the logits buffer).
    The first call of a key runs ``step`` eagerly, as an engine without
    graphs does: a key met once (a job's odd tail, a resumed chunk of a
    length no other job forms) costs no capture, whose host time
    (about one eager run's) would land on that request's TTFT.  The
    second call runs ``step`` eagerly on the side stream, the warm-up
    ``torch.cuda.graphs`` asks for and this call's own prefill (so the
    job's cache and recurrent carries end as a replay would leave them;
    a second run would advance the RWKV and RG-LRU carries twice), then
    captures it on the same stream, which runs nothing, while the card
    still runs the eager step.  Every later call replays.  A failed
    capture or replay raises; nothing falls back to eager prefill.

    All graphs capture into one memory pool (``pool``): their replays
    never overlap and each call's logits are read before the next
    prefill, so the pool holds about the largest shape's activations
    however many graphs share it.  Every graph is held for the engine's
    life, as the reference's jit cache holds its executables; ``clear``
    drops them all when the storage they captured is replaced.
    ``captures``, ``replays``, ``eager_runs`` (first calls),
    ``capture_seconds`` (the captures' time, not the eager runs') and
    ``pool_bytes`` (what the captures added to the device's reserved
    memory) are the bookkeeping; ``met`` counts the calls of each key
    since the last ``clear``.  A replay adds the launches its capture
    made (``runtime.add_counts``); ``run`` returns the ``flash_prefill``
    launches of one call by body, from which the caller counts the
    unaligned ones at its host ``start`` (``runtime.count_unaligned``).

    ``graph`` stands in for ``torch.cuda.CUDAGraph``: a function of the
    key returning an object with ``capture_begin(pool=...)``,
    ``capture_end`` and ``replay``; with one given, ``device`` may be the
    CPU."""

    def __init__(self, device, *, graph=None, stream=None,
                 dtype=torch.float32):
        device = torch.device(device)
        self.cuda = device.type == "cuda"
        if graph is None and not self.cuda:
            raise ValueError(f"PrefillGraph: CUDA graphs are captured on a "
                             f"CUDA device, not {device}")
        self.device = device
        self._new = graph or (lambda key: torch.cuda.CUDAGraph())
        self._side = None
        self.pool = None
        if self.cuda:
            self._side = stream if stream is not None \
                else torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()
            # cuBLAS's workspace of the side stream, allocated before
            # the first job rather than during it
            with _on(self._side):
                torch.ones((8, 8), dtype=dtype, device=device).matmul(
                    torch.ones((8, 8), dtype=dtype, device=device))
            torch.cuda.synchronize(device)
        self._graphs: Dict[tuple, tuple] = {}
        self.met: Dict[tuple, int] = {}
        self.captures = self.replays = self.eager_runs = 0
        self.capture_seconds = 0.0
        self.pool_bytes = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key: tuple, step: Callable[[], object]) -> Dict[str, int]:
        n = self.met[key] = self.met.get(key, 0) + 1
        entry = self._graphs.get(key)
        if entry is not None:
            entry[0].replay()
            self.replays += 1
            runtime.add_counts(entry[1])
        elif n == 1:
            self.eager_runs += 1
            return _eager_bodies(step)
        else:
            entry = self._capture(key, step)
        return dict(entry[1][0][1])     # the capture's prefill_body_counts

    def _capture(self, key: tuple, step) -> tuple:
        graph = self._new(key)
        if self.cuda:
            self._side.wait_stream(torch.cuda.current_stream(self.device))
        with _on(self._side):
            step()
        captured, seconds, grown = _capture(graph, step, self.device,
                                            self._side, self.pool)
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self._side)
        self.captures += 1
        self.capture_seconds += seconds
        self.pool_bytes += grown
        entry = self._graphs[key] = (graph, captured)
        return entry

    def clear(self) -> None:
        """Drop every graph (the storage they captured is going away)."""
        self._graphs.clear()
        self.met.clear()


def check_servable(cfg: ModelConfig) -> None:
    """Raise ValueError for a config the engine cannot serve, as the
    reference's engine cannot: an encoder has no decode step (the
    reference's launcher refuses it with this message), and a VLM's
    prefill needs the request's vision embeddings, which the reference's
    engine never passes (its ``_prefill_fn`` prefills token ids only, so
    its first VLM prefill fails in ``cross_kv``)."""
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only; serve prefill-only "
                         "workloads via max_new_tokens=1")
    if cfg.arch_type == "vlm":
        raise ValueError(
            f"{cfg.name}: the engine prefills token ids only, as the "
            f"reference's engine does (its prefill passes no "
            f"vision_embeds); run transformer.prefill / decode_step with "
            f"vision_embeds instead")


def kv_shards(cfg: ModelConfig, mesh) -> int:
    """The ranks a pool's K/V is cut over by kv head: ``model`` when the
    kv heads divide over it, else 1 (no mesh, or a pool whole on every
    rank or cut along the sequence)."""
    m = 1 if mesh is None else mesh.size("model")
    return m if cfg.n_kv_heads % m == 0 else 1


def check_mesh(cfg: ModelConfig, model: tfm.Transformer, mesh, *,
               decode_graph: Optional[bool] = None,
               prefill_graph: Optional[bool] = None) -> None:
    """Raise for a model not cut for ``mesh``, and for a graph asked
    for: a CUDA graph of the mesh step would capture its NCCL calls, a
    later item."""
    tfm.resolve_mesh(cfg, model, mesh)
    for name, flag in (("decode_graph", decode_graph),
                       ("prefill_graph", prefill_graph)):
        if flag:
            raise ValueError(f"{name}=True under a mesh: the engine runs "
                             f"its steps eagerly there (a captured step "
                             f"would hold its NCCL calls)")


class TorchEngineBackend:
    """ExecutionBackend over PyTorch prefill/decode on one device, or on
    every rank of a mesh (``mesh``; module docstring).

    ``decode_graph``: None captures the decode step as a CUDA graph
    (:class:`DecodeGraph`) on a CUDA device and runs it eagerly on the
    CPU; True asks for the graph and raises on the CPU; False runs the
    step eagerly on the card too (the graph-against-eager comparisons).
    ``prefill_graph`` is the same choice for the prefill graphs
    (:class:`PrefillGraph`).  The reference engine has no such options:
    it always compiles.  Under a mesh both default to False and True is
    refused: a captured step would hold its NCCL calls.

    ``prefill_rows``: the rows of the batch prefill cache, allocated at
    construction (pass the scheduler's batch cap, as the launcher does);
    None allocates it at the first job, with that batch's rows.  A
    larger batch grows the cache and drops the prefill graphs captured
    over the old one.

    ``moe_impl`` is the reference engine's: the MoE blocks' path in
    prefill, the chunk and the decode step, ``"local"`` (grouped, the
    default; on experts cut over ``data``, through ``moe_ep``'s dispatch
    at a capacity that drops nothing) or ``"ref"`` (the dense oracle);
    ``"ep"`` is refused: the reference's engine passes no mesh to its
    model, which its ``_apply_moe("ep")`` needs.

    ``mesh``: the mesh the model was cut for; rank 0 drives, the other
    ranks are workers (``worker``), which answer the driver's commands
    through ``driver.serve_worker``."""

    prefill_needs_slots = True
    # armed by the ServingLoop when the scheduler is slack-aware
    slack_of = None

    # the device halves a command may name (``command``)
    DEVICE_OPS = ("hello", "begin_job", "chunk", "insert", "decode",
                  "spill", "poll", "drop")

    def __init__(self, cfg: ModelConfig, model: tfm.Transformer, *,
                 max_slots: int = 8, cache_len: Optional[int] = None,
                 chunk_tokens: Optional[int] = None,
                 paged: bool = False, page_size: int = 128,
                 kv_pool_tokens: Optional[int] = None,
                 prefix_cache: bool = False,
                 session_ttl: Optional[float] = None,
                 host_pool_tokens: Optional[int] = None,
                 spill_bw: float = 16e9, spill_dtype: str = "",
                 time_scale: float = 1.0, device="cuda",
                 decode_graph: Optional[bool] = None,
                 prefill_graph: Optional[bool] = None,
                 prefill_rows: Optional[int] = None,
                 moe_impl: str = "local", mesh=None):
        check_servable(cfg)
        if moe_impl == "ep":
            raise NotImplementedError(
                "moe_impl='ep': the engine serves moe_impl='local' (on "
                "experts cut over data too), as the reference's engine "
                "does: its prefill, chunk and decode calls pass no mesh "
                "to the model, which its _apply_moe('ep') needs")
        moe.check_impl(moe_impl)
        if spill_dtype not in SPILL_DTYPES:
            raise ValueError(f"spill_dtype {spill_dtype!r}: one of "
                             f"{SPILL_DTYPES}")
        if model.device.type != resolve_device(device).type:
            raise ValueError(f"model lives on {model.device}, engine device "
                             f"is {device}")
        self.mesh = mesh
        self.channel = None
        if mesh is not None:
            check_mesh(cfg, model, mesh, decode_graph=decode_graph,
                       prefill_graph=prefill_graph)
            decode_graph = prefill_graph = False
            self.channel = driver.channel(mesh)
        for name, flag in (("decode_graph", decode_graph),
                           ("prefill_graph", prefill_graph)):
            if flag and model.device.type != "cuda":
                raise ValueError(f"{name}=True: a CUDA graph needs the "
                                 f"card, the engine runs on {model.device}")
        self.worker = self.channel is not None and not self.channel.is_driver
        self.device = model.device
        self.dtype = model.dtype
        self.cfg = cfg
        self.model = model
        self.max_slots = max_slots
        self.cache_len = cache_len or cfg.max_seq_len
        self.chunk_tokens = chunk_tokens
        self.moe_impl = moe_impl
        self.clock = WallClock(time_scale)
        self.supports_decode = cfg.has_decode
        self.flops_per_token = 2.0 * cfg.active_param_count()
        self.paged = paged
        self.spill_dtype = spill_dtype
        like_model = dict(dtype=self.dtype, device=self.device)
        if mesh is not None:
            like_model["mesh"] = mesh
        # the retention layer: the radix prefix index, TTL'd sessions
        # when session_ttl is set, and the host spill tier beneath when
        # host_pool_tokens is; host slots and the per-page transfer price
        # are counted in the spill dtype's bytes (paging.host_tier_geometry),
        # a rank's share of a page under a mesh that cuts the pool
        self.retention: Optional[KvRetention] = None
        self.copier: Optional[_EngineCopier] = None
        host_pages, slot_bytes = paging.host_tier_geometry(
            cfg, host_pool_tokens, page_size, spill_dtype)
        slot_bytes //= kv_shards(cfg, mesh)
        if prefix_cache or session_ttl is not None:
            if not paged:
                raise ValueError("KV retention rides on the paged KV pool: "
                                 "pass paged=True")
            if not cfg.prefix_cacheable:
                raise ValueError(
                    f"{cfg.name}: KV retention needs chunk-resumable "
                    f"prefill and purely attention-paged state (no "
                    f"recurrent carries)")
            if not self.worker:
                self.retention = KvRetention(
                    page_size, session_ttl=session_ttl,
                    host_pool_pages=host_pages,
                    spill_seconds_per_page=slot_bytes / spill_bw,
                    spill_page_bytes=slot_bytes)
        elif host_pages:
            raise ValueError("the host spill tier rides on the retention "
                             "layer: pass prefix_cache or session_ttl")

        self.n_pages = 0
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
            self.n_pages = n_pages
            self.trash_page = n_pages            # pool index n_pages
            self.pool_cache = tfm.init_paged_cache(
                cfg, max_slots, self.cache_len, n_pages + 1, page_size,
                **like_model)
            if not self.worker:
                self.alloc = paging.BlockAllocator(
                    n_pages, page_size, host_pages=host_pages,
                    page_bytes=page_size * max(cfg.cache_bytes_per_token(),
                                               1),
                    host_slot_bytes=slot_bytes)
                self._bt = _BlockTableMirror(max_slots, self.pages_per_seq,
                                             self.trash_page)
            self.pool_cache["block_tables"].fill_(self.trash_page)
            if host_pages:
                self.copier = _EngineCopier(self, host_pages, spill_dtype)
                if self.retention is not None:
                    self.retention.copier = self.copier
        else:
            self.pool_cache = tfm.init_cache(cfg, max_slots, self.cache_len,
                                             **like_model)
        self.host_pages = host_pages
        self._slot_lo, self._slot_n = self._slot_range()
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self._slot_of: Dict[int, int] = {}
        # every slot's next token, on every rank (the step's argmax of
        # the gathered logits)
        self.next_tok = torch.zeros((max_slots,), dtype=torch.int32,
                                    device=self.device)
        self.outputs: Dict[int, List[int]] = {}
        self._prefill_shapes: set = set()
        # the job whose inputs and batch-cache rows are live
        self._job: Optional[PrefillJob] = None
        self._job_toks: Optional[torch.Tensor] = None
        self.prefill_rows = self._pf_held = 0
        if prefill_rows:
            self._alloc_prefill(prefill_rows)
        cuda = self.device.type == "cuda"
        decode_graph = cuda if decode_graph is None else decode_graph
        decode_graph = decode_graph and cfg.has_decode
        prefill_graph = cuda if prefill_graph is None else prefill_graph
        # one side stream for every capture: its cuBLAS workspace is
        # allocated once, at construction
        side = torch.cuda.Stream(self.device) \
            if cuda and (decode_graph or prefill_graph) else None
        self._step = self._decode_step_fn()
        self.decode_graph: Optional[DecodeGraph] = None
        if decode_graph:
            self.decode_graph = DecodeGraph(self._step, self.device,
                                            stream=side)
            self._reset_pool()
        self.prefill_graph: Optional[PrefillGraph] = None
        if prefill_graph:
            self.prefill_graph = PrefillGraph(self.device, stream=side,
                                              dtype=self.dtype)

    # ---------------------------------------------------- the channel ----
    def _run(self, op: str, **args):
        """Run the device half ``op`` with ``args``: under a mesh rank 0
        first sends it to every rank (``core/driver.py``); here in any
        case.  Returns the device half's result (rank 0 reads it)."""
        if self.channel is not None:
            self.channel.send(op, args)
        return getattr(self, "_d_" + op)(**args)

    def command(self, op: str, args: dict):
        """A worker's run of one command of the driver."""
        if op not in self.DEVICE_OPS:
            raise ValueError(f"unknown engine command {op!r}")
        return getattr(self, "_d_" + op)(**args)

    def geometry(self) -> dict:
        """What every rank's backend must agree on: the pool, the batch
        prefill cache and the paths the device halves take."""
        return dict(arch=self.cfg.name, layers=self.cfg.n_layers,
                    dtype=str(self.dtype), max_slots=self.max_slots,
                    cache_len=self.cache_len, paged=self.paged,
                    n_pages=self.n_pages,
                    page_size=self.page_size if self.paged else 0,
                    host_pages=self.host_pages,
                    spill_dtype=self.spill_dtype,
                    prefill_rows=self.prefill_rows, moe_impl=self.moe_impl,
                    mesh=None if self.mesh is None else dict(
                        self.mesh.shape))

    def hello(self) -> None:
        """The driver's first command of a run: every worker checks its
        geometry against the driver's."""
        self._run("hello", geometry=self.geometry())

    def _d_hello(self, geometry: dict) -> None:
        mine = self.geometry()
        if mine != geometry:
            raise ValueError(f"engine geometry differs from the driver "
                             f"rank's: {mine} != {geometry}")

    def close(self, reason: Optional[str] = None) -> None:
        """End a run under a mesh: ``stop`` every worker, or ``abort``
        them with ``reason``."""
        if self.channel is not None and not self.worker:
            self.channel.send("abort" if reason else "stop",
                              {"reason": reason})

    def _slot_range(self) -> Tuple[int, int]:
        """(first slot, slots) of the pool this rank holds: its cut of
        the slots over ``data``."""
        return self._job_rows(self.max_slots)

    def _job_rows(self, B: int) -> Tuple[int, int]:
        """(first row, rows) of a batch of ``B`` rows this rank holds:
        its cut over the batch axes (``sharding.rows``), all of them
        without a mesh or when no axis divides ``B``."""
        if self.mesh is None:
            return 0, B
        axes = batch_tuple(self.mesh, B)
        n = math.prod(self.mesh.shape[a] for a in axes)
        return axes_index(self.mesh, axes) * (B // n), B // n

    # ------------------------------------------------------ prefill ----
    def _alloc_prefill(self, rows: int, held: int = 0) -> None:
        """The batch prefill cache for jobs of up to ``rows`` rows and the
        fixed buffers a prefill reads and writes: token ids (room for
        ``rows`` full prompts), lengths, the chunk's ``start`` and the
        logits, all global.  Under a mesh the cache holds this rank's
        rows of a job (``_job_rows``): the cut of ``rows``, or ``held``
        rows when more (a job whose rows no axis divides is whole on
        every rank), with the pool's cut of the K/V (never along the
        sequence over a paged pool, which is not)."""
        dev = dict(device=self.device)
        self.prefill_rows = rows
        self._pf_held = max(held, self._job_rows(rows)[1])
        if self.mesh is None:
            self._batch_cache = tfm.init_cache(self.cfg, rows, self.cache_len,
                                               self.dtype, self.device)
        else:
            self._batch_cache = tfm.init_cache(
                self.cfg, self._pf_held, self.cache_len, self.dtype,
                self.device, self.mesh, rows_cut=False,
                seq_cut=not self.paged)
        self._pf_toks = torch.zeros((rows * self.cache_len,),
                                    dtype=torch.int32, **dev)
        self._pf_lens = torch.zeros((rows,), dtype=torch.int32, **dev)
        self._pf_start = torch.zeros((), dtype=torch.int32, **dev)
        self._pf_logits = torch.zeros((rows, self.cfg.vocab_size),
                                      dtype=torch.float32, **dev)

    def _batch_view(self, B: int):
        """The batch cache's rows of a job of ``B`` rows: the first ``B``,
        or under a mesh the first of this rank's share (``_job_rows``;
        each leaf's ``[:, :n]`` is contiguous a rep, as the kernels
        need)."""
        bc = self._batch_cache
        n = self._job_rows(B)[1]
        view = {"pos": bc["pos"][:n],
                "groups": tuple(tuple({k: leaf[:, :n]
                                       for k, leaf in slot.items()}
                                      for slot in slots)
                                for slots in bc["groups"])}
        if "seq_sharded" in bc:
            view["seq_sharded"] = bc["seq_sharded"]
        return view

    def _decode_step_fn(self) -> Callable[[], None]:
        """One decode step over the pool, the argmax written into
        ``next_tok``: the function a ``DecodeGraph`` captures.  It holds
        the tensors and not the backend: no reference cycle keeps a
        dropped engine's pool alive through it."""
        cfg, model, cache, nxt = (self.cfg, self.model, self.pool_cache,
                                  self.next_tok)
        kw = dict(page_size=self.page_size,
                  paged_len=self.s_attn) if self.paged else {}
        kw["moe_impl"] = self.moe_impl
        if self.mesh is not None:
            kw["mesh"] = self.mesh

        def step() -> None:
            logits, _ = tfm.decode_step(cfg, model, nxt, cache, **kw)
            nxt.copy_(torch.argmax(logits, -1))
        return step

    def _reset_pool(self) -> None:
        """Zero what the capture's warm-up steps wrote (every row was
        dead): the engine starts as an eager one does."""
        self.next_tok.zero_()
        self.pool_cache["pos"].zero_()
        for slots in self.pool_cache["groups"]:
            for slot in slots:
                for leaf in slot.values():
                    leaf.zero_()

    @property
    def prefix_cache(self) -> Optional[PrefixCache]:
        """The retention layer's radix index (None when disabled)."""
        return self.retention.prefix if self.retention is not None else None

    # ------------------------------------------------------- shapes -----
    def _note_shape(self, kind: str, length: int, bsz: int) -> tuple:
        """The reference compiles one executable per (pad_to, bsz) shape
        and counts them; the port captures one prefill graph per shape
        key (:class:`PrefillGraph`).  The count is kept either way
        (serve.py prints it, the tests compare it).  Returns the key."""
        key = (kind, length, bsz)
        self._prefill_shapes.add(key)
        return key

    @property
    def n_prefill_shapes(self) -> int:
        return len(self._prefill_shapes)

    # --------------------------------------------------------- protocol --
    def begin(self, requests: Sequence[Request]) -> None:
        for r in requests:
            r.materialize_tokens(self.cfg.vocab_size)
            # a slice-promoted request resumed cold from a drain
            # checkpoint: the promoted ids are the last sliced_tokens of
            # its prompt, and seeding the outputs with them keeps the
            # generated-token indexing (_transcript_tokens, the next
            # yield) aligned on an engine that never ran those steps
            self.outputs[r.rid] = [
                int(t) for t in
                r.tokens[r.prompt_len - r.sliced_tokens:r.prompt_len]] \
                if r.sliced_tokens > 0 else []
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
        """Tokens after this iteration's write (sliced tokens were
        promoted into the prompt by a slice yield: not counted twice)."""
        return min(r.prompt_len + r.generated - r.sliced_tokens, self.s_attn)

    def free_blocks(self) -> int:
        return self.alloc.free_pages() if self.paged else 1 << 30

    def _prompt_tokens(self, r: Request):
        return r.tokens[:r.prompt_len]

    def admit_blocks(self, requests: Sequence[Request]) -> int:
        if not self.paged:
            return len(requests)
        return paging.admit_blocks(self.alloc, requests, self._insert_tokens,
                                   cache=self.retention,
                                   tokens_of=self._prompt_tokens)

    def decode_preempt(self, pool: Sequence[Request]) -> List[Request]:
        if not self.paged:
            return []
        victims = paging.extend_for_decode(self.alloc, pool,
                                           self._decode_tokens,
                                           cache=self.retention,
                                           slack_of=self.slack_of)
        for v in victims:
            slot = self._slot_of.pop(v.rid, None)
            if slot is not None:
                self.slot_req[slot] = None
                self._bt.clear(slot, v.rid)
            else:
                self._bt.forget(v.rid)
            # outputs survive: the loop keeps a slice (on_slice_yield)
            # or restarts the victim (on_preempt_reset)
        for r in pool:                       # tables may have grown a page
            slot = self._slot_of.get(r.rid)
            if slot is not None:
                self._bt.sync(slot, r.rid, self.alloc)
        return victims

    def on_slice_yield(self, req: Request, keep: int) -> None:
        """A yield kept ``keep`` generated tokens, now promoted into the
        prompt: drop the tail past them; the resume prefill's first
        token lands at index ``keep``."""
        out = self.outputs.get(req.rid)
        if out is not None:
            del out[keep:]

    def on_preempt_reset(self, req: Request) -> None:
        self.outputs[req.rid] = []       # regenerated after re-prefill

    # ------------------------------------------- fault/drain teardown -----
    def abort_prefill(self, req: Request) -> None:
        """A request leaves mid-prefill (job abandoned after its retry
        budget, or a drain): free the pages reserved at admission and
        drop the job.  The batch cache is the engine's for its life (its
        storage is what the prefill graphs captured); the job's rows of
        it keep what the job wrote until the next job zeroes its rows
        before its first chunk, so nothing of this job reaches it.  No
        slot was taken yet (slots are assigned in ``_finish_prefill``)."""
        job = self._job
        if job is not None and any(r is req for r in job.batch.requests):
            job.handle = None
            self._job = None
        if self.paged:
            self.alloc.release(req.rid)
            self._bt.forget(req.rid)

    def evict_request(self, req: Request) -> None:
        """Tear down a pooled request's slot and pages without
        registering its K/V with the retention layer (decode-pool kill,
        drain); ``outputs`` survives for the loop to promote the kept
        slice.  ``_bt.clear`` points the slot's block-table row at the
        trash page and marks the mirror dirty, and ``decode_iter`` pushes
        the mirror before the next in-place step, so the dead slot's
        masked write never lands in a freed (or reassigned) page."""
        slot = self._slot_of.pop(req.rid, None)
        if slot is not None:
            self.slot_req[slot] = None
        if self.paged:
            self.alloc.release(req.rid)
            if slot is not None:
                self._bt.clear(slot, req.rid)
            else:
                self._bt.forget(req.rid)

    def chunk_plan(self, batch: FormedBatch) -> List[Tuple[int, int]]:
        total = max(batch.pad_to, 8)     # min real-tensor prompt width
        c = self.chunk_tokens if tfm.supports_chunked_prefill(self.cfg) \
            else None
        skip = batch_prefix_skip(batch) if self.retention is not None \
            else 0
        return plan_chunks(total, c, skip=skip)

    def transfer_seconds(self, batch: FormedBatch) -> float:
        return 0.0            # prefill writes straight into the slot pool

    def prefill_chunk(self, job: PrefillJob, idx: int) -> float:
        reqs = job.batch.requests
        B = len(reqs)
        start, clen = job.chunks[idx]
        # chunk mode whenever the plan is split or starts past position 0
        # (a cached prefix was skipped: the one span continues a cache)
        chunked = len(job.chunks) > 1 or job.chunks[0][0] > 0
        h = job.handle
        if h is None:
            h = job.handle = self._begin_job(job)
        if chunked and not 0 <= start < start + clen <= self.cache_len:
            # the graph reads start on the device: checked here
            raise ValueError(f"chunk [{start}, {start + clen}) outside the "
                             f"cache of {self.cache_len} slots")
        self._note_shape("chunk" if chunked else "prefill", clen, B)
        last = idx == len(job.chunks) - 1
        bodies = self._run("chunk", B=B, start=start, clen=clen,
                           chunked=chunked, last=last)
        runtime.count_unaligned(start, bodies)
        first = torch.argmax(self._pf_logits[:B], -1).cpu().numpy()
        lens = h["np_lens"] - 1
        fin = (lens >= start) & (lens < start + clen)
        h["first"][fin] = first[fin]
        if last:
            self._finish_prefill(job)
        return 0.0            # wall backend: the loop reads the clock

    def _d_chunk(self, B: int, start: int, clen: int, chunked: bool,
                 last: bool) -> Dict[str, int]:
        """Device half of a prefill chunk: the job's token ids of [start,
        start + clen) into the fixed buffer, the prefill of its shape
        (eager, or a prefill graph), and after a chunked job's last chunk
        the rows' positions.  Returns the ``flash_prefill`` launches by
        body."""
        if B * clen > self._pf_toks.numel():
            # a prompt past cache_len: room for it, and the graphs
            # captured over the old buffer go
            self._drop_prefill_graphs()
            self._pf_toks = torch.zeros((B * clen,), dtype=torch.int32,
                                        device=self.device)
        self._pf_toks[:B * clen].view(B, clen).copy_(
            self._job_toks[:, start:start + clen])
        self._pf_start.fill_(start)
        key = ("chunk" if chunked else "prefill", clen, B)
        step = self._prefill_step(key)
        if self.prefill_graph is not None:
            bodies = self.prefill_graph.run(key, step)
        else:
            bodies = _eager_bodies(step)
        if last and chunked:
            lo, n = self._job_rows(B)
            self._batch_view(B)["pos"].copy_(self._pf_lens[lo:lo + n])
        return bodies

    def _begin_job(self, job: PrefillJob) -> dict:
        """A job's first chunk: its rows of the batch cache zeroed (a
        fresh cache, whatever earlier jobs left there), its token ids on
        the device once, its lengths in the fixed buffer, and a cached
        prefix copied in (``_d_begin_job``)."""
        reqs = job.batch.requests
        B = len(reqs)
        total = job.chunks[-1][0] + job.chunks[-1][1]
        toks = np.zeros((B, total), np.int32)
        lens = np.zeros((B,), np.int32)
        for i, r in enumerate(reqs):
            L = min(r.prompt_len, total)
            toks[i, :L] = r.tokens[:L]
            lens[i] = L
        seed = self._prefix_rows(reqs) if job.chunks[0][0] > 0 else []
        self._job = job
        dev_toks = self._run("begin_job", toks=toks, lens=lens, seed=seed)
        return {"toks": dev_toks, "np_lens": lens,
                "cache": self._batch_view(B),
                "first": np.zeros((B,), np.int64)}

    def _d_begin_job(self, toks: np.ndarray, lens: np.ndarray,
                     seed: list) -> torch.Tensor:
        """Every rank takes the job's token ids and lengths whole (the
        model cuts its rows) and copies in the cached prefix of its own
        rows only."""
        B = toks.shape[0]
        lo, n = self._job_rows(B)
        if B > self.prefill_rows or n > self._pf_held:
            # the first job, or a batch above the rows held: a larger
            # cache, and the graphs captured over the old one go
            self._drop_prefill_graphs()
            self._batch_cache = None
            self._alloc_prefill(max(B, self.prefill_rows), n)
        cache = self._batch_view(B)
        cache["pos"].zero_()
        for slots in cache["groups"]:
            for slot in slots:
                for leaf in slot.values():
                    leaf.zero_()
        self._pf_lens[:B].copy_(torch.from_numpy(lens))
        self._job_toks = torch.from_numpy(toks).to(self.device)
        seed = [(i - lo, hit, pages) for i, hit, pages in seed
                if lo <= i < lo + n]
        if seed:
            self._copy_prefix(cache, seed)
        return self._job_toks

    def _drop_prefill_graphs(self) -> None:
        if self.prefill_graph is not None:
            self.prefill_graph.clear()

    def _prefill_step(self, key: tuple) -> Callable[[], None]:
        """The prefill of shape ``key`` over the engine's fixed storage,
        its logits into the logits buffer: what a ``PrefillGraph``
        captures.  It reads the token, length and ``start`` buffers and
        writes the batch cache's rows of the job, as every later prefill
        of the key does.  Under a mesh the model takes this rank's rows
        of the global token ids and lengths, and gathers the logits."""
        kind, T, B = key
        cfg, model, moe_impl = self.cfg, self.model, self.moe_impl
        toks = self._pf_toks[:B * T].view(B, T)
        lens, start = self._pf_lens[:B], self._pf_start
        out = self._pf_logits[:B]
        cache = self._batch_view(B)
        mkw = {} if self.mesh is None else dict(mesh=self.mesh)
        if kind == "chunk":
            def step() -> None:
                logits, _ = tfm.prefill_chunk(cfg, model, toks, cache, start,
                                              lens, moe_impl=moe_impl, **mkw)
                out.copy_(logits)
        else:
            cache_len = self.cache_len

            def step() -> None:
                logits, _ = tfm.prefill(cfg, model, toks, lens,
                                        cache_len=cache_len,
                                        moe_impl=moe_impl, cache=cache, **mkw)
                out.copy_(logits)
        return step

    def _prefix_rows(self, reqs: Sequence[Request]) -> list:
        """(row, hit tokens, hit pages) of each row with a cached prefix."""
        page = self.page_size
        rows = []
        for i, r in enumerate(reqs):
            n = r.prefix_hit_tokens
            if n:
                rows.append((i, n, list(self.alloc.table(r.rid)[:-(-n // page)])))
        return rows

    def _seed_prefix(self, h, reqs: Sequence[Request]) -> None:
        """Copy each row's cached prefix K/V out of the page pool into
        the batch prefill cache ``h["cache"]``, so chunked prefill
        resumes past it (``_copy_prefix``)."""
        self._copy_prefix(h["cache"], self._prefix_rows(reqs))

    def _copy_prefix(self, cache, rows: list) -> None:
        """For each (row, hit tokens n, hit pages) and attention leaf,
        one gather of the row's hit pages and an in-place copy of
        positions [0, n).  A session-resumed row's hit ends inside its
        partial tail page; the copy stops at that exact token.  The
        values are the pool's bits."""
        rows = [(i, n, self._index(pages)) for i, n, pages in rows]
        for gi, (pattern, _) in enumerate(self.cfg.block_groups()):
            for j, btype in enumerate(pattern):
                if btype not in (BLOCK_ATTN, BLOCK_MOE):
                    continue        # unreachable under prefix_cacheable
                pool_slot = self.pool_cache["groups"][gi][j]
                for k, leaf in cache["groups"][gi][j].items():
                    for i, n, pages in rows:
                        g = pool_slot[k][:, pages]   # (reps, np, page, ...)
                        leaf[:, i, :n] = g.flatten(1, 2)[:, :n]

    def _finish_prefill(self, job: PrefillJob) -> None:
        """First tokens out; batched slot insertion for continuing rows."""
        h = job.handle
        slots, rows, firsts, tables, shared = [], [], [], [], []
        to_register = []
        free = iter(i for i, r in enumerate(self.slot_req) if r is None)
        for i, r in enumerate(job.batch.requests):
            tok = int(h["first"][i])
            self.outputs[r.rid].append(tok)
            if r.max_new_tokens <= 1 or not self.cfg.has_decode:
                if self.paged:
                    # done at first token: never scattered into the pool,
                    # so its pages hold no transcript — a plain free,
                    # never retention (which would index them)
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
                tables.append(list(t))
                # shared prefix pages already hold this K/V and may be
                # read by other live requests: never written again
                if self.retention is not None:
                    shared.append(r.prefix_hit_tokens // self.page_size)
                    to_register.append((r, t))
                else:
                    shared.append(0)
        if slots:
            if self.paged:
                self._run("insert", B=len(job.batch.requests), slots=slots,
                          rows=rows, firsts=firsts, tables=tables,
                          shared=shared, bt=self._bt.host)
                self._bt.dirty = False
            else:
                self._run("insert", B=len(job.batch.requests), slots=slots,
                          rows=rows, firsts=firsts)
        # index full prompt pages only once their K/V is in the pool: a
        # later batch may hit them at once
        for r, t in to_register:
            self.prefix_cache.register(self.alloc, self._prompt_tokens(r), t)
        job.handle = None
        self._job = None

    def _index(self, values: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int64),
                               device=self.device)

    def _d_insert(self, B: int, slots: List[int], rows: List[int],
                  firsts: List[int], tables=None, shared=None,
                  bt=None) -> None:
        """Device half of the slot insertion, in place, one cache leaf at
        a time: the leaf's job rows (gathered over the batch axes under a
        mesh, ``_job_leaf``) into the pool with one index-put for the
        whole batch.  A per-slot leaf (the contiguous pool's K/V, a
        recurrent carry) takes the rows of the slots this rank holds
        (``_held``).  On the paged pool the attention K/V rows are
        chopped into page-sized spans and written to each row's pages
        ``tables`` on every rank (every replica), and ``pos`` is every
        slot's; the first ``shared[i]`` pages of a table are a cached
        prefix that already lives in the pool: skipped, so a shared page
        is written once, by its first owner.  ``bt``, the host block
        tables, is pushed after, and every slot's first token goes into
        ``next_tok``."""
        cache = self._batch_view(B)
        local, held_rows = self._held(slots, rows)
        sl, rw = self._index(local), self._index(held_rows)
        pos = self._job_leaf(cache["pos"], B, 0)
        if self.paged:
            self.pool_cache["pos"][self._index(slots)] = \
                pos[self._index(rows)]
            dst, srow, spg = self._page_spans(rows, tables, shared)
        elif local:
            self.pool_cache["pos"][sl] = pos[rw]
        for gi, (pattern, _) in enumerate(self.cfg.block_groups()):
            for j, btype in enumerate(pattern):
                pool_slot = self.pool_cache["groups"][gi][j]
                bc_slot = cache["groups"][gi][j]
                paged = self.paged and btype in (BLOCK_ATTN, BLOCK_MOE)
                for k, pool_leaf in pool_slot.items():
                    leaf = self._job_leaf(bc_slot[k], B, 1)
                    if paged:
                        pool_leaf[:, dst] = self._in_pages(leaf)[:, srow,
                                                                 spg]
                    elif local:
                        pool_leaf[:, sl] = leaf[:, rw]
        if self.paged:
            self.pool_cache["block_tables"].copy_(torch.from_numpy(bt))
        self.next_tok[self._index(slots)] = torch.as_tensor(
            firsts, dtype=torch.int32, device=self.device)

    def _job_leaf(self, x: torch.Tensor, B: int, dim: int) -> torch.Tensor:
        """A batch-cache leaf's rows of a job of ``B`` rows, all of them:
        this rank's own without a mesh, else all-gathered over the batch
        axes along ``dim`` (a no-op where the rows are not cut, or cut
        over axes of one rank)."""
        return x if self.mesh is None else gather_rows(x, self.mesh, B, dim)

    def _held(self, slots: List[int], rows: List[int]):
        """This rank's pool indices of ``slots`` (global) and the batch
        rows that go to them: the slots it holds (all of them without a
        mesh or when the slots are not cut)."""
        lo, n = self._slot_lo, self._slot_n
        kept = [(s - lo, r) for s, r in zip(slots, rows) if lo <= s < lo + n]
        return [s for s, _ in kept], [r for _, r in kept]

    def _page_spans(self, rows: List[int], tables: List[List[int]],
                    shared: Sequence[int]):
        """(pool page, batch row, page of the row) of every page a row
        writes: its table past the ``shared`` prefix pages."""
        dst, srow, spg = [], [], []
        for row, t, skip in zip(rows, tables, shared):
            for j, pg in enumerate(t[skip:], skip):
                dst.append(pg)
                srow.append(row)
                spg.append(j)
        return self._index(dst), self._index(srow), self._index(spg)

    def _in_pages(self, leaf: torch.Tensor) -> torch.Tensor:
        """A batch-cache K/V leaf (reps, B, S, ...) as (reps, B, pages a
        sequence, page, ...), its sequence padded to whole pages."""
        page, maxp = self.page_size, self.pages_per_seq
        pad = maxp * page - leaf.shape[2]
        if pad:
            leaf = torch.nn.functional.pad(
                leaf, (0, 0) * (leaf.ndim - 3) + (0, pad))
        return leaf.reshape(leaf.shape[:2] + (maxp, page) + leaf.shape[3:])

    def decode_iter(self, pool: Sequence[Request],
                    context_tokens: int) -> float:
        bt = None
        if self.paged and self._bt.dirty:
            # tables changed (extend/preempt/release): push the small host
            # mirror; steady-state iterations skip the transfer
            bt = self._bt.host
            self._bt.dirty = False
        self._run("decode", bt=bt)
        toks = self.next_tok.cpu().numpy()
        for slot, r in enumerate(self.slot_req):
            if r is not None:
                self.outputs[r.rid].append(int(toks[slot]))
        return 0.0

    def _d_decode(self, bt=None) -> None:
        """Device half of a decode step: the block tables ``bt`` pushed
        when given, then the step (a replay of the decode graph, or
        eager)."""
        if bt is not None:
            self.pool_cache["block_tables"].copy_(torch.from_numpy(bt))
        if self.decode_graph is not None:
            self.decode_graph.replay()
        else:
            self._step()

    def release(self, req: Request) -> None:
        slot = self._slot_of.pop(req.rid, None)
        if slot is not None:
            self.slot_req[slot] = None
        if self.paged:
            self._release_pages(req)
            if slot is not None:
                self._bt.clear(slot, req.rid)
            else:
                self._bt.forget(req.rid)

    def _release_pages(self, req: Request) -> None:
        """End of a request's pages: with retention, the transcript's
        full pages join the radix and the partial tail stays pinned under
        the session key (core/retention.py); else a plain free."""
        if self.retention is not None:
            self.retention.on_release(self.alloc, req,
                                      self._transcript_tokens(req),
                                      self.clock.now())
        else:
            self.alloc.release(req.rid)

    def _transcript_tokens(self, req: Request) -> np.ndarray:
        """The token path whose K/V the pool holds for ``req``: the
        prompt plus generated[:-1] (the step that produced the last token
        never wrote its K/V).  The first ``sliced_tokens`` generated
        tokens were promoted into the prompt by a slice yield: counted
        once."""
        out = self.outputs.get(req.rid) or []
        gen = np.asarray(out[req.sliced_tokens:max(req.generated - 1, 0)],
                         np.int32)
        return np.concatenate(
            [np.asarray(self._prompt_tokens(req), np.int32), gen])

    def generated_tokens(self, req: Request) -> np.ndarray:
        return np.asarray(self.outputs.get(req.rid, ()), np.int32)

    def maintain(self, now: float) -> None:
        maintain_backend(self, now)

    # the spill tier's device halves (``_EngineCopier``)
    def _d_spill(self, page: int, hslot: int) -> None:
        self.copier._spill(page, hslot)

    def _d_poll(self, pending: List[Tuple[int, int]]) -> None:
        self.copier._poll(pending)

    def _d_drop(self, hslot: int) -> None:
        self.copier._drop(hslot)


class ServingEngine:
    """Facade: schedule and serve a request set on the PyTorch backend.

    Thin wiring only — the run loop is ``ServingLoop`` in ``disagg``
    topology (prefill chunks interleave with slot decode).  The options
    and defaults are the reference engine's; a ``FaultInjector`` is
    built only for a plan with an armed site (``self.faults``).
    ``device`` defaults to ``"cuda"`` and raises when no card is
    present; ``decode_graph``, ``prefill_graph``, ``prefill_rows``,
    ``moe_impl`` and ``mesh`` are ``TorchEngineBackend``'s
    (``prefill_rows`` above ``max_slots`` is cut to it: no batch holds
    more).

    Under a mesh every rank builds the engine with the same arguments
    and calls ``run``: rank 0 (the driver) runs the loop with
    ``scheduler`` and ends the run by stopping the workers (or aborting
    them when it raises); on any other rank (a worker: ``scheduler`` is
    not used and may be None, and the loop's options are ignored)
    ``run`` answers the driver's commands until it stops and returns
    no request."""

    def __init__(self, cfg: ModelConfig, model: tfm.Transformer, scheduler,
                 *, max_slots: int = 8, cache_len: Optional[int] = None,
                 time_scale: float = 1.0,
                 chunk_tokens: Optional[int] = None, paged: bool = False,
                 page_size: int = 128,
                 kv_pool_tokens: Optional[int] = None,
                 prefix_cache: bool = False,
                 session_ttl: Optional[float] = None,
                 host_pool_tokens: Optional[int] = None,
                 spill_bw: float = 16e9, spill_dtype: str = "",
                 slice_tokens: Optional[int] = None,
                 recorder=None, tracer=None,
                 fault_plan=None, recovery=None,
                 restore_timeout: float = 30.0,
                 device="cuda", decode_graph: Optional[bool] = None,
                 prefill_graph: Optional[bool] = None,
                 prefill_rows: Optional[int] = None,
                 moe_impl: str = "local", mesh=None):
        self.cfg = cfg
        self.model = model
        self.backend = TorchEngineBackend(
            cfg, model, max_slots=max_slots, cache_len=cache_len,
            chunk_tokens=chunk_tokens, paged=paged,
            page_size=page_size, kv_pool_tokens=kv_pool_tokens,
            prefix_cache=prefix_cache, session_ttl=session_ttl,
            host_pool_tokens=host_pool_tokens, spill_bw=spill_bw,
            spill_dtype=spill_dtype, time_scale=time_scale, device=device,
            decode_graph=decode_graph, prefill_graph=prefill_graph,
            prefill_rows=None if prefill_rows is None
            else min(max_slots, prefill_rows),
            moe_impl=moe_impl, mesh=mesh)
        self.sched = None if self.backend.worker else scheduler
        self.faults = None
        self.loop = None
        if not self.backend.worker:
            self.faults = FaultInjector(fault_plan) \
                if fault_plan is not None and fault_plan.any_armed else None
            self.loop = ServingLoop(scheduler, self.backend, LoopConfig(
                mode="disagg", decode_slot_cap=max_slots,
                slice_tokens=slice_tokens, restore_timeout=restore_timeout),
                recorder=recorder, tracer=tracer, faults=self.faults,
                recovery=recovery)
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
        be = self.backend
        if be.worker:
            driver.serve_worker(be)
            return []
        if be.channel is not None:
            be.channel.reset_counts()       # the counts are this run's
            be.hello()
        try:
            self.result = self.loop.run(self._pending, time_limit=math.inf,
                                        max_wall_s=max_wall_s)
        except BaseException as e:
            be.close(reason=f"{type(e).__name__}: {e}")
            raise
        be.close()
        return [r for r in self._pending
                if r.finished >= 0 and not r.dropped]
