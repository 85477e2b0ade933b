#!/usr/bin/env python3
"""Start the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  It
imports only ``repro_torch`` (never JAX or the reference package) and
goes through these phases, each printing its own lines:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: the five CUDA sources from ``src/repro_torch/csrc`` (seven
   kernels: the two decode sources also hold the int8 variants, and
   ``wkv6_bwd.cu`` holds ``wkv6``'s backward; nvcc,
   sm_90a, one process per source in parallel); ``cuobjdump -sass``
   must find HGMMA (wgmma) instructions in the prefill tensor-core body,
   and the wrapper's rule for which prefill body takes a call must be
   the C launch's;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the reference's sweep shapes and at the main paths' shapes (Qwen3-14B
   attention: H=40, Hkv=8, Dh=128; rwkv6-3b's recurrence: 40 heads of
   64, a 512-token chunk and a decode step of 8 rows), in f32 and in
   bf16, each prefill call through the body its dtype and head dim
   select, a chunk's query offset passed as the engine passes it (a 0-d
   int32 tensor the kernel reads on the card); at the main paths' bf16
   shapes also its time, the plain
   version's time, the card's bound for the same work and, where one
   PyTorch call computes the same function, that call's time as a
   yardstick; the decode kernels also at rows of every length (0-4095)
   and on wrapped rings, where two calls must give the same bits, with
   the split (n_split, L) and body each call chose, and a sweep of the
   split length a step either side of the rule's; then the prefill
   tensor-core body's phase profile at its two main-path shapes (a
   library built with ``-DRT_PREFILL_PHASES``); ``wkv6`` also at a ragged
   T, bit-identical over two calls at the chunk, with the wrapper's tile
   rule the C launch's, and timed at the plan's tile and the tiles around
   it (the tile sweep); ``wkv6``'s backward kernel ``wkv6_bwd`` against
   ``ref.wkv6_bwd_ref`` over the sweep, both decay extremes, dsT given
   and absent, ragged T (1, 17, 37, 0), s0 zero and padded steps, a
   ``--model 4`` rank's 10 heads, then at rwkv6-3b's chunk (and at 10
   heads) bit-identical over two calls and timed beside its bound and
   the plain versions;
4. model parity: smoke-size qwen3-14b and rwkv6-3b through the kernels on
   the card and through the plain versions on the CPU, same weights;
   then the graphs at smoke size: the engine with its decode step and
   its prefills captured as CUDA graphs (``core/engine.py:DecodeGraph``,
   ``PrefillGraph``, the default on the card) against the same engine
   run eagerly (``decode_graph=False, prefill_graph=False``) and on the
   CPU, f32, on the paged and the
   contiguous qwen3-14b pools and the rwkv6-3b carry pool: ids
   identical, launch counts equal, one prefill graph captured for each
   prefill shape met twice; the same for smoke llama2-13b (MHA,
   G = 1) on both pools, whose paged ids must also equal the contiguous
   ones;
5. serve: the port's ``ServingEngine`` on full-width, full-depth
   Qwen3-14B (bf16, random weights from a seeded generator on the card,
   cache length 4096), paged pool with chunked prefill, then a short
   contiguous-pool run, each run eagerly and then with the decode and
   the prefill graphs, the paged run also with the decode graph alone
   (ids and launch counts identical; tok/s, TTFT, TPOT, the decode
   capture's seconds and the graph's private pool bytes, the prefill
   graphs' captures, replays, pool bytes and capture seconds beside the
   prefill shapes; the prefill graphs must replay), then four
   full-width decode steps under ``torch.profiler``, eager and as graph
   replays (wall, device busy, idle share, kernels a step), and
   full-width prefill chunks of (Tc, B) = (512, 8), (512, 1), (128, 4)
   at offset 1536 and (45, 4) at 1037 through the engine's
   ``prefill_chunk``, eager and as prefill-graph replays (the same
   figures a chunk);
5b. analysis (``launch/op_analysis.py``, on the same model): the
   profile's decode step (B = 8, context 1024, paged) and a 512 x 8
   chunk at offset 1536 counted on real tensors (each kernel launched
   and counted by its ``kernels/cost.py`` formula) and traced again on
   fake ``cuda`` tensors, which must count the same FLOPs, bytes,
   collective bytes, ops and kernel calls; the step's fake ``cpu`` trace
   beside it with the ops that differ; each count's bound at the H100
   peaks against the CUDA-event time of the call (the step eager and as
   a graph replay, the chunk eager), at most 1.05 x it, each count
   taking the live keys a row from the host; one
   ``paged_flash_decode`` (step) or ``flash_prefill`` (chunk) launch a
   layer; an unfused count of the step on ``cuda`` tensors refused with
   no launch; the kernel scope's host cost, 40 wrapped calls against 40
   unwrapped; and ``launch/dryrun.py --arch qwen3-14b --all --device
   cuda`` in a subprocess (8 records, no error, each printed as counts)
   beside another for rwkv6-3b's two ``train_4k`` pairs (a ``roofline``
   each, ``wkv6`` and its backward kernel by formula, 64 and 32 calls;
   the plain count skipped with its reason), both started after the
   phase's timed work and run side by side;
6. retention (KV retention in the engine, on the same model): smoke qwen3-14b at f32 on the
   reference tests' shared-prefix and 2-session workloads, cold and with
   retention on the card and with retention on the CPU, token ids equal;
   a resumed chunk off the tile grid (Tc 45 at ``q_offset`` 1037 over
   4096, bf16, full width) against the plain version on the tensor-core
   body; full-width Qwen3-14B serving 4 sessions x 3 turns behind a
   512-token system prompt cold and then with session retention (hits,
   tokens skipped, unaligned ``flash_prefill`` launches all on the
   tensor-core body, turns >= 2 prefilling at most 40% of the cold
   run's prompt tokens, pages balanced, each resumed turn's first-token
   logits against the turn prefilled cold within 1.5x the spread of the
   cold run against the same prompts prefilled alone, TTFT of later
   turns); then
   the same over a 48-page pool with a 128-page host spill tier (spills,
   restores and holds > 0, both tiers balanced, one page spilled,
   overwritten and restored into another page byte-identical);
7. recovery (slice yield, faults, recovery and drain in the engine, on
   the same model): smoke qwen3-14b at f32 on ``TestSlicePreemption``'s
   workload over a 5-page pool with slice 4, its ids equal to the
   uncontended run's and to the CPU run's; ``TestEngineFaults``'
   workload drained at half its run's wall time, the checkpoint through
   JSON, resumed on a cold engine, ids equal to the uninterrupted run's;
   then full-width Qwen3-14B, 12 requests of 512-2048 prompt tokens and
   64 new tokens under the goodput scheduler with slice 16 over a
   34-page pool, the fault plan armed and a Tracer on (every request
   finished or quarantined, slice yields, preemptions and fault events
   > 0, each kept slice the head of its final output, pages balanced,
   ``memory_allocated`` back within 64 MiB of its value after the
   engine's construction, which allocates its batch prefill cache and
   buffers, the timeline valid,
   ``paged_flash_decode`` 40 launches a decode step, every
   ``flash_prefill`` launch on the tensor-core body); then the same
   workload without faults drained at the faulted run's TTFT p50, the first
   engine's pool freed and the checkpoint resumed on a cold engine
   (nothing lost or duplicated, kept slices equal, pages balanced in
   both engines);
8. int8 KV tier (on the same model): the int8 decode kernels were held
   in the kernel phase (the reference sweeps with int8 caches in f32 and
   bf16, against the plain int8 versions and bit for bit against the
   float kernels over the dequantized cache with the same plan, at the
   main widths also at rows of every length and wrapped rings and over
   two calls; the bf16 main shape timed with its plain version, the
   dequantize + bf16 kernel route, SDPA on the dequantized gathered
   cache and its bound; a split sweep; at the serve step's shape (B = 8
   at context 1024 of 4096: L 512, two live splits) both int8 kernels
   over caches of every code from -128 to 127 at scales from the 1e-8
   floor to 1e3, the float kernels' bits over two calls, then timed
   beside the bf16 kernel over the dequantized cache; a chunk's
   dequantization of its live prefix timed against the engine's
   fixed-size one of the whole cache, the chunk's bits the same over
   both), and smoke qwen3-14b f32
   over int8 caches after the parity phase (card ids == CPU ids, graph ==
   eager == CPU, paged == contiguous, prefix and session hits == cold);
   here full-width Qwen3-14B serves the paged run's 12 requests over an
   int8 pool under the same ``pool_tokens`` (about 1.94x the bf16
   pages) and the contiguous run's 4, eager and with the graph; the
   first decode step's logits over an int8 cache against a bf16 cache
   (max abs at most 1.5) and the int8 step's profile; the recovery
   workload without faults over its 4480-token budget, 34 bf16 pages
   against 66 int8 pages; and an int8 pool with an int8 spill tier
   (spills and restores, a page of codes and scales byte-identical
   through the tier);
8b. distribution (on the same model, about 150 s): both contiguous decode
   kernels' ``lse_out`` (each (row, head)'s log-sum-exp) at Qwen3-14B's
   decode shape (B = 8 over 4096 slots), bf16 and f32, float and int8
   caches, at context 2048, at rows of every length (three inside the
   first 512-slot range, one with its only live slot 0) and on wrapped
   rings: output and log-sum-exp against the plain version, the output
   the same bits with and without ``lse_out``, and the cache cut into
   m = 2, 4, 8 slot ranges, each through the kernel at its local
   positions and combined (``attention.combine_decode_partials``)
   against the unsharded kernel and the plain version (f32 atol 1e-5);
   the bf16 kernels timed without and with ``lse_out`` beside the bound,
   the plain version and the library's flash-attention forward with its
   log-sum-exp (per-row key lengths, GQA native); the serve phase's 12
   requests at t = 0 served eagerly by the engine without a mesh on the
   paged and the contiguous pool (8 slots each); then a one-rank NCCL
   process group and the (1, 1)
   host mesh: one full-width qwen3-moe layer through ``moe_ep`` (the
   all-to-all and the f32 all-reduce) against ``moe_local`` at 8 and 512
   tokens, timed; smoke f32 yi-6b ``forward`` and one qwen3-moe EP train
   step on the card under the mesh against the CPU; and the main path:
   the full-width Qwen3-14B prefilling 8 prompts and decoding 8 greedy
   steps with no mesh, under the mesh, under the mesh with its cache
   marked cut along the sequence into one shard (each decode through
   ``distributed_decode_attention``), and the int8 pair, every mesh
   run's ids equal to the no-mesh run's, its launches one a layer a
   prefill or step, the ``lse_out`` ones counted apart; smoke f32
   qwen3-14b through the engine under the mesh on the card against the
   engine without a mesh on the CPU, both pools, ids equal; then the
   same 12 requests through ``ServingEngine(mesh=...)`` (rank 0 driving,
   each device call a command over the gloo channel) on both pools,
   eagerly: ids equal to the no-mesh runs', one ``flash_prefill`` a
   layer a chunk and one decode kernel a layer a step, every page back,
   TPOT and TTFT p50 both ways beside the card's name and power limit,
   the decode command's host time a step, and a decode step of the
   mesh engine profiled (the NCCL kernels' share); and the paged pool
   under the data axis (one replica a data rank, every decode write
   gathered over data, prefill rows cut over data): smoke f32 qwen3-14b
   through the engine under the mesh with the prefix cache, sessions
   and the spill tier (TTL 0) on the card against the engine without a
   mesh on the CPU, ids equal, every page and host slot back; then the
   retention phase's 4 sessions x 3 turns (every first turn at t = 0)
   and its 48-page spill run at full width with 10 of the 40 layers
   (the same weights), eagerly, without a mesh and
   through ``ServingEngine(mesh=...)``: ids equal (and the sessions'
   formed batches; the spill run's follow the wall clock),
   session hits, pages spilled and restored, one ``flash_prefill`` a
   layer a chunk and one paged decode kernel a layer a step, every page
   and host slot back after ``clear``, later-turn TTFT p50 both ways,
   restore holds, preemptions and each later turn's TTFT phases from
   its latency ledger (``chip_mesh_retention.py`` serves the same two
   runs at all 40 layers);
9. paper (the paper's own model): the Qwen3-14B model is freed and
   full-width, full-depth llama2-13b (bf16, seeded random weights, its
   native 4096-token cache) is built; both decode kernels at its widths
   (B = 8, H = Hkv = 40, Dh 128 over 4096 slots, contexts 2048 and
   4096) and a 512-token prefill chunk at offset 1536, each against its
   plain version and timed beside its bound and SDPA, with the decode
   split the rule picks; the fits of the cost model's ``H100`` spec
   (``core/hardware.py``: ``bw_eff`` from a profiled graph-mode decode
   step, ``mfu`` from an 8 x 512 prefill chunk, ``link_bw`` from a 1 GiB
   copy), each beside the spec's constant; the 12 requests at t = 0
   served eagerly and with the graph (ids and launch counts identical,
   formed batches equal to the cost model's on the same requests); then
   32 requests of the launcher's mixed workload arriving at 8 req/s,
   served under BucketServe (waste trigger) and under the DistServe-like
   baseline on fresh engines, each with the decode graph alone and then
   with both graphs (every request finished, every page free after each
   run, the prefill graphs replayed), each with the cost model's
   prediction on the same
   requests (TTFT, TPOT, makespan) beside the measurement;
10. rwkv6-3b: the llama2-13b model is freed and full-width, full-depth
   rwkv6-3b is served the same way on the contiguous pool (eager, then
   with the graph), profiled (eager and graph), and served again,
   eagerly, through ``ServingEngine(mesh=...)`` on a one-rank NCCL mesh
   with the model cut by ``shard_model`` (the tensor-parallel time and
   channel mix on the rank's own heads): ids and steps equal to the
   eager run, the same ``wkv6`` gate.
   Launch counts are zeroed before each serve run and read after it (a
   graph replay counts the launches its capture made; a prefill replay's
   unaligned ``flash_prefill`` launches are counted from its own
   offset):
   every kernel must have been launched by the path it belongs to, every
   bf16 Qwen3-14B or llama2-13b ``flash_prefill`` launch through the
   tensor-core body, and ``wkv6`` exactly 32 times per prefill chunk and
   per decode step;
11. recurrentgemma-2b (RG-LRU blocks and local attention on ring
   caches): the rwkv6-3b model is freed; both decode kernels at its
   widths (B = 8, H = 10, Hkv = 1: G = 10 at Dh 256) over the 2048-slot
   ring, on rows not yet wrapped and wrapped (two calls, same bits) and
   with every slot live, and ``flash_prefill`` on a 4096-token prompt
   under the 2048-token window (bf16 on the tensor-core body: two
   warpgroups a block at Dh 256), f32 and bf16, each
   against its plain version and in bf16 timed beside its bound and
   SDPA; smoke f32 recurrentgemma (5 layers) and qwen3-14b with a
   48-token window through ``graph_smoke`` on both pools (card ids ==
   CPU ids, graph == eager, paged == contiguous); then full width and
   depth (bf16, seeded random weights, the cache cut from 32768 to 8192)
   serving 12 requests of 256-6144 prompt tokens at t = 0 on the paged
   pool (page 128) and 4 on the contiguous pool, eagerly and with the
   graph (ids and launches identical, every page free, one
   ``flash_prefill`` a local-attention layer a prefill and one decode
   kernel a layer a step), and a decode step of 8 wrapped rows profiled
   eager and as a graph replay, with the RG-LRU functions' share of an
   eager step and of a 6144-token prefill; then both pools' requests
   again, eagerly, through ``ServingEngine(mesh=...)`` on a one-rank
   NCCL mesh with the model cut (the RG-LRU branch's column and row
   products and gathered gates, the local attention on its own query
   heads): ids and steps equal to the eager runs, the same launch gates,
   every page back;
12. MoE (qwen3-moe-235b-a22b, llama4-scout-17b-a16e): the
   recurrentgemma-2b model is freed; both decode kernels at qwen3-moe's
   widths (B = 8, H = 64, Hkv = 4: G = 16 at Dh 128, the decode body's
   G * Dh cap) over 4096 slots at context 2048 and on rows of every
   length and wrapped rings (two calls, same bits), and a 512-token
   chunk at offset 1536, f32 and bf16, each against its plain version
   and in bf16 timed beside its bound and SDPA; llama4-scout's G = 5
   decode rows checked; one MoE layer of each config at full width
   (bf16): ``moe_local`` against ``moe_dense_ref`` at 8 tokens and at a
   512-token chunk, every grouped product through the library's grouped
   GEMM, timed against its bytes bound beside the plain route and the
   dense oracle, with the distinct experts hit; smoke f32 qwen3-moe and
   llama4-scout through ``graph_smoke`` on both pools (card ids == CPU
   ids, graph == eager, paged == contiguous; the f32 grouped products
   on the plain route); then qwen3-moe at full width with its depth cut
   from 94 to 8 layers (bf16, seeded random weights, cache 4096): 12
   requests at t = 0 on the paged pool and 4 on the contiguous pool,
   eagerly and with the graph (ids and launches identical, every page
   free, one ``flash_prefill`` a layer a chunk on the tensor-core body,
   one decode kernel a layer a step, three grouped GEMM calls a layer
   a step), and a decode step profiled eager and as a graph replay with
   the MoE functions' share of an eager step and of a prefill;
13. encoder and VLM (hubert-xlarge, llama-3.2-vision-90b, nemotron-4-340b):
   the qwen3-moe model is freed; hubert's non-causal ``flash_prefill``
   (B = 8, T = 1500 frames, H = Hkv = 16, Dh 80, lengths 1500/1200/900/
   600: the tensor-core body, P·V at N 128), the VLM's cross-attention
   ``flash_prefill``
   (B = 8, Tq = 1024 over Tk = 1600 vision keys, H = 64, Hkv = 8, no
   mask), its cross decode through ``flash_decode`` over the 1600 keys
   (every row's pos 1599; two calls, same bits; the split the rule
   picks) and its self-attention decode on both kernels at context 2048,
   each against its plain version and in bf16 timed beside its bound and
   SDPA, the first three also in f32 at a smoke shape; smoke f32 of the
   three configs (cross gates 1.0): ``forward``, ``prefill`` and 4
   ``decode_step``s on the card against the CPU (atol 1e-4), the VLM
   also on the paged pool with the contiguous ids; hubert-xlarge at full
   width and depth (bf16, seeded weights): ``forward`` on 8 x 1500
   frames (48 ``flash_prefill`` launches, all tensor-core; wall, device
   busy, the kernel's share) and ``prefill(embeds=...)``'s last-token
   logits against ``forward``'s; then llama-3.2-vision-90b at full
   width with its depth cut from 100 to 20 layers (38.4 GB, every cross
   gate set to 1.0, cache 4096): 8 prompts of 256-1024 tokens, each
   with its own vision embeddings, prefilled whole and decoded 32
   greedy steps on the contiguous cache and on the paged pool (page
   128) after a warm-up: ids equal, launches one a layer a prefill or
   step, prefill and step wall, the first tokens ``forward``'s argmax;
14. nemotron-4-340b (head dim 192): the VLM is freed; the three
   attention kernels at its widths (H = 96, Hkv = 8: G = 12 at Dh 192):
   a 512-token chunk at offset 1536 over 4096 slots through the
   tensor-core body, both decode kernels at context 2048 and on rows of
   every length and wrapped rings (two calls, same bits) and both int8
   decode kernels (the float kernel's bits over the dequantized cache),
   f32 and bf16, each against its plain version and in bf16 timed
   beside its bound and SDPA; then the model at every published width
   with its depth cut from 96 to 4 layers (46.5 GB, cache 4096): 8
   prompts of 256-1024 tokens, 32 new tokens each, chunk 512, served
   through the engine on the paged pool and then on the contiguous
   pool, eagerly and with both graphs (ids and launches identical,
   every page free, one ``flash_prefill`` a layer a chunk on the
   tensor-core body, one decode kernel a layer a step), paged ids ==
   contiguous ids;
15. training: the kernels under autograd at smoke shapes (f32):
   ``flash_prefill`` causal, windowed and non-causal with Tq != Tk, each
   launching its kernel once with its plain version's backward, and
   ``wkv6``, launching its kernel and its backward kernel once each,
   against autograd through the plain versions; the bf16
   grouped product's backward (``moe.GroupedMM``) at a full-width
   qwen3-moe layer's shapes against autograd through the plain loop,
   timed; ``flash_prefill`` at the training step's attention shape
   (B = 4, T = 511), forward and forward + backward, timed beside its
   plain version, SDPA and the bound; one f32 train step at smoke size
   for qwen3-14b, rwkv6-3b, recurrentgemma-2b and qwen3-moe on the card
   against the CPU (loss, grad_norm, every updated parameter); then
   Qwen3-14B at every published width with 8 of its 40 layers (bf16,
   4.20 B parameters, AdamW state 33.6 GB), 10 steps of 4 x 512 tokens
   with remat (loss finite at every step and falling, 16
   ``flash_prefill`` launches a step: 8 forward and 8 recomputed, 8
   plain backward passes, peak memory under 75 GB), one step split by
   CUDA events into forward, backward and update, and one profiled
   (device busy, idle share, the plain attention backward's time); then
   rwkv6-3b at every published width and all 32 layers (3.1 B
   parameters), 5 steps of 2 x 4096 tokens with remat (loss finite and
   falling; 64 ``wkv6`` and 32 ``wkv6_bwd`` launches a step, no plain
   backward pass), a step split by CUDA events, one profiled (the
   backward kernel's share of device time) and one counted by
   ``launch/op_analysis.py`` on real tensors == on fake ``cuda`` ones,
   its bound at most 1.05 x its CUDA-event time; then ``wkv6_bwd`` and
   ``wkv6`` on the operands of the first step's last layer (B 2, T
   4095, the step's dy, dsT absent) against their plain versions, the
   backward bit-identical over two calls, both timed;
16. the kernel table as one JSON line (launches from the serve runs:
   each decode kernel from the run on its own pool, the int8 kernels
   from the int8 runs; the three attention kernels once more at
   recurrentgemma-2b's, qwen3-moe's and nemotron-4-340b's widths with
   those runs' launches, at hubert-xlarge's and llama-3.2-vision's
   shapes with the launches of its forward and of its two runs, and
   ``flash_prefill`` at the training shape with the training run's
   launches, ``wkv6_bwd`` and ``wkv6`` at the rwkv6-3b training
   step's shape (timed on one of its steps' operands) with that run's
   launches and ``wkv6_bwd`` at the chunk shape and at 10 heads (no
   launches), the two contiguous decode kernels with ``lse_out`` at the
   distribution phase's shape with the sequence-cut mesh runs'
   launches, the three attention kernels at the serve shapes with
   the mesh engine runs' launches, at recurrentgemma-2b's and
   qwen3-moe's widths with their mesh runs' launches, ``wkv6`` with
   rwkv6-3b's mesh run's, the kernels at a rank's shapes under
   ``model`` > 1 with launches 0 (no one-card run reaches them), and ``flash_prefill`` and
   ``paged_flash_decode`` at the serve shapes with the mesh session and
   spill runs' launches, and the same two with the analysis phase's
   counted step's and chunk's launches, each entry naming its
   ``path``), the
   ``nvidia-smi`` line,
   and as the last line ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; there is no CPU fallback.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, H100 SXM
TOL = {"float32": dict(atol=1e-4, rtol=1e-3),         # summation order
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# Main-path shapes: kernel and plain version both accumulate in f32 and
# round the output to bf16 once, so they differ by about one bf16 ulp
# (2**-7 relative) at most; a dropped or misplaced key tile does not.
MAIN_TOL = {"float32": TOL["float32"],
            "bfloat16": dict(atol=2e-3, rtol=1e-2)}
MAIN = dict(H=40, Hkv=8, Dh=128)                      # Qwen3-14B attention
# int8 caches at smoke f32, card against CPU: the K/V of the two sides
# differ in the last f32 bits, and a value on a rounding boundary takes
# the neighbouring code on one side, which moves the logits by up to a
# few 1e-3; the ids must still be equal
INT8_SMOKE_ATOL = 5e-3          # one flipped code measured 2.5e-3
# first-decode-step logits of the int8 cache against the bf16 cache at
# full width: the reference's int4 spill-tier bound (tests/test_kv_spill.py
# TestInt4LogitDrift), which int8 must meet a fortiori
INT8_DRIFT_MAX = 1.5
WKV_MAIN = dict(B=8, T=512, H=40, hs=64)              # rwkv6-3b chunk
WKV_RANK_H = WKV_MAIN["H"] // 4    # a --model 4 rank's heads (10 of 40)
# wkv6: kernel and plain version both compute in f32 from exactly cast
# inputs (another summation order), so the f32 tolerance holds for bf16
# r/k/v too
WKV_TOL = TOL["float32"]

PREFILL_SHAPES = [   # (B, T, H, Hkv, Dh, window, causal): reference sweep
    (1, 128, 4, 4, 64, 0, True), (2, 200, 8, 2, 64, 0, True),
    (2, 384, 4, 1, 128, 0, True), (1, 300, 4, 2, 64, 128, True),
    (2, 256, 4, 4, 80, 0, False), (1, 64, 2, 2, 256, 0, True),
    (1, 300, 16, 1, 128, 0, True)]                             # G = 16
DECODE_SHAPES = [    # (B, S, H, Hkv, Dh, ring)
    (2, 256, 8, 2, 64, False), (1, 600, 4, 1, 128, False),
    (2, 256, 8, 8, 64, False), (2, 128, 4, 2, 64, True),
    (1, 512, 16, 2, 80, False),
    (2, 256, 10, 1, 256, False), (2, 256, 10, 1, 256, True),   # G = 10
    (1, 300, 16, 1, 128, False), (2, 256, 16, 1, 128, True)]   # G = 16
WKV_SHAPES = [       # (B, T, H, hs): reference sweep
    (1, 64, 2, 64), (2, 100, 4, 64), (1, 128, 1, 32), (2, 48, 8, 16)]
# constant decays: exp(-exp(3)) forgets at once, exp(-exp(-6)) keeps
# nearly everything (the case a chunked cumulative-decay form overflows)
WKV_DECAYS = {"strong": math.exp(-math.exp(3.0)),
              "weak": math.exp(-math.exp(-6.0))}
WKV_RAGGED = (2, 37, 4, 64)   # T off the kernel's 16-step tile
# wkv6 tiles timed at the main shapes, (rows, columns) a thread and
# columns a block: the plans' (4, 8, 64) for a chunk and (4, 8, 32) for a
# decode step, and one step away in each
WKV_SWEEP = [(4, 8, 64), (4, 8, 32), (8, 4, 64), (8, 4, 32), (8, 8, 64)]
# decode rows at the main widths (B = 8 over 4096 slots): (label, pos,
# ring).  Every length from one slot to the whole cache, so rows end in
# the first split, mid-split and in the last; then rings wrapped or not.
DECODE_MIXED = [
    ("mixed contexts", [0, 63, 255, 256, 1023, 2047, 3000, 4095], False),
    ("wrapped ring", [5000, 100, 4096, 8191, 0, 4095, 9000, 2047], True)]
# decode rows of the Qwen3-14B serve run: the first eight prompts
# (SERVE_LENGTHS) a few tokens into their decode
SERVE_DECODE_POS = [95, 2079, 331, 1055, 159, 1567, 543, 127]
PAGED_SHAPES = [     # (B, S, H, Hkv, Dh, page, ring)
    (2, 256, 8, 2, 64, 128, False), (2, 256, 8, 8, 64, 128, False),
    (1, 600, 4, 1, 128, 128, False), (1, 300, 4, 2, 64, 128, False),
    (2, 128, 4, 2, 64, 64, True), (2, 96, 8, 2, 64, 64, True),
    (1, 512, 16, 2, 80, 256, False), (2, 256, 10, 1, 256, 128, True),
    (1, 300, 16, 1, 128, 128, False), (2, 256, 16, 1, 128, 128, True)]
# recurrentgemma-2b's local attention (G = 10 at Dh 256) over its
# 2048-slot ring: decode rows not yet wrapped and wrapped, a band of
# window 2048 over a 4096-token prompt
RG_ATTN = dict(B=8, H=10, Hkv=1, Dh=256, S=2048)
RG_DECODE_POS = [0, 700, 2046, 2047, 2048, 3000, 5000, 9000]
RG_PREFILL_T = 4096
RG_RANK_H = RG_ATTN["H"] // 2   # a --model 2 rank's query heads (G = 5)
RG_RANK_ROLE = ("a --model 2 rank's query heads (5 of 10 over the one kv "
                "head: G = 5): timed and checked here; no run on one card "
                "launches it at this shape")
RG_MESH_PATH = "recurrentgemma-2b engine under the (1, 1) mesh"
# the full-width serve: the cache cut from 32768 to 8192 (the ring is
# 2048 slots either way; the cut bounds the prompt), 12 prompts of
# 256-6144 tokens, 7 of them past the window, 32 new tokens each
RG_MAX_SEQ = 8192
RG_SERVE_LENGTHS = [256, 6144, 1024, 4096, 512, 3000, 2500, 768, 5000, 1500,
                    3500, 2200]
RG_CONTIG_LENGTHS = [300, 2500, 700, 4000]
# the full-width serve runs: (prompt lengths, new tokens, slots) a pool
RG_SERVE = {"paged": (RG_SERVE_LENGTHS, 32, 8),
            "contiguous": (RG_CONTIG_LENGTHS, 16, 4)}
RG_PROFILE_CTX = 2560       # the decode step's rows: their rings wrapped
RG_RANGES = ("rec_block_forward", "rec_block_decode", "linear_scan",
             "_rglru_gates", "_conv1d", "rglru_step")


_T0 = time.perf_counter()
SPANS = {}      # a log tag's first and last line, seconds from the start


def log(phase: str, msg: str) -> None:
    now = time.perf_counter() - _T0
    SPANS.setdefault(phase, [now, now])[1] = now
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- timing ---
def _events(torch):
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_ms(torch) -> float:
    """Clock cycles ``torch.cuda._sleep`` spins per millisecond on this
    card (measured once)."""
    start, end = _events(torch)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 2e7 / start.elapsed_time(end)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup``.  The calls are queued behind a
    sleep kernel that outlasts their host-side work, so a call whose
    host work takes longer than its device work (a short kernel, a small
    decode step) is timed by the device work.  A call that makes more
    launches than the launch queue holds is still paced by the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start, end = _events(torch)
    torch.cuda._sleep(int(sleep_cycles_per_ms(torch)
                          * (2 * iters * host_ms + 1.0)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(work, dtype: str):
    """The card's least time for ``work`` (a ``kernels/cost.py:Cost``:
    FLOPs and HBM bytes) and what bounds it."""
    t_bytes = work.bytes / HBM_BYTES_PER_S * 1e3
    t_ops = work.flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def prefill(q, k, v, *args, **kw):
    """``ops.flash_prefill``, checking that the launch went through the
    body that the dispatch rule names for q's dtype and head dim."""
    from repro_torch.kernels import flash_prefill as fp, ops, runtime
    body = fp.body(q.dtype, q.shape[-1])
    n0 = runtime.prefill_body_counts[body]
    out = ops.flash_prefill(q, k, v, *args, **kw)
    if runtime.prefill_body_counts[body] != n0 + 1:
        raise AssertionError(f"flash_prefill {q.dtype} Dh={q.shape[-1]}: "
                             f"not launched through the {body} body")
    return out


def hgmma_count(lib) -> int:
    """HGMMA (wgmma) instructions in the SASS of the prefill tensor-core
    kernels of the built library, by the toolkit's own cuobjdump."""
    from repro_torch.kernels import runtime
    sass = subprocess.run([str(runtime.cuda_tool("cuobjdump")), "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return sum(fn.count("HGMMA") for fn in sass.split("Function : ")
               if "flash_prefill_wgmma" in fn.split("\n", 1)[0])


def check_body_rule() -> None:
    """The wrapper's rule for which prefill body takes a call is the one
    the C launch applies (``rt_flash_prefill_body``)."""
    from repro_torch.kernels import flash_prefill as fp, runtime
    lib = runtime.library()
    for dtype, code in runtime.DTYPE_CODES.items():
        for Dh in (64, 80, 128, 192, 256):
            c_body = ("tensor_core" if lib.rt_flash_prefill_body(code, Dh)
                      else "cuda_core")
            if c_body != fp.body(dtype, Dh):
                raise AssertionError(f"prefill body of {dtype} Dh={Dh}: C "
                                     f"{c_body}, wrapper {fp.body(dtype, Dh)}")


def assert_close(torch, name, got, want, tol, valid=None) -> float:
    g, w = got.detach().float(), want.detach().float()
    if valid is not None:
        g, w = g[valid], w[valid]
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    torch.testing.assert_close(g, w, **tol, msg=lambda m: f"{name}: {m}")
    return float((g - w).abs().max())


# ------------------------------------------------------------ kernels ---
def kernel_phase(torch):
    from repro_torch.kernels import cost, ops, ref, runtime
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(getattr(torch, dtype))

    # reference sweeps, both dtypes: correctness only
    n_checked = 0
    for dtype in ("float32", "bfloat16"):
        for B, T, H, Hkv, Dh, window, causal in PREFILL_SHAPES:
            q, k, v = rnd((B, T, H, Dh), dtype), rnd((B, T, Hkv, Dh), dtype), \
                rnd((B, T, Hkv, Dh), dtype)
            lens = torch.tensor([T, max(T // 2, 1)][:B], dtype=torch.int32,
                                device=dev)
            got = prefill(q, k, v, lens, causal=causal, window=window)
            want = ref.flash_prefill_ref(q, k, v, lens, causal=causal,
                                         window=window)
            valid = (torch.arange(T, device=dev)[None] < lens[:, None])
            assert_close(torch, f"flash_prefill{(B, T, H, Hkv, Dh)}", got,
                         want, TOL[dtype], valid)
            n_checked += 1
        for B, S, H, Hkv, Dh, ring in DECODE_SHAPES:
            q, kc, vc = rnd((B, H, Dh), dtype), rnd((B, S, Hkv, Dh), dtype), \
                rnd((B, S, Hkv, Dh), dtype)
            pos = torch.tensor([S // 3, 2 * S + 5][:B] if ring else
                               [S - 1, S // 2][:B], dtype=torch.int32,
                               device=dev)
            assert_close(torch, f"flash_decode{(B, S, H, Hkv, Dh)}",
                         ops.flash_decode(q, kc, vc, pos, ring=ring),
                         ref.flash_decode_ref(q, kc, vc, pos, ring=ring),
                         TOL[dtype])
            n_checked += 1
        for B, S, H, Hkv, Dh, page, ring in PAGED_SHAPES:
            q = rnd((B, H, Dh), dtype)
            n_p = -(-S // page)
            n_pages = B * n_p + 3
            kp, vp = rnd((n_pages, page, Hkv, Dh), dtype), \
                rnd((n_pages, page, Hkv, Dh), dtype)
            bt = torch.randperm(n_pages, generator=gen, device=dev)[
                :B * n_p].reshape(B, n_p).to(torch.int32)
            pos = torch.tensor([2 * S + 5, S // 3][:B] if ring else
                               [S - 1, S // 2][:B], dtype=torch.int32,
                               device=dev)
            got = ops.paged_flash_decode(q, kp, vp, bt, pos, s_len=S,
                                         ring=ring)
            assert_close(torch, f"paged_flash_decode{(B, S, H, Hkv, Dh)}",
                         got, ref.paged_flash_decode_ref(
                             q, kp, vp, bt, pos, s_len=S, ring=ring),
                         TOL[dtype])
            contig = ops.flash_decode(
                q, ref.gather_paged_kv(kp, bt, S).contiguous(),
                ref.gather_paged_kv(vp, bt, S).contiguous(), pos, ring=ring)
            assert_close(torch, "paged vs contiguous", got, contig,
                         TOL[dtype])
            n_checked += 1
    log("kernels", f"{n_checked} sweep cases agree with the plain versions "
        f"(f32 atol 1e-4 rtol 1e-3; bf16 atol 2e-2 rtol 2e-2); prefill "
        f"launches by body {runtime.prefill_body_counts} (f32 on the CUDA "
        f"cores, bf16 at every head dim on the tensor cores)")

    # main-path shapes: f32 against the tight tolerance, then bf16 (the
    # served dtype) checked and timed
    H, Hkv, Dh = MAIN["H"], MAIN["Hkv"], MAIN["Dh"]
    rows, worst = {}, {}
    for dt in ("float32", "bfloat16"):
        esz, tol = (4 if dt == "float32" else 2), MAIN_TOL[dt]
        timed = dt == "bfloat16"

        # whole-prompt prefill, T = 2048
        T = 2048
        q, k, v = rnd((1, T, H, Dh), dt), rnd((1, T, Hkv, Dh), dt), \
            rnd((1, T, Hkv, Dh), dt)
        lens = torch.tensor([T], dtype=torch.int32, device=dev)
        got = prefill(q, k, v, lens)
        err = assert_close(torch, f"flash_prefill main {dt}", got,
                           ref.flash_prefill_ref(q, k, v, lens), tol)
        worst[f"flash_prefill T=2048 {dt}"] = err
        if timed:
            b_ms, b_by = bound_ms(cost.prefill(1, T, T, H, Hkv, Dh, esz,
                                               lengths=[T]), dt)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            rows["flash_prefill T=2048"] = dict(
                ms=time_ms(torch, lambda: ops.flash_prefill(q, k, v, lens),
                           10),
                plain_ms=time_ms(torch, lambda: ref.flash_prefill_ref(
                    q, k, v, lens), 5, 1),
                library_ms=time_ms(torch, lambda: sdpa(
                    qt, kt, vt, is_causal=True, enable_gqa=True), 10),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        del q, k, v, got

        # chunked prefill: Tc = 512 at q_offset 1536 over a 4096-slot cache
        Tc, off, S = 512, 1536, 4096
        q, k, v = rnd((1, Tc, H, Dh), dt), rnd((1, S, Hkv, Dh), dt), \
            rnd((1, S, Hkv, Dh), dt)
        row = chunk_case(torch, q, k, v, off, tol, f"chunk {dt}", timed)
        worst[f"flash_prefill chunk 512@1536/4096 {dt}"] = row["max_abs_err"]
        if timed:
            rows["flash_prefill chunk 512@1536/4096"] = row
        del q, k, v

        # decode: B = 8 at context 2048 over 4096-slot caches, page 128
        B, S, ctx, page = 8, 4096, 2048, 128
        q = rnd((B, H, Dh), dt)
        kc, vc = rnd((B, S, Hkv, Dh), dt), rnd((B, S, Hkv, Dh), dt)
        kp, vp, bt = paged_copy(torch, kc, vc, page, gen)
        pos = torch.full((B,), ctx - 1, dtype=torch.int32, device=dev)
        case = decode_case(torch, q, kc, vc, kp, vp, bt, pos, tol,
                           f"main {dt}", timed)
        for name, row in case.items():
            key = f"{name} B=8 ctx=2048" + (" page=128" if "paged" in name
                                            else "")
            worst[f"{key} {dt}"] = row["max_abs_err"]
            plan = row["plan"]
            log("kernels", f"{name} B=8 S={S} {dt}: n_split "
                f"{plan.n_split}, L {plan.L}, {plan.body} body")
            if timed:
                rows[key] = row
        if timed:
            decode_split_sweep(torch, q, kc, vc,
                               case["flash_decode"]["plan"].L)

        # rows of every length and wrapped rings, both pools, each kernel
        # called twice: the two calls must give the same bits
        for label, posl, ring in DECODE_MIXED:
            pm = torch.tensor(posl, dtype=torch.int32, device=dev)
            calls = [(ops.flash_decode(q, kc, vc, pm, ring=ring),
                      ops.paged_flash_decode(q, kp, vp, bt, pm, s_len=S,
                                             ring=ring)) for _ in range(2)]
            (a, b), (a2, b2) = calls
            worst[f"decode {label} {dt}"] = max(
                assert_close(torch, f"flash_decode {label} {dt}", a,
                             ref.flash_decode_ref(q, kc, vc, pm, ring=ring),
                             tol),
                assert_close(torch, f"paged_flash_decode {label} {dt}", b,
                             ref.paged_flash_decode_ref(
                                 q, kp, vp, bt, pm, s_len=S, ring=ring), tol),
                assert_close(torch, f"paged vs contiguous {label} {dt}", b,
                             a, tol))
            if not (torch.equal(a, a2) and torch.equal(b, b2)):
                raise AssertionError(f"decode {label} {dt}: two calls on "
                                     f"the same inputs differ")
        log("kernels", f"decode {dt}: {', '.join(d[0] for d in DECODE_MIXED)}"
            f" agree with the plain versions (paged also with the "
            f"contiguous kernel), and two calls of each kernel give the "
            f"same bits")
        del q, kc, vc, kp, vp
        torch.cuda.empty_cache()

    log("kernels", "main-path shapes agree with the plain versions (f32 "
        "atol 1e-4 rtol 1e-3; bf16 atol 2e-3 rtol 1e-2); max abs err: "
        + "; ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    log_rows("kernels", rows)
    return rows


def log_rows(phase, rows):
    """One line a timed kernel row: its time, its plain version's, its
    bound, SDPA's, the decode split where it has one, its error."""
    for name, r in rows.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        extra = (f", sdpa on the gathered cache {r['sdpa_contiguous_ms']:.4f}"
                 if "sdpa_contiguous_ms" in r else "")
        if "plan" in r:
            extra += (f"; n_split {r['plan'].n_split}, L {r['plan'].L}, "
                      f"{r['plan'].body} body")
        log(phase, f"{name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), sdpa {lib} ms{extra}, max abs err "
            f"{r['max_abs_err']:.3g}")


def paged_copy(torch, kc, vc, page, gen):
    """Contiguous caches (B, S, Hkv, Dh) scattered into a page pool in a
    random page order, with one spare page: (k pool, v pool, block
    tables)."""
    B, S, Hkv, Dh = kc.shape
    n_p = S // page
    n_pages = B * n_p + 1
    bt = torch.randperm(n_pages - 1, generator=gen, device=kc.device)[
        :B * n_p].reshape(B, n_p).to(torch.int32)
    kp = torch.zeros((n_pages, page, Hkv, Dh), dtype=kc.dtype,
                     device=kc.device)
    vp = torch.zeros_like(kp)
    kp[bt.reshape(-1).long()] = kc.reshape(B * n_p, page, Hkv, Dh)
    vp[bt.reshape(-1).long()] = vc.reshape(B * n_p, page, Hkv, Dh)
    return kp, vp, bt


def decode_case(torch, q, kc, vc, kp, vp, bt, pos, tol, label, timed):
    """Both decode kernels on rows ``pos`` (one context for all) of the
    contiguous cache (kc, vc) and of the same cache paged (kp, vp through
    bt): each against its plain version, the paged kernel also against
    the contiguous plain version.  With ``timed`` each is also timed
    beside its plain version, SDPA on the contiguous cache and the
    card's bound for the live context.  Returns {kernel: row}, each row
    with its max abs error and the split its call took."""
    from repro_torch.kernels import cost, ops, ref, runtime
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dt, esz = str(q.dtype).split(".")[-1], q.element_size()
    B, H, Dh = q.shape
    S, Hkv, page = kc.shape[1], kc.shape[2], kp.shape[1]
    want = ref.flash_decode_ref(q, kc, vc, pos)
    err = assert_close(torch, f"flash_decode {label}",
                       ops.flash_decode(q, kc, vc, pos), want, tol)
    rows = {"flash_decode": dict(max_abs_err=err,
                                 plan=runtime.decode_plans["flash_decode"])}
    got = ops.paged_flash_decode(q, kp, vp, bt, pos, s_len=S)
    err = max(assert_close(torch, f"paged_flash_decode {label}", got,
                           ref.paged_flash_decode_ref(q, kp, vp, bt, pos,
                                                      s_len=S), tol),
              assert_close(torch, f"paged vs contiguous {label}", got, want,
                           tol))
    rows["paged_flash_decode"] = dict(
        max_abs_err=err, plan=runtime.decode_plans["paged_flash_decode"])
    if not timed:
        return rows
    ctx = int(pos.max()) + 1
    dmask = (torch.arange(S, device=q.device)[None]
             <= pos[:, None])[:, None, None]
    q4, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    sdpa_ms = time_ms(torch, lambda: sdpa(q4, kt, vt, attn_mask=dmask,
                                          enable_gqa=True), 20)
    b_ms, b_by = bound_ms(cost.decode(B, H, Hkv, Dh, esz, ctx), dt)
    rows["flash_decode"].update(
        ms=time_ms(torch, lambda: ops.flash_decode(q, kc, vc, pos), 50),
        plain_ms=time_ms(torch, lambda: ref.flash_decode_ref(
            q, kc, vc, pos), 10),
        library_ms=sdpa_ms, bound_ms=b_ms, bound_by=b_by)
    b_ms, b_by = bound_ms(cost.decode(B, H, Hkv, Dh, esz, ctx, page=page),
                          dt)
    rows["paged_flash_decode"].update(
        ms=time_ms(torch, lambda: ops.paged_flash_decode(
            q, kp, vp, bt, pos, s_len=S), 50),
        plain_ms=time_ms(torch, lambda: ref.paged_flash_decode_ref(
            q, kp, vp, bt, pos, s_len=S), 10),
        library_ms=None, sdpa_contiguous_ms=sdpa_ms, bound_ms=b_ms,
        bound_by=b_by)
    return rows


def chunk_case(torch, q, k, v, off, tol, label, timed):
    """``flash_prefill`` on a chunk of queries at ``q_offset`` ``off``
    over the cache (k, v), through the body its dtype and head dim name,
    against its plain version.  With ``timed`` also timed beside its
    plain version, SDPA under the same causal mask and the card's bound
    for the keys the mask reaches.  Returns the row."""
    from repro_torch.kernels import cost, ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dt, esz = str(q.dtype).split(".")[-1], q.element_size()
    _, Tc, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    # the offset as the engine passes it: a 0-d int32 on the card
    dev_off = torch.full((), off, dtype=torch.int32, device=q.device)
    row = dict(max_abs_err=assert_close(
        torch, f"flash_prefill {label}", prefill(q, k, v, q_offset=dev_off),
        ref.flash_prefill_ref(q, k, v, q_offset=off), tol))
    if not timed:
        return row
    b_ms, b_by = bound_ms(cost.prefill(1, Tc, S, H, Hkv, Dh, esz,
                                       q_offset=off), dt)
    mask = (torch.arange(Tc, device=q.device)[:, None] + off
            >= torch.arange(S, device=q.device)[None])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    row.update(
        ms=time_ms(torch, lambda: ops.flash_prefill(q, k, v, q_offset=off),
                   10),
        plain_ms=time_ms(torch, lambda: ref.flash_prefill_ref(
            q, k, v, q_offset=off), 5, 1),
        library_ms=time_ms(torch, lambda: sdpa(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), 10),
        bound_ms=b_ms, bound_by=b_by)
    return row


def decode_split_sweep(torch, q, kc, vc, L0, scales=()):
    """Device time of the contiguous decode kernel at the split length
    ``L0`` the rule chose and a step either side, at context 2048 and at
    the serve run's decode rows (bf16, B = 8 over 4096 slots).  With
    ``scales`` (k_s, v_s) the caches are int8 codes and the int8 kernel
    is timed: its plan is the float kernels' while its tiles are half the
    bytes.  Launched through the C entry directly, so no launch count
    moves."""
    from repro_torch.kernels import ref, runtime
    dev = q.device
    B, H, Dh = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    lib = runtime.library()
    out = torch.empty_like(q)
    arrivals = runtime.arrival_counters(dev, B * Hkv)
    name = "flash_decode_int8" if scales else "flash_decode"
    entry = getattr(lib, "rt_" + name)
    res = []
    for label, posl in (("ctx 2048", [2047] * B),
                        ("serve rows", SERVE_DECODE_POS)):
        pos = torch.tensor(posl, dtype=torch.int32, device=dev)
        want = (ref.flash_decode_int8_ref(q, kc, vc, *scales, pos) if scales
                else ref.flash_decode_ref(q, kc, vc, pos))
        for L in (L0 // 2, L0, 2 * L0):
            n_split = -(-S // L)
            part = torch.empty((B, H, n_split, Dh + 2), device=dev)

            def call():
                err = entry(
                    q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                    *(t.data_ptr() for t in scales), pos.data_ptr(),
                    out.data_ptr(), None, part.data_ptr(),
                    arrivals.data_ptr(), B,
                    S, H, Hkv, Dh, 0, L, n_split,
                    runtime.DTYPE_CODES[q.dtype], runtime.stream_ptr(dev))
                if err:
                    raise RuntimeError(f"{name} L={L}: error {err}")
            call()
            assert_close(torch, f"{name} L={L} {label}", out, want,
                         MAIN_TOL["bfloat16"])
            res.append(f"{label} L={L}{' (rule)' if L == L0 else ''} "
                       f"{time_ms(torch, call, 50):.4f} ms")
    log("int8" if scales else "kernels", f"{name} split sweep, bf16 B=8 "
        f"S=4096: " + "; ".join(res))


def int8_serve_step_rows(torch, gen):
    """Both int8 kernels at the serve step's shape (Qwen3-14B's widths,
    bf16, B = 8 at context 1024 of 4096 slots: L 512, two live splits,
    128 blocks), over caches holding every code from -128 to 127 with
    scales in three bands from ``quantize_kv``'s 1e-8 floor to 1e3 (q
    scaled so the scores stay near 1): bit for bit the float kernel over
    the dequantized cache with the same plan, and over two calls; then,
    on ``quantize_kv`` codes, each timed beside the bf16 kernel over the
    dequantized cache, the decode kernel a layer of the profiled int8
    step.  Returns the timed rows."""
    from repro_torch.kernels import cost, ops, ref, runtime
    from repro_torch.models.attention import quantize_kv
    dev = torch.device("cuda")
    H, Hkv, Dh = MAIN["H"], MAIN["Hkv"], MAIN["Dh"]
    B, S, ctx, page = 8, 4096, 1024, 128
    deq, bf16 = ref.dequantize_kv, torch.bfloat16
    pos = torch.full((B,), ctx - 1, dtype=torch.int32, device=dev)
    bt = torch.randperm(B * S // page + 1, generator=gen, device=dev)[
        :B * S // page].reshape(B, S // page).to(torch.int32)

    def paged(t):
        pl = t.new_zeros((B * S // page + 1, page) + tuple(t.shape[2:]))
        pl[bt.reshape(-1).long()] = t.reshape((B * S // page, page)
                                              + tuple(t.shape[2:]))
        return pl

    def calls(q, kc, vc, ks, vs):
        pools = [paged(t) for t in (kc, vc, ks, vs)]
        kd, vd = deq(kc, ks, bf16), deq(vc, vs, bf16)
        kpd, vpd = deq(pools[0], pools[2], bf16), deq(pools[1], pools[3],
                                                       bf16)
        return {"flash_decode_int8": (
                    lambda: ops.flash_decode_int8(q, kc, vc, ks, vs, pos),
                    lambda: ops.flash_decode(q, kd, vd, pos), "flash_decode"),
                "paged_flash_decode_int8": (
                    lambda: ops.paged_flash_decode_int8(q, *pools, bt, pos,
                                                        s_len=S),
                    lambda: ops.paged_flash_decode(q, kpd, vpd, bt, pos,
                                                   s_len=S),
                    "paged_flash_decode")}

    codes = torch.arange(-128, 128, dtype=torch.int8, device=dev).repeat(
        B * S * Hkv * Dh // 256)
    for band, (lo, hi) in (("floor", (1e-8, 1e-7)), ("unit", (1e-3, 1e-2)),
                           ("high", (1e2, 1e3))):
        def cache():
            c = codes[torch.randperm(codes.numel(), generator=gen,
                                     device=dev)].reshape(B, S, Hkv, Dh)
            u = torch.rand((B, S, Hkv), generator=gen, device=dev)
            return c, torch.exp(math.log(lo) + u * math.log(hi / lo))
        q = (torch.randn((B, H, Dh), generator=gen, device=dev)
             / (74 * hi)).to(bf16)
        kc, ks = cache()
        vc, vs = cache()
        for name, (int8, float_, fname) in calls(q, kc, vc, ks,
                                                 vs).items():
            a, a2, want = int8(), int8(), float_()
            p8, pf = runtime.decode_plans[name], runtime.decode_plans[fname]
            if not (torch.equal(a, want) and torch.equal(a, a2)
                    and torch.isfinite(a.float()).all() and p8 == pf
                    and (p8.L, -(-ctx // p8.L)) == (512, 2)):
                raise AssertionError(
                    f"{name} every code, scales {lo:g}-{hi:g}: the float "
                    f"kernel's bits {torch.equal(a, want)}, two calls "
                    f"{torch.equal(a, a2)}, plans {p8} / {pf}")
        del q, kc, vc, ks, vs
    del codes
    log("int8", "serve step shape (B=8, context 1024 of 4096, L 512, two "
        "live splits), every code -128..127, scales in [1e-8, 1e-7], "
        "[1e-3, 1e-2], [1e2, 1e3]: both int8 kernels give the float "
        "kernels' bits over the dequantized cache with the same plan, and "
        "the same bits over two calls")

    q = torch.randn((B, H, Dh), generator=gen, device=dev).to(bf16)
    kc, ks = quantize_kv(torch.randn((B, S, Hkv, Dh), generator=gen,
                                     device=dev))
    vc, vs = quantize_kv(torch.randn((B, S, Hkv, Dh), generator=gen,
                                     device=dev))
    rows = {}
    for name, (int8, float_, fname) in calls(q, kc, vc, ks, vs).items():
        b_ms, b_by = bound_ms(cost.decode(
            B, H, Hkv, Dh, 2, ctx, int8=True,
            page=page if "paged" in name else 0), "bfloat16")
        rows[f"{name} serve step B=8 ctx=1024"] = r = dict(
            ms=time_ms(torch, int8, 50), bf16_ms=time_ms(torch, float_, 50),
            bound_ms=b_ms, bound_by=b_by, plan=runtime.decode_plans[name])
        log("int8", f"{name} at the serve step (B=8, context 1024, n_split "
            f"{r['plan'].n_split}, L {r['plan'].L}): {r['ms']:.4f} ms, the "
            f"bf16 kernel {fname} over the dequantized cache "
            f"{r['bf16_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return rows


def int8_kernel_phase(torch):
    """The int8 decode kernels on the card: the reference sweeps with
    int8 caches (codes and scales from ``quantize_kv`` of normal data) in
    f32 and bf16, rings and rows past their length included, against the
    plain int8 versions and bit for bit against the float kernel over the
    dequantized cache (the same plan); at the main widths (B = 8 over
    4096 slots) the same at context 2048 and at rows of every length and
    wrapped rings, two calls giving the same bits; then the bf16 main
    shape timed: kernel, plain version, dequantize + bf16 kernel, SDPA
    on the dequantized gathered cache, and the bound."""
    from repro_torch.kernels import cost, ops, ref, runtime
    from repro_torch.models.attention import quantize_kv
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    deq = ref.dequantize_kv

    def rnd(shape, dtype="float32"):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(getattr(torch, dtype))

    def same_bits(name, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: the int8 kernel differs from the "
                                 f"float kernel over the dequantized cache "
                                 f"(max abs {float((got.float() - want.float()).abs().max()):.3g})")

    n_checked = 0
    for dtype in ("float32", "bfloat16"):
        for B, S, H, Hkv, Dh, ring in DECODE_SHAPES:
            q = rnd((B, H, Dh), dtype)
            kc, ks = quantize_kv(rnd((B, S, Hkv, Dh)))
            vc, vs = quantize_kv(rnd((B, S, Hkv, Dh)))
            pos = torch.tensor([S // 3, 2 * S + 5][:B] if ring else
                               [S - 1, S // 2][:B], dtype=torch.int32,
                               device=dev)
            name = f"flash_decode_int8{(B, S, H, Hkv, Dh)} {dtype}"
            got = ops.flash_decode_int8(q, kc, vc, ks, vs, pos, ring=ring)
            assert_close(torch, name, got, ref.flash_decode_int8_ref(
                q, kc, vc, ks, vs, pos, ring=ring), TOL[dtype])
            same_bits(name, got, ops.flash_decode(
                q, deq(kc, ks, q.dtype), deq(vc, vs, q.dtype), pos,
                ring=ring))
            n_checked += 1
        for B, S, H, Hkv, Dh, page, ring in PAGED_SHAPES:
            q = rnd((B, H, Dh), dtype)
            n_p = -(-S // page)
            n_pages = B * n_p + 3
            kp, ksp = quantize_kv(rnd((n_pages, page, Hkv, Dh)))
            vp, vsp = quantize_kv(rnd((n_pages, page, Hkv, Dh)))
            bt = torch.randperm(n_pages, generator=gen, device=dev)[
                :B * n_p].reshape(B, n_p).to(torch.int32)
            pos = torch.tensor([2 * S + 5, S // 3][:B] if ring else
                               [S - 1, S // 2][:B], dtype=torch.int32,
                               device=dev)
            name = f"paged_flash_decode_int8{(B, S, H, Hkv, Dh)} {dtype}"
            got = ops.paged_flash_decode_int8(q, kp, vp, ksp, vsp, bt, pos,
                                              s_len=S, ring=ring)
            assert_close(torch, name, got, ref.paged_flash_decode_int8_ref(
                q, kp, vp, ksp, vsp, bt, pos, s_len=S, ring=ring),
                TOL[dtype])
            same_bits(name, got, ops.paged_flash_decode(
                q, deq(kp, ksp, q.dtype), deq(vp, vsp, q.dtype), bt, pos,
                s_len=S, ring=ring))
            gathered = [ref.gather_paged_kv(t, bt, S).contiguous()
                        for t in (kp, vp, ksp, vsp)]
            assert_close(torch, f"{name} vs contiguous", got,
                         ops.flash_decode_int8(q, *gathered, pos, ring=ring),
                         TOL[dtype])
            n_checked += 1
    log("int8", f"{n_checked} sweep cases of the int8 decode kernels agree "
        f"with the plain int8 versions (f32 atol 1e-4 rtol 1e-3; bf16 atol "
        f"2e-2 rtol 2e-2) and give the float kernel's bits over the "
        f"dequantized cache")

    H, Hkv, Dh = MAIN["H"], MAIN["Hkv"], MAIN["Dh"]
    B, S, ctx, page = 8, 4096, 2048, 128
    n_p = S // page
    rows, worst = {}, {}
    for dt in ("float32", "bfloat16"):
        tol = MAIN_TOL[dt]
        q = rnd((B, H, Dh), dt)
        kc, ks = quantize_kv(rnd((B, S, Hkv, Dh)))
        vc, vs = quantize_kv(rnd((B, S, Hkv, Dh)))
        kd, vd = deq(kc, ks, q.dtype), deq(vc, vs, q.dtype)
        bt = torch.randperm(B * n_p, generator=gen, device=dev).reshape(
            B, n_p).to(torch.int32)
        pools = []
        for t in (kc, vc, ks, vs):
            pl = t.new_zeros((B * n_p + 1, page) + tuple(t.shape[2:]))
            pl[bt.reshape(-1).long()] = t.reshape((B * n_p, page)
                                                  + tuple(t.shape[2:]))
            pools.append(pl)
        kpd, vpd = deq(pools[0], pools[2], q.dtype), \
            deq(pools[1], pools[3], q.dtype)
        cases = [("context 2048", [ctx - 1] * B, False)] + DECODE_MIXED
        for label, posl, ring in cases:
            pos = torch.tensor(posl, dtype=torch.int32, device=dev)
            want = ref.flash_decode_int8_ref(q, kc, vc, ks, vs, pos,
                                             ring=ring)
            a, a2 = (ops.flash_decode_int8(q, kc, vc, ks, vs, pos, ring=ring)
                     for _ in range(2))
            plan8 = runtime.decode_plans["flash_decode_int8"]
            b, b2 = (ops.paged_flash_decode_int8(q, *pools, bt, pos, s_len=S,
                                                 ring=ring)
                     for _ in range(2))
            worst[f"int8 decode {label} {dt}"] = max(
                assert_close(torch, f"flash_decode_int8 {label} {dt}", a,
                             want, tol),
                assert_close(torch, f"paged_flash_decode_int8 {label} {dt}",
                             b, want, tol))
            same_bits(f"flash_decode_int8 {label} {dt}", a, ops.flash_decode(
                q, kd, vd, pos, ring=ring))
            same_bits(f"paged_flash_decode_int8 {label} {dt}", b,
                      ops.paged_flash_decode(q, kpd, vpd, bt, pos, s_len=S,
                                             ring=ring))
            if plan8 != runtime.decode_plans["flash_decode"]:
                raise AssertionError(f"int8 plan {plan8}, float plan "
                                     f"{runtime.decode_plans['flash_decode']}")
            if not (torch.equal(a, a2) and torch.equal(b, b2)):
                raise AssertionError(f"int8 decode {label} {dt}: two calls "
                                     f"on the same inputs differ")
        log("int8", f"main widths {dt}, B=8 over {S} slots ("
            f"{', '.join(c[0] for c in cases)}): both int8 kernels agree "
            f"with the plain version, give the float kernels' bits over the "
            f"dequantized cache with the same plan ({plan8.body} body, "
            f"n_split {plan8.n_split}, L {plan8.L}), and the same bits over "
            f"two calls")
        if dt == "bfloat16":
            pos = torch.full((B,), ctx - 1, dtype=torch.int32, device=dev)
            code_bytes = 2 * B * ctx * Hkv * Dh
            scale_bytes = 2 * 4 * B * ctx * Hkv
            dmask = (torch.arange(S, device=dev)[None]
                     <= pos[:, None])[:, None, None]
            q4, kt, vt = q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)
            sdpa_ms = time_ms(torch, lambda: sdpa(
                q4, kt, vt, attn_mask=dmask, enable_gqa=True), 20)
            want = ref.flash_decode_int8_ref(q, kc, vc, ks, vs, pos)
            for name, call, plain, dq, tables in (
                    ("flash_decode_int8 B=8 ctx=2048",
                     lambda: ops.flash_decode_int8(q, kc, vc, ks, vs, pos),
                     lambda: ref.flash_decode_int8_ref(q, kc, vc, ks, vs,
                                                       pos),
                     lambda: ops.flash_decode(q, deq(kc, ks, q.dtype),
                                              deq(vc, vs, q.dtype), pos),
                     dict()),
                    ("paged_flash_decode_int8 B=8 ctx=2048 page=128",
                     lambda: ops.paged_flash_decode_int8(q, *pools, bt, pos,
                                                         s_len=S),
                     lambda: ref.paged_flash_decode_int8_ref(
                         q, *pools, bt, pos, s_len=S),
                     lambda: ops.paged_flash_decode(
                         q, deq(pools[0], pools[2], q.dtype),
                         deq(pools[1], pools[3], q.dtype), bt, pos, s_len=S),
                     dict(page=page))):
                err = assert_close(torch, name, call(), want, tol)
                b_ms, b_by = bound_ms(cost.decode(B, H, Hkv, Dh, 2, ctx,
                                                  int8=True, **tables), dt)
                kernel = name.split()[0]
                rows[name] = dict(
                    ms=time_ms(torch, call, 50),
                    plain_ms=time_ms(torch, plain, 10),
                    dequant_ms=time_ms(torch, dq, 20),
                    library_ms=sdpa_ms, bound_ms=b_ms, bound_by=b_by,
                    max_abs_err=err, plan=runtime.decode_plans[kernel],
                    code_bytes=code_bytes, scale_bytes=scale_bytes)
            decode_split_sweep(torch, q, kc, vc,
                               rows["flash_decode_int8 B=8 ctx=2048"]
                               ["plan"].L, scales=(ks, vs))
        del q, kc, vc, ks, vs, kd, vd, pools, kpd, vpd
        torch.cuda.empty_cache()
    log("int8", "max abs err: " + "; ".join(f"{k} {v:.3g}"
                                            for k, v in worst.items()))
    rows.update(int8_serve_step_rows(torch, gen))

    # the chunk path: a 512-token chunk at offset 1536 of a 4096-slot int8
    # cache dequantizes its 2048 live slots of K and V in torch, then runs
    # flash_prefill on them unchanged (a layer's share of a chunk)
    Tc, off = 512, 1536
    live = off + Tc
    q = rnd((1, Tc, H, Dh), "bfloat16")
    kc, ks = quantize_kv(rnd((1, S, Hkv, Dh)))
    vc, vs = quantize_kv(rnd((1, S, Hkv, Dh)))

    def dequant():
        return (deq(kc[:, :live], ks[:, :live], q.dtype),
                deq(vc[:, :live], vs[:, :live], q.dtype))
    kd, vd = dequant()
    err = assert_close(torch, "flash_prefill over the dequantized prefix",
                       ops.flash_prefill(q, kd, vd, q_offset=off),
                       ref.flash_prefill_ref(q, kd, vd, q_offset=off),
                       MAIN_TOL["bfloat16"])
    deq_ms = time_ms(torch, dequant, 20)
    pre_ms = time_ms(torch, lambda: ops.flash_prefill(q, kd, vd,
                                                      q_offset=off), 10)

    def dequant_all():
        return deq(kc, ks, q.dtype), deq(vc, vs, q.dtype)
    kf, vf = dequant_all()
    full_out = ops.flash_prefill(q, kf, vf, q_offset=off)
    if not torch.equal(full_out, ops.flash_prefill(q, kd, vd, q_offset=off)):
        raise AssertionError("int8 chunk: flash_prefill over the whole "
                             "dequantized cache differs from over its live "
                             "prefix")
    full_ms = time_ms(torch, dequant_all, 20)
    log("int8", f"int8 chunk path, Tc {Tc} at q_offset {off} over {S} "
        f"slots (bf16, H={H} Hkv={Hkv} Dh={Dh}): dequantize the {live} "
        f"live slots of K and V {deq_ms:.4f} ms, flash_prefill on them "
        f"{pre_ms:.4f} ms (max abs err {err:.3g}); dequantize moves "
        f"{2 * live * Hkv * (Dh + 4 + 2 * Dh)} B; the engine's fixed-size "
        f"dequantize of all {S} slots (one graph for every offset, as the "
        f"reference) {full_ms:.4f} ms, moving "
        f"{2 * S * Hkv * (Dh + 4 + 2 * Dh)} B, flash_prefill over it the "
        f"same bits")
    del q, kc, vc, ks, vs, kd, vd, kf, vf
    rows["int8 chunk dequantize"] = dict(dequant_ms=deq_ms,
                                         dequant_full_ms=full_ms,
                                         prefill_ms=pre_ms)
    for name, r in rows.items():
        if "plain_ms" not in r:
            continue
        p = r["plan"]
        log("int8", f"{name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, dequantize + bf16 kernel "
            f"{r['dequant_ms']:.4f} ms, sdpa on the dequantized gathered "
            f"cache {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {r['code_bytes']} B of codes, "
            f"{r['scale_bytes']} B of scales); n_split {p.n_split}, L "
            f"{p.L}, {p.body} body; max abs err {r['max_abs_err']:.3g}")
    return rows


PREFILL_PHASES = ("load wait", "issue", "S wait", "softmax", "P.V wait",
                  "rescale+split")


def prefill_phase_profile(torch):
    """Where the prefill tensor-core body's time goes at the two bf16
    main-path shapes: ``csrc/flash_prefill.cu`` built alone with
    ``-DRT_PREFILL_PHASES`` (not the library the port runs), whose
    blocks add the clock cycles thread 0 spends in each phase of the key
    loop.  Launched through the C entry directly, so no launch count
    moves."""
    import ctypes
    from repro_torch.kernels import runtime
    lib = ctypes.CDLL(str(runtime.build(sources=("flash_prefill.cu",),
                                        defines=("RT_PREFILL_PHASES",))))
    fn, read = lib.rt_flash_prefill, lib.rt_prefill_phases
    fn.argtypes = runtime._SIGNATURES["rt_flash_prefill"]
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = read.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    H, Hkv, Dh = MAIN["H"], MAIN["Hkv"], MAIN["Dh"]
    n = len(PREFILL_PHASES)
    for label, Tq, Tk, off in (("T=2048", 2048, 2048, 0),
                               ("chunk 512@1536/4096", 512, 4096, 1536)):
        q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                   for shape in ((1, Tq, H, Dh), (1, Tk, Hkv, Dh),
                                 (1, Tk, Hkv, Dh)))
        out = torch.empty_like(q)

        off_t = torch.full((), off, dtype=torch.int32, device=dev)

        def call():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                     out.data_ptr(), 1, Tq, Tk, H, Hkv, Dh, 1, 0,
                     off_t.data_ptr(), runtime.DTYPE_CODES[torch.bfloat16],
                     runtime.stream_ptr(dev))
            if err:
                raise RuntimeError(f"instrumented flash_prefill: error {err}")
        call()
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * (n + 2))()
        if read(None, 1):
            raise RuntimeError("rt_prefill_phases reset failed")
        call()
        torch.cuda.synchronize()
        if read(ctypes.addressof(counts), 0):
            raise RuntimeError("rt_prefill_phases read failed")
        tiles, blocks = counts[n], counts[n + 1]
        cyc = [counts[i] / tiles for i in range(n)]
        ms = time_ms(torch, call, 10)
        log("profile", f"flash_prefill tensor-core body, {label}, "
            f"instrumented build {ms:.4f} ms: {blocks} blocks, "
            f"{tiles / blocks:.1f} key tiles a block; clock cycles a tile "
            f"(thread 0 of a block) " + ", ".join(
                f"{p} {c:.0f}" for p, c in zip(PREFILL_PHASES, cyc))
            + f"; {sum(cyc):.0f} in all")


def wkv6_phase(torch):
    """wkv6 against its plain version on the card: the reference sweep
    and the two decay extremes in f32 and bf16, a ragged T (off the
    16-step tile), then rwkv6-3b's chunk of 512 and decode step (8 rows,
    40 heads of 64) and the chunk at a ``--model 4`` rank's 10 heads,
    checked with f32 and bf16 r/k/v (the state written
    over s0, as the model does), the chunk bit-identical over two calls,
    and timed in bf16; then the tile sweep (``wkv6_tile_sweep``).  The
    wrapper's split rule must be the C launch's."""
    from repro_torch.kernels import cost, ops, ref
    from repro_torch.kernels import wkv6 as wk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    check_wkv6_plan_rule()

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def inputs(B, T, H, hs, dtype, w):
        r, k, v = (rnd((B, T, H, hs)).to(dtype) for _ in range(3))
        return r, k, v, w, rnd((H, hs), 0.1), rnd((B, H, hs, hs), 0.1)

    def check(name, args):
        y, sT = ops.wkv6(*args)
        want_y, want_s = ref.wkv6_ref(*args)
        return max(assert_close(torch, f"{name} y", y, want_y, WKV_TOL),
                   assert_close(torch, f"{name} sT", sT, want_s, WKV_TOL))

    def check_weak(name, args):
        """Weak decay over 512 steps: the state grows to ~1/(1-w) = 400
        steps of k v, and y is a 64-term sum of such terms that can cancel
        to near 0, where the two f32 summation orders differ by more than
        atol 1e-4 (1.72e-4 measured on the card).  There the kernel must
        be as exact as the plain version: its error against a float64
        evaluation at most twice the plain version's."""
        y, sT = ops.wkv6(*args)
        want_y, want_s = ref.wkv6_ref(*args)
        exact, _ = ref.wkv6_ref(*(a.double() for a in args))
        err_k = float((y.double() - exact).abs().max())
        err_p = float((want_y.double() - exact).abs().max())
        if not torch.isfinite(y).all() or err_k > 2 * err_p + 1e-6:
            raise AssertionError(f"{name}: max abs err vs float64 kernel "
                                 f"{err_k:.3g}, plain {err_p:.3g}")
        assert_close(torch, f"{name} sT", sT, want_s, WKV_TOL)
        log("kernels", f"{name}: max |y| {float(exact.abs().max()):.4g}; "
            f"max abs err vs float64: kernel {err_k:.3g}, plain {err_p:.3g}; "
            f"kernel vs plain {float((y - want_y).abs().max()):.3g}")
        return float((y - want_y).abs().max())

    n_checked, worst = 0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, H, hs in WKV_SHAPES:
            w = torch.sigmoid(rnd((B, T, H, hs))).to(dtype).float()
            check(f"wkv6{(B, T, H, hs)} {dtype}",
                  inputs(B, T, H, hs, dtype, w))
            n_checked += 1
        for name, decay in WKV_DECAYS.items():
            B, T, H, hs = 2, 512, 4, 64
            w = torch.full((B, T, H, hs), decay, device=dev)
            worst[f"{name} decay {dtype}"] = \
                (check_weak if name == "weak" else check)(
                    f"wkv6 {name} decay {dtype}",
                    inputs(B, T, H, hs, dtype, w))
            n_checked += 1
    log("kernels", f"wkv6: {n_checked} sweep and decay cases agree with the "
        f"plain version (atol 1e-4 rtol 1e-3, f32 and bf16 r/k/v; the weak "
        f"decay against float64, above); max abs err vs plain "
        + "; ".join(f"{k} {v:.3g}" for k, v in worst.items()))

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        B, T, H, hs = WKV_RAGGED
        w = torch.sigmoid(rnd((B, T, H, hs)))
        r, k, v, w, u, s0 = inputs(B, T, H, hs, dtype, w)
        want_y, want_s = ref.wkv6_ref(r, k, v, w, u, s0)
        state = s0.clone()
        y, _ = ops.wkv6(r, k, v, w, u, state, state_out=state)
        worst[f"ragged T={T} {dtype}"] = max(
            assert_close(torch, f"wkv6 ragged T={T} y", y, want_y, WKV_TOL),
            assert_close(torch, f"wkv6 ragged T={T} sT", state, want_s,
                         WKV_TOL))
    B, T, hs = (WKV_MAIN[k] for k in ("B", "T", "hs"))
    cases = ((f"wkv6 chunk B={B} T={T}", T, WKV_MAIN["H"]),
             (f"wkv6 decode B={B}", 1, WKV_MAIN["H"]),
             (f"wkv6 chunk B={B} T={T} H={WKV_RANK_H}", T, WKV_RANK_H))
    for dtype in (torch.float32, torch.bfloat16):
        for label, TT, H in cases:
            # the model's decay: exp(-exp(w0 + lora)), w0 = -0.5
            w = torch.exp(-torch.exp(rnd((B, TT, H, hs)) - 0.5))
            r, k, v, w, u, s0 = inputs(B, TT, H, hs, dtype, w)
            s0 = rnd((B, H, hs, hs))
            want_y, want_s = ref.wkv6_ref(r, k, v, w, u, s0)
            state = s0.clone()
            y, _ = ops.wkv6(r, k, v, w, u, state, state_out=state)
            err = max(assert_close(torch, f"{label} y", y, want_y, WKV_TOL),
                      assert_close(torch, f"{label} sT", state, want_s,
                                   WKV_TOL))
            worst[f"{label} {dtype}"] = err
            if TT > 1:
                y1, s1 = ops.wkv6(r, k, v, w, u, s0)
                y2, s2 = ops.wkv6(r, k, v, w, u, s0)
                if not (torch.equal(y1, y2) and torch.equal(s1, s2)):
                    raise AssertionError(f"{label} {dtype}: two calls on "
                                         f"the same inputs differ")
            if dtype != torch.bfloat16:
                continue
            b_ms, b_by = bound_ms(cost.wkv6(B, TT, H, hs, 2), "float32")
            rows[label] = dict(
                ms=time_ms(torch, lambda: ops.wkv6(r, k, v, w, u, s0),
                           20 if TT > 1 else 100),
                plain_ms=time_ms(torch, lambda: ref.wkv6_ref(
                    r, k, v, w, u, s0), 3 if TT > 1 else 20, 1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err, plan=wk.plan(B, H, hs, TT))
            if H == WKV_MAIN["H"]:
                wkv6_tile_sweep(torch, label, (r, k, v, w, u, s0), want_y)
    log("kernels", "wkv6 main-path shapes and the ragged T agree with the "
        "plain version (atol 1e-4 rtol 1e-3), the chunk bit-identical over "
        "two calls; max abs err: " + "; ".join(
            f"{k} {v:.3g}" for k, v in worst.items() if "=" in k))
    for name, r in rows.items():
        p = r["plan"]
        log("kernels", f"{name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library null (no single PyTorch call "
            f"computes this recurrence), max abs err {r['max_abs_err']:.3g}; "
            f"tile {p.kr} rows x {p.vc} columns a thread, {p.cols} columns "
            f"a block")
    return rows


def check_wkv6_plan_rule() -> None:
    """The wrapper's split rule (``kernels/wkv6.py:plan``) is the one the
    C launch applies (``rt_wkv6_plan``)."""
    import ctypes
    from repro_torch.kernels import runtime
    from repro_torch.kernels import wkv6 as wk
    lib = runtime.library()
    out = (ctypes.c_int * 3)()
    for hs in wk.HEAD_SIZES:
        for B, H in ((1, 1), (2, 4), (8, 40), (1, 40), (64, 40)):
            for T in (0, 1, 512):
                if lib.rt_wkv6_plan(B, H, hs, T, out) or \
                        tuple(out) != tuple(wk.plan(B, H, hs, T)):
                    raise AssertionError(
                        f"wkv6 plan of B={B} H={H} hs={hs} T={T}: C "
                        f"{tuple(out)}, wrapper {wk.plan(B, H, hs, T)}")


def wkv6_tile_sweep(torch, label, args, want_y):
    """Device time of the wkv6 kernel at the plan's tile and the tiles
    around it (rows a thread halved or doubled, columns a thread halved,
    half a head a block), each checked against the plain version.
    Launched through the C entry directly (``rt_wkv6_tile``), so no
    launch count moves."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels import wkv6 as wk
    r, k, v, w, u, s0 = args
    B, T, H, hs = r.shape
    p0 = wk.plan(B, H, hs, T)
    lib = runtime.library()
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    sT = torch.empty_like(s0)
    res = []
    for p in WKV_SWEEP:
        p = wk.WkvPlan(*p)

        def call():
            err = lib.rt_wkv6_tile(
                *(x.data_ptr() for x in (r, k, v, w, u, s0, y, sT)), B, T,
                H, hs, runtime.DTYPE_CODES[r.dtype], *p,
                runtime.stream_ptr(r.device))
            if err:
                raise RuntimeError(f"wkv6 tile {tuple(p)}: error {err}")
        call()
        assert_close(torch, f"{label} tile {tuple(p)}", y, want_y, WKV_TOL)
        res.append(f"{p.kr}x{p.vc}, {p.cols} columns a block"
                   f"{' (plan)' if p == p0 else ''} "
                   f"{time_ms(torch, call, 20 if T > 1 else 100):.4f} ms")
    log("kernels", f"{label} tile sweep (rows x columns a thread), bf16: "
        + "; ".join(res))


# wkv6's backward kernel against ref.wkv6_bwd_ref: each gradient within a
# tolerance relative to its largest magnitude (f32 sums in another order
# over up to 512 steps; one bf16 rounding of dr, dk, dv in bf16)
WKV_BWD_REL = {"float32": 1e-4, "bfloat16": 8e-3}
WKV_BWD_NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")
# (B, T, H, hs): T = 1, T off the 8-step checkpoint interval, T = 0, and
# a --model 4 rank's 10 heads
WKV_BWD_RAGGED = [(2, 1, 4, 64), (2, 17, 4, 64), (2, 37, WKV_RANK_H, 64),
                  (3, 5, 1, 16), (2, 0, 4, 64)]


def wkv6_bwd_check(torch, name, args, dy, dsT):
    """``ops.wkv6_bwd`` (one launch) against ``ref.wkv6_bwd_ref`` on the
    same tensors; returns the largest absolute error and the largest
    error relative to its gradient's largest magnitude."""
    from repro_torch.kernels import ops, ref, runtime
    n0 = runtime.launch_counts["wkv6_bwd"]
    got = ops.wkv6_bwd(*args, dy, dsT)
    torch.cuda.synchronize()
    if runtime.launch_counts["wkv6_bwd"] != n0 + 1:
        raise AssertionError(f"{name}: wkv6_bwd not launched once")
    want = ref.wkv6_bwd_ref(*args, dy, dsT)
    worst, worst_abs = 0.0, 0.0
    for g_name, g, w in zip(WKV_BWD_NAMES, got, want):
        if g.dtype != w.dtype or g.shape != w.shape or \
                not torch.isfinite(g).all():
            raise AssertionError(f"{name} {g_name}: {g.dtype} "
                                 f"{tuple(g.shape)} against {w.dtype} "
                                 f"{tuple(w.shape)}, or not finite")
        if not w.numel():
            continue
        scale = float(w.abs().max())
        err = float((g.double() - w.double()).abs().max())
        rel = WKV_BWD_REL["bfloat16" if g.dtype == torch.bfloat16
                          else "float32"]
        if err > rel * scale + 1e-30:
            raise AssertionError(f"{name} {g_name}: max abs err {err:.4g} "
                                 f"over {rel} x max |plain| {scale:.4g}")
        worst = max(worst, err / scale if scale else 0.0)
        worst_abs = max(worst_abs, err)
    return worst_abs, worst


def check_wkv6_bwd_plan_rule() -> None:
    """The wrapper's cluster rule (``kernels/wkv6.py:bwd_plan``) is the
    one the backward's C launch applies (``rt_wkv6_bwd_plan``)."""
    import ctypes
    from repro_torch.kernels import runtime
    from repro_torch.kernels import wkv6 as wk
    lib = runtime.library()
    out = (ctypes.c_int * 2)()
    for hs in wk.HEAD_SIZES:
        for B, H in ((1, 1), (2, 40), (8, 10), (8, 40), (1, 263), (1, 264)):
            for T in (0, 512, 4095):
                if lib.rt_wkv6_bwd_plan(B, H, hs, T, out) or \
                        tuple(out) != tuple(wk.bwd_plan(B, H, hs, T)):
                    raise AssertionError(
                        f"wkv6_bwd plan of B={B} H={H} hs={hs} T={T}: C "
                        f"{tuple(out)}, wrapper {wk.bwd_plan(B, H, hs, T)}")


def wkv6_bwd_plan_info(torch, B, H, hs, T, nc=None):
    """The backward's launch at a shape (the plan's cluster size, or
    ``nc``): cluster size, threads and blocks, shared memory a block,
    registers a thread, and the blocks an SM holds at once
    (``cudaOccupancyMaxActiveClusters`` times the cluster size over the
    SMs), from ``rt_wkv6_bwd_occupancy``."""
    import ctypes
    from repro_torch.kernels import runtime
    from repro_torch.kernels import wkv6 as wk
    nc = wk.bwd_plan(B, H, hs, T).nc if nc is None else nc
    out = (ctypes.c_int * 4)()
    err = runtime.library().rt_wkv6_bwd_occupancy(
        hs, runtime.DTYPE_CODES[torch.bfloat16], nc, out)
    if err:
        raise RuntimeError(f"rt_wkv6_bwd_occupancy hs={hs} nc={nc}: {err}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(nc=nc, threads=out[0], blocks=B * H * nc, smem_bytes=out[1],
                registers=out[3], blocks_an_sm=out[2] * nc / sms)


def wkv6_bwd_plan_text(p) -> str:
    return (f"NC {p['nc']} ({p['threads']} threads, {p['blocks']} blocks, "
            f"{p['smem_bytes']} B shared and {p['registers']} registers a "
            f"thread, {p['blocks_an_sm']:.2f} blocks an SM)")


def wkv6_bwd_body(row) -> str:
    """The kernels line's body of a ``wkv6_bwd`` row: the design and the
    row's plan."""
    return f"{WKV6_BWD_BODY}; {wkv6_bwd_plan_text(row['plan'])}"


def wkv6_bwd_plan_sweep(torch, label, args, dy):
    """Device time of the backward at every cluster size its head size
    takes (``wkv6.bwd_valid``), each checked against
    ``ref.wkv6_bwd_ref`` within ``WKV_BWD_REL``.  Launched through the
    sweep's entry (``wkv6.wkv6_bwd_nc``), so no launch count moves."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wk
    B, T, H, hs = args[0].shape
    want = ref.wkv6_bwd_ref(*args, dy)
    p0 = wk.bwd_plan(B, H, hs, T).nc
    res = []
    for nc in wk.BWD_CLUSTERS:
        if not wk.bwd_valid(hs, nc):
            continue
        out = wk.wkv6_bwd_nc(*args, dy, None, nc)
        torch.cuda.synchronize()
        for g_name, g, want_g in zip(WKV_BWD_NAMES, out, want):
            scale = float(want_g.abs().max())
            rel = WKV_BWD_REL["bfloat16" if g.dtype == torch.bfloat16
                              else "float32"]
            if not torch.isfinite(g).all() or float(
                    (g.double() - want_g.double()).abs().max()) > \
                    rel * scale + 1e-30:
                raise AssertionError(f"{label} NC {nc} {g_name}: beyond "
                                     f"{rel} of max |plain| {scale:.4g}")
        del out
        ms = time_ms(torch, lambda: wk.wkv6_bwd_nc(*args, dy, None, nc), 10)
        res.append(f"NC {nc}{' (plan)' if nc == p0 else ''} {ms:.4f} ms, "
                   + wkv6_bwd_plan_text(wkv6_bwd_plan_info(torch, B, H, hs,
                                                           T, nc)))
    log("kernels", f"{label} plan sweep (cluster size), bf16, each against "
        f"ref.wkv6_bwd_ref: " + "; ".join(res))
    del want


def wkv6_bwd_phase(torch):
    """``wkv6``'s backward kernel (``csrc/wkv6_bwd.cu``) against its plain
    version ``ref.wkv6_bwd_ref`` on the card: the reference sweep and the
    two decay extremes in f32 and bf16, with dsT given and absent; T = 1,
    T off the 8-step checkpoint interval and T = 0, s0 zero and padded
    steps (k = 0, w = 1), a ``--model 4`` rank's 10 heads; then
    rwkv6-3b's chunk (B 8, T 512, 40 heads of 64, the model's decay, dsT
    absent as in training) and the same at 10 heads, bit-identical over
    two calls, and in bf16 timed beside its bound (``cost.wkv6_bwd``)
    and the plain versions (``ref.wkv6_bwd_ref``; autograd through
    ``ref.wkv6_ref``, forward and backward)."""
    from repro_torch.kernels import cost, ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    check_wkv6_bwd_plan_rule()

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def inputs(B, T, H, hs, dtype, w, s0=True):
        r, k, v = (rnd((B, T, H, hs)).to(dtype) for _ in range(3))
        s = rnd((B, H, hs, hs), 0.1) if s0 else \
            torch.zeros((B, H, hs, hs), device=dev)
        return r, k, v, w, rnd((H, hs), 0.1), s

    def grads(B, T, H, hs, with_dsT=True):
        return (rnd((B, T, H, hs)),
                rnd((B, H, hs, hs)) if with_dsT else None)
    worst, n = {}, 0

    def note(key, errs):
        worst[key] = max(worst.get(key, 0.0), errs[1])
    for dtype in (torch.float32, torch.bfloat16):
        for with_dsT in (True, False):
            for B, T, H, hs in WKV_SHAPES:
                w = torch.sigmoid(rnd((B, T, H, hs)))
                note(f"sweep {dtype}", wkv6_bwd_check(
                    torch, f"wkv6_bwd{(B, T, H, hs)} {dtype}",
                    inputs(B, T, H, hs, dtype, w),
                    *grads(B, T, H, hs, with_dsT)))
                n += 1
            for name, decay in WKV_DECAYS.items():
                B, T, H, hs = 2, 512, 4, 64
                w = torch.full((B, T, H, hs), decay, device=dev)
                note(f"{name} decay {dtype}", wkv6_bwd_check(
                    torch, f"wkv6_bwd {name} decay {dtype}",
                    inputs(B, T, H, hs, dtype, w),
                    *grads(B, T, H, hs, with_dsT)))
                n += 1
        for B, T, H, hs in WKV_BWD_RAGGED:
            for s0 in (True, False):
                w = torch.sigmoid(rnd((B, T, H, hs)))
                r, k, v, w, u, s = inputs(B, T, H, hs, dtype, w, s0)
                if T > 4:                  # padded steps, as models/rwkv.py
                    k[:, -3:], w[:, -3:] = 0.0, 1.0
                note(f"ragged {dtype}", wkv6_bwd_check(
                    torch, f"wkv6_bwd{(B, T, H, hs)} {dtype} s0 {s0}",
                    (r, k, v, w, u, s), *grads(B, T, H, hs)))
                n += 1
    log("kernels", f"wkv6_bwd: {n} cases agree with ref.wkv6_bwd_ref "
        f"(each gradient within {WKV_BWD_REL['float32']} of its largest "
        f"magnitude, bf16 dr/dk/dv {WKV_BWD_REL['bfloat16']}); largest "
        f"relative error: " + "; ".join(f"{k} {v:.3g}"
                                        for k, v in worst.items()))
    rows = {}
    B, T, hs = (WKV_MAIN[k] for k in ("B", "T", "hs"))
    for H in (WKV_MAIN["H"], WKV_RANK_H):
        label = f"wkv6_bwd chunk B={B} T={T}" + (
            f" H={H}" if H != WKV_MAIN["H"] else "")
        w = torch.exp(-torch.exp(rnd((B, T, H, hs)) - 0.5))
        args = inputs(B, T, H, hs, torch.bfloat16, w)
        dy, _ = grads(B, T, H, hs)
        err, rel = wkv6_bwd_check(torch, label, args, dy, None)
        one, two = ops.wkv6_bwd(*args, dy), ops.wkv6_bwd(*args, dy)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(one, two)):
            raise AssertionError(f"{label}: two calls differ")
        del one, two
        req = [a.detach().float().requires_grad_(True) for a in args]

        def plain_autograd():
            return torch.autograd.grad(ref.wkv6_ref(*req)[0], req, dy)
        b_ms, b_by = bound_ms(cost.wkv6_bwd(B, T, H, hs, 2,
                                            state_grad=False), "float32")
        rows[label] = dict(
            ms=time_ms(torch, lambda: ops.wkv6_bwd(*args, dy), 10),
            plain_ms=time_ms(torch, lambda: ref.wkv6_bwd_ref(*args, dy),
                             1, 0),
            plain_autograd_ms=time_ms(torch, plain_autograd, 1, 0),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            plan=wkv6_bwd_plan_info(torch, B, H, hs, T))
        r = rows[label]
        log("kernels", f"{label} ({H} heads of {hs}, bf16, dsT absent): "
            f"kernel {wkv6_bwd_plan_text(r['plan'])} "
            f"{r['ms']:.4f} ms, plain (ref.wkv6_bwd_ref) "
            f"{r['plain_ms']:.4f} ms, autograd through ref.wkv6_ref "
            f"(forward and backward) {r['plain_autograd_ms']:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), library null (no PyTorch call "
            f"computes this recurrence's gradient); max abs err {err:.3g}, "
            f"{rel:.3g} of a gradient's largest magnitude; two calls "
            f"identical")
        if H == WKV_MAIN["H"]:
            wkv6_bwd_plan_sweep(torch, label, args, dy)
        del args, dy, req
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------- parity ---
def parity_phase(torch, kv_dtype=""):
    """Smoke qwen3-14b at f32: kernels on the card vs plain on the CPU.
    With ``kv_dtype`` "int8" the caches are int8 and the decode steps
    run the int8 decode kernels; the token ids must then be equal on the
    card and on the CPU, and the logits agree within ``INT8_SMOKE_ATOL``
    (a K/V value on a rounding boundary may take the neighbouring code on
    one side)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import runtime
    from repro_torch.models import transformer as tfm
    cfg = get_smoke_config("qwen3-14b", max_seq_len=128,
                           kv_cache_dtype=kv_dtype)
    atol = INT8_SMOKE_ATOL if kv_dtype else 1e-3
    cpu_model = tfm.init_params(cfg, seed=0, dtype=torch.float32,
                                device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    gen = torch.Generator().manual_seed(1)
    lens = torch.tensor([40, 17, 29], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (3, 40), generator=gen,
                         dtype=torch.int32)
    worst = 0.0
    runtime.reset_launch_counts()
    for paged in (False, True):
        lc, cc = tfm.prefill(cfg, cpu_model, toks, lens, cache_len=128)
        lg, cg = tfm.prefill(cfg, gpu_model, toks.cuda(), lens.cuda(),
                             cache_len=128)
        kw = {}
        if paged:
            cc, cg = to_paged(torch, tfm, cfg, cc), to_paged(torch, tfm, cfg,
                                                            cg)
            kw = dict(page_size=16, paged_len=128)
        ids_cpu, ids_gpu = [], []
        for step in range(9):
            torch.testing.assert_close(lg.cpu(), lc, atol=atol, rtol=1e-3)
            worst = max(worst, float((lg.cpu() - lc).abs().max()))
            ids_cpu.append(lc.argmax(-1).tolist())
            ids_gpu.append(lg.argmax(-1).tolist())
            if step == 8:
                break
            tok = lc.argmax(-1).to(torch.int32)      # same inputs both sides
            lc, cc = tfm.decode_step(cfg, cpu_model, tok, cc, **kw)
            lg, cg = tfm.decode_step(cfg, gpu_model, tok.cuda(), cg, **kw)
        torch.cuda.synchronize()
        if kv_dtype and ids_cpu != ids_gpu:
            raise AssertionError(f"parity {kv_dtype}: token ids cpu "
                                 f"{ids_cpu}, cuda {ids_gpu}")
        log("parity", f"{kv_dtype or 'float'} cache, "
            f"{'paged' if paged else 'contiguous'}: prefill + 8 "
            f"decode steps, logits within atol {atol:g} (f32); token ids "
            f"cpu {ids_cpu} | cuda {ids_gpu}")
    if kv_dtype:
        n8 = (runtime.launch_counts["flash_decode_int8"],
              runtime.launch_counts["paged_flash_decode_int8"])
        if n8 != (8 * cfg.n_layers,) * 2 or \
                runtime.launch_counts["flash_decode"] or \
                runtime.launch_counts["paged_flash_decode"]:
            raise AssertionError(f"parity {kv_dtype}: decode launches "
                                 f"{runtime.launch_counts}")
    log("parity", f"{kv_dtype or 'float'} cache: max abs logit difference "
        f"{worst:.3g}")


def to_paged(torch, tfm, cfg, cache, page=16, s_len=None):
    """A contiguous prefill cache moved into a paged pool (identity page
    order plus a trash page), on the cache's device; recurrent carries
    (a hybrid's RG-LRU state) and a VLM's cross K/V stay per slot.  With
    ``s_len`` past the cache's length the block tables span ``s_len``
    slots, and their entries past the cache point at the trash page."""
    from repro_torch.models.config import BLOCK_ATTN, BLOCK_MOE
    dev = cache["pos"].device
    B = cache["pos"].shape[0]
    kinds = [[b in (BLOCK_ATTN, BLOCK_MOE) for b in pat]
             for pat, _ in cfg.block_groups()]
    k0 = next(s["k"] for g, kg in zip(cache["groups"], kinds)
              for s, paged_kv in zip(g, kg) if paged_kv)
    S = k0.shape[2]
    n_p = S // page
    s_len = s_len or S
    paged = tfm.init_paged_cache(cfg, B, s_len, B * n_p + 1, page,
                                 dtype=k0.dtype, device=dev)
    paged["pos"] = cache["pos"].clone()
    bt = torch.full((B, s_len // page), B * n_p, dtype=torch.int32,
                    device=dev)
    bt[:, :n_p] = torch.arange(B * n_p, dtype=torch.int32,
                               device=dev).reshape(B, n_p)
    paged["block_tables"] = bt
    for src_g, dst_g, kg in zip(cache["groups"], paged["groups"], kinds):
        for src_s, dst_s, paged_kv in zip(src_g, dst_g, kg):
            for key, src in src_s.items():
                if not paged_kv:                     # a per-slot leaf
                    dst_s[key].copy_(src)
                    continue
                # K/V and int8 scales: (reps, B, S, Hkv[, Dh])
                dst_s[key][:, :B * n_p] = src.reshape(
                    (src.shape[0], B * n_p, page) + src.shape[3:])
    return paged


def rwkv_parity_phase(torch):
    """Smoke rwkv6-3b at f32: the wkv6 kernel on the card vs the plain
    loop on the CPU, same weights and inputs: prefill, chunked prefill in
    16-token chunks, then 8 decode steps from the chunked carries."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import runtime
    from repro_torch.models import transformer as tfm
    cfg = get_smoke_config("rwkv6-3b", max_seq_len=128)
    cpu_model = tfm.init_params(cfg, seed=0, dtype=torch.float32,
                                device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    gen = torch.Generator().manual_seed(2)
    lens = torch.tensor([40, 17, 29], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (3, 40), generator=gen,
                         dtype=torch.int32)
    ids, worst = [], 0.0

    def compare(lc, lg, what):
        nonlocal worst
        lg = lg.cpu()
        torch.testing.assert_close(lg, lc, atol=1e-4, rtol=0,
                                   msg=lambda m: f"rwkv {what}: {m}")
        worst = max(worst, float((lg - lc).abs().max()))
        a, b = lc.argmax(-1).tolist(), lg.argmax(-1).tolist()
        if a != b:
            raise AssertionError(f"rwkv {what}: token ids cpu {a} cuda {b}")
        ids.append(a)

    runtime.reset_launch_counts()
    lc, _ = tfm.prefill(cfg, cpu_model, toks, lens, cache_len=128)
    lg, _ = tfm.prefill(cfg, gpu_model, toks.cuda(), lens.cuda(),
                        cache_len=128)
    compare(lc, lg, "prefill")
    C = 16
    cc = tfm.init_cache(cfg, 3, 128, device="cpu")
    cg = tfm.init_cache(cfg, 3, 128, device="cuda")
    first_c, first_g = torch.zeros_like(lc), torch.zeros_like(lc)
    n_chunks = 0
    for s in range(0, toks.shape[1], C):
        l1, cc = tfm.prefill_chunk(cfg, cpu_model, toks[:, s:s + C], cc, s,
                                   lens)
        l2, cg = tfm.prefill_chunk(cfg, gpu_model, toks[:, s:s + C].cuda(),
                                   cg, s, lens.cuda())
        fin = ((lens - 1) >= s) & ((lens - 1) < s + C)
        first_c[fin], first_g[fin] = l1[fin], l2.cpu()[fin]
        n_chunks += 1
    compare(first_c, first_g, "chunked prefill")
    cc["pos"], cg["pos"] = lens.clone(), lens.cuda()
    tok = first_c.argmax(-1).to(torch.int32)
    for step in range(8):
        lc, cc = tfm.decode_step(cfg, cpu_model, tok, cc)
        lg, cg = tfm.decode_step(cfg, gpu_model, tok.cuda(), cg)
        compare(lc, lg, f"decode step {step}")
        tok = lc.argmax(-1).to(torch.int32)   # same inputs both sides
    torch.cuda.synchronize()
    want = cfg.n_layers * (1 + n_chunks + 8)
    if runtime.launch_counts["wkv6"] != want:
        raise AssertionError(f"rwkv parity: wkv6 launched "
                             f"{runtime.launch_counts['wkv6']} times, "
                             f"expected {want}")
    log("parity", f"rwkv6-3b smoke: prefill, {n_chunks} chunks of {C}, 8 "
        f"decode steps; logits within atol 1e-4 (f32), max abs difference "
        f"{worst:.3g}; token ids identical: {ids}; wkv6 launched {want} "
        f"times on the card")


# -------------------------------------------------------------- graph ---
GRAPH_SMOKE_LENGTHS = [40, 17, 90, 8, 60, 33, 120, 25]   # 8 requests, 4 slots


GRAPH_SMOKE_RUNS = (("qwen3-14b", True), ("qwen3-14b", False),
                    ("rwkv6-3b", False))


def graph_smoke(torch, runs=GRAPH_SMOKE_RUNS, kv_dtype="", counts_out=None,
                **overrides):
    """Smoke f32, the engine with its decode step and its prefills as CUDA
    graphs against the same engine run eagerly (neither graph) on the
    card and on the CPU: qwen3-14b on the paged and the contiguous pool
    and rwkv6-3b on its carry pool, chunk 32, 4 slots, 8 requests of 8
    new tokens.  Ids must be identical, the graph run's launch counts the
    eager run's, its decode graph replayed and one prefill graph captured
    a prefill shape.  With ``kv_dtype`` "int8" the attention configs'
    caches are int8; ``overrides`` go to every run's smoke config.
    Returns the graph runs' ids by (arch, paged), and puts their counts
    (the MoE's grouped products by route included) into ``counts_out``
    when it is given."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import runtime
    from repro_torch.models import transformer as tfm
    t0 = time.perf_counter()
    res, all_ids = [], {}
    for arch, paged in runs:
        cfg = get_smoke_config(arch, max_seq_len=128,
                               kv_cache_dtype=kv_dtype, **overrides)
        cpu_model = tfm.init_params(cfg, seed=0, dtype=torch.float32,
                                    device="cpu")
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
        ids, counts, replays, pgraph = {}, {}, 0, None
        for label, model, dev, flag in (("cpu", cpu_model, "cpu", None),
                                        ("eager", gpu_model, "cuda", False),
                                        ("graph", gpu_model, "cuda", None)):
            eng = make_engine(torch, cfg, model, 0, paged, 4, dev=dev,
                              chunk=32, hbm_bytes=2 ** 30, page=16,
                              decode_graph=flag)
            be = eng.backend
            g, pg = be.decode_graph, be.prefill_graph
            if (g is not None) != (label == "graph") or \
                    (pg is not None) != (label == "graph"):
                raise AssertionError(f"graph smoke {arch} {label}: decode "
                                     f"graph {g}, prefill graph {pg}")
            reqs = requests(GRAPH_SMOKE_LENGTHS, 8)
            runtime.reset_launch_counts()
            eng.submit(reqs)
            if len(eng.run(max_wall_s=600)) != len(reqs):
                raise AssertionError(f"graph smoke {arch} {label}: not all "
                                     f"served")
            torch.cuda.synchronize()
            counts[label] = dict(runtime.launch_counts, **{
                f"grouped/{k}": n for k, n in runtime.grouped_counts.items()},
                **{f"flash_prefill/unaligned/{k}": n for k, n in
                   runtime.prefill_unaligned_counts.items()})
            ids[label] = finished_ids(eng, reqs)
            if g is not None:
                replays, pgraph = g.replays, pg
                if not prefill_graph_ok(pg, eng.n_prefill_shapes) or \
                        not pg.captures:
                    raise AssertionError(
                        f"graph smoke {arch}: {pg.captures} prefill graphs "
                        f"captured for {eng.n_prefill_shapes} shapes")
        pool = "paged" if paged else "contiguous"
        if not ids["graph"] == ids["eager"] == ids["cpu"]:
            raise AssertionError(f"graph smoke {arch} {pool}: ids differ "
                                 f"(graph, eager, cpu): {ids}")
        if counts["graph"] != counts["eager"] or not replays:
            raise AssertionError(f"graph smoke {arch} {pool}: launches "
                                 f"graph {counts['graph']}, eager "
                                 f"{counts['eager']}; {replays} replays")
        res.append(f"{arch} {pool} {replays} decode replays, prefill graphs "
                   f"{pgraph.captures} captured / {pgraph.replays} replayed")
        all_ids[arch, paged] = ids["graph"]
        if counts_out is not None:
            counts_out[arch, paged] = counts["graph"]
    what = "".join(f" {k}={v}" for k, v in overrides.items())
    log("graph", f"smoke f32{' ' + kv_dtype if kv_dtype else ''}{what}, "
        f"decode and prefill graphs against eager on the card and the CPU, "
        f"{len(GRAPH_SMOKE_LENGTHS)} requests each: ids identical and "
        f"launch counts equal ({'; '.join(res)}) in "
        f"{time.perf_counter() - t0:.1f} s")
    return all_ids


def paper_smoke(torch):
    """Smoke llama2-13b (MHA, G = 1) at f32 through ``graph_smoke``: the
    card's ids equal the CPU's and graph equals eager, on the paged and
    the contiguous pool; then paged equals contiguous."""
    ids = graph_smoke(torch, runs=(("llama2-13b", True),
                                   ("llama2-13b", False)))
    if ids["llama2-13b", True] != ids["llama2-13b", False]:
        raise AssertionError(f"llama2-13b smoke: paged ids "
                             f"{ids['llama2-13b', True]} differ from "
                             f"contiguous {ids['llama2-13b', False]}")
    log("graph", "smoke f32 llama2-13b (G = 1): paged ids equal contiguous "
        f"for {len(ids['llama2-13b', True])} requests")


GRAPH_MODES = {"eager": dict(decode_graph=False, prefill_graph=False),
               "decode graph": dict(decode_graph=None, prefill_graph=False),
               "graph": dict(decode_graph=None, prefill_graph=None)}


def prefill_graph_ok(pg, n_shapes: int) -> bool:
    """The engine's ``PrefillGraph`` met ``n_shapes`` prefill shapes: one
    eager run each, one capture for each shape met twice, and every
    later call of a shape a replay."""
    met = pg.met.values()
    return (len(pg.met) == n_shapes == pg.eager_runs
            and pg.captures == len(pg) == sum(n >= 2 for n in met)
            and pg.replays == sum(n - 2 for n in met if n > 2))


def prefill_graph_stats(eng, label, want_replays=False):
    """The prefill graphs' bookkeeping after a run with them
    (``prefill_graph_ok``), and replays when ``want_replays``."""
    pg = eng.backend.prefill_graph
    n = eng.n_prefill_shapes
    stats = dict(prefill_captures=pg.captures, prefill_replays=pg.replays,
                 prefill_eager=pg.eager_runs,
                 prefill_pool_bytes=pg.pool_bytes,
                 prefill_capture_s=pg.capture_seconds, prefill_shapes=n,
                 prefill_graphs=len(pg))
    if not prefill_graph_ok(pg, n) or (want_replays and not pg.replays):
        raise AssertionError(f"{label}: prefill graphs {stats}")
    return stats


def serve_pair(torch, cfg, make_eng, lengths, max_new, label,
               modes=("eager", "graph"), want_replays=False, ids_out=None):
    """The same requests served by engines in each of ``modes``
    (``GRAPH_MODES``: eager, with the decode graph alone, with the decode
    and the prefill graphs), in turn; ``make_eng(**graphs)`` builds one.
    Token ids and launch counts must be identical in every mode, and a
    paged pool must get every page back.  Returns the last mode's counts,
    every run's stats (with the decode graph's capture seconds and
    private pool bytes, and the prefill graphs' captures, replays, pool
    bytes and capture seconds beside the prefill shapes) and the last
    run's prefill chunks and decode steps; ``ids_out`` (a dict) receives
    the token ids by request."""
    runs = {}
    for mode in modes:
        eng = make_eng(**GRAPH_MODES[mode])
        g, pg = eng.backend.decode_graph, eng.backend.prefill_graph
        if (g is not None) != (mode != "eager") or \
                (pg is not None) != (mode == "graph"):
            raise AssertionError(f"{label} {mode}: decode graph {g}, "
                                 f"prefill graph {pg}")
        reqs = requests(lengths, max_new)
        counts, stats, steps = serve_run(torch, cfg, eng, reqs,
                                         f"{label}, {mode}")
        be = eng.backend
        if be.paged and be.free_blocks() != be.alloc.n_pages:
            raise AssertionError(f"{label} {mode}: paged pool leaked pages")
        if g is not None:
            if g.replays != steps["decode"]:
                raise AssertionError(f"{label}: {g.replays} replays for "
                                     f"{steps['decode']} decode steps")
            stats.update(capture_s=g.capture_seconds,
                         graph_pool_bytes=g.pool_bytes)
        if pg is not None:
            stats.update(prefill_graph_stats(eng, f"{label} {mode}",
                                             want_replays))
        runs[mode] = (counts, stats, steps, finished_ids(eng, reqs))
        del eng, be, g, pg
        gc.collect()
        torch.cuda.empty_cache()
    ce, se, ste, ide = runs[modes[0]]
    for mode in modes[1:]:
        cg, sg, stg, idg = runs[mode]
        if idg != ide:
            bad = [(rid, next(i for i, (a, b) in enumerate(zip(ide[rid],
                                                              idg[rid]))
                              if a != b))
                   for rid in ide if ide[rid] != idg[rid]]
            raise AssertionError(f"{label}: {mode} ids differ from "
                                 f"{modes[0]} for {len(bad)} requests (rid, "
                                 f"first divergent token): {bad}")
        if cg != ce or stg != ste:
            raise AssertionError(f"{label}: {mode} launches {cg} steps "
                                 f"{stg}, {modes[0]} {ce} {ste}")
    cg, sg, stg, idg = runs[modes[-1]]
    if ids_out is not None:
        ids_out.update(idg)
    pre = ""
    if "prefill_captures" in sg:
        pre = (f"; prefill graphs {sg['prefill_captures']} captured for "
               f"{sg['prefill_shapes']} shapes, {sg['prefill_replays']} "
               f"replays, pool {sg['prefill_pool_bytes']} B, capture "
               f"{sg['prefill_capture_s']:.3f} s")
    log("graph", f"{label}: ids identical in every mode "
        f"({', '.join(modes)}) for {len(idg)} requests, launch counts "
        f"equal; decode graph capture {sg['capture_s']:.3f} s, private "
        f"pool {sg['graph_pool_bytes']} B{pre}; " + ", ".join(
            f"{m} TTFT p50 {runs[m][1]['ttft_p50']:.3f} s p99 "
            f"{runs[m][1]['ttft_p99']:.3f} s TPOT p50 "
            f"{runs[m][1]['tpot_p50'] * 1e3:.1f} ms {runs[m][1]['tok_s']:.1f}"
            f" tok/s" for m in modes))
    return cg, {m: runs[m][1] for m in modes}, stg


# -------------------------------------------------------------- serve ---
SERVE_LENGTHS =[64, 2048, 300, 1024, 128, 1536, 512, 96, 1800, 700, 256,
                 1200]
ATTENTION_KERNELS = ("flash_prefill", "paged_flash_decode", "flash_decode")


def make_model(torch, arch, cfg):
    """Full-width bf16 weights from a seeded generator on the card, and a
    full-width forward that must give finite logits of the right shape."""
    from repro_torch.models import transformer as tfm
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    params = list(model.parameters())
    wbytes = sum(p.numel() * p.element_size() for p in params)
    n_f32 = sum(p.numel() for p in params if p.dtype == torch.float32)
    log("serve", f"{arch} full width: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{sum(p.numel() for p in params) / 1e9:.3f} B parameters "
        f"({n_f32 / 1e6:.2f} M of them f32, the rest bf16), "
        f"{wbytes / 1e9:.2f} GB made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    toks = torch.randint(0, cfg.vocab_size, (1, 64), device=dev,
                         dtype=torch.int32)
    logits, cache = tfm.prefill(cfg, model, toks, cache_len=128)
    if logits.shape != (1, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"{arch}: full-width logits "
                             f"{tuple(logits.shape)} not finite / wrong "
                             f"shape")
    return model, wbytes


def requests(lengths, max_new):
    from repro_torch.core import Request, TaskType
    return [Request(rid=i, prompt_len=L, max_new_tokens=max_new,
                    arrival=0.0, task_type=TaskType.ONLINE)
            for i, L in enumerate(lengths)]


def make_engine(torch, cfg, model, wbytes, paged, slots, pool_tokens=None,
                dev="cuda", chunk=512, hbm_bytes=None, page=128,
                goodput=False, sched=None, batch=None, **options):
    """A ``ServingEngine`` budgeted with the device's memory unless
    ``hbm_bytes`` is given, under the BucketServe scheduler (the goodput
    scheduler with ``goodput``) capped at ``batch`` requests a batch
    (default ``slots``), or under ``sched`` when one is given, whose cap
    ``batch`` must then name; the batch prefill cache is allocated at
    construction with that many rows;
    ``options`` passes the engine's other options (KV retention,
    ``slice_tokens``, ``fault_plan``, ``tracer``); ``prefill_graph``
    follows ``decode_graph`` unless it is given: an eager run is eager
    in both, a graph run captures both."""
    from repro_torch.core import (BucketServeScheduler, GoodputScheduler,
                                  MemoryBudget, SchedulerConfig)
    from repro_torch.core.engine import ServingEngine
    from repro_torch.launch.serve import device_memory_bytes
    dev = torch.device(dev)
    if sched is None:
        budget = MemoryBudget(
            hbm_bytes_per_device=hbm_bytes or device_memory_bytes(dev),
            n_devices=1, weight_bytes=wbytes)
        sched = (GoodputScheduler if goodput else BucketServeScheduler)(
            cfg, budget, SchedulerConfig(
                max_batch=batch or slots,
                memory_model="paged" if paged else "sum", page_size=page))
    options.setdefault("prefill_graph", options.get("decode_graph"))
    return ServingEngine(cfg, model, sched, max_slots=slots,
                         cache_len=cfg.max_seq_len, chunk_tokens=chunk,
                         paged=paged, page_size=page,
                         kv_pool_tokens=pool_tokens, device=dev,
                         prefill_rows=batch or slots, **options)


def count_steps(be, steps):
    """Count the backend's prefill chunks and decode steps into
    ``steps``."""
    def counted(fn, key):
        def call(*args):
            steps[key] += 1
            return fn(*args)
        return call
    be.prefill_chunk = counted(be.prefill_chunk, "prefill")
    be.decode_iter = counted(be.decode_iter, "decode")


def serve_run(torch, cfg, eng, reqs, label):
    """Serve ``reqs`` with the launch counts zeroed just before; returns
    (counts, stats, model steps run: prefill chunks and decode steps)."""
    from repro_torch.kernels import runtime
    steps = {"prefill": 0, "decode": 0}
    count_steps(eng.backend, steps)
    runtime.reset_launch_counts()
    eng.submit(reqs)
    t = time.perf_counter()
    done = eng.run(max_wall_s=600)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    counts = launch_counts()
    counts.update({f"flash_prefill/unaligned/{b}": n
                   for b, n in runtime.prefill_unaligned_counts.items()})
    counts.update({f"{k}/last plan": p for k, p in runtime.decode_plans.items()
                   if p is not None})
    counts.update({f"grouped/{k}": n for k, n in runtime.grouped_counts.items()})
    if len(done) != len(reqs):
        raise AssertionError(f"{label}: served {len(done)}/{len(reqs)}")
    for r in reqs:
        out = eng.outputs[r.rid]
        if len(out) != r.max_new_tokens or \
                not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"{label}: rid {r.rid} emitted {out}")
    res = eng.result
    ntok = sum(r.generated for r in done)
    pg = eng.backend.prefill_graph
    pgs = "" if pg is None else (
        f" (prefill graphs: {pg.captures} captured in "
        f"{pg.capture_seconds:.3f} s, {pg.replays} replays, "
        f"{pg.eager_runs} eager, pool {pg.pool_bytes} B)")
    log("serve", f"{label}: served {len(done)}/{len(reqs)} requests, "
        f"{ntok} tokens in {dt:.2f} s ({ntok / dt:.1f} tok/s); TTFT "
        f"p50 {res.p50('ttft'):.3f} s, p99 {res.p99('ttft'):.3f} s; "
        f"TPOT p50 {res.p50('tpot') * 1e3:.1f} ms; prefill shapes "
        f"{eng.n_prefill_shapes}{pgs}; prefill chunks {steps['prefill']}, "
        f"decode "
        f"steps {steps['decode']}, interleaved "
        f"{eng.interleaved_decode_steps}; launches {counts}")
    return counts, dict(tok_s=ntok / dt, ttft_p50=res.p50("ttft"),
                        ttft_p99=res.p99("ttft"),
                        tpot_p50=res.p50("tpot"), seconds=dt), steps


def serve_phase(torch):
    """Qwen3-14B: paged pool, then contiguous pool; returns the launches
    of its three kernels and the model for the profile."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import default_pool_tokens
    import dataclasses

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen3-14b"), max_seq_len=4096)
    model, wbytes = make_model(torch, "qwen3-14b", cfg)
    log("serve", f"cache length {cfg.max_seq_len} (the config's 32768 cut "
        f"to fit the batch prefill cache and the pool beside the weights)")

    def engine(paged, slots, pool_tokens=None, **graphs):
        return make_engine(torch, cfg, model, wbytes, paged, slots,
                           pool_tokens, **graphs)

    # warm-up: cuBLAS handles and the first launch of each kernel
    warm = engine(paged=True, slots=2, pool_tokens=2 * cfg.max_seq_len,
                  decode_graph=False)
    serve_run(torch, cfg, warm, requests([96, 700], 4), "warm-up")
    del warm
    gc.collect()
    torch.cuda.empty_cache()

    free, total = torch.cuda.mem_get_info(dev)
    per_tok = cfg.kv_bytes_per_token(2)
    pool_tokens = default_pool_tokens(cfg, model, dev)
    log("serve", f"device memory free {free / 2**30:.1f} of "
        f"{total / 2**30:.1f} GiB after the weights; paged pool "
        f"{pool_tokens} tokens ({pool_tokens * per_tok / 2**30:.1f} GiB, "
        f"40% of free)")
    paged_counts, paged_stats, _ = serve_pair(
        torch, cfg, lambda **g: engine(True, 8, pool_tokens, **g),
        SERVE_LENGTHS, 32, "paged pool, chunk 512, page 128",
        modes=("eager", "decode graph", "graph"), want_replays=True)
    contig_counts, contig_stats, _ = serve_pair(
        torch, cfg, lambda **g: engine(False, 4, None, **g),
        [200, 900, 64, 1500], 16, "contiguous pool, chunk 512",
        want_replays=True)

    for name in ("flash_prefill", "paged_flash_decode"):
        if paged_counts[name] <= 0:
            raise AssertionError(f"{name} not launched on the paged path")
    for name in ("flash_prefill", "flash_decode"):
        if contig_counts[name] <= 0:
            raise AssertionError(f"{name} not launched on the contiguous "
                                 "path")
    if paged_counts["flash_decode"] or contig_counts["paged_flash_decode"]:
        raise AssertionError("a decode kernel ran on the wrong pool")
    if paged_counts["wkv6"] or contig_counts["wkv6"]:
        raise AssertionError("wkv6 ran on an attention path")
    for label, c in (("paged", paged_counts), ("contiguous", contig_counts)):
        if c["flash_prefill/tensor_core"] != c["flash_prefill"] or \
                c["flash_prefill/cuda_core"]:
            raise AssertionError(
                f"{label}: {c['flash_prefill']} flash_prefill launches, "
                f"{c['flash_prefill/tensor_core']} of them through the "
                f"tensor-core body")
    log("serve", f"every flash_prefill launch of the bf16 serve runs went "
        f"through the tensor-core body: {paged_counts['flash_prefill']} "
        f"paged, {contig_counts['flash_prefill']} contiguous")
    for name, c in (("paged_flash_decode", paged_counts),
                    ("flash_decode", contig_counts)):
        plan = c[f"{name}/last plan"]
        if plan.body != "tensor_core":
            raise AssertionError(f"{name}: bf16 serve run took the "
                                 f"{plan.body} body")
        log("serve", f"{name}: last launch of the serve run split-KV with "
            f"n_split {plan.n_split}, L {plan.L}, {plan.body} body")
    launches = {"flash_prefill": paged_counts["flash_prefill"],
                "paged_flash_decode": paged_counts["paged_flash_decode"],
                "flash_decode": contig_counts["flash_decode"]}
    return launches, paged_stats, contig_stats, cfg, model, wbytes, \
        pool_tokens


def rwkv_serve_phase(torch):
    """Full-width, full-depth rwkv6-3b on the contiguous slot pool with
    512-token chunked prefill: 8 slots, the 12 requests of the Qwen3-14B
    run.  Returns the wkv6 launches, the run's stats and the model."""
    from repro_torch.configs import get_config
    cfg = get_config("rwkv6-3b")
    model, wbytes = make_model(torch, "rwkv6-3b", cfg)

    warm = make_engine(torch, cfg, model, wbytes, paged=False, slots=2,
                       decode_graph=False)
    serve_run(torch, cfg, warm, requests([96, 700], 4), "rwkv warm-up")
    del warm
    ids = {}
    counts, stats, steps = serve_pair(
        torch, cfg, lambda **g: make_engine(torch, cfg, model, wbytes,
                                            paged=False, slots=8, **g),
        SERVE_LENGTHS, 32, "rwkv6-3b contiguous pool, chunk 512",
        ids_out=ids)
    rwkv_check_launches("rwkv6-3b", cfg, counts, steps)
    want = dict(ids=ids, steps=steps, stats=stats["eager"], wbytes=wbytes)
    return counts["wkv6"], stats, cfg, model, want


def rwkv_check_launches(label, cfg, counts, steps):
    """``wkv6`` once a layer a prefill chunk and a decode step; no
    attention kernel."""
    want = cfg.n_layers * (steps["prefill"] + steps["decode"])
    if counts["wkv6"] != want or want == 0:
        raise AssertionError(f"{label}: wkv6 launched {counts['wkv6']} "
                             f"times, expected {cfg.n_layers} x "
                             f"({steps['prefill']} prefill chunks + "
                             f"{steps['decode']} decode steps) = {want}")
    ran = {k: counts[k] for k in ATTENTION_KERNELS if counts[k]}
    if ran:
        raise AssertionError(f"{label}: attention kernels ran: {ran}")
    log("serve", f"{label}: wkv6 launched {counts['wkv6']} = "
        f"{cfg.n_layers} x ({steps['prefill']} prefill chunks + "
        f"{steps['decode']} decode steps); no attention kernel ran")


def rwkv_mesh_engine(torch, cfg, model, want):
    """The rwkv6-3b serve run again through ``mesh_serve``: ``wr, wk,
    wv, wg, cr, ck`` column-cut, ``wo, cv`` row-cut, the recurrence on
    the rank's own heads (all 40 on one rank), the token-shift carries
    gathered over the group; the same launch gate."""
    label = ("rwkv6-3b engine under the (1, 1) mesh, contiguous pool, "
             "8 slots, eager")
    return mesh_serve(torch, "serve", cfg, model, want["wbytes"], {
        "contiguous": (label, SERVE_LENGTHS, 32, 8, None)},
        {"contiguous": want},
        lambda label, counts, steps, _: rwkv_check_launches(
            label, cfg, counts, steps))["contiguous"]


# ---------------------------------------------------------- retention ---
RET_PREFIX = 512            # system prompt shared by the full-width sessions
RET_SESSIONS, RET_TURNS, RET_NEW = 4, 3, 32
RET_SPILL_PAGES = 48        # device pool of the spill run (32 a request)
RET_HOST_PAGES = 128        # its host tier: 2.6 GB at 160 KiB a token
UNALIGNED = (45, 1037, 4096)    # a resumed chunk: Tc at q_offset over S


def smoke_retention_workloads(cfg):
    """The reference tests' workloads: ``TestPrefixCacheEngine``'s
    shared-prefix set (16 requests, 2 system prompts of 512 tokens) and
    ``TestSessionBackendParity``'s 2 sessions x 3 turns."""
    from repro_torch.core import TaskType
    from repro_torch.data.workload import WorkloadSpec, generate

    def prefix():
        reqs = generate(WorkloadSpec(
            dataset="alpaca", rps=1e6, n_requests=16, seed=3,
            max_model_len=cfg.max_seq_len, task_type=TaskType.OFFLINE,
            prefix_groups=2, prefix_tokens=512, vocab_size=cfg.vocab_size))
        for r in reqs:
            r.max_new_tokens = min(r.max_new_tokens, 4)
        return reqs

    def sessions():
        return generate(WorkloadSpec(
            dataset="alpaca", rps=1e6, sessions=2, turns=3,
            utterance_tokens=220, max_new_tokens=4, seed=7,
            task_type=TaskType.OFFLINE, max_model_len=cfg.max_seq_len,
            vocab_size=cfg.vocab_size))
    return [("prefix", prefix, dict(pool_tokens=8 * 1024),
             dict(prefix_cache=True)),
            ("sessions", sessions, dict(pool_tokens=64 * 128),
             dict(session_ttl=1000.0))]


def retention_smoke(torch, kv_dtype=""):
    """Smoke qwen3-14b at f32: each workload cold on the card, with
    retention on the card, and with retention through the plain versions
    on the CPU.  The three must give the same token ids (and, for the
    sessions, the same composed prompts).  ``kv_dtype`` "int8" runs the
    same over int8 caches with 64-token chunked prefill: a whole-prompt
    prefill attends over the unquantized K/V and a prefill resumed from
    cached pages over their dequantized codes (in the reference too), so
    hit == cold holds for int8 only when the cold run's chunks also
    attend over codes."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm
    cfg = get_smoke_config("qwen3-14b", max_seq_len=1024,
                           kv_cache_dtype=kv_dtype)
    cpu_model = tfm.init_params(cfg, seed=0, dtype=torch.float32,
                                device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    chunk = 64 if kv_dtype else None
    for name, make, pool, ret in smoke_retention_workloads(cfg):
        got = {}
        for label, model, dev, kw in (
                ("card cold", gpu_model, "cuda", {}),
                ("card retention", gpu_model, "cuda", ret),
                ("cpu retention", cpu_model, "cpu", ret)):
            reqs = make()
            eng = make_engine(torch, cfg, model, 0, True, 4, dev=dev,
                              chunk=chunk, hbm_bytes=2 ** 30, **pool, **kw)
            eng.submit(reqs)
            done = eng.run(max_wall_s=600)
            if len(done) != len(reqs):
                raise AssertionError(f"retention smoke {name} {label}: "
                                     f"served {len(done)}/{len(reqs)}")
            got[label] = ({r.rid: list(eng.outputs[r.rid]) for r in reqs},
                          {r.rid: r.tokens.tolist() for r in reqs})
            res = eng.result
            if kw and not (res.prefix_hits if name == "prefix"
                           else res.session_hits):
                raise AssertionError(f"retention smoke {name} {label}: "
                                     f"no hit")
            if kw:
                hits = (f"prefix hits {res.prefix_hits}/"
                        f"{res.prefix_lookups}, session hits "
                        f"{res.session_hits}/{res.session_lookups}, "
                        f"{res.prefill_tokens_skipped} prompt tokens "
                        f"skipped")
        if not got["card cold"] == got["card retention"] \
                == got["cpu retention"]:
            base = got["card cold"][0]
            diff = {label: sorted(rid for rid in base if o[rid] != base[rid])
                    for label, (o, _) in got.items()}
            raise AssertionError(f"retention smoke {name}: token ids or "
                                 f"prompts differ between card cold, card "
                                 f"retention and cpu retention (requests "
                                 f"whose ids differ from card cold: {diff}; "
                                 f"prompts equal: "
                                 f"{[g[1] == got['card cold'][1] for g in got.values()]})")
        log("retention", f"smoke f32{' ' + kv_dtype if kv_dtype else ''} "
            f"{name} workload ({len(got['card cold'][0])} requests): token "
            f"ids identical cold and with retention on the card and with "
            f"retention on the CPU; {hits}")


def unaligned_prefill_check(torch):
    """A resumed chunk at the full-width shape: Tc = 45 queries at
    q_offset 1037 (off the 64-row tile) over a 4096-slot cache, bf16,
    against the plain version at the main-path tolerance, through the
    tensor-core body and counted as unaligned."""
    from repro_torch.kernels import ref, runtime
    Tc, off, S = UNALIGNED
    H, Hkv, Dh = MAIN["H"], MAIN["Hkv"], MAIN["Dh"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for shape in ((1, Tc, H, Dh), (1, S, Hkv, Dh),
                                      (1, S, Hkv, Dh)))
    n0 = runtime.prefill_unaligned_counts["tensor_core"]
    got = prefill(q, k, v, q_offset=off)
    if runtime.prefill_unaligned_counts["tensor_core"] != n0 + 1:
        raise AssertionError("unaligned prefill not counted")
    err = assert_close(torch, f"flash_prefill Tc={Tc} @ {off}/{S}", got,
                       ref.flash_prefill_ref(q, k, v, q_offset=off),
                       MAIN_TOL["bfloat16"])
    log("retention", f"flash_prefill chunk Tc={Tc} at q_offset {off} over "
        f"{S} slots, bf16 H={H} Hkv={Hkv} Dh={Dh}: tensor-core body, "
        f"counted unaligned, agrees with the plain version (atol 2e-3 "
        f"rtol 1e-2), max abs err {err:.3g}")
    return err


def session_requests(cfg, seed=0):
    """4 sessions x 3 turns sized to the window by the launcher's rule
    (utterances of max_seq_len // (2 turns) - 8 tokens, 32 new tokens),
    each conversation opening with one shared 512-token system prompt
    (the session workload has no ``prefix_groups``, so it is prepended
    here and every turn's length grows by it)."""
    import numpy as np
    from repro_torch.data.workload import WorkloadSpec, generate
    reqs = generate(WorkloadSpec(
        dataset="mixed", rps=8.0, max_model_len=cfg.max_seq_len - RET_PREFIX,
        vocab_size=cfg.vocab_size, sessions=RET_SESSIONS, turns=RET_TURNS,
        utterance_tokens=max(cfg.max_seq_len // (2 * RET_TURNS) - 8, 8),
        max_new_tokens=RET_NEW, seed=seed))
    system = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, RET_PREFIX).astype(np.int32)
    for r in reqs:
        r.prompt_len += RET_PREFIX
        if r.turn == 0:
            r.tokens = np.concatenate([system, r.tokens])
        else:
            r.history_tokens += RET_PREFIX
    return reqs


def capture_first_logits(be, store):
    """Record each request's first-token logits (f32, on the host) as the
    engine's prefill produces them: each prefill call, eager or a graph
    replay, leaves its logits in the engine's logits buffer.  Returns the
    function that undoes the wrapping."""
    original = be.prefill_chunk

    def chunk(job, idx):
        start, clen = job.chunks[idx]
        whole = len(job.chunks) == 1 and start == 0
        out = original(job, idx)
        logits = be._pf_logits[:len(job.batch.requests)]
        for i, r in enumerate(job.batch.requests):
            if whole or start <= r.prompt_len - 1 < start + clen:
                store[r.rid] = logits[i].float().cpu()
        return out
    be.prefill_chunk = chunk

    def undo():
        be.prefill_chunk = original
    return undo


def cold_first_logits(torch, cfg, model, tokens, chunk=512):
    """First-token logits of ``tokens`` prefilled alone from position 0
    in 512-token chunks: the turn served cold."""
    from repro_torch.models import transformer as tfm
    dev = model.device
    L = len(tokens)
    toks = torch.as_tensor(tokens, dtype=torch.int32, device=dev)[None]
    lens = torch.tensor([L], dtype=torch.int32, device=dev)
    cache = tfm.init_cache(cfg, 1, cfg.max_seq_len, model.dtype, dev)
    for s in range(0, L, chunk):
        logits, cache = tfm.prefill_chunk(cfg, model, toks[:, s:s + chunk],
                                          cache, s, lens)
    return logits[0].float().cpu()


def later(reqs, first_turn):
    return [r for r in reqs if r.turn >= first_turn]


def p50(xs):
    xs = sorted(xs)
    return xs[(len(xs) - 1) // 2]


def session_phase(torch, cfg, model, wbytes, pool_tokens):
    """Full-width Qwen3-14B, bf16: the multi-turn workload served cold
    (no retention), then with session retention, in one call."""
    from repro_torch.kernels import runtime
    runs = {}
    for label, kw in (("cold", {}), ("resumed", dict(session_ttl=1000.0))):
        eng = make_engine(torch, cfg, model, wbytes, True, 8, pool_tokens,
                          dev=model.device, **kw)
        reqs = session_requests(cfg)
        logits = {}
        undo = capture_first_logits(eng.backend, logits)
        try:
            counts, stats, steps = serve_run(
                torch, cfg, eng, reqs, f"sessions {label}, {RET_SESSIONS} x "
                f"{RET_TURNS} turns, chunk 512, page 128")
        finally:
            undo()
        runs[label] = dict(eng=eng, reqs=reqs, counts=counts, stats=stats,
                           logits=logits, res=eng.result)
    cold, warm = runs["cold"], runs["resumed"]
    res, be = warm["res"], warm["eng"].backend
    c = warm["counts"]

    # kernels of the path, unaligned resumes on the tensor-core body
    for name in ("flash_prefill", "paged_flash_decode"):
        if c[name] <= 0:
            raise AssertionError(f"sessions resumed: {name} not launched")
    una = {b: c[f"flash_prefill/unaligned/{b}"]
           for b in runtime.PREFILL_BODIES}
    if una["tensor_core"] <= 0 or una["cuda_core"] or \
            c["flash_prefill/tensor_core"] != c["flash_prefill"]:
        raise AssertionError(f"sessions resumed: unaligned flash_prefill "
                             f"launches by body {una}, all launches "
                             f"{c['flash_prefill']}, tensor-core "
                             f"{c['flash_prefill/tensor_core']}")
    # prefill saved on turns >= 2 (the reference's criterion)
    cold_t2 = sum(r.prefilled_tokens for r in later(cold["reqs"], 2))
    warm_t2 = sum(r.prefilled_tokens for r in later(warm["reqs"], 2))
    if not warm_t2 <= 0.4 * cold_t2 or res.session_hits <= 0:
        raise AssertionError(f"sessions resumed: turns >= 2 prefilled "
                             f"{warm_t2} of the cold run's {cold_t2} prompt "
                             f"tokens, {res.session_hits} session hits")
    # pages balance, and clear frees every retained page
    a = be.alloc
    if a.free_pages() + a.live_pages() != a.n_pages:
        raise AssertionError("sessions resumed: free + live != total")
    live = a.live_pages()
    be.retention.clear(a)
    if a.free_pages() != a.n_pages:
        raise AssertionError("sessions resumed: clear left pages live")

    # first-token logits.  Serving one turn cold twice with other batch
    # shapes already moves bf16 logits (cuBLAS picks kernels by M): the
    # spread of the cold run against the same prompts prefilled alone is
    # the yardstick, and a resumed turn must stay within 1.5x it
    def diff(a, b):
        d = (a - b).abs()
        return float(d.max()), float(d.mean()), bool(a.argmax() == b.argmax())
    spread = [0.0, 0.0]
    for r in cold["reqs"]:
        ref_logits = cold_first_logits(torch, cfg, model,
                                       r.tokens[:r.prompt_len])
        mx, mean, _ = diff(cold["logits"][r.rid], ref_logits)
        spread = [max(spread[0], mx), max(spread[1], mean)]
    if not 0.0 < spread[0] < 1.0:
        raise AssertionError(f"sessions cold: logits spread {spread}")
    resumed = [r for r in warm["reqs"] if r.prefix_hit_tokens > 0]
    cold_by = {r.rid: r for r in cold["reqs"]}
    worst, top1 = [0.0, 0.0], 0
    same_prompt = []
    for r in resumed:
        pairs = [("cold prefill", cold_first_logits(
            torch, cfg, model, r.tokens[:r.prompt_len]))]
        q = cold_by[r.rid]
        if q.prompt_len == r.prompt_len and \
                (q.tokens[:q.prompt_len] == r.tokens[:r.prompt_len]).all():
            same_prompt.append(r.rid)
            pairs.append(("cold run", cold["logits"][r.rid]))
        for what, want in pairs:
            mx, mean, same_top = diff(warm["logits"][r.rid], want)
            if mx > 1.5 * spread[0] or mean > 1.5 * spread[1]:
                raise AssertionError(
                    f"resumed rid {r.rid} first-token logits vs the {what}: "
                    f"max abs {mx:.4g}, mean abs {mean:.4g}, above 1.5x the "
                    f"cold run's spread {spread}")
            worst = [max(worst[0], mx), max(worst[1], mean)]
            top1 += same_top
    # ids against the cold run: reported, not gated
    full, first_div = 0, {}
    for r in warm["reqs"]:
        a_ids, b_ids = warm["eng"].outputs[r.rid], cold["eng"].outputs[r.rid]
        if a_ids == b_ids:
            full += 1
        else:
            first_div[r.rid] = next(i for i, (x, y) in
                                    enumerate(zip(a_ids, b_ids)) if x != y)
    ttft = {label: {t: p50([r.ttft() for r in later(run["reqs"], t)])
                    for t in (1, 2)} for label, run in runs.items()}
    log("retention", f"sessions resumed: session hits {res.session_hits}/"
        f"{res.session_lookups}, prefix hits {res.prefix_hits}/"
        f"{res.prefix_lookups}, {res.prefill_tokens_skipped} prompt tokens "
        f"skipped ({res.prefill_tokens_processed} prefilled; cold run "
        f"{cold['res'].prefill_tokens_processed}); turns >= 2 prefilled "
        f"{warm_t2} of the cold run's {cold_t2} prompt tokens "
        f"({warm_t2 / cold_t2:.3f}); flash_prefill {c['flash_prefill']} "
        f"launches, {una['tensor_core']} at unaligned offsets (tensor-core "
        f"body {una['tensor_core']}, CUDA-core {una['cuda_core']}); "
        f"paged_flash_decode {c['paged_flash_decode']}; pages {a.n_pages}, "
        f"{live} retained at the end, all free after clear")
    log("retention", f"first-token logits (std about "
        f"{float(cold['logits'][0].std()):.2f}): the cold run against the "
        f"same prompts prefilled alone differs by max abs {spread[0]:.4g}, "
        f"mean abs {spread[1]:.4g}; the {len(resumed)} resumed turns "
        f"against their prompt prefilled cold, and the {len(same_prompt)} "
        f"of them whose prompt the cold run also composed ({same_prompt}) "
        f"against the cold run, by at most max abs {worst[0]:.4g}, mean abs "
        f"{worst[1]:.4g} (gate: 1.5x the cold spread); top-1 token equal in "
        f"{top1}/{len(resumed) + len(same_prompt)}; ids equal to the cold "
        f"run in full for {full}/{len(warm['reqs'])} requests, first "
        f"divergent step of the others {first_div}")
    log("retention", f"TTFT p50, turns >= 1: cold {ttft['cold'][1]:.3f} s, "
        f"resumed {ttft['resumed'][1]:.3f} s; turns >= 2: cold "
        f"{ttft['cold'][2]:.3f} s, resumed {ttft['resumed'][2]:.3f} s; "
        f"cold {cold['stats']}; resumed {warm['stats']}")
    out = dict(hits=(res.session_hits, res.session_lookups,
                     res.prefix_hits, res.prefix_lookups),
               skipped=res.prefill_tokens_skipped,
               unaligned=una["tensor_core"], launches={
                   k: c[k] for k in ("flash_prefill", "paged_flash_decode")},
               t2_share=warm_t2 / cold_t2, ttft=ttft, logits_err=worst,
               logits_spread=spread,
               ids_full=(full, len(warm["reqs"])))
    del runs, cold, warm, be
    return out


def spill_phase(torch, cfg, model, wbytes):
    """Full-width Qwen3-14B, bf16: the multi-turn workload over a 48-page
    device pool with a 128-page host tier, then the copier's round trip
    of one page on the card."""
    dev = model.device
    eng = make_engine(torch, cfg, model, wbytes, True, 8,
                      (RET_SPILL_PAGES + 1) * 128, dev=dev,
                      session_ttl=1000.0,
                      host_pool_tokens=RET_HOST_PAGES * 128)
    be = eng.backend
    if be.alloc.n_pages != RET_SPILL_PAGES or \
            be.alloc.host_pages != RET_HOST_PAGES:
        raise AssertionError(f"spill run: {be.alloc.n_pages} device pages, "
                             f"{be.alloc.host_pages} host pages")
    counts, stats, _ = serve_run(torch, cfg, eng, session_requests(cfg),
                                 f"spill, {RET_SPILL_PAGES}-page pool, "
                                 f"{RET_HOST_PAGES}-page host tier")
    res, a = eng.result, be.alloc
    if not (res.spilled_pages > 0 and res.restored_pages > 0
            and res.spill_hold_events > 0):
        raise AssertionError(f"spill run: {res.spilled_pages} spilled, "
                             f"{res.restored_pages} restored, "
                             f"{res.spill_hold_events} holds")
    if a.free_host_slots() + a.spilled_slots() != a.host_pages or \
            a.free_pages() + a.live_pages() != a.n_pages:
        raise AssertionError("spill run: a tier does not balance")
    for name in ("flash_prefill", "paged_flash_decode"):
        if counts[name] <= 0:
            raise AssertionError(f"spill run: {name} not launched")
    host_end = (a.free_host_slots(), a.spilled_slots())
    be.retention.clear(a)
    if a.free_host_slots() != a.host_pages or a.free_pages() != a.n_pages:
        raise AssertionError("spill run: clear left pages or slots in use")
    # one page spilled, overwritten in the pool, restored into another
    # page: the bytes at spill time come back
    cp = be.retention.copier
    gen = torch.Generator(device=dev).manual_seed(7)
    leaves = [leaf for _, leaf in cp._attn_leaves()]
    src, dst, hslot = 0, 1, 0
    for leaf in leaves:
        leaf[:, src] = torch.randn(leaf[:, src].shape, generator=gen,
                                   device=dev).to(leaf.dtype)
    want = [leaf[:, src].clone() for leaf in leaves]
    cp.spill(src, hslot)
    for leaf in leaves:
        leaf[:, src] = torch.randn(leaf[:, src].shape, generator=gen,
                                   device=dev).to(leaf.dtype)
    cp.poll()
    cp.restore(hslot, dst)
    cp.poll()
    for leaf, w in zip(leaves, want):
        if not torch.equal(leaf[:, dst].view(torch.int16),
                           w.view(torch.int16)) or \
                torch.equal(leaf[:, dst], leaf[:, src]):
            raise AssertionError("spill round trip: the restored page is "
                                 "not the page as spilled")
    log("retention", f"spill run: {res.spilled_pages} pages spilled "
        f"({res.spilled_bytes} B), {res.restored_pages} restored "
        f"({res.restored_tokens} tokens), {res.spill_drops} dropped, "
        f"{res.spill_hold_events} holds, session hits {res.session_hits}/"
        f"{res.session_lookups}, {res.prefill_tokens_processed} prompt "
        f"tokens prefilled ({res.prefill_tokens_skipped} skipped); at the end host slots free {host_end[0]} "
        f"+ spilled {host_end[1]} == {a.host_pages}, all free after clear; "
        f"launches flash_prefill {counts['flash_prefill']}, "
        f"paged_flash_decode {counts['paged_flash_decode']}; one "
        f"page ({len(leaves)} leaves of {tuple(want[0].shape)} "
        f"{want[0].dtype}) spilled, overwritten and restored into another "
        f"page: byte-identical; {stats}")
    out = dict(spilled=res.spilled_pages, restored=res.restored_pages,
               holds=res.spill_hold_events, stats=stats)
    del eng, be, cp, leaves, want
    return out


def retention_phase(torch, cfg, model, wbytes):
    """KV retention on the port's engine: smoke parity at f32, the
    unaligned resume kernel check, then full-width sessions cold against
    resumed and a run with the host spill tier."""
    from repro_torch.launch.serve import default_pool_tokens
    t0 = time.perf_counter()
    retention_smoke(torch)
    err = unaligned_prefill_check(torch)
    pool = default_pool_tokens(cfg, model, torch.device("cuda"))
    sessions = session_phase(torch, cfg, model, wbytes, pool)
    gc.collect()
    torch.cuda.empty_cache()
    spill = spill_phase(torch, cfg, model, wbytes)
    gc.collect()
    torch.cuda.empty_cache()
    log("retention", f"phase took {time.perf_counter() - t0:.1f} s")
    return dict(unaligned_err=err, sessions=sessions, spill=spill)


# ----------------------------------------------------------- recovery ---
REC_N, REC_NEW, REC_SLICE = 12, 64, 16
REC_PROMPTS = (512, 2048)
REC_PAGES = 34          # device pool of the full-width recovery runs
REC_PLAN = "seed=7,decode_step=0.02,prefill_chunk=0.05,maintain_tick=0.1"
REC_MEM_SLACK = 64 * 2 ** 20


def capture_yields(be, kept):
    """Record each request's outputs as a slice yield leaves them (the
    kept tokens), keyed by rid."""
    hook = be.on_slice_yield

    def on_yield(req, keep):
        hook(req, keep)
        kept.setdefault(req.rid, []).append(list(be.outputs[req.rid]))
    be.on_slice_yield = on_yield


def check_kept(label, kept, final):
    """Every kept slice is the head of its request's final output, byte
    for byte; returns the number of yields checked."""
    n = 0
    for rid, heads in kept.items():
        for head in heads:
            if rid in final and final[rid][:len(head)] != head:
                raise AssertionError(f"{label}: rid {rid} kept {head} at a "
                                     f"yield, final output {final[rid]}")
            n += rid in final
    return n


def smoke_preempt_requests():
    """``TestSlicePreemption``'s workload: 6 requests at t = 0, prompts of
    20-40 tokens, 20-40 new tokens."""
    import numpy as np
    from repro_torch.core import Request, TaskType
    rng = np.random.default_rng(3)
    return [Request(rid=i, prompt_len=int(rng.integers(20, 40)),
                    max_new_tokens=int(rng.integers(20, 40)), arrival=0.0,
                    task_type=TaskType.OFFLINE) for i in range(6)]


def smoke_fault_requests():
    """``TestEngineFaults``' workload: 8 requests at t = 0, prompts of
    8-48 tokens, 6 new tokens."""
    import numpy as np
    from repro_torch.core import Request, TaskType
    rng = np.random.default_rng(3)
    return [Request(rid=i, prompt_len=int(rng.integers(8, 48)),
                    max_new_tokens=6, arrival=0.0,
                    task_type=TaskType.OFFLINE) for i in range(8)]


def finished_ids(eng, reqs):
    return {r.rid: list(eng.outputs[r.rid]) for r in reqs
            if r.finished >= 0 and not r.dropped}


def recovery_smoke(torch):
    """Smoke qwen3-14b at f32: slice-yield resume against the uncontended
    run on the card and the CPU, then a drain at a wall time mid-run,
    resumed cold from the checkpoint's JSON, against the uninterrupted
    run."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.recovery import LoopCheckpoint
    from repro_torch.models import transformer as tfm
    cfg = get_smoke_config("qwen3-14b", max_seq_len=128)
    cpu_model = tfm.init_params(cfg, seed=0, dtype=torch.float32,
                                device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")

    def engine(model, dev, paged=False, **kw):
        return make_engine(torch, cfg, model, 0, paged, 4, dev=dev,
                           chunk=None, hbm_bytes=2 ** 30, **kw)

    def serve_all(eng, reqs, label):
        eng.submit(reqs)
        if len(eng.run(max_wall_s=600)) != len(reqs):
            raise AssertionError(f"recovery smoke {label}: not all served")
        return finished_ids(eng, reqs)
    ids, yields = {}, {}
    for label, model, dev in (("card", gpu_model, "cuda"),
                              ("cpu", cpu_model, "cpu")):
        eng = engine(model, dev, paged=True, page=32, pool_tokens=5 * 32,
                     slice_tokens=4)
        kept = {}
        capture_yields(eng.backend, kept)
        reqs = smoke_preempt_requests()
        ids[label] = serve_all(eng, reqs, f"slice yield, {label}")
        yields[label] = eng.result.slice_yields
        check_kept(f"recovery smoke {label}", kept, ids[label])
        if not yields[label] or eng.backend.free_blocks() != \
                eng.backend.alloc.n_pages:
            raise AssertionError(f"recovery smoke {label}: "
                                 f"{yields[label]} slice yields, pages "
                                 f"unbalanced")
        if label == "card":
            sliced = sum(r.sliced_tokens > 0 for r in reqs)
            uncontended = [dataclasses.replace(
                r, arrival=0.0, generated=0,
                prompt_len=r.prompt_len - r.sliced_tokens,
                tokens=r.tokens[:r.prompt_len - r.sliced_tokens],
                sliced_tokens=0, first_token=-1.0, prefill_start=-1.0,
                finished=-1.0) for r in reqs]
    ids["uncontended"] = serve_all(engine(gpu_model, "cuda", paged=True,
                                          page=32), uncontended,
                                   "uncontended")
    if not ids["card"] == ids["uncontended"] == ids["cpu"]:
        raise AssertionError("recovery smoke: slice-yield ids differ from "
                             "the uncontended run or the CPU")
    log("recovery", f"smoke f32 slice yield (5-page pool, slice 4): "
        f"{yields['card']} yields on the card ({sliced} requests kept "
        f"work), {yields['cpu']} on the CPU; ids equal to the uncontended "
        f"run and to the CPU run for all {len(ids['card'])} requests")

    # drain at a wall time mid-run (half the uninterrupted run's seconds,
    # halved again while nothing is left in flight), JSON, cold resume
    kw = dict(slice_tokens=2)
    t = time.perf_counter()
    want = serve_all(engine(gpu_model, "cuda", **kw), smoke_fault_requests(),
                     "uninterrupted")
    frac, wall = 0.5, time.perf_counter() - t
    while True:
        eng = engine(gpu_model, "cuda", **kw)
        reqs = smoke_fault_requests()
        eng.loop.run(reqs, time_limit=math.inf, max_wall_s=600,
                     drain_at=frac * wall)
        ck = LoopCheckpoint.from_json(eng.loop.drain().to_json())
        if ck.requests or frac < 0.01:
            break
        frac /= 2
    cold_eng = engine(gpu_model, "cuda", **kw)
    cold = ck.restore_requests()
    cold_eng.loop.run(cold, time_limit=math.inf, max_wall_s=600,
                      resume_clock=ck.now)
    done1, done2 = finished_ids(eng, reqs), finished_ids(cold_eng, cold)
    if not ck.requests or set(done1) & set(done2) or \
            set(done1) | set(done2) != set(want):
        raise AssertionError(f"recovery smoke drain: {len(ck.requests)} "
                             f"in the checkpoint; finished {sorted(done1)} "
                             f"before, {sorted(done2)} after, of "
                             f"{sorted(want)}")
    if {**done1, **done2} != want:
        raise AssertionError("recovery smoke drain: resumed ids differ "
                             "from the uninterrupted run")
    log("recovery", f"smoke f32 drain at {frac * wall * 1e3:.1f} ms of a "
        f"{wall * 1e3:.1f} ms run: {len(done1)} finished before, "
        f"{len(ck.requests)} in the checkpoint ({len(ck.to_json())} B of "
        f"JSON, {sum(r.sliced_tokens > 0 for r in cold)} with kept "
        f"slices), {len(done2)} finished after a cold resume; ids equal "
        f"to the uninterrupted run, nothing lost or duplicated")


def recovery_requests(cfg, seed=0):
    """12 requests at t = 0 with prompts of 512-2048 tokens and 64 new
    tokens each, their classes drawn from the default class mix with
    each class's SLOs."""
    import numpy as np
    from repro_torch.core import Request, TaskType
    from repro_torch.data.workload import CLASS_SLOS, DEFAULT_CLASS_MIX
    rng = np.random.default_rng(seed)
    names = [c for c, _ in DEFAULT_CLASS_MIX]
    weights = [w for _, w in DEFAULT_CLASS_MIX]
    out = []
    for i in range(REC_N):
        cls = names[rng.choice(len(names), p=weights)]
        ttft, tpot = CLASS_SLOS[cls]
        out.append(Request(
            rid=i, prompt_len=int(rng.integers(REC_PROMPTS[0],
                                               REC_PROMPTS[1] + 1)),
            max_new_tokens=REC_NEW, arrival=0.0,
            task_type=TaskType.OFFLINE if cls == "batch"
            else TaskType.ONLINE, cls=cls, slo_ttft=ttft, slo_tpot=tpot))
    return out


def recovery_engine(torch, cfg, model, wbytes, **kw):
    """The full-width recovery runs' engine: goodput scheduler, slice
    yield, paged pool of ``REC_PAGES``, chunk 512, 8 slots."""
    return make_engine(torch, cfg, model, wbytes, True, 8,
                       (REC_PAGES + 1) * 128, dev=model.device, goodput=True,
                       slice_tokens=REC_SLICE, **kw)


def recovery_faults(torch, cfg, model, wbytes):
    """Full-width Qwen3-14B, bf16, under the goodput scheduler with slice
    yield over a 40-page pool, the fault plan armed and a Tracer on."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.telemetry import Tracer, validate_perfetto
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import _fault_line
    plan = FaultPlan.parse(REC_PLAN)
    tracer = Tracer()
    eng = recovery_engine(torch, cfg, model, wbytes, fault_plan=plan,
                          tracer=tracer)
    be = eng.backend
    if be.alloc.n_pages != REC_PAGES:
        raise AssertionError(f"recovery: {be.alloc.n_pages} pages")
    kept, steps = {}, {"prefill": 0, "decode": 0}
    capture_yields(be, kept)
    count_steps(be, steps)
    reqs = recovery_requests(cfg)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    runtime.reset_launch_counts()
    eng.submit(reqs)
    t = time.perf_counter()
    eng.run(max_wall_s=600)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    mem1 = torch.cuda.memory_allocated()
    counts = dict(runtime.launch_counts)
    bodies = dict(runtime.prefill_body_counts)
    unaligned = dict(runtime.prefill_unaligned_counts)
    res = eng.result
    final = finished_ids(eng, reqs)
    quarantined = [r.rid for r in reqs if r.quarantined]
    errs = []
    if sorted(list(final) + quarantined) != [r.rid for r in reqs]:
        errs.append(f"finished {sorted(final)}, quarantined {quarantined}")
    errs += [f"rid {rid}: {len(o)} tokens" for rid, o in final.items()
             if len(o) != REC_NEW]
    n_kept = check_kept("recovery faults", kept, final)
    if not (res.slice_yields > 0 and res.preempt_events > 0 and n_kept):
        errs.append(f"{res.slice_yields} slice yields, "
                    f"{res.preempt_events} preemptions, {n_kept} kept "
                    f"slices checked")
    if res.fault_events <= 0:
        errs.append("no fault fired")
    if be.free_blocks() != be.alloc.n_pages:
        errs.append(f"{be.free_blocks()} of {be.alloc.n_pages} pages free")
    doc = tracer.export()
    bad = validate_perfetto(doc)
    if bad:
        errs.append(f"timeline: {bad[:3]}")
    if abs(mem1 - mem0) > REC_MEM_SLACK:
        errs.append(f"memory_allocated {mem0} before, {mem1} after")
    if counts["paged_flash_decode"] != steps["decode"] * cfg.n_layers or \
            not steps["decode"]:
        errs.append(f"paged_flash_decode {counts['paged_flash_decode']} "
                    f"launches for {steps['decode']} decode steps")
    if bodies["tensor_core"] != counts["flash_prefill"] or \
            bodies["cuda_core"] or unaligned["cuda_core"] or \
            not counts["flash_prefill"]:
        errs.append(f"flash_prefill {counts['flash_prefill']} launches, "
                    f"bodies {bodies}, unaligned {unaligned}")
    if errs:
        raise AssertionError("recovery faults: " + "; ".join(errs))
    n_ev = sum(1 for e in doc["traceEvents"] if e.get("ph") != "M")
    attain = ", ".join(f"{c} {res.slo_attainment(c):.2f}"
                       for c in res.classes())
    log("recovery", f"full width, goodput scheduler, slice {REC_SLICE}, "
        f"{REC_PAGES}-page pool, plan {REC_PLAN}: {len(final)}/{REC_N} "
        f"finished, {len(quarantined)} quarantined in {dt:.2f} s; "
        f"{res.slice_yields} slice yields ({n_kept} kept slices equal to "
        f"the head of the final output), {res.preempt_events} preemptions; "
        f"TTFT p50 {res.p50('ttft'):.3f} s, p99 {res.p99('ttft'):.3f} s, "
        f"TPOT p50 {res.p50('tpot') * 1e3:.1f} ms; attainment {attain}; "
        f"pages {be.free_blocks()}/{be.alloc.n_pages} free; "
        f"memory_allocated {mem0} -> {mem1} B")
    log("recovery", _fault_line(res, plan))
    log("recovery", f"timeline valid: {n_ev} events on "
        f"{len(tracer._tracks)} tracks; {steps['prefill']} prefill chunks, "
        f"{steps['decode']} decode steps; flash_prefill "
        f"{counts['flash_prefill']} launches (tensor-core "
        f"{bodies['tensor_core']}, {unaligned['tensor_core']} at unaligned "
        f"offsets), paged_flash_decode {counts['paged_flash_decode']} = "
        f"{steps['decode']} x {cfg.n_layers}")
    out = dict(seconds=dt, yields=res.slice_yields,
               preempts=res.preempt_events, faults=res.fault_events,
               ttft_p50=res.p50("ttft"), ttft_p99=res.p99("ttft"),
               tpot_p50=res.p50("tpot"), launches={
                   k: counts[k] for k in ("flash_prefill",
                                          "paged_flash_decode")},
               steps=dict(steps))
    return out, final


def recovery_drain(torch, cfg, model, wbytes, drain_at, uninterrupted):
    """The same workload without the fault plan, drained at ``drain_at``
    wall seconds, its checkpoint round-tripped through JSON, the first
    engine's pool freed, and resumed on a cold engine."""
    from repro_torch.core.recovery import LoopCheckpoint
    eng = recovery_engine(torch, cfg, model, wbytes)
    kept = {}
    capture_yields(eng.backend, kept)
    reqs = recovery_requests(cfg)
    t = time.perf_counter()
    eng.loop.run(reqs, time_limit=math.inf, max_wall_s=600,
                 drain_at=drain_at)
    ck = LoopCheckpoint.from_json(eng.loop.drain().to_json())
    be = eng.backend
    balanced = [be.free_blocks() == be.alloc.n_pages]
    done1 = finished_ids(eng, reqs)
    del eng, be
    gc.collect()
    torch.cuda.empty_cache()
    cold_eng = recovery_engine(torch, cfg, model, wbytes)
    capture_yields(cold_eng.backend, kept)
    cold = ck.restore_requests()
    cold_eng.loop.run(cold, time_limit=math.inf, max_wall_s=600,
                      resume_clock=ck.now)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    be = cold_eng.backend
    balanced.append(be.free_blocks() == be.alloc.n_pages)
    done2 = finished_ids(cold_eng, cold)
    final = {**done1, **done2}
    n_kept = check_kept("recovery drain", kept, final)
    errs = []
    if not ck.requests:
        errs.append("nothing in flight at the drain")
    if set(done1) & set(done2) or len(final) != REC_N:
        errs.append(f"finished {sorted(done1)} before, {sorted(done2)} "
                    f"after")
    errs += [f"rid {rid}: {len(o)} tokens" for rid, o in final.items()
             if len(o) != REC_NEW]
    if not all(balanced):
        errs.append(f"pages balanced before / after: {balanced}")
    if errs:
        raise AssertionError("recovery drain: " + "; ".join(errs))
    same = sum(final[rid] == uninterrupted.get(rid) for rid in final)
    log("recovery", f"full-width drain at {drain_at:.2f} s: {len(done1)} "
        f"finished before, {len(ck.requests)} in the checkpoint "
        f"({len(ck.to_json())} B of JSON, "
        f"{sum(r.sliced_tokens > 0 for r in cold)} with kept slices, "
        f"{sum(r.sliced_tokens for r in cold)} kept tokens), {len(done2)} "
        f"finished after a cold resume; {n_kept} kept slices equal to the "
        f"head of the final output; pages balanced in both engines; "
        f"{dt:.2f} s in all; ids equal to the faulted uninterrupted run in "
        f"full for {same}/{REC_N} requests (bf16: batch shape moves the "
        f"logits; not gated)")
    return dict(seconds=dt, before=len(done1), checkpoint=len(ck.requests),
                after=len(done2), ids_equal=same)


def recovery_phase(torch, cfg, model, wbytes):
    """Slice yield, faults, recovery and drain on the port's engine: the
    smoke f32 checks, then full width with the fault plan, then a drain
    and a cold resume of the same workload."""
    t0 = time.perf_counter()
    recovery_smoke(torch)
    faults, final = recovery_faults(torch, cfg, model, wbytes)
    gc.collect()
    torch.cuda.empty_cache()
    # the drain run has no faults: drained at the faulted run's TTFT p50,
    # which the faults barely move, it still has requests in flight; half
    # the faulted run's wall (9-18 s with the same steps, as its fault
    # backoffs fall) can come after the clean run's end
    drain = recovery_drain(torch, cfg, model, wbytes, faults["ttft_p50"],
                           final)
    gc.collect()
    torch.cuda.empty_cache()
    log("recovery", f"phase took {time.perf_counter() - t0:.1f} s")
    return dict(faults=faults, drain=drain)


# ---------------------------------------------------------------- int8 ---
# the recovery runs' 4480-token budget at int8: 163840 B a token of bf16
# over 84480 B of int8 codes and scales buys 67 pages, less the trash page
REC_PAGES_INT8 = 66


def int8_smoke(torch):
    """Smoke qwen3-14b at f32 over int8 caches: prefill and decode on the
    card against the CPU (ids equal), the engine's decode graph against
    eager and the CPU on the paged and the contiguous pool (ids equal,
    and paged equal to contiguous), and prefix and session hits against
    the cold run."""
    t0 = time.perf_counter()
    parity_phase(torch, kv_dtype="int8")
    ids = graph_smoke(torch, runs=(("qwen3-14b", True),
                                   ("qwen3-14b", False)), kv_dtype="int8")
    if ids["qwen3-14b", True] != ids["qwen3-14b", False]:
        raise AssertionError("int8 smoke: paged ids differ from contiguous "
                             "ids")
    retention_smoke(torch, kv_dtype="int8")
    log("int8", f"smoke f32 int8: card ids == CPU ids, graph == eager == "
        f"CPU, paged == contiguous, prefix and session hits == cold, in "
        f"{time.perf_counter() - t0:.1f} s")


def int8_serve(torch, cfg8, model, wbytes, pool_tokens, bf16_pages):
    """Full-width Qwen3-14B over an int8 pool: the bf16 serve runs'
    requests under the same ``pool_tokens`` (the paged pool then holds
    about 1.94x the pages), eager and with the decode graph, then the
    contiguous pool's four requests."""
    from repro_torch.core import paging
    want = paging.device_pool_pages(cfg8, pool_tokens, 128) - 1

    def paged_engine(**graphs):
        eng = make_engine(torch, cfg8, model, wbytes, True, 8, pool_tokens,
                          **graphs)
        if eng.backend.alloc.n_pages != want:
            raise AssertionError(f"int8 pool: {eng.backend.alloc.n_pages} "
                                 f"pages, want {want}")
        if eng.backend.pool_cache["groups"][0][0]["k"].dtype != torch.int8:
            raise AssertionError("int8 pool: the pool is not int8")
        return eng
    paged, stats, steps = serve_pair(
        torch, cfg8, paged_engine, SERVE_LENGTHS, 32,
        "int8 paged pool, chunk 512, page 128")
    contig, contig_stats, csteps = serve_pair(
        torch, cfg8, lambda **g: make_engine(torch, cfg8, model, wbytes,
                                             False, 4, **g),
        [200, 900, 64, 1500], 16, "int8 contiguous pool, chunk 512")
    errs = []
    for label, c, kernel, st in (("paged", paged, "paged_flash_decode_int8",
                                  steps),
                                 ("contiguous", contig, "flash_decode_int8",
                                  csteps)):
        others = {k: c[k] for k in ("paged_flash_decode", "flash_decode",
                                    "flash_decode_int8",
                                    "paged_flash_decode_int8", "wkv6")
                  if k != kernel and c[k]}
        if c[kernel] != st["decode"] * cfg8.n_layers or not st["decode"] \
                or others:
            errs.append(f"{label}: {kernel} {c[kernel]} launches for "
                        f"{st['decode']} decode steps; others {others}")
        if c["flash_prefill/tensor_core"] != c["flash_prefill"] or \
                not c["flash_prefill"]:
            errs.append(f"{label}: flash_prefill {c['flash_prefill']}, "
                        f"tensor-core {c['flash_prefill/tensor_core']}")
    if errs:
        raise AssertionError("int8 serve: " + "; ".join(errs))
    log("int8", f"int8 paged pool of {want} pages against the bf16 pool's "
        f"{bf16_pages} under the same {pool_tokens} tokens "
        f"({want / bf16_pages:.3f}x); paged_flash_decode_int8 "
        f"{paged['paged_flash_decode_int8']} = {steps['decode']} x "
        f"{cfg8.n_layers}, flash_decode_int8 "
        f"{contig['flash_decode_int8']} = {csteps['decode']} x "
        f"{cfg8.n_layers}; no float decode kernel ran")
    return dict(pages=want, bf16_pages=bf16_pages, stats=stats,
                contig_stats=contig_stats,
                launches={"paged_flash_decode_int8":
                          paged["paged_flash_decode_int8"],
                          "flash_decode_int8": contig["flash_decode_int8"]})


def int8_drift_and_profile(torch, cfg, cfg8, model):
    """8 rows of 1024 tokens prefilled into a bf16 and an int8 paged
    cache, one decode step of each from the same tokens: the int8 step's
    logits against the bf16 step's (gate ``INT8_DRIFT_MAX``); then the
    int8 step profiled, eager and as a graph replay."""
    from repro_torch.models import transformer as tfm
    dev = torch.device("cuda")
    B, ctx, page = 8, 1024, 128
    S = cfg.max_seq_len
    gen = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (B, ctx), generator=gen,
                         device=dev, dtype=torch.int32)
    logits, tok, paged = {}, None, None
    for c in (cfg, cfg8):
        first, cache = tfm.prefill(c, model, toks, cache_len=S)
        paged = to_paged(torch, tfm, c, cache, page)
        del cache
        if tok is None:
            tok = first.argmax(-1).to(torch.int32)    # the same for both
        logits[c.kv_cache_dtype or "bf16"], _ = tfm.decode_step(
            c, model, tok, paged, page_size=page, paged_len=S)
    d = (logits["int8"].float() - logits["bf16"].float()).abs()
    drift = float(d.max())
    agree = int((logits["int8"].argmax(-1) == logits["bf16"].argmax(-1))
                .sum())
    if not drift <= INT8_DRIFT_MAX or not torch.isfinite(d).all():
        raise AssertionError(f"int8 first-step logits drift {drift} from "
                             f"bf16 (gate {INT8_DRIFT_MAX})")
    log("int8", f"first decode step at context {ctx}, B={B}: int8 logits "
        f"against bf16 max abs {drift:.4f} (gate {INT8_DRIFT_MAX}), mean "
        f"abs {float(d.mean()):.4f}, std of the bf16 logits "
        f"{float(logits['bf16'].float().std()):.3f}; top-1 equal in "
        f"{agree}/{B} rows")
    prof = profile_pair(torch, f"qwen3-14b full-width decode step, B={B}, "
                        f"context {ctx}, int8 paged", lambda: tfm.decode_step(
                            cfg8, model, tok, paged, page_size=page,
                            paged_len=S), "paged_flash_decode_int8",
                        "decode_kernel")
    return dict(drift=drift, mean_abs=float(d.mean()), top1=agree,
                profile=prof)


def int8_tight_pair(torch, cfg, cfg8, model, wbytes):
    """The recovery phase's workload without faults over its 4480-token
    budget: 34 bf16 pages, then 66 int8 pages.  Every request must
    finish with all its tokens and both pools balance."""
    from repro_torch.kernels import runtime
    out = {}
    for label, c, want in (("bf16", cfg, REC_PAGES),
                           ("int8", cfg8, REC_PAGES_INT8)):
        eng = recovery_engine(torch, c, model, wbytes)
        be = eng.backend
        if be.alloc.n_pages != want:
            raise AssertionError(f"tight pool {label}: {be.alloc.n_pages} "
                                 f"pages, want {want}")
        reqs = recovery_requests(c)
        runtime.reset_launch_counts()
        eng.submit(reqs)
        t = time.perf_counter()
        eng.run(max_wall_s=600)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        final = finished_ids(eng, reqs)
        res = eng.result
        if len(final) != REC_N or any(len(o) != REC_NEW
                                      for o in final.values()) or \
                be.free_blocks() != want:
            raise AssertionError(f"tight pool {label}: {len(final)}/{REC_N} "
                                 f"finished, pages {be.free_blocks()}/{want}")
        out[label] = dict(pages=want, seconds=dt,
                          preempts=res.preempt_events,
                          yields=res.slice_yields,
                          ttft_p50=res.p50("ttft"), ttft_p99=res.p99("ttft"),
                          tpot_p50=res.p50("tpot"))
        log("int8", f"tight pool {label}, {want} pages, goodput scheduler, "
            f"slice {REC_SLICE}, no faults: {len(final)}/{REC_N} finished in "
            f"{dt:.2f} s; {res.preempt_events} preemptions, "
            f"{res.slice_yields} slice yields; TTFT p50 "
            f"{res.p50('ttft'):.3f} s, p99 {res.p99('ttft'):.3f} s; TPOT "
            f"p50 {res.p50('tpot') * 1e3:.1f} ms")
        del eng, be
        gc.collect()
        torch.cuda.empty_cache()
    return out


def int8_spill(torch, cfg8, model, wbytes):
    """An int8 pool of ``RET_SPILL_PAGES`` pages with an int8 host tier:
    the multi-turn workload (spills and restores > 0), then one page of
    codes and scales spilled, overwritten and restored into another page,
    byte for byte (an int8 pool passes an int8 tier raw)."""
    from repro_torch.core import paging
    dev = model.device
    per_tok = cfg8.kv_bytes_per_token(2)
    pool = -(-(RET_SPILL_PAGES + 1) * 128 * cfg8.cache_bytes_per_token()
             // per_tok)
    eng = make_engine(torch, cfg8, model, wbytes, True, 8, pool, dev=dev,
                      session_ttl=1000.0,
                      host_pool_tokens=RET_HOST_PAGES * 128,
                      spill_dtype="int8")
    be = eng.backend
    host = paging.host_tier_geometry(cfg8, RET_HOST_PAGES * 128, 128,
                                     "int8")[0]
    if be.alloc.n_pages != RET_SPILL_PAGES or be.alloc.host_pages != host:
        raise AssertionError(f"int8 spill run: {be.alloc.n_pages} device "
                             f"pages, {be.alloc.host_pages} host pages")
    counts, stats, _ = serve_run(torch, cfg8, eng, session_requests(cfg8),
                                 f"int8 spill, {RET_SPILL_PAGES}-page int8 "
                                 f"pool, {host}-slot int8 host tier")
    res, a = eng.result, be.alloc
    if not (res.spilled_pages > 0 and res.restored_pages > 0) or \
            a.free_host_slots() + a.spilled_slots() != a.host_pages or \
            a.free_pages() + a.live_pages() != a.n_pages or \
            not counts["paged_flash_decode_int8"]:
        raise AssertionError(f"int8 spill run: {res.spilled_pages} spilled, "
                             f"{res.restored_pages} restored, launches "
                             f"{counts}")
    cp = be.retention.copier
    if cp._scales:
        raise AssertionError("int8 spill run: a leaf was requantized")
    gen = torch.Generator(device=dev).manual_seed(9)
    leaves = dict((lk[2], leaf) for lk, leaf in cp._attn_leaves())

    def fill(leaf, page):
        shape = leaf[:, page].shape
        leaf[:, page] = (torch.randint(-127, 128, shape, generator=gen,
                                       device=dev).to(torch.int8)
                         if leaf.dtype == torch.int8 else
                         torch.rand(shape, generator=gen, device=dev))
    be.retention.clear(a)
    src, dst, hslot = 0, 1, 0
    for leaf in leaves.values():
        fill(leaf, src)
    want = {k: leaf[:, src].clone() for k, leaf in leaves.items()}
    cp.spill(src, hslot)
    for leaf in leaves.values():
        fill(leaf, src)
    cp.poll()
    cp.restore(hslot, dst)
    cp.poll()
    for k, leaf in leaves.items():
        got, w = leaf[:, dst], want[k]
        bits = (torch.equal(got, w) if got.dtype == torch.int8 else
                torch.equal(got.view(torch.int32), w.view(torch.int32)))
        if not bits or torch.equal(got, leaf[:, src]):
            raise AssertionError(f"int8 spill round trip: leaf {k} is not "
                                 f"the page as spilled")
    log("int8", f"int8 spill run: {res.spilled_pages} pages spilled "
        f"({res.spilled_bytes} B), {res.restored_pages} restored, "
        f"{res.spill_hold_events} holds, session hits {res.session_hits}/"
        f"{res.session_lookups}; paged_flash_decode_int8 "
        f"{counts['paged_flash_decode_int8']}; one page of "
        f"{', '.join(f'{k} {tuple(w.shape)} {w.dtype}' for k, w in want.items())}"
        f" spilled raw, overwritten and restored into another page: "
        f"byte-identical; {stats}")
    out = dict(spilled=res.spilled_pages, restored=res.restored_pages,
               host_pages=host, stats=stats)
    del eng, be, cp, leaves, want
    return out


def int8_phase(torch, cfg, model, wbytes, pool_tokens):
    """The int8 KV tier at full width on the same model: the serve runs
    over an int8 pool under the bf16 runs' ``pool_tokens``, the
    first-step logit drift against bf16 and the int8 step's profile, the
    tight-pool pair, and the int8 spill tier."""
    import dataclasses
    from repro_torch.core import paging
    t0 = time.perf_counter()
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    serve = int8_serve(torch, cfg8, model, wbytes, pool_tokens,
                       paging.device_pool_pages(cfg, pool_tokens, 128) - 1)
    gc.collect()
    torch.cuda.empty_cache()
    drift = int8_drift_and_profile(torch, cfg, cfg8, model)
    gc.collect()
    torch.cuda.empty_cache()
    tight = int8_tight_pair(torch, cfg, cfg8, model, wbytes)
    spill = int8_spill(torch, cfg8, model, wbytes)
    gc.collect()
    torch.cuda.empty_cache()
    log("int8", f"phase took {time.perf_counter() - t0:.1f} s")
    return dict(serve=serve, drift=drift, tight=tight, spill=spill)


def profile_steps(torch, label, step, kernel, match, steps=4):
    """Where a full-width decode step spends its time: ``steps`` calls
    of ``step`` under ``torch.profiler``.  Device busy time is the sum of
    the CUDA kernels' durations under the profiler; the idle share is
    what is left of the wall time of the same steps run without it.
    ``kernel`` is reported on its own, its device kernels found by
    ``match`` in their names."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    # wall time without the profiler, whose host-side tracing of every
    # op would inflate it
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log("profile", f"{label}: {wall_ms:.2f} ms wall; the profiler saw "
            f"no device events (device time not measured)")
        return dict(wall_ms=wall_ms)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3 / steps

    def share(pred):
        return sum(v for k, v in by_name.items() if pred(k)) / 1e3 / steps
    own = share(lambda k: match in k)
    gemm = share(lambda k: any(w in k.lower() for w in
                               ("gemm", "cutlass", "xmma", "nvjet", "sm90")))
    log("profile", f"{label}: {wall_ms:.2f} ms wall, {busy_ms:.2f} ms "
        f"device busy (idle share {1 - busy_ms / wall_ms:.3f}); {kernel} "
        f"{own:.2f} ms, matmuls {gemm:.2f} ms, other kernels "
        f"{busy_ms - own - gemm:.2f} ms; {len(kernels) // steps} kernel "
        f"launches per step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log("profile", "top kernels per step: " + "; ".join(
        f"{k[:60]} {v / 1e3 / steps:.3f} ms" for k, v in top))
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1 - busy_ms / wall_ms, own_ms=own, gemm_ms=gemm,
                other_ms=busy_ms - own - gemm,
                launches=len(kernels) // steps)


def profile_pair(torch, label, step, kernel, match):
    """``profile_steps`` of ``step`` run eagerly, then of a
    ``DecodeGraph`` of it replayed (its launches are the kernels a replay
    runs, as the profiler sees them)."""
    from repro_torch.core.engine import DecodeGraph
    eager = profile_steps(torch, f"{label}, eager", step, kernel, match)
    g = DecodeGraph(step, torch.device("cuda"))
    graph = profile_steps(torch, f"{label}, graph replay", g.replay,
                          kernel, match)
    graph.update(capture_s=g.capture_seconds, graph_pool_bytes=g.pool_bytes)
    log("profile", f"{label}: graph capture {g.capture_seconds:.3f} s, "
        f"private pool {g.pool_bytes} B; step wall eager "
        f"{eager['wall_ms']:.2f} ms, graph {graph['wall_ms']:.2f} ms")
    return {"eager": eager, "graph": graph}


# (Tc, B, q_offset): the serve chunk at 8 and 1 rows, a short chunk, and
# a resumed session turn's chunk off the 64-row tile
PREFILL_PROFILE = ((512, 8, 1536), (512, 1, 1536), (128, 4, 1536),
                   (45, 4, 1037))


def prefill_profile_phase(torch, cfg, model, wbytes):
    """Where a full-width Qwen3-14B prefill chunk spends its time, eager
    and as a prefill-graph replay: for each ``PREFILL_PROFILE`` shape,
    the paged engine's ``prefill_chunk`` (its input copies, the chunk
    over the engine's batch cache of 8 rows and cache length 4096, the
    argmax read back) at that offset, under ``profile_steps``: wall,
    device busy, idle share and kernels a chunk.  The graph engine's
    first call of the shape runs it eagerly, its second runs it eagerly
    and captures it; the profiled calls are replays."""
    from repro_torch.core.batcher import FormedBatch
    from repro_torch.core.serving_loop import PrefillJob
    from repro_torch.kernels import runtime
    out, launched = {}, {}
    for mode in ("eager", "graph"):
        eng = make_engine(torch, cfg, model, wbytes, True, 8,
                          34 * 128, decode_graph=False,
                          prefill_graph=None if mode == "graph" else False)
        be = eng.backend
        for Tc, B, off in PREFILL_PROFILE:
            reqs = requests([off + Tc + 8] * B, 2)
            be.begin(reqs)
            job = PrefillJob(FormedBatch(reqs, pad_to=off + Tc + 8),
                             [(0, off), (off, Tc), (off + Tc, 8)])
            label = (f"qwen3-14b full-width prefill chunk Tc={Tc}, B={B}, "
                     f"q_offset {off}, batch cache 8 x {cfg.max_seq_len}, "
                     f"{mode}")
            # the shape's first three calls, each to its end on the
            # card: with the graph, an eager run, an eager run and the
            # capture, then the first replay
            pg = be.prefill_graph
            cap0 = pg.capture_seconds if pg is not None else 0.0
            first = []
            runtime.reset_launch_counts()
            for _ in range(3):
                t0 = time.perf_counter()
                be.prefill_chunk(job, 1)
                torch.cuda.synchronize()
                first.append((time.perf_counter() - t0) * 1e3)
            launched[mode, Tc, B, off] = (
                runtime.launch_counts["flash_prefill"],
                dict(runtime.prefill_body_counts),
                dict(runtime.prefill_unaligned_counts))
            cap = (pg.capture_seconds - cap0) * 1e3 if pg is not None else 0.0
            log("prefill", f"{label}: first call {first[0]:.2f} ms, "
                f"second call {first[1]:.2f} ms (of it the capture's host "
                f"time {cap:.2f} ms), third call {first[2]:.2f} ms")
            row = profile_steps(torch, label, lambda: be.prefill_chunk(job, 1),
                                "flash_prefill", "flash_prefill", steps=3)
            out[f"Tc={Tc} B={B} off={off} {mode}"] = dict(
                row, first_ms=first[0], second_ms=first[1],
                third_ms=first[2], capture_ms=cap)
            be._job = None
        pg = be.prefill_graph
        if pg is not None:
            if not prefill_graph_ok(pg, len(PREFILL_PROFILE)) \
                    or not pg.replays:
                raise AssertionError(f"prefill profile: {pg.captures} "
                                     f"captures, {pg.replays} replays")
            out["graph pool bytes"] = pg.pool_bytes
            out["graph capture s"] = pg.capture_seconds
            log("prefill", f"prefill graphs: {pg.captures} captured in "
                f"{pg.capture_seconds:.3f} s, {pg.replays} replays, pool "
                f"{pg.pool_bytes} B")
        del eng, be
        gc.collect()
        torch.cuda.empty_cache()
    # the first three calls of each shape (with the graph: two eager
    # runs, the second captured, then a replay) launch what the eager
    # engine's do, every one on the tensor-core body, the unaligned ones
    # counted from each call's own offset
    L = cfg.n_layers
    for Tc, B, off in PREFILL_PROFILE:
        want = (3 * L, {"tensor_core": 3 * L, "cuda_core": 0},
                {"tensor_core": 3 * L if off % runtime.PREFILL_TILE else 0,
                 "cuda_core": 0})
        for mode in ("eager", "graph"):
            if launched[mode, Tc, B, off] != want:
                raise AssertionError(
                    f"prefill profile Tc={Tc} B={B} q_offset {off} {mode}: "
                    f"flash_prefill launches, by body, unaligned by body "
                    f"{launched[mode, Tc, B, off]}, want {want}")
    log("prefill", f"the first three calls of each shape launched "
        f"flash_prefill {3 * L} times on the tensor-core body in both "
        f"modes, unaligned {3 * L} at q_offset 1037 and 0 at 1536 (a "
        f"replay's counted from its own offset)")
    for Tc, B, off in PREFILL_PROFILE:
        e = out[f"Tc={Tc} B={B} off={off} eager"]
        g = out[f"Tc={Tc} B={B} off={off} graph"]
        log("prefill", f"Tc={Tc} B={B} q_offset {off}: wall eager "
            f"{e['wall_ms']:.2f} ms, graph {g['wall_ms']:.2f} ms; device "
            f"busy {e.get('busy_ms', float('nan')):.2f} / "
            f"{g.get('busy_ms', float('nan')):.2f} ms; idle share "
            f"{e.get('idle_share', float('nan')):.3f} / "
            f"{g.get('idle_share', float('nan')):.3f}; kernels a chunk "
            f"{e.get('launches')} / {g.get('launches')}")
    return out


def profile_phase(torch, cfg, model):
    """Qwen3-14B decode step: 8 rows at context 1024 on the paged pool."""
    from repro_torch.models import transformer as tfm
    dev = torch.device("cuda")
    B, ctx, page = 8, 1024, 128
    S = cfg.max_seq_len
    toks = torch.randint(0, cfg.vocab_size, (B, ctx), device=dev,
                         dtype=torch.int32)
    logits, cache = tfm.prefill(cfg, model, toks, cache_len=S)
    paged = to_paged(torch, tfm, cfg, cache, page)
    del cache
    tok = logits.argmax(-1).to(torch.int32)
    return profile_pair(torch, f"qwen3-14b full-width decode step, B={B}, "
                        f"context {ctx}, paged", lambda: tfm.decode_step(
                            cfg, model, tok, paged, page_size=page,
                            paged_len=S), "paged_flash_decode",
                        "decode_kernel")


# ------------------------------------------------------------ analysis ---
ANALYSIS_CHUNK = (512, 8, 1536)     # (Tc, B, q_offset): the serve chunk
ANALYSIS_BOUND_SLACK = 1.05         # a count's bound over the measured time
ANALYSIS_PATH = "qwen3-14b under launch/op_analysis.count"
DRYRUN_SECONDS = 900
DRYRUN_JOBS = 8                     # pairs traced at once: one a pair
# the two rwkv6-3b train pairs (single and multi pod): wkv6 forward and
# backward by formula; the plain versions' loop over 4096 steps skipped
RWKV_DRYRUN_PAIRS = ("--arch", "rwkv6-3b", "--shape", "train_4k",
                     "--both-meshes")


def fake_like(torch, tree, device):
    """``tree`` with each tensor replaced by an empty one of its shape,
    strides and dtype on ``device``: a fake tensor when called under a
    ``FakeTensorMode`` (nothing allocated)."""
    if isinstance(tree, dict):
        return {k: fake_like(torch, v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fake_like(torch, v, device) for v in tree)
    if not hasattr(tree, "shape"):
        return tree
    return torch.empty_strided(tree.shape, tree.stride(), dtype=tree.dtype,
                               device=device)


def count_diff(a, b) -> list:
    """The ops two counts saw differently: (op, calls, FLOPs, bytes) of
    each side."""
    out = []
    for name in sorted(set(a.ops) | set(b.ops)):
        sa, sb = a.op_stats.get(name), b.op_stats.get(name)
        if a.ops[name] != b.ops[name] or sa != sb:
            out.append((name, a.ops[name], b.ops[name],
                        sa and (sa.flops, sa.bytes),
                        sb and (sb.flops, sb.bytes)))
    return out


def start_dryrun(out: Path, pairs, jobs: int):
    """``launch/dryrun.py <pairs> --device cuda`` in a subprocess (the
    distribution phase owns this process's default process group),
    writing ``out`` afresh."""
    import os
    if out.exists():
        out.unlink()
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *pairs,
         "--device", "cuda", "--jobs", str(jobs), "--out", str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def dryruns() -> dict:
    """The analysis phase's two dry-runs on fake ``cuda`` tensors, side by
    side in subprocesses: ``--arch qwen3-14b --all`` (8 pairs,
    ``DRYRUN_JOBS`` at a time) and rwkv6-3b's two ``train_4k`` pairs
    (``RWKV_DRYRUN_PAIRS``: a ``roofline`` each with ``wkv6`` twice a
    layer, forward and remat, and ``wkv6_bwd`` once, by formula; the
    plain count skipped with its reason).  Both are checked by
    ``finish_dryrun``; a subprocess still running when this returns or
    raises is killed."""
    from repro_torch.configs import get_config
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    runs = {"dryrun": (build / "dryrun_torch.json",
                       ("--arch", "qwen3-14b", "--all"), DRYRUN_JOBS, 8),
            "dryrun_rwkv": (build / "dryrun_torch_rwkv.json",
                            RWKV_DRYRUN_PAIRS, 2, 2)}
    t0 = time.perf_counter()
    procs = {}
    try:
        for key, (path, pairs, jobs, _) in runs.items():
            procs[key] = start_dryrun(path, pairs, jobs)
        out = {key: finish_dryrun(procs[key], path, t0, " ".join(pairs),
                                  want)
               for key, (path, pairs, _, want) in runs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    kernels = {k: r["kernels"]
               for k, r in out["dryrun_rwkv"]["records"].items()}
    n = get_config("rwkv6-3b").n_layers
    if any(k != {"wkv6": 2 * n, "wkv6_bwd": n} for k in kernels.values()):
        raise AssertionError(f"dryrun rwkv6-3b train_4k: kernels {kernels},"
                             f" want {2 * n} wkv6 (forward and remat) and "
                             f"{n} wkv6_bwd a step")
    return out


def finish_dryrun(proc, out: Path, t0: float, label: str,
                  want: int) -> dict:
    """Wait for ``start_dryrun``'s subprocess (killed past
    ``DRYRUN_SECONDS``), check its ``want`` records (no error, no pair
    skipped whole, a ``roofline`` each; a ``roofline_plain`` may be
    skipped with its reason) and print their terms."""
    try:
        text, _ = proc.communicate(timeout=DRYRUN_SECONDS)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"dryrun {label}: not done after "
                             f"{DRYRUN_SECONDS} s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"dryrun {label} exited {proc.returncode}:\n"
                             f"{text[-3000:]}")
    recs = json.loads(out.read_text())
    if len(recs) != want or any(
            "error" in r or "skipped" in r or "skipped" in r["roofline"]
            for r in recs.values()):
        raise AssertionError(f"dryrun {label}: {len(recs)} records, want "
                             f"{want} with no error or skip and a roofline "
                             f"each")
    for key, r in recs.items():
        for tag in ("roofline", "roofline_plain"):
            t = r[tag]
            if "skipped" in t:
                log("analysis", f"dryrun {key} {tag}: skipped: "
                    f"{t['skipped']}")
                continue
            log("analysis", f"dryrun {key} {tag} (counts, not times; "
                f"traced on fake {r['device']} in {r['trace_s']} s): "
                f"{t['flops_per_device']:.4g} FLOP, "
                f"{t['bytes_per_device']:.4g} B, "
                f"{t['coll_bytes_per_device']:.4g} B of collectives a rank;"
                f" compute {t['compute_s']:.4g} s, memory "
                f"{t['memory_s']:.4g} s, collective {t['collective_s']:.4g}"
                f" s, {t['dominant']}, useful {t['useful_ratio']:.3f}; "
                f"args {r['memory']['argument_bytes'] / 2 ** 30:.2f} GiB, "
                f"temp {r['memory']['temp_bytes'] / 2 ** 30:.2f} GiB; "
                f"kernels {r['kernels']}")
    log("analysis", f"dryrun {label} --device cuda: {want} records, 0 "
        f"errors, {wall:.1f} s of wall time")
    return dict(records=recs, wall_s=wall)


def unfused_refused(torch, oa, runtime, call) -> str:
    """An unfused count of the decode step on real ``cuda`` tensors must
    raise before its first kernel call, and launch no kernel: on the
    card the plain version never takes a kernel's place."""
    fn, args, kw = call[:3]
    runtime.reset_launch_counts()
    try:
        oa.count(fn, *args, fused_kernels=False, **kw)
    except ValueError as e:
        msg = str(e)
    else:
        raise AssertionError("analysis: an unfused count on cuda tensors "
                             "ran the plain versions")
    torch.cuda.synchronize()
    if any(runtime.launch_counts.values()):
        raise AssertionError(f"analysis: the refused unfused count "
                             f"launched {dict(runtime.launch_counts)}")
    log("analysis", f"unfused count on cuda tensors refused, no launch: "
        f"{msg}")
    return msg


SCOPE_CALLS = 40                    # paged decode calls a step (40 layers)
SCOPE_ROUNDS = 200


def scope_host_cost(torch, cfg, smi) -> dict:
    """Host time of ``SCOPE_CALLS`` ``ops.paged_flash_decode`` calls
    (the decode step's, B = 8 at context 1024 over 4096 slots) through
    the ``kernels/cost.py`` scope and through the entry it wraps
    (``__wrapped__``), outside a count, the two interleaved; the
    median of ``SCOPE_ROUNDS`` rounds each.  The difference is what the
    scope adds to an eager step on this host."""
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    B, H, Hkv, Dh, page, S, pos = 8, cfg.n_heads, cfg.n_kv_heads, \
        cfg.d_head, 128, 4096, 1024
    q = torch.randn(B, H, Dh, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn(B * S // page, page, Hkv, Dh, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    tables = torch.arange(B * S // page, device=dev,
                          dtype=torch.int32).view(B, S // page)
    posv = torch.full((B,), pos, device=dev, dtype=torch.int32)
    fns = {"scope": ops.paged_flash_decode,
           "entry": ops.paged_flash_decode.__wrapped__}
    times = {name: [] for name in fns}
    for _ in range(SCOPE_ROUNDS):
        for name, f in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SCOPE_CALLS):
                f(q, k, v, tables, posv, s_len=S)
            times[name].append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    med = {name: statistics.median(t) for name, t in times.items()}
    r = dict(calls=SCOPE_CALLS, rounds=SCOPE_ROUNDS, scope_us=med["scope"],
             entry_us=med["entry"], added_us=med["scope"] - med["entry"],
             added_us_a_call=(med["scope"] - med["entry"]) / SCOPE_CALLS)
    log("analysis", f"scope's host cost, {SCOPE_CALLS} paged_flash_decode "
        f"calls outside a count (median of {SCOPE_ROUNDS} rounds): "
        f"{r['scope_us']:.2f} us through the scope, {r['entry_us']:.2f} us "
        f"through the entry it wraps; added {r['added_us']:.2f} us a step, "
        f"{r['added_us_a_call']:.3f} us a call; on {smi}")
    return r


def analysis_phase(torch, cfg, model):
    """``launch/op_analysis.py`` held against the card: the profile
    phase's full-width Qwen3-14B paged decode step (B = 8, context 1024)
    and one 512 x 8 prefill chunk at offset 1536 over an 8-row batch
    cache, each counted on real tensors (the kernels launch and count by
    their formulas) and traced again on fake ``cuda`` tensors: FLOPs,
    bytes, collective bytes, per-op counts and kernel calls must be
    equal.  The decode step is also traced on fake ``cpu`` tensors and
    the ops where the two devices' traces differ are listed.  Each
    count's bound at the H100 peaks (the larger of ``compute_s`` and
    ``memory_s``) beside the CUDA-event time of the same call, eager and
    (the step) as a graph replay, must be at most
    ``ANALYSIS_BOUND_SLACK`` x that time.  Each count takes the live
    keys a row from the host (``count(..., context=)``).  An unfused
    count on the card's tensors must raise and launch nothing, and the
    scope's host cost is timed against the entry it wraps.  Then the
    dry-runs (``dryruns``: ``--arch qwen3-14b --all`` and rwkv6-3b's two
    ``train_4k`` pairs) join the result."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.engine import DecodeGraph
    from repro_torch.kernels import runtime
    from repro_torch.launch import op_analysis as oa
    from repro_torch.launch.input_specs import params_shapes
    from repro_torch.models import transformer as tfm
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    B, ctx, page = 8, 1024, 128
    S = cfg.max_seq_len
    toks = torch.randint(0, cfg.vocab_size, (B, ctx), device=dev,
                         dtype=torch.int32)
    logits, cache = tfm.prefill(cfg, model, toks, cache_len=S)
    paged = to_paged(torch, tfm, cfg, cache, page)
    del cache
    tok = logits.argmax(-1).to(torch.int32)
    Tc, Bc, off = ANALYSIS_CHUNK
    ctoks = torch.randint(0, cfg.vocab_size, (Bc, Tc), device=dev,
                          dtype=torch.int32)
    clens = torch.full((Bc,), off + Tc + 8, dtype=torch.int32,
                       device=dev)
    batch_cache = tfm.init_cache(cfg, Bc, S, torch.bfloat16, dev)
    # (fn, args, kwargs, tokens, the live keys a row the host knows: the
    # decode token at position ctx sees ctx + 1 slots, the chunk's rows
    # their lengths)
    calls = {
        "decode": (tfm.decode_step, (cfg, model, tok, paged),
                   dict(page_size=page, paged_len=S), 2.0 * B, ctx + 1),
        "chunk": (tfm.prefill_chunk,
                  (cfg, model, ctoks, batch_cache, off, clens), {},
                  2.0 * Bc * Tc, off + Tc + 8)}
    out, launched = {}, {}
    for name, (fn, args, kw, tokens, live) in calls.items():
        runtime.reset_launch_counts()
        real = oa.count(fn, *args, context=live, **kw)
        torch.cuda.synchronize()
        launched[name] = {k: v for k, v in runtime.launch_counts.items()
                          if v}
        traces = {}
        for fdev in ("cuda", "cpu") if name == "decode" else ("cuda",):
            with FakeTensorMode():
                fmodel = params_shapes(cfg, torch.bfloat16, fdev)
                fargs = (cfg, fmodel) + fake_like(torch, args[2:],
                                                  fdev)
                traces[fdev] = oa.count(fn, *fargs, context=live, **kw)
        fake = traces["cuda"]
        same = (real.stats == fake.stats and real.ops == fake.ops
                and real.kernels == fake.kernels)
        if not same:
            raise AssertionError(f"analysis {name}: real count "
                                 f"{real.stats} {dict(real.kernels)} != "
                                 f"fake cuda {fake.stats} "
                                 f"{dict(fake.kernels)}; ops "
                                 f"{count_diff(real, fake)}")
        terms = oa.analyze(real, 1, cfg.active_param_count() * tokens)
        formulas = {k: (v.flops, v.bytes)
                    for k, v in real.kernel_stats.items()}
        log("analysis", f"{name} (live keys a row {live}): real == fake "
            f"cuda: {real.stats.flops:.6g} FLOP, {real.stats.bytes:.6g} B, "
            f"{sum(real.stats.coll.values()):.6g} B of collectives, "
            f"{sum(real.ops.values())} ops outside {dict(real.kernels)} "
            f"kernel calls (the kernels' formulas, FLOP and B: "
            f"{formulas}); launches in the real count {launched[name]}")
        if "cpu" in traces:
            cpu = traces["cpu"]
            log("analysis", f"{name}: fake cpu trace "
                f"{cpu.stats.flops:.6g} FLOP, {cpu.stats.bytes:.6g} B "
                f"against fake cuda {fake.stats.flops:.6g} FLOP, "
                f"{fake.stats.bytes:.6g} B; ops that differ (op, calls "
                f"cuda / cpu, (FLOP, B) cuda / cpu): "
                f"{count_diff(fake, cpu)}")
        out[name] = dict(flops=real.stats.flops, bytes=real.stats.bytes,
                         compute_s=terms.compute_s,
                         memory_s=terms.memory_s,
                         launches=launched[name],
                         memory=real.memory)
    # measured: CUDA-event time a call (eager: the stream's elapsed
    # time, its idle gaps included), the step also as a graph replay
    step = calls["decode"]
    times = {
        "decode eager": time_ms(torch, lambda: step[0](
            *step[1], **step[2]), 20),
        "chunk eager": time_ms(torch, lambda: tfm.prefill_chunk(
            cfg, model, ctoks, batch_cache, off, clens), 5, 1)}
    g = DecodeGraph(lambda: step[0](*step[1], **step[2]), dev)
    times["decode graph"] = time_ms(torch, g.replay, 20)
    del g
    for key, ms in times.items():
        r = out[key.split()[0]]
        bound = max(r["compute_s"], r["memory_s"]) * 1e3
        by = "compute" if r["compute_s"] >= r["memory_s"] else "memory"
        r[f"{key.split()[1]}_ms"] = ms
        log("analysis", f"{key}: count's bound {bound:.4f} ms "
            f"({by}; compute {r['compute_s'] * 1e3:.4f} ms, memory "
            f"{r['memory_s'] * 1e3:.4f} ms at 989e12 FLOP/s and "
            f"3.35e12 B/s) against {ms:.4f} ms measured: share "
            f"{bound / ms:.4f} on {smi}")
        if bound > ANALYSIS_BOUND_SLACK * ms:
            raise AssertionError(f"analysis {key}: bound {bound:.4f} ms "
                                 f"> {ANALYSIS_BOUND_SLACK} x measured "
                                 f"{ms:.4f} ms: the count is wrong")
    want = {"decode": {"paged_flash_decode": cfg.n_layers},
            "chunk": {"flash_prefill": cfg.n_layers}}
    if launched != want:
        raise AssertionError(f"analysis: launches {launched}, want "
                             f"{want} (the profile phase's a step and "
                             f"a chunk)")
    out["unfused_on_card"] = unfused_refused(torch, oa, runtime,
                                             calls["decode"])
    out["scope_host_us"] = scope_host_cost(torch, cfg, smi)
    del paged, batch_cache
    gc.collect()
    torch.cuda.empty_cache()
    out.update(dryruns())
    return out


def rwkv_profile_phase(torch, cfg, model):
    """rwkv6-3b decode step: 8 rows after a 1024-token prefill."""
    from repro_torch.models import transformer as tfm
    dev = torch.device("cuda")
    B, ctx = 8, 1024
    toks = torch.randint(0, cfg.vocab_size, (B, ctx), device=dev,
                         dtype=torch.int32)
    logits, cache = tfm.prefill(cfg, model, toks, cache_len=ctx)
    tok = logits.argmax(-1).to(torch.int32)
    return profile_pair(torch, f"rwkv6-3b full-width decode step, B={B}, "
                        f"after {ctx} tokens", lambda: tfm.decode_step(
                            cfg, model, tok, cache), "wkv6", "wkv6_kernel")


# ---------------------------------------------------------------- paper ---
PAPER_SLOTS = 8             # prefill batch cap and decode slots
PAPER_REQUESTS = 32         # the comparison's requests, arriving over time
PAPER_RPS = 8.0
PAPER_MAX_NEW = 64          # generated tokens a request, at most
# llama2-13b attention (MHA, G = 1) at the decode kernels' main shape
PAPER_ATTN = dict(B=8, H=40, Hkv=40, Dh=128, S=4096)


def paper_kernels(torch):
    """The attention kernels at llama2-13b's widths, bf16: both decode
    kernels at B = 8 over 4096 slots at contexts 2048 and 4096 (the
    whole cache), with the split the rule picks, and a 512-token prefill
    chunk at ``q_offset`` 1536 over 4096; each against its plain version
    at that shape, timed beside its bound and SDPA's time."""
    from repro_torch.kernels import decode_attn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    tol = MAIN_TOL["bfloat16"]
    B, H, Hkv, Dh, S = (PAPER_ATTN[k] for k in ("B", "H", "Hkv", "Dh", "S"))

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)
    rows = {}
    q = rnd((B, H, Dh))
    kc, vc = rnd((B, S, Hkv, Dh)), rnd((B, S, Hkv, Dh))
    kp, vp, bt = paged_copy(torch, kc, vc, 128, gen)
    for ctx in (2048, S):
        pos = torch.full((B,), ctx - 1, dtype=torch.int32, device=dev)
        case = decode_case(torch, q, kc, vc, kp, vp, bt, pos, tol,
                           f"llama2 ctx {ctx}", True)
        rows[f"flash_decode B=8 H=Hkv=40 ctx={ctx}"] = case["flash_decode"]
        rows[f"paged_flash_decode B=8 H=Hkv=40 ctx={ctx} page=128"] = \
            case["paged_flash_decode"]
    p = decode_attn.plan(B, Hkv, S, torch.bfloat16, Dh)
    log("paper", f"decode split at llama2-13b widths (B {B}, Hkv {Hkv}, S "
        f"{S}): n_split {p.n_split}, L {p.L}, {B * Hkv * p.n_split} blocks "
        f"on {torch.cuda.get_device_properties(0).multi_processor_count} "
        f"SMs, {p.body} body")
    del q, kc, vc, kp, vp

    q, k, v = rnd((1, 512, H, Dh)), rnd((1, S, Hkv, Dh)), rnd((1, S, Hkv, Dh))
    rows["flash_prefill H=Hkv=40 chunk 512@1536/4096"] = chunk_case(
        torch, q, k, v, 1536, tol, "llama2 chunk", True)
    del q, k, v
    torch.cuda.empty_cache()
    log_rows("paper", rows)
    return rows


def paper_fits(torch, cfg, model, wbytes):
    """The card's figures for ``core/hardware.py``'s ``H100`` spec, each
    beside the spec's constant: ``bw_eff`` from a graph-mode decode step
    (B = 8 at context 1024, paged, profiled eagerly and as a graph),
    ``mfu`` from a 512-token prefill chunk of 8 rows at offset 1536, and
    ``link_bw`` from a 1 GiB device-to-device copy; with the cost model's
    time for the same step and chunk."""
    from repro_torch.core.hardware import H100
    from repro_torch.core.simulator import CostModel
    from repro_torch.models import transformer as tfm
    dev = torch.device("cuda")
    cost = CostModel(cfg, H100)
    per_tok = cfg.kv_bytes_per_token(2)
    B, ctx, page = 8, 1024, 128
    # the prompt and the profiled steps fit in 10 pages a row; the block
    # tables span the engine's 4096 slots, the rest on the trash page
    toks = torch.randint(0, cfg.vocab_size, (B, ctx), device=dev,
                         dtype=torch.int32)
    logits, cache = tfm.prefill(cfg, model, toks, cache_len=10 * page)
    paged = to_paged(torch, tfm, cfg, cache, page, s_len=cfg.max_seq_len)
    del cache
    tok = logits.argmax(-1).to(torch.int32)
    prof = profile_pair(
        torch, f"llama2-13b full-width decode step, B={B}, context {ctx}, "
        f"paged", lambda: tfm.decode_step(cfg, model, tok, paged,
                                          page_size=page,
                                          paged_len=cfg.max_seq_len),
        "paged_flash_decode", "decode_kernel")
    del paged, logits, tok
    torch.cuda.empty_cache()
    step_ms = prof["graph"]["wall_ms"]
    step_bytes = wbytes + B * (ctx + 1) * per_tok
    bw_eff = step_bytes / (step_ms * 1e-3) / HBM_BYTES_PER_S
    step_pred = cost.decode_iter_seconds(B * (ctx + 1), B) * 1e3

    Tc, off = 512, 1536
    toks = torch.randint(0, cfg.vocab_size, (B, off + Tc), device=dev,
                         dtype=torch.int32)
    lens = torch.full((B,), off + Tc, dtype=torch.int32, device=dev)
    cache = tfm.init_cache(cfg, B, off + Tc, torch.bfloat16, dev)
    for start in range(0, off, Tc):
        _, cache = tfm.prefill_chunk(cfg, model, toks[:, start:start + Tc],
                                     cache, start, lens)
    chunk_ms = time_ms(torch, lambda: tfm.prefill_chunk(
        cfg, model, toks[:, off:], cache, off, lens), 5, 1)
    del cache, toks
    torch.cuda.empty_cache()
    chunk_flops = 2.0 * cost.p_active * B * Tc + B * (
        cost._attn_flops(off + Tc) - cost._attn_flops(off))
    mfu = chunk_flops / (chunk_ms * 1e-3) / PEAK_FLOPS["bfloat16"]
    chunk_pred = cost.prefill_chunk_seconds(B, off, Tc) * 1e3

    src = torch.empty(2 ** 29, dtype=torch.bfloat16, device=dev)
    dst = torch.empty_like(src)
    copy_ms = time_ms(torch, lambda: dst.copy_(src), 10)
    del src, dst
    link_bw = 2 ** 30 / (copy_ms * 1e-3)
    log("paper", f"H100 spec fitted on this card: bw_eff {bw_eff:.4f} "
        f"(spec {H100.bw_eff}; {step_bytes / 1e9:.2f} GB a graph step in "
        f"{step_ms:.3f} ms, the cost model's {step_pred:.3f} ms), mfu "
        f"{mfu:.4f} (spec {H100.mfu}; {chunk_flops / 1e12:.2f} TFLOP a "
        f"chunk in {chunk_ms:.3f} ms, the cost model's {chunk_pred:.3f} "
        f"ms), link_bw {link_bw:.4g} B/s (spec {H100.link_bw:.4g}; 1 GiB "
        f"copied in {copy_ms:.3f} ms)")
    return dict(bw_eff=bw_eff, mfu=mfu, link_bw=link_bw, step_ms=step_ms,
                step_pred_ms=step_pred, chunk_ms=chunk_ms,
                chunk_pred_ms=chunk_pred, copy_ms=copy_ms, profile=prof)


def record_formed(sched):
    """Record every batch ``sched`` forms (request-id tuples) in
    ``sched.formed``; returns ``sched``."""
    sched.formed = []
    form = sched.next_prefill_batch

    def recorded(now):
        batch = form(now)
        if batch is not None:
            sched.formed.append(tuple(r.rid for r in batch.requests))
        return batch
    sched.next_prefill_batch = recorded
    return sched


def paper_scheduler(cfg, name, budget):
    """``bucketserve`` (the paper's waste trigger on the paged memory
    model) or ``distserve`` (``baselines.DistServeLikeScheduler``), each
    capped at ``PAPER_SLOTS`` a batch, on ``budget``."""
    from repro_torch.core import BucketServeScheduler, SchedulerConfig
    from repro_torch.core.baselines import DistServeLikeScheduler
    if name == "bucketserve":
        return BucketServeScheduler(cfg, budget, SchedulerConfig(
            max_batch=PAPER_SLOTS, trigger="waste", memory_model="paged",
            page_size=128))
    return DistServeLikeScheduler(cfg, budget, max_batch=PAPER_SLOTS)


def paper_sim(cfg, sched, reqs, pool_tokens, chunk=512, page=128):
    """The port's cost model on ``core/hardware.py``'s ``H100`` beside an
    engine run: the engine's disagg loop, slots, chunk, page and pool."""
    from repro_torch.core.hardware import H100
    from repro_torch.core.simulator import CostModel, Simulator
    sim = Simulator(sched, CostModel(cfg, H100), mode="disagg",
                    decode_slot_cap=PAPER_SLOTS, chunk_tokens=chunk,
                    paged=True, page_size=page, kv_pool_tokens=pool_tokens,
                    cache_len=cfg.max_seq_len)
    return sim, sim.run(reqs)


def paper_compare(torch, cfg, model, wbytes, pool_tokens, hbm, dev="cuda",
                  n=PAPER_REQUESTS, max_new=PAPER_MAX_NEW, chunk=512,
                  page=128):
    """BucketServe against the DistServe-like baseline on the same
    requests with their arrivals: the launcher's ``make_requests`` rules
    (the mixed dataset at 8 req/s, prompts clipped at ``max_seq_len -
    16``, generated tokens capped at ``max_new``), each system on a fresh
    engine with the decode graph alone and then on another with the
    decode and the prefill graphs (its prefill graphs must replay), in
    the disagg loop that
    ``SIM_MODE`` gives both, each budgeted from the one reading ``hbm``;
    and the cost model on the same requests beside each run.  Gates: every
    request finished in both runs and in both predictions, and every page
    free after each run."""
    from repro_torch.core import MemoryBudget
    from repro_torch.core.baselines import SIM_MODE
    from repro_torch.launch import serve as launcher
    args = launcher.build_parser().parse_args(
        ["--arch", cfg.name, "--requests", str(n), "--dataset", "mixed",
         "--rps", str(PAPER_RPS), "--paged"])
    base = launcher.make_requests(cfg, args, max_new=max_new)
    budget = MemoryBudget(hbm_bytes_per_device=hbm, n_devices=1,
                          weight_bytes=wbytes)
    log("paper", f"{len(base)} requests of the mixed dataset at "
        f"{PAPER_RPS} req/s over {base[-1].arrival:.2f} s, prompts "
        f"{min(r.prompt_len for r in base)}-"
        f"{max(r.prompt_len for r in base)} tokens "
        f"({sum(r.prompt_len for r in base)} in all), "
        f"{sum(r.max_new_tokens for r in base)} tokens to generate")
    out = {}
    for name in ("bucketserve", "distserve"):
        if SIM_MODE[name] != "disagg":
            raise AssertionError(f"{name}: mode {SIM_MODE[name]}")
        alone = {}
        for mode in ("decode graph", "graph"):
            sched = record_formed(paper_scheduler(cfg, name, budget))
            eng = make_engine(torch, cfg, model, wbytes, True, PAPER_SLOTS,
                              pool_tokens, dev=dev, chunk=chunk, page=page,
                              sched=sched, batch=PAPER_SLOTS,
                              **GRAPH_MODES[mode])
            counts, stats, steps = serve_run(
                torch, cfg, eng, copy.deepcopy(base),
                f"llama2-13b {name}, {mode}")
            be, res = eng.backend, eng.result
            if be.free_blocks() != be.alloc.n_pages:
                raise AssertionError(f"paper {name} {mode}: "
                                     f"{be.free_blocks()} of "
                                     f"{be.alloc.n_pages} pages free")
            if mode == "graph":
                stats.update(prefill_graph_stats(eng, f"paper {name}",
                                                 want_replays=True))
                break
            alone = dict(stats)
            del eng, be, res
            gc.collect()
            if dev == "cuda":
                torch.cuda.empty_cache()
        sim_sched = record_formed(paper_scheduler(cfg, name, budget))
        _, pred = paper_sim(cfg, sim_sched, copy.deepcopy(base), pool_tokens,
                            chunk, page)
        if len(pred.finished()) != len(base):
            raise AssertionError(f"paper {name}: the cost model finished "
                                 f"{len(pred.finished())}/{len(base)}")
        buckets = [(b.low, b.up) for b in sched.buckets.buckets] \
            if hasattr(sched, "buckets") else None
        row = dict(stats, decode_graph_alone=alone, slo=res.slo_attainment(),
                   padding_waste=res.padding_waste_ratio(),
                   kv_util=res.kv_util_time_weighted,
                   preemptions=res.preempt_events, buckets=buckets,
                   pages=be.alloc.n_pages, makespan=res.makespan,
                   prefill_chunks=steps["prefill"],
                   decode_steps=steps["decode"],
                   launches={k: counts[k] for k in ATTENTION_KERNELS},
                   batches=len(sched.formed),
                   predicted=dict(
                       tok_s=pred.output_tok_s(),
                       batches=len(sim_sched.formed),
                       ttft_p50=pred.p50("ttft"), ttft_p99=pred.p99("ttft"),
                       tpot_p50=pred.p50("tpot"), makespan=pred.makespan,
                       slo=pred.slo_attainment(),
                       padding_waste=pred.padding_waste_ratio(),
                       preemptions=pred.preempt_events))
        out[name] = row
        pr = row["predicted"]
        log("paper", f"{name}: {row['tok_s']:.1f} tok/s, TTFT p50/p99 "
            f"{row['ttft_p50']:.3f}/{row['ttft_p99']:.3f} s, TPOT p50 "
            f"{row['tpot_p50'] * 1e3:.1f} ms with both graphs (decode graph "
            f"alone: {alone['tok_s']:.1f} tok/s, TTFT p50/p99 "
            f"{alone['ttft_p50']:.3f}/{alone['ttft_p99']:.3f} s, TPOT p50 "
            f"{alone['tpot_p50'] * 1e3:.1f} ms); prefill graphs "
            f"{row['prefill_captures']} captured for "
            f"{row['prefill_shapes']} shapes, {row['prefill_replays']} "
            f"replays, pool {row['prefill_pool_bytes']} B, capture "
            f"{row['prefill_capture_s']:.3f} s; SLO {row['slo']:.3f}, padding "
            f"waste {row['padding_waste']:.3f}, kv util "
            f"{row['kv_util']:.3f}, preemptions {row['preemptions']}, "
            f"buckets {buckets}, {row['batches']} batches formed "
            f"({row['prefill_chunks']} prefill chunks, "
            f"{row['decode_steps']} decode steps); {row['pages']} pages, "
            f"all free after")
        log("paper", f"{name} cost model (H100 spec) against the card: TTFT "
            f"p50 {pr['ttft_p50']:.3f} against {row['ttft_p50']:.3f} s, "
            f"TPOT p50 {pr['tpot_p50'] * 1e3:.1f} against "
            f"{row['tpot_p50'] * 1e3:.1f} ms, makespan "
            f"{pr['makespan']:.3f} against {row['makespan']:.3f} s; "
            f"predicted {pr['tok_s']:.1f} tok/s, SLO {pr['slo']:.3f}, "
            f"padding waste {pr['padding_waste']:.3f}, preemptions "
            f"{pr['preemptions']}, {pr['batches']} batches formed: "
            f"{sim_sched.formed}")
        del eng, be, res
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
    return out


def paper_phase(torch):
    """The paper's own model, llama2-13b, at full width and depth (bf16,
    seeded random weights, its native 4096-token cache): the kernels at
    its widths, the ``H100`` spec's fits, the 12-request set at t = 0
    eagerly and with the graph (ids and launches identical, formed
    batches equal to the cost model's), then BucketServe against the
    DistServe-like baseline on 32 requests arriving at 8 req/s with the
    cost model's prediction beside each."""
    from repro_torch.configs import get_config
    from repro_torch.core import MemoryBudget
    from repro_torch.launch.serve import default_pool_tokens, \
        device_memory_bytes
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg = get_config("llama2-13b")
    model, wbytes = make_model(torch, "llama2-13b", cfg)
    kernels = paper_kernels(torch)
    fits = paper_fits(torch, cfg, model, wbytes)
    gc.collect()
    torch.cuda.empty_cache()

    free, total = torch.cuda.mem_get_info(dev)
    per_tok = cfg.kv_bytes_per_token(2)
    pool_tokens = default_pool_tokens(cfg, model, dev)
    hbm = device_memory_bytes(dev)
    row_cache = cfg.max_seq_len * per_tok
    log("paper", f"memory: {wbytes / 1e9:.2f} GB of weights, "
        f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free; pool "
        f"{pool_tokens} tokens = {pool_tokens // 128} pages of 128 "
        f"({pool_tokens * per_tok / 1e9:.2f} GB, 40% of free at "
        f"{per_tok} B a token); a prefill job's batch cache "
        f"{row_cache / 1e9:.2f} GB a row, {PAPER_SLOTS * row_cache / 1e9:.2f}"
        f" GB at {PAPER_SLOTS} rows")

    # the 12-request set at t = 0, eager then graph.  The engine gets 3x
    # the batch cap in slots (block-table rows only on the paged pool):
    # it shares its slots between prefill admission and live decodes,
    # where the cost model gives prefill its own, so with as many slots
    # as the cap its slot clamp splits batches the cost model keeps whole
    budget = MemoryBudget(hbm_bytes_per_device=hbm, n_devices=1,
                          weight_bytes=wbytes)
    formed = {}

    def pair_engine(**graphs):
        sched = record_formed(paper_scheduler(cfg, "bucketserve", budget))
        formed[graphs["prefill_graph"]] = sched.formed
        return make_engine(torch, cfg, model, wbytes, True, 3 * PAPER_SLOTS,
                           pool_tokens, sched=sched, batch=PAPER_SLOTS,
                           **graphs)
    counts, stats, steps = serve_pair(
        torch, cfg, pair_engine, SERVE_LENGTHS, 32,
        f"llama2-13b paged pool, chunk 512, page 128, "
        f"{3 * PAPER_SLOTS} slots, batches of {PAPER_SLOTS}")
    if counts["paged_flash_decode"] != cfg.n_layers * steps["decode"] or \
            counts["flash_prefill"] != cfg.n_layers * steps["prefill"] or \
            counts["flash_prefill/tensor_core"] != counts["flash_prefill"] \
            or counts["flash_decode"] or counts["wkv6"]:
        raise AssertionError(f"llama2-13b launches {counts} for "
                             f"{steps['prefill']} prefill chunks and "
                             f"{steps['decode']} decode steps")
    plan = counts["paged_flash_decode/last plan"]
    log("paper", f"llama2-13b launches on the serve run: flash_prefill "
        f"{counts['flash_prefill']} = {cfg.n_layers} x {steps['prefill']} "
        f"chunks, all on the tensor-core body; paged_flash_decode "
        f"{counts['paged_flash_decode']} = {cfg.n_layers} x "
        f"{steps['decode']} steps (last plan n_split {plan.n_split}, L "
        f"{plan.L}, {plan.body} body); flash_decode 0")
    sim_sched = record_formed(paper_scheduler(cfg, "bucketserve", budget))
    _, pred = paper_sim(cfg, sim_sched, requests(SERVE_LENGTHS, 32),
                        pool_tokens)
    if not formed[False] == formed[None] == sim_sched.formed:
        raise AssertionError(f"llama2-13b at t = 0, formed batches: eager "
                             f"{formed[False]}, graph {formed[None]}, cost "
                             f"model {sim_sched.formed}")
    log("paper", f"formed batches at t = 0 equal on the card (eager and "
        f"graph) and in the cost model: {sim_sched.formed}; cost model "
        f"TTFT p50 {pred.p50('ttft'):.3f} s, TPOT p50 "
        f"{pred.p50('tpot') * 1e3:.1f} ms, makespan {pred.makespan:.3f} s "
        f"against the graph run's {stats['graph']['ttft_p50']:.3f} s, "
        f"{stats['graph']['tpot_p50'] * 1e3:.1f} ms, "
        f"{stats['graph']['seconds']:.3f} s")

    compare = paper_compare(torch, cfg, model, wbytes, pool_tokens, hbm)
    log("paper", f"done in {time.perf_counter() - t0:.1f} s")
    return dict(kernels={k: {f: v for f, v in r.items() if f != "plan"}
                         for k, r in kernels.items()},
                fits={k: v for k, v in fits.items() if k != "profile"},
                profile=fits["profile"], serve=stats,
                launches={k: counts[k] for k in ATTENTION_KERNELS},
                compare=compare, pool_tokens=pool_tokens)


# ------------------------------------------------------ recurrentgemma ---
def rg_kernels(torch):
    """The attention kernels at recurrentgemma-2b's widths (H = 10, Hkv =
    1, G = 10 at Dh 256), f32 and bf16, and at a ``--model 2`` rank's (5
    of the 10 query heads over the one kv head: G = 5), bf16: both
    decode kernels at B = 8 over the 2048-slot ring, on rows not yet
    wrapped and wrapped (two calls giving the same bits) and with every
    slot of the ring live, and a 4096-token prompt under the 2048-token
    window through the body its dtype names (bf16: tensor-core); each
    against its plain version, and in bf16 timed beside its bound and
    SDPA (on the gathered cache for decode, under the band mask for
    prefill), with the decode split the rule picks."""
    rows, worst = {}, {}
    for H, dts in ((RG_ATTN["H"], ("float32", "bfloat16")),
                   (RG_RANK_H, ("bfloat16",))):
        rg_kernel_rows(torch, H, dts, rows, worst)
    log("rg", "kernels at recurrentgemma's widths agree with the plain "
        "versions (f32 atol 1e-4 rtol 1e-3; bf16 atol 2e-3 rtol 1e-2); max "
        "abs err: " + "; ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    log_rows("rg", rows)
    return rows


def rg_kernel_rows(torch, H, dts, rows, worst):
    """``rg_kernels``' cases at ``H`` query heads in each of ``dts``,
    into ``rows`` (timed, bf16) and ``worst`` (max abs errors)."""
    from repro_torch.kernels import cost, ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    B, Hkv, Dh, S = (RG_ATTN[k] for k in ("B", "Hkv", "Dh", "S"))
    T = RG_PREFILL_T
    for dt in dts:
        esz, tol, timed = (4 if dt == "float32" else 2), MAIN_TOL[dt], \
            dt == "bfloat16"

        def rnd(shape):
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).to(getattr(torch, dt))
        q = rnd((B, H, Dh))
        kc, vc = rnd((B, S, Hkv, Dh)), rnd((B, S, Hkv, Dh))
        kp, vp, bt = paged_copy(torch, kc, vc, 128, gen)
        pm = torch.tensor(RG_DECODE_POS, dtype=torch.int32, device=dev)
        calls = [(ops.flash_decode(q, kc, vc, pm, ring=True),
                  ops.paged_flash_decode(q, kp, vp, bt, pm, s_len=S,
                                         ring=True)) for _ in range(2)]
        (a, b), (a2, b2) = calls
        worst[f"decode ring rows H={H} {dt}"] = max(
            assert_close(torch, f"recurrentgemma H={H} flash_decode ring "
                         f"{dt}", a,
                         ref.flash_decode_ref(q, kc, vc, pm, ring=True), tol),
            assert_close(torch, f"recurrentgemma paged_flash_decode ring "
                         f"{dt}", b, ref.paged_flash_decode_ref(
                             q, kp, vp, bt, pm, s_len=S, ring=True), tol),
            assert_close(torch, f"recurrentgemma paged vs contiguous {dt}",
                         b, a, tol))
        if not (torch.equal(a, a2) and torch.equal(b, b2)):
            raise AssertionError(f"recurrentgemma decode {dt}: two calls on "
                                 f"the same inputs differ")
        # every slot of the ring live: the steady state of a served row
        pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
        case = decode_case(torch, q, kc, vc, kp, vp, bt, pos, tol,
                           f"recurrentgemma H={H} {dt}", timed)
        for name, row in case.items():
            key = f"{name} B=8 H={H} Hkv=1 Dh=256 ring 2048" + (
                " page=128" if "paged" in name else "")
            worst[f"{key} {dt}"] = row["max_abs_err"]
            plan = row["plan"]
            log("rg", f"{name} at recurrentgemma's widths, H={H} {dt}: "
                f"n_split {plan.n_split}, L {plan.L}, "
                f"{B * Hkv * plan.n_split} blocks, {plan.body} body")
            if timed:
                rows[key] = row
        del q, kc, vc, kp, vp

        q, k, v = rnd((1, T, H, Dh)), rnd((1, T, Hkv, Dh)), \
            rnd((1, T, Hkv, Dh))
        lens = torch.tensor([T], dtype=torch.int32, device=dev)
        err = assert_close(torch, f"recurrentgemma H={H} flash_prefill {dt}",
                           prefill(q, k, v, lens, window=S),
                           ref.flash_prefill_ref(q, k, v, lens, window=S),
                           tol)
        worst[f"flash_prefill H={H} T={T} window {S} {dt}"] = err
        if timed:
            b_ms, b_by = bound_ms(cost.prefill(1, T, T, H, Hkv, Dh, esz,
                                               window=S, lengths=[T]), dt)
            i = torch.arange(T, device=dev)
            band = (i[:, None] >= i[None]) & (i[:, None] - i[None] < S)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            key = f"flash_prefill H={H} Hkv=1 Dh=256 T={T} window {S}"
            rows[key] = dict(
                ms=time_ms(torch, lambda: ops.flash_prefill(
                    q, k, v, lens, window=S), 10),
                plain_ms=time_ms(torch, lambda: ref.flash_prefill_ref(
                    q, k, v, lens, window=S), 3, 1),
                library_ms=time_ms(torch, lambda: sdpa(
                    qt, kt, vt, attn_mask=band, enable_gqa=True), 10),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        del q, k, v
        torch.cuda.empty_cache()


def rg_smoke(torch):
    """Smoke f32 ring caches through the engine (``graph_smoke``):
    recurrentgemma with 5 layers (its two block groups) and qwen3-14b
    with a 48-token sliding window, each on the paged and the contiguous
    pool: card ids == CPU ids, graph == eager, and paged == contiguous."""
    for arch, over in (("recurrentgemma-2b", dict(n_layers=5)),
                       ("qwen3-14b", dict(sliding_window=48))):
        ids = graph_smoke(torch, runs=((arch, True), (arch, False)), **over)
        if ids[arch, True] != ids[arch, False]:
            raise AssertionError(f"{arch} {over} smoke: paged ids "
                                 f"{ids[arch, True]} differ from contiguous "
                                 f"{ids[arch, False]}")
        log("rg", f"smoke f32 {arch} {over}: paged ids equal contiguous for "
            f"{len(ids[arch, True])} requests")


def op_shares(torch, phase, label, fn, module, names, steps=2):
    """Device time of ``fn`` under ``torch.profiler``, eager, with the
    functions ``names`` of ``module`` each inside a ``record_function``
    range: each range's device time (its kernels, nested ranges
    included) and share of the device busy time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    saved = {n: getattr(module, n) for n in names}
    tag = phase + "/"

    def ranged(name, f):
        def call(*args, **kw):
            with record_function(tag + name):
                return f(*args, **kw)
        return call
    fn()
    torch.cuda.synchronize()
    try:
        for n, f in saved.items():
            setattr(module, n, ranged(n, f))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
    finally:
        for n, f in saved.items():
            setattr(module, n, f)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    # the ranges also show as device-side annotations spanning their
    # kernels (idle gaps included): only kernels count as busy time
    kernels = [e for e in events if e.device_type == cuda
               and not e.name.startswith(tag)]
    if not kernels:
        log(phase, f"{label}: the profiler saw no device events (shares "
            f"not measured)")
        return {}
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    attn = sum(e.time_range.elapsed_us() for e in kernels
               if "flash_prefill" in e.name or "decode_kernel" in e.name
               ) / 1e3 / steps

    def launched_us(e):
        """Device time of the kernels launched under a CPU event."""
        return sum(k.duration for k in e.kernels) + sum(
            launched_us(c) for c in e.cpu_children)
    out = {"busy_ms": busy, "attention_ms": attn}
    for e in events:
        if e.device_type != cuda and e.name.startswith(tag):
            key = e.name[len(tag):] + "_ms"
            out[key] = out.get(key, 0.0) + launched_us(e) / 1e3 / steps
    log(phase, f"{label}: {busy:.2f} ms device busy; attention kernels "
        f"{attn:.2f} ms; " + "; ".join(
            f"{n} {out.get(n + '_ms', 0.0):.2f} ms "
            f"({out.get(n + '_ms', 0.0) / busy:.3f})" for n in names
            if n + "_ms" in out))
    return out


def rg_op_shares(torch, label, fn, steps=2):
    """``op_shares`` of the RG-LRU functions (``RG_RANGES``)."""
    from repro_torch.models import rglru
    return op_shares(torch, "rg", label, fn, rglru, RG_RANGES, steps)


def rg_profile(torch, cfg, model):
    """A full-width decode step of 8 rows whose rings have wrapped
    (paged, page 128): eager and as a graph replay (``profile_pair``),
    then the RG-LRU functions' share of an eager step and of a 6144-token
    prefill."""
    from repro_torch.models import transformer as tfm
    dev = torch.device("cuda")
    B, page = 8, 128
    toks = torch.randint(0, cfg.vocab_size, (B, RG_PROFILE_CTX), device=dev,
                         dtype=torch.int32)
    logits, cache = tfm.prefill(cfg, model, toks, cache_len=cfg.max_seq_len)
    paged = to_paged(torch, tfm, cfg, cache, page)
    del cache
    tok = logits.argmax(-1).to(torch.int32)
    S = cfg.attn_cache_len(cfg.max_seq_len)

    def step():
        tfm.decode_step(cfg, model, tok, paged, page_size=page, paged_len=S)
    label = (f"recurrentgemma-2b full-width decode step, B={B}, after "
             f"{RG_PROFILE_CTX} tokens (rings wrapped), paged")
    prof = profile_pair(torch, label, step, "paged_flash_decode",
                        "decode_kernel")
    prof["decode_shares"] = rg_op_shares(torch, f"{label}, eager", step)
    T = max(RG_SERVE_LENGTHS)
    ptoks = torch.randint(0, cfg.vocab_size, (1, T), device=dev,
                          dtype=torch.int32)
    prof["prefill_shares"] = rg_op_shares(
        torch, f"recurrentgemma-2b full-width prefill, 1 x {T} tokens",
        lambda: tfm.prefill(cfg, model, ptoks, cache_len=cfg.max_seq_len),
        steps=1)
    return prof


def rg_check_launches(label, cfg, counts, steps, decode_kernel):
    """Each local-attention layer launches ``flash_prefill`` once a
    prefill (the tensor-core body at Dh 256, none on the CUDA-core body)
    and ``decode_kernel`` once a decode step; nothing else of the kernels
    runs."""
    n_attn = sum(p.count("attn") * r for p, r in cfg.block_groups())
    other = "flash_decode" if decode_kernel == "paged_flash_decode" else \
        "paged_flash_decode"
    if counts[decode_kernel] != n_attn * steps["decode"] or \
            counts["flash_prefill"] != n_attn * steps["prefill"] or \
            counts["flash_prefill/tensor_core"] != counts["flash_prefill"] \
            or counts["flash_prefill/cuda_core"] or \
            not steps["decode"] or counts[other] or counts["wkv6"]:
        raise AssertionError(f"{label}: launches {counts} for "
                             f"{steps['prefill']} prefills and "
                             f"{steps['decode']} decode steps of {n_attn} "
                             f"attention layers")
    plan = counts[f"{decode_kernel}/last plan"]
    log("rg", f"{label}: flash_prefill {counts['flash_prefill']} = {n_attn} "
        f"x {steps['prefill']} prefills, all on the tensor-core body; "
        f"{decode_kernel} {counts[decode_kernel]} = {n_attn} x "
        f"{steps['decode']} steps (last plan n_split {plan.n_split}, L "
        f"{plan.L}, {plan.body} body)")


def rg_phase(torch):
    """recurrentgemma-2b: the kernels at its widths, the smoke ring
    parity, then full width and depth (bf16, seeded random weights, the
    cache cut to ``RG_MAX_SEQ``): 12 requests at t = 0 on the paged pool
    and 4 on the contiguous pool, each eagerly and with the decode graph
    (ids and launches identical, every page free), and the decode step's
    profile.  Returns the kernel rows, the launches of each path's run,
    the serve stats and the profile."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import default_pool_tokens
    import dataclasses
    t0 = time.perf_counter()
    rows = rg_kernels(torch)
    rg_smoke(torch)
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"),
                              max_seq_len=RG_MAX_SEQ)
    model, wbytes = make_model(torch, "recurrentgemma-2b", cfg)
    log("rg", f"cache length {cfg.max_seq_len} (the config's 32768 cut: the "
        f"local-attention ring is {cfg.attn_cache_len(cfg.max_seq_len)} "
        f"slots either way, the cut bounds the prompt); block groups "
        f"{cfg.block_groups()}")
    warm = make_engine(torch, cfg, model, wbytes, True, 2,
                       2 * cfg.max_seq_len, decode_graph=False)
    serve_run(torch, cfg, warm, requests([96, 3000], 4),
              "recurrentgemma warm-up")
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    pool_tokens = default_pool_tokens(cfg, model, dev)
    counts, stats, want, runs = {}, {}, {}, {}
    for pool, (lengths, new, slots) in RG_SERVE.items():
        paged = pool == "paged"
        label = (f"recurrentgemma-2b {pool} pool, "
                 f"{'page 128, ' if paged else ''}{slots} slots")
        ids = {}
        counts[pool], stats[pool], steps = serve_pair(
            torch, cfg, lambda **g: make_engine(
                torch, cfg, model, wbytes, paged, slots,
                pool_tokens if paged else None, **g),
            lengths, new, label, ids_out=ids)
        rg_check_launches(label, cfg, counts[pool], steps,
                          _decode_kernel(pool))
        want[pool] = dict(ids=ids, steps=steps, stats=stats[pool]["eager"])
        runs[pool] = (f"recurrentgemma-2b engine under the (1, 1) mesh, "
                      f"{pool} pool, {slots} slots, eager", lengths, new,
                      slots, pool_tokens if paged else None)
    profile = rg_profile(torch, cfg, model)
    # the same requests under the one-rank mesh: wx, wg, wr, wi and the
    # conv cut over the width, the gates' input gathered, wo row-cut, the
    # local attention on its own query heads over the one kv head
    mesh = mesh_serve(torch, "rg", cfg, model, wbytes, runs, want,
                      lambda label, c, steps, pool: rg_check_launches(
                          label, cfg, c, steps, _decode_kernel(pool)))
    log("rg", f"done in {time.perf_counter() - t0:.1f} s")
    return dict(rows=rows, launches={
        "flash_prefill": counts["paged"]["flash_prefill"],
        "paged_flash_decode": counts["paged"]["paged_flash_decode"],
        "flash_decode": counts["contiguous"]["flash_decode"]},
        serve=stats, mesh=mesh, profile=profile, pool_tokens=pool_tokens)


def _decode_kernel(pool):
    return "paged_flash_decode" if pool == "paged" else "flash_decode"


# ------------------------------------------------------------------ moe ---
MOE_ARCH = "qwen3-moe-235b-a22b"
SCOUT_ARCH = "llama4-scout-17b-a16e"
# qwen3-moe's attention: 64 query heads on 4 kv heads, G = 16 at Dh 128
# (G * Dh 2048, the decode body's cap); llama4-scout's: 40 on 8, G = 5
MOE_ATTN = dict(B=8, H=64, Hkv=4, Dh=128, S=4096)
SCOUT_ATTN = dict(B=8, H=40, Hkv=8, Dh=128, S=4096)
# the full-width serve: the depth cut from 94 layers to 8 (21.15 B
# parameters, 42.3 GB in bf16, beside the pool on one 80 GB card) and the
# cache to 4096; every width as published
MOE_LAYERS = 8
MOE_MAX_SEQ = 4096
# the MoE layer alone, (B, T) of its input: a decode batch and a chunk
MOE_FFN_SHAPES = {"decode 8 tokens": (8, 1), "chunk 512 tokens": (1, 512)}
MOE_RANGES = ("moe_local", "router_topk", "grouped_ffn")
MOE_PATH = "qwen3-moe-235b-a22b (8 of 94 layers)"
MOE_MESH_PATH = f"{MOE_PATH} engine under the (1, 1) mesh"
# the full-width serve runs: (prompt lengths, new tokens, slots) a pool
MOE_SERVE = {"paged": (SERVE_LENGTHS, 32, 8),
             "contiguous": ([200, 900, 64, 1500], 16, 4)}


def moe_kernels(torch):
    """The attention kernels at qwen3-moe's widths (B = 8, H = 64, Hkv =
    4: G = 16 at Dh 128), f32 and bf16: both decode kernels over 4096
    slots at context 2048 and on rows of every length and wrapped rings
    (two calls, same bits), and a 512-token chunk at offset 1536 over
    4096 slots through the body its dtype names; each against its plain
    version, and in bf16 timed beside its bound and SDPA, with the
    decode split the rule picks.  Then llama4-scout's G = 5 decode rows
    (H = 40, Hkv = 8), checked, not timed."""
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    rows, worst = {}, {}
    for dt in ("float32", "bfloat16"):
        tol, timed = MAIN_TOL[dt], dt == "bfloat16"

        def rnd(shape):
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).to(getattr(torch, dt))
        for widths, name, timed_here in ((MOE_ATTN, "qwen3-moe", timed),
                                         (SCOUT_ATTN, "llama4-scout", False)):
            B, H, Hkv, Dh, S = (widths[k] for k in ("B", "H", "Hkv", "Dh",
                                                    "S"))
            q = rnd((B, H, Dh))
            kc, vc = rnd((B, S, Hkv, Dh)), rnd((B, S, Hkv, Dh))
            kp, vp, bt = paged_copy(torch, kc, vc, 128, gen)
            pos = torch.full((B,), 2047, dtype=torch.int32, device=dev)
            case = decode_case(torch, q, kc, vc, kp, vp, bt, pos, tol,
                               f"{name} {dt}", timed_here)
            for kname, row in case.items():
                key = f"{kname} B=8 H={H} Hkv={Hkv} ctx=2048" + (
                    " page=128" if "paged" in kname else "")
                worst[f"{key} {dt}"] = row["max_abs_err"]
                plan = row["plan"]
                log("moe", f"{kname} at {name}'s widths (G = {H // Hkv}) "
                    f"{dt}: n_split {plan.n_split}, L {plan.L}, "
                    f"{B * Hkv * plan.n_split} blocks, {plan.body} body")
                if timed_here:
                    rows[key] = row
            for label, posl, ring in DECODE_MIXED:
                pm = torch.tensor(posl, dtype=torch.int32, device=dev)
                (a, b), (a2, b2) = [
                    (ops.flash_decode(q, kc, vc, pm, ring=ring),
                     ops.paged_flash_decode(q, kp, vp, bt, pm, s_len=S,
                                            ring=ring)) for _ in range(2)]
                worst[f"{name} decode {label} {dt}"] = max(
                    assert_close(torch, f"{name} flash_decode {label} {dt}",
                                 a, ref.flash_decode_ref(q, kc, vc, pm,
                                                         ring=ring), tol),
                    assert_close(torch, f"{name} paged_flash_decode {label} "
                                 f"{dt}", b, ref.paged_flash_decode_ref(
                                     q, kp, vp, bt, pm, s_len=S, ring=ring),
                                 tol),
                    assert_close(torch, f"{name} paged vs contiguous "
                                 f"{label} {dt}", b, a, tol))
                if not (torch.equal(a, a2) and torch.equal(b, b2)):
                    raise AssertionError(f"{name} decode {label} {dt}: two "
                                         f"calls on the same inputs differ")
            del q, kc, vc, kp, vp
        B, H, Hkv, Dh, S = (MOE_ATTN[k] for k in ("B", "H", "Hkv", "Dh",
                                                  "S"))
        Tc, off = 512, 1536
        q, k, v = rnd((1, Tc, H, Dh)), rnd((1, S, Hkv, Dh)), \
            rnd((1, S, Hkv, Dh))
        row = chunk_case(torch, q, k, v, off, tol, f"qwen3-moe chunk {dt}",
                         timed)
        key = f"flash_prefill H={H} Hkv={Hkv} chunk 512@1536/4096"
        worst[f"{key} {dt}"] = row["max_abs_err"]
        if timed:
            rows[key] = row
        del q, k, v
        torch.cuda.empty_cache()
    log("moe", "kernels at qwen3-moe's widths (G = 16) and llama4-scout's "
        "decode rows (G = 5) agree with the plain versions (f32 atol 1e-4 "
        "rtol 1e-3; bf16 atol 2e-3 rtol 1e-2), two calls the same bits; "
        "max abs err: " + "; ".join(f"{k} {v:.3g}" for k, v in
                                    worst.items()))
    log_rows("moe", rows)
    return rows


def moe_ffn(torch):
    """One MoE layer of each config at full width, bf16, seeded random
    weights and inputs: ``moe_local`` against ``moe_dense_ref`` on the
    same input, at a decode batch (8 tokens) and at a 512-token chunk,
    within the bf16 tolerance (atol 2e-2, rtol 2e-2: both accumulate in
    f32 and round each projection to bf16; a flipped expert moves an
    output by a whole expert); every grouped product through the
    library's grouped GEMM.  Timed against the bytes the call must move
    (each expert it routes to read once, the shared expert and the f32
    router, the input and the output) and its FLOPs, beside the plain
    route (the masked loop over the E experts) and the dense oracle.
    The routing of random weights is the traffic: how many distinct
    experts a batch hits is logged."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cost, runtime
    from repro_torch.models import moe
    dev = torch.device("cuda")
    rows = {}
    for arch in (MOE_ARCH, SCOUT_ARCH):
        cfg = get_config(arch)
        d, f, E, k = cfg.d_model, cfg.d_ff_expert, cfg.n_experts, cfg.top_k
        gen = torch.Generator(device=dev).manual_seed(3)
        p = moe.Moe(cfg, torch.bfloat16, dev)
        with torch.no_grad():
            p.init_(gen)
        for label, (B, T) in MOE_FFN_SHAPES.items():
            x = torch.randn((B, T, d), generator=gen, device=dev,
                            dtype=torch.float32).to(torch.bfloat16)
            N = B * T
            runtime.reset_launch_counts()
            got = moe.moe_local(cfg, p, x)
            if runtime.grouped_counts != {"grouped_mm": 3, "masked_loop": 0}:
                raise AssertionError(f"{arch} moe_local {label}: grouped "
                                     f"products {runtime.grouped_counts}")
            err = assert_close(torch, f"{arch} moe_local {label}", got,
                               moe.moe_dense_ref(cfg, p, x),
                               TOL["bfloat16"])
            _, idx, _ = moe.router_topk(cfg, p, x.reshape(N, d))
            hit = int(torch.unique(idx).numel())
            work = cost.moe_ffn(N, d, f, E, k, hit, cfg.d_ff
                                if cfg.shared_expert else 0)
            nbytes, flops = work.bytes, work.flops
            b_ms, b_by = bound_ms(work, "bfloat16")
            ms = time_ms(torch, lambda: moe.moe_local(cfg, p, x), 10)
            dense_ms = time_ms(torch, lambda: moe.moe_dense_ref(cfg, p, x),
                               3, 1)
            library = moe.grouped_mm
            moe.grouped_mm = moe.grouped_mm_plain
            try:
                plain_ms = time_ms(torch, lambda: moe.moe_local(cfg, p, x),
                                   3, 1)
            finally:
                moe.grouped_mm = library
            rows[f"{arch} {label}"] = dict(
                ms=ms, plain_ms=plain_ms, dense_ms=dense_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, max_abs_err=err,
                experts_hit=hit, tokens=N, bytes=nbytes, flops=flops)
            log("moe", f"{arch} MoE layer, {label} (bf16, full width: d "
                f"{d}, {E} experts, top-{k}, d_ff_expert {f}"
                f"{', shared expert' if cfg.shared_expert else ''}): "
                f"{hit} distinct experts hit by {N * k} routed pairs; "
                f"moe_local {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
                f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.1f} GFLOP), "
                f"{ms / b_ms:.2f}x; plain route (masked loop) "
                f"{plain_ms:.4f} ms; dense oracle {dense_ms:.4f} ms; "
                f"against the oracle max abs err {err:.3g}")
        del p
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def moe_smoke(torch):
    """Smoke f32 qwen3-moe and llama4-scout through ``graph_smoke`` on
    both pools: card ids == CPU ids, graph == eager (launches and grouped
    products by route equal), paged == contiguous.  The f32 grouped
    products on the card take the plain route, chosen by dtype."""
    counts = {}
    runs = tuple((arch, paged) for arch in (MOE_ARCH, SCOUT_ARCH)
                 for paged in (True, False))
    ids = graph_smoke(torch, runs=runs, counts_out=counts)
    for arch in (MOE_ARCH, SCOUT_ARCH):
        if ids[arch, True] != ids[arch, False]:
            raise AssertionError(f"{arch} smoke: paged ids "
                                 f"{ids[arch, True]} differ from contiguous "
                                 f"{ids[arch, False]}")
    for (arch, paged), c in counts.items():
        if c["grouped/grouped_mm"] or not c["grouped/masked_loop"]:
            raise AssertionError(f"{arch} smoke f32: grouped products {c}")
    log("moe", "smoke f32 qwen3-moe and llama4-scout: paged ids equal "
        "contiguous; the f32 grouped products took the plain route (the "
        "masked loop, chosen by dtype) on the card: " + "; ".join(
            f"{a} {'paged' if pg else 'contiguous'} "
            f"{c['grouped/masked_loop']}" for (a, pg), c in counts.items()))


def moe_check_launches(label, cfg, counts, steps, decode_kernel):
    """Each layer launches ``flash_prefill`` once a prefill chunk (the
    tensor-core body) and ``decode_kernel`` once a decode step, and runs
    its three grouped products through the grouped GEMM in each; nothing
    else of the kernels runs."""
    L = cfg.n_layers
    other = "flash_decode" if decode_kernel == "paged_flash_decode" else \
        "paged_flash_decode"
    if counts[decode_kernel] != L * steps["decode"] or \
            counts["flash_prefill"] != L * steps["prefill"] or \
            counts["flash_prefill/tensor_core"] != counts["flash_prefill"] \
            or not steps["decode"] or counts[other] or counts["wkv6"] or \
            counts["grouped/grouped_mm"] != 3 * L * (steps["prefill"]
                                                     + steps["decode"]) or \
            counts["grouped/masked_loop"]:
        raise AssertionError(f"{label}: launches {counts} for "
                             f"{steps['prefill']} prefill chunks and "
                             f"{steps['decode']} decode steps of {L} layers")
    plan = counts[f"{decode_kernel}/last plan"]
    log("moe", f"{label}: flash_prefill {counts['flash_prefill']} = {L} x "
        f"{steps['prefill']} chunks, all on the tensor-core body; "
        f"{decode_kernel} {counts[decode_kernel]} = {L} x {steps['decode']} "
        f"steps (last plan n_split {plan.n_split}, L {plan.L}, {plan.body} "
        f"body); grouped GEMM calls {counts['grouped/grouped_mm']} = 3 x "
        f"{L} x {steps['prefill'] + steps['decode']}")


def moe_profile(torch, cfg, model):
    """A full-width decode step of 8 rows at context 1024 (paged, page
    128), eager and as a graph replay (``profile_pair``), and the MoE
    functions' share of an eager step and of an 8 x 512 prefill through
    ``record_function`` ranges."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    dev = torch.device("cuda")
    B, ctx, page = 8, 1024, 128
    S = cfg.max_seq_len
    toks = torch.randint(0, cfg.vocab_size, (B, ctx), device=dev,
                         dtype=torch.int32)
    logits, cache = tfm.prefill(cfg, model, toks, cache_len=S)
    paged = to_paged(torch, tfm, cfg, cache, page)
    del cache
    tok = logits.argmax(-1).to(torch.int32)

    def step():
        tfm.decode_step(cfg, model, tok, paged, page_size=page, paged_len=S)
    label = (f"qwen3-moe-235b-a22b full width, {cfg.n_layers} of 94 "
             f"layers, decode step, B={B}, context {ctx}, paged")
    prof = profile_pair(torch, label, step, "paged_flash_decode",
                        "decode_kernel")
    prof["decode_shares"] = op_shares(torch, "moe", f"{label}, eager", step,
                                      moe, MOE_RANGES)
    ptoks = toks[:, :512].contiguous()
    prof["prefill_shares"] = op_shares(
        torch, "moe", f"qwen3-moe-235b-a22b full width, {cfg.n_layers} "
        f"layers, prefill {B} x 512 tokens", lambda: tfm.prefill(
            cfg, model, ptoks, cache_len=S), moe, MOE_RANGES, steps=1)
    return prof


def moe_phase(torch):
    """The MoE family: the kernels at qwen3-moe's widths, one MoE layer of
    each config at full width, the smoke parity, then qwen3-moe at full
    width with its depth cut to ``MOE_LAYERS`` (bf16, seeded random
    weights, cache ``MOE_MAX_SEQ``): 12 requests at t = 0 on the paged
    pool and 4 on the contiguous pool, each eagerly and with the decode
    graph (ids and launches identical, every page free), and the decode
    step's profile.  Returns the kernel rows, the MoE layer rows, each
    path's launches, the serve stats and the profile."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import default_pool_tokens
    import dataclasses
    t0 = time.perf_counter()
    rows = moe_kernels(torch)
    ffn = moe_ffn(torch)
    moe_smoke(torch)
    dev = torch.device("cuda")
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS,
                              max_seq_len=MOE_MAX_SEQ)
    model, wbytes = make_model(torch, MOE_ARCH, cfg)
    log("moe", f"depth cut from {full.n_layers} to {cfg.n_layers} layers "
        f"({cfg.param_count() / 1e9:.2f} B of {full.param_count() / 1e9:.1f}"
        f" B parameters, {cfg.active_param_count() / 1e9:.2f} B active a "
        f"token), cache length {cfg.max_seq_len} (the config's "
        f"{full.max_seq_len} cut); every width as published")
    warm = make_engine(torch, cfg, model, wbytes, True, 2,
                       2 * cfg.max_seq_len, decode_graph=False)
    serve_run(torch, cfg, warm, requests([96, 700], 4), "qwen3-moe warm-up")
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    pool_tokens = default_pool_tokens(cfg, model, dev)
    counts, stats, want = {}, {}, {}
    for pool, (lengths, new, slots) in MOE_SERVE.items():
        paged = pool == "paged"
        label = (f"qwen3-moe-235b-a22b ({MOE_LAYERS} layers) {pool} pool, "
                 f"chunk 512{', page 128' if paged else ''}, {slots} slots")
        ids = {}
        counts[pool], stats[pool], steps = serve_pair(
            torch, cfg, lambda **g: make_engine(
                torch, cfg, model, wbytes, paged, slots,
                pool_tokens if paged else None, **g),
            lengths, new, label, ids_out=ids)
        moe_check_launches(label, cfg, counts[pool], steps,
                           "paged_flash_decode" if paged else "flash_decode")
        want[pool] = dict(ids=ids, steps=steps, stats=stats[pool]["eager"])
    profile = moe_profile(torch, cfg, model)
    mesh = moe_mesh_engine(torch, cfg, model, wbytes, pool_tokens, want)
    log("moe", f"done in {time.perf_counter() - t0:.1f} s")
    return dict(rows=rows, ffn=ffn, launches={
        "flash_prefill": counts["paged"]["flash_prefill"],
        "paged_flash_decode": counts["paged"]["paged_flash_decode"],
        "flash_decode": counts["contiguous"]["flash_decode"]},
        serve=stats, mesh=mesh, profile=profile, pool_tokens=pool_tokens)


def moe_mesh_engine(torch, cfg, model, wbytes, pool_tokens, want):
    """The MoE phase's requests (``MOE_SERVE``) through ``mesh_serve``:
    each expert's d_ff cut over ``model``, so the MoE runs
    tensor-parallel with its f32 all-reduce over the group; every launch
    gate of ``moe_check_launches``."""
    runs = {pool: (f"qwen3-moe-235b-a22b ({MOE_LAYERS} layers) engine under "
                   f"the (1, 1) mesh, {pool} pool, {slots} slots, eager",
                   lengths, new, slots,
                   pool_tokens if pool == "paged" else None)
            for pool, (lengths, new, slots) in MOE_SERVE.items()}
    return mesh_serve(torch, "moe", cfg, model, wbytes, runs, want,
                      lambda label, counts, steps, pool: moe_check_launches(
                          label, cfg, counts, steps, "paged_flash_decode"
                          if pool == "paged" else "flash_decode"))


def mesh_serve(torch, phase, cfg, model, wbytes, runs, want, check):
    """Each of ``runs`` ({pool: (label, prompt lengths, new tokens, slots,
    pool tokens)}) served through ``ServingEngine(mesh=...)`` on a
    one-rank NCCL mesh, rank 0 driving, eagerly.  The model is cut by
    ``shard_model`` first, so every cut leaf takes its column-, row- or
    own-part path with its one-rank collectives.  ``check(label, counts,
    steps, pool)`` holds each run's launch gates; every page comes back;
    ids and steps must equal the eager run without a mesh (``want[pool]``:
    ids, steps, stats); TPOT / TTFT p50 both ways.  The model stays cut:
    this is the phase's last use of it."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.sharding import partition
    smi = nvidia_smi_line()
    res = {}
    with tempfile.TemporaryDirectory() as d:
        mesh_mod.init_distributed(1, 1, "cuda", rank=0, world_size=1,
                                  init_method=f"file://{d}/store")
        try:
            mesh = mesh_mod.make_host_mesh(1, 1)
            partition.shard_model(cfg, model, mesh)
            for pool, (label, lengths, new, slots, tokens) in runs.items():
                paged = pool == "paged"
                eng = make_engine(torch, cfg, model, wbytes, paged, slots,
                                  tokens, decode_graph=False, mesh=mesh)
                reqs = requests(lengths, new)
                counts, stats, steps = serve_run(torch, cfg, eng, reqs,
                                                 label)
                check(label, counts, steps, pool)
                be, w = eng.backend, want[pool]
                if paged and be.free_blocks() != be.alloc.n_pages:
                    raise AssertionError(f"{label}: pages leaked")
                ids = finished_ids(eng, reqs)
                if ids != w["ids"] or steps != w["steps"]:
                    bad = [rid for rid in ids if ids[rid] != w["ids"][rid]]
                    raise AssertionError(f"{label}: ids differ from the run "
                                         f"without a mesh for rids {bad}; "
                                         f"steps {steps}, {w['steps']}")
                log(phase, f"[{smi}] {label}: ids equal to the eager run "
                    f"without a mesh for {len(ids)} requests; TPOT p50 "
                    f"{stats['tpot_p50'] * 1e3:.2f} ms under the mesh, "
                    f"{w['stats']['tpot_p50'] * 1e3:.2f} ms without; TTFT "
                    f"p50 {stats['ttft_p50']:.4f} s, "
                    f"{w['stats']['ttft_p50']:.4f} s; decode command host "
                    f"time {be.channel.host_ms('decode'):.4f} ms a step")
                res[pool] = dict(stats=stats, no_mesh_stats=w["stats"],
                                 steps=steps, launches={
                                     k: counts[k] for k in
                                     ATTENTION_KERNELS + ("wkv6",)},
                                 grouped_mm=counts["grouped/grouped_mm"])
                del eng, be
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    return res


# ------------------------------------------------- encoder and VLM ---
HUBERT_ARCH = "hubert-xlarge"
VLM_ARCH = "llama-3.2-vision-90b"
NEMOTRON_ARCH = "nemotron-4-340b"
# hubert-xlarge's self-attention: 30 s of audio at its 50 Hz frame rate,
# H = Hkv = 16 at Dh 80 (the tensor-core prefill body), non-causal, ragged
HUBERT_ATTN = dict(B=8, T=1500, H=16, Hkv=16, Dh=80)
HUBERT_LENGTHS = [1500, 1200, 900, 600] * 2
# the VLM's cross-attention: prompts of up to 1024 tokens over 1600
# vision keys (Tk off the 64-key tile), G = 8 at Dh 128; its decode
# reads the same keys through the decode kernel (pos 1599 every row)
VLM_CROSS = dict(B=8, Tq=1024, Tk=1600, H=64, Hkv=8, Dh=128)
# the VLM's self-attention decode at its widths over a 4096-slot cache
VLM_SELF = dict(B=8, H=64, Hkv=8, Dh=128, S=4096)
# the full-width run: the depth cut from 100 layers to 20 (four of its
# (4 self + 1 cross) patterns, 19.22 B parameters, 38.4 GB in bf16) and
# the cache to 4096; every width as published
VLM_LAYERS = 20
VLM_MAX_SEQ = 4096
VLM_PROMPTS = [256, 1024, 512, 768, 384, 900, 640, 1000]
VLM_STEPS = 32
VLM_GATE = 1.0            # every cross gate (zero at the seeded init)
VLM_PATH = f"{VLM_ARCH} ({VLM_LAYERS} of 100 layers)"
# smoke parity, card against CPU (f32): tests/test_torch_model.py's logit
# tolerance
SMOKE_LOGIT_TOL = dict(atol=1e-4, rtol=0)
# hubert's prefill last-token logits against its forward's (bf16, full
# width): the same kernels on the same activations; only the head's
# product differs in its row count (8 rows against 8 x 1500), which may
# take another GEMM and another f32 summation order over d = 1280
HUBERT_LAST_TOL = dict(atol=1e-2, rtol=1e-2)


def set_cross_gates(torch, model, value):
    """Every cross layer's gate (a 0-d leaf) set to ``value``; returns
    how many were set."""
    n = 0
    with torch.no_grad():
        for _, _, _, blk in model.blocks():
            if hasattr(blk.attn, "gate"):
                blk.attn.gate.fill_(value)
                n += 1
    return n


@contextlib.contextmanager
def cross_launches():
    """Each kernel's launches made inside the cross layers' attention:
    ``attention.cross_attn_forward`` and ``cross_attn_decode``, which the
    cross block calls through its module, are wrapped for the block's
    duration, and the wrappers' own counts are read before and after
    each call.  Yields {kernel: launches}."""
    from repro_torch.kernels import runtime
    from repro_torch.models import attention
    tally = dict.fromkeys(runtime.launch_counts, 0)
    saved = attention.cross_attn_forward, attention.cross_attn_decode

    def counted(fn):
        def call(*args, **kw):
            before = dict(runtime.launch_counts)
            out = fn(*args, **kw)
            for name, n in runtime.launch_counts.items():
                tally[name] += n - before[name]
            return out
        return call
    attention.cross_attn_forward, attention.cross_attn_decode = (
        counted(fn) for fn in saved)
    try:
        yield tally
    finally:
        attention.cross_attn_forward, attention.cross_attn_decode = saved


def vision_kernels(torch):
    """The attention kernels at the shapes the encoder and the VLM give
    them, each against its plain version on the card: hubert's
    non-causal ``flash_prefill`` (B = 8, T = 1500, H = Hkv = 16, Dh 80,
    lengths 1500/1200/900/600: bf16 on the tensor-core body), the VLM's
    causal self-attention ``flash_prefill`` (B = 8, T = 1024 with the
    ``VLM_PROMPTS`` lengths, H = 64, Hkv = 8: the tensor-core body), its
    cross-attention ``flash_prefill`` (B = 8, Tq = 1024 over Tk = 1600
    vision keys, no mask), its cross decode through ``flash_decode`` (B =
    8 over the 1600 keys, pos 1599), and its self-attention decode on
    both kernels (B = 8 over 4096 slots at context 2048); in bf16 each
    timed beside its plain version, its bound and SDPA under the same
    mask; the f32 body of the first four at a smoke shape."""
    from repro_torch.kernels import cost, ops, ref, runtime
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    rows, worst = {}, {}
    for dt in ("float32", "bfloat16"):
        esz, tol, full = (4 if dt == "float32" else 2), MAIN_TOL[dt], \
            dt == "bfloat16"

        def rnd(shape):
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).to(getattr(torch, dt))
        # hubert: non-causal, ragged lengths, Dh 80
        B, T, H, Hkv, Dh = ((HUBERT_ATTN[k] for k in ("B", "T", "H", "Hkv",
                                                       "Dh")) if full
                            else (2, 300, 4, 4, 80))
        lens_l = HUBERT_LENGTHS if full else [300, 170]
        q, k, v = rnd((B, T, H, Dh)), rnd((B, T, Hkv, Dh)), \
            rnd((B, T, Hkv, Dh))
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        key = f"flash_prefill B={B} T={T} H={H} Dh={Dh} non-causal ragged"
        err = assert_close(torch, f"hubert {key} {dt}",
                           prefill(q, k, v, lens, causal=False),
                           ref.flash_prefill_ref(q, k, v, lens,
                                                 causal=False), tol)
        worst[f"{key} {dt}"] = err
        if full:
            b_ms, b_by = bound_ms(cost.prefill(B, T, T, H, Hkv, Dh, esz,
                                               causal=False, lengths=lens_l),
                                  dt)
            kmask = (torch.arange(T, device=dev)[None] < lens[:, None])[
                :, None, None]
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            rows[key] = dict(
                ms=time_ms(torch, lambda: ops.flash_prefill(
                    q, k, v, lens, causal=False), 10),
                plain_ms=time_ms(torch, lambda: ref.flash_prefill_ref(
                    q, k, v, lens, causal=False), 3, 1),
                library_ms=time_ms(torch, lambda: sdpa(
                    qt, kt, vt, attn_mask=kmask), 10),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        del q, k, v
        # the VLM's self-attention prefill: causal, the prompts padded to
        # the longest with their own key lengths, G = 8 at Dh 128; padded
        # query rows are garbage in both, so only the valid rows compare
        B, T, H, Hkv, Dh = ((len(VLM_PROMPTS), max(VLM_PROMPTS),
                             VLM_CROSS["H"], VLM_CROSS["Hkv"],
                             VLM_CROSS["Dh"]) if full
                            else (2, 200, 8, 1, 128))
        lens_l = VLM_PROMPTS if full else [200, 77]
        q, k, v = rnd((B, T, H, Dh)), rnd((B, T, Hkv, Dh)), \
            rnd((B, T, Hkv, Dh))
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        valid = torch.arange(T, device=dev)[None] < lens[:, None]
        key = f"flash_prefill self B={B} T={T} H={H} Hkv={Hkv} causal ragged"
        err = assert_close(torch, f"vlm {key} {dt}", prefill(q, k, v, lens),
                           ref.flash_prefill_ref(q, k, v, lens), tol, valid)
        worst[f"{key} {dt}"] = err
        if full:
            # every query row's live keys: row t of a prompt of L tokens
            # reads min(t, L - 1) + 1 of them
            b_ms, b_by = bound_ms(cost.prefill(B, T, T, H, Hkv, Dh, esz,
                                               lengths=lens_l), dt)
            G = H // Hkv
            smask = (torch.ones(T, T, dtype=torch.bool, device=dev).tril()
                     & valid[:, None, :])[:, None]
            qt = q.transpose(1, 2)
            kt, vt = (x.repeat_interleave(G, dim=2).transpose(1, 2)
                      for x in (k, v))
            rows[key] = dict(
                ms=time_ms(torch, lambda: ops.flash_prefill(q, k, v, lens),
                           10),
                plain_ms=time_ms(torch, lambda: ref.flash_prefill_ref(
                    q, k, v, lens), 3, 1),
                library_ms=time_ms(torch, lambda: sdpa(
                    qt, kt, vt, attn_mask=smask), 10),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
            del kt, vt, smask
        del q, k, v
        # the VLM's cross-attention prefill: Tq != Tk, no mask
        B, Tq, Tk, H, Hkv, Dh = ((VLM_CROSS[k] for k in (
            "B", "Tq", "Tk", "H", "Hkv", "Dh")) if full
            else (2, 100, 160, 8, 1, 128))
        q, k, v = rnd((B, Tq, H, Dh)), rnd((B, Tk, Hkv, Dh)), \
            rnd((B, Tk, Hkv, Dh))
        key = f"flash_prefill cross B={B} Tq={Tq} Tk={Tk} H={H} Hkv={Hkv}"
        err = assert_close(torch, f"vlm {key} {dt}",
                           prefill(q, k, v, causal=False),
                           ref.flash_prefill_ref(q, k, v, causal=False), tol)
        worst[f"{key} {dt}"] = err
        if full:
            b_ms, b_by = bound_ms(cost.prefill(B, Tq, Tk, H, Hkv, Dh, esz,
                                               causal=False), dt)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            rows[key] = dict(
                ms=time_ms(torch, lambda: ops.flash_prefill(
                    q, k, v, causal=False), 10),
                plain_ms=time_ms(torch, lambda: ref.flash_prefill_ref(
                    q, k, v, causal=False), 3, 1),
                library_ms=time_ms(torch, lambda: sdpa(
                    qt, kt, vt, enable_gqa=True), 10),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        del q
        # its cross decode: one query a row over all Tk keys
        qd = rnd((B, H, Dh))
        pos = torch.full((B,), Tk - 1, dtype=torch.int32, device=dev)
        key = f"flash_decode cross B={B} H={H} Hkv={Hkv} over {Tk} keys"
        got, again = (ops.flash_decode(qd, k, v, pos) for _ in range(2))
        err = max(assert_close(torch, f"vlm {key} {dt}", got,
                               ref.flash_decode_ref(qd, k, v, pos), tol),
                  assert_close(torch, f"vlm {key} {dt} against the "
                               f"unmasked prefill", got[:, None],
                               ref.flash_prefill_ref(qd[:, None], k, v,
                                                     causal=False), tol))
        if not torch.equal(got, again):
            raise AssertionError(f"vlm {key} {dt}: two calls differ")
        plan = runtime.decode_plans["flash_decode"]
        worst[f"{key} {dt}"] = err
        log("vlm", f"{key} {dt}: n_split {plan.n_split}, L {plan.L} (the "
            f"last split {Tk - (plan.n_split - 1) * plan.L} slots), "
            f"{B * Hkv * plan.n_split} blocks, {plan.body} body")
        if full:
            b_ms, b_by = bound_ms(cost.decode(B, H, Hkv, Dh, esz, Tk), dt)
            q4, kt, vt = qd[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
            rows[key] = dict(
                ms=time_ms(torch, lambda: ops.flash_decode(qd, k, v, pos),
                           50),
                plain_ms=time_ms(torch, lambda: ref.flash_decode_ref(
                    qd, k, v, pos), 10),
                library_ms=time_ms(torch, lambda: sdpa(
                    q4, kt, vt, enable_gqa=True), 20),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err, plan=plan)
        del qd, k, v
        if full:
            # the VLM's self-attention decode at its widths
            B, H, Hkv, Dh, S = (VLM_SELF[k] for k in ("B", "H", "Hkv", "Dh",
                                                      "S"))
            q = rnd((B, H, Dh))
            kc, vc = rnd((B, S, Hkv, Dh)), rnd((B, S, Hkv, Dh))
            kp, vp, bt = paged_copy(torch, kc, vc, 128, gen)
            pos = torch.full((B,), 2047, dtype=torch.int32, device=dev)
            for name, row in decode_case(torch, q, kc, vc, kp, vp, bt, pos,
                                         tol, f"vlm self {dt}", True).items():
                key = f"{name} B=8 H={H} Hkv={Hkv} ctx=2048" + (
                    " page=128" if "paged" in name else "")
                worst[f"{key} {dt}"] = row["max_abs_err"]
                rows[key] = row
            del q, kc, vc, kp, vp
        torch.cuda.empty_cache()
    log("vlm", "kernels at hubert-xlarge's and llama-3.2-vision's shapes "
        "agree with the plain versions (f32 atol 1e-4 rtol 1e-3; bf16 atol "
        "2e-3 rtol 1e-2); max abs err: " + "; ".join(
            f"{k} {v:.3g}" for k, v in worst.items()))
    log_rows("vlm", rows)
    return rows


def smoke_inputs(torch, cfg, B, T, seed):
    """CPU inputs from a seeded generator: token ids, and an encoder's
    frame embeddings or a VLM's vision embeddings (normal x 0.02, as the
    reference's ``data/tokens.py``)."""
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                         dtype=torch.int32)
    kw = {}
    if cfg.arch_type == "audio":
        kw["embeds"] = torch.randn((B, T, cfg.d_model), generator=gen) * 0.02
    if cfg.arch_type == "vlm":
        kw["vision_embeds"] = torch.randn(
            (B, cfg.n_vision_tokens, cfg.d_vision), generator=gen) * 0.02
    return toks, kw


def vision_smoke(torch):
    """Smoke f32 hubert-xlarge, llama-3.2-vision-90b (cross gates set to
    ``VLM_GATE``) and nemotron-4-340b (squared-ReLU MLP): ``forward``,
    ``prefill`` and 4 ``decode_step``s on the card against the same calls
    on the CPU within ``SMOKE_LOGIT_TOL``; the VLM's decode also on the
    paged pool, its ids the contiguous cache's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm
    res = []
    for arch in (HUBERT_ARCH, VLM_ARCH, NEMOTRON_ARCH):
        cfg = get_smoke_config(arch, max_seq_len=64)
        cpu_model = tfm.init_params(cfg, seed=0, dtype=torch.float32,
                                    device="cpu")
        set_cross_gates(torch, cpu_model, VLM_GATE)
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
        B, T = 3, 40
        toks, kw = smoke_inputs(torch, cfg, B, T, seed=5)
        gkw = {n: t.cuda() for n, t in kw.items()}
        lens = torch.tensor([40, 23, 31], dtype=torch.int32)
        tin = None if cfg.arch_type == "audio" else toks
        worst = 0.0

        def check(what, got, want):
            nonlocal worst
            torch.testing.assert_close(got.cpu(), want, **SMOKE_LOGIT_TOL,
                                       msg=lambda m: f"{arch} {what}: {m}")
            worst = max(worst, float((got.cpu() - want).abs().max()))
        fc = tfm.forward(cfg, cpu_model, tin, lengths=lens, **kw)
        fg = tfm.forward(cfg, gpu_model, None if tin is None else tin.cuda(),
                         lengths=lens.cuda(), **gkw)
        for b, L in enumerate(lens.tolist()):
            check("forward", fg[b, :L], fc[b, :L])
        if not cfg.has_decode:
            lc, _ = tfm.prefill(cfg, cpu_model, None, lens, cache_len=T,
                                **kw)
            lg, _ = tfm.prefill(cfg, gpu_model, None, lens.cuda(),
                                cache_len=T, **gkw)
            check("prefill", lg, lc)
            check("prefill against forward", lg,
                  fc[torch.arange(B), lens.long() - 1])
            res.append(f"{arch} forward + prefill")
            continue
        plens = torch.tensor([24, 9, 17], dtype=torch.int32)
        ids = {}
        for paged in ((False, True) if cfg.arch_type == "vlm" else (False,)):
            lc, cc = tfm.prefill(cfg, cpu_model, toks[:, :24], plens,
                                 cache_len=64, **kw)
            lg, cg = tfm.prefill(cfg, gpu_model, toks[:, :24].cuda(),
                                 plens.cuda(), cache_len=64, **gkw)
            dkw = {}
            if paged:
                cc, cg = to_paged(torch, tfm, cfg, cc), \
                    to_paged(torch, tfm, cfg, cg)
                dkw = dict(page_size=16, paged_len=64)
            got = []
            pos = plens.clone()
            for step in range(5):
                check(f"{'paged' if paged else 'contiguous'} step {step}",
                      lg, lc)
                got.append(lg.argmax(-1).tolist())
                if step == 4:
                    break
                nxt = toks[torch.arange(B), pos]
                pos += 1
                lc, cc = tfm.decode_step(cfg, cpu_model, nxt, cc, **dkw)
                lg, cg = tfm.decode_step(cfg, gpu_model, nxt.cuda(), cg,
                                         **dkw)
            ids[paged] = got
        if cfg.arch_type == "vlm" and ids[True] != ids[False]:
            raise AssertionError(f"{arch} smoke: paged ids {ids[True]}, "
                                 f"contiguous {ids[False]}")
        res.append(f"{arch} forward + prefill + 4 decode steps"
                   + (" on both caches, paged ids == contiguous"
                      if cfg.arch_type == "vlm" else ""))
        res[-1] += f" (max abs {worst:.3g})"
    torch.cuda.synchronize()
    log("vlm", f"smoke f32, card against CPU within atol "
        f"{SMOKE_LOGIT_TOL['atol']:g}, cross gates {VLM_GATE}: "
        + "; ".join(res))


def build_model(torch, arch, cfg, full, phase="vlm"):
    """Seeded random bf16 weights on the card; logs the depth cut against
    the full config ``full``."""
    from repro_torch.models import transformer as tfm
    t0 = time.perf_counter()
    model = tfm.init_params(cfg, seed=0, dtype=torch.bfloat16,
                            device="cuda")
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(phase, f"{arch}: {cfg.n_layers} of {full.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, Dh "
        f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{cfg.param_count() / 1e9:.2f} B parameters of the full config's "
        f"{full.param_count() / 1e9:.2f} B, {wbytes / 1e9:.2f} GB made on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    return model


def launch_counts():
    """Each kernel's launches since the last reset, and
    ``flash_prefill``'s by body."""
    from repro_torch.kernels import runtime
    counts = dict(runtime.launch_counts)
    counts.update({f"flash_prefill/{b}": n
                   for b, n in runtime.prefill_body_counts.items()})
    return counts


def hubert_run(torch):
    """hubert-xlarge at full width and depth (bf16): ``forward`` on B = 8
    frames of 1500 with ``HUBERT_LENGTHS``, its wall, device busy and
    ``flash_prefill``'s share (``profile_steps``) and launches (one a
    layer, the tensor-core body); ``prefill(embeds=...)``'s last-token
    logits against ``forward``'s at each row's last position within
    ``HUBERT_LAST_TOL``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime
    from repro_torch.models import transformer as tfm
    dev = torch.device("cuda")
    cfg = get_config(HUBERT_ARCH)
    model = build_model(torch, HUBERT_ARCH, cfg, cfg)
    B, T = HUBERT_ATTN["B"], HUBERT_ATTN["T"]
    gen = torch.Generator(device=dev).manual_seed(17)
    embeds = (torch.randn((B, T, cfg.d_model), generator=gen, device=dev)
              * 0.02).to(torch.bfloat16)
    lens = torch.tensor(HUBERT_LENGTHS, dtype=torch.int32, device=dev)
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    logits = tfm.forward(cfg, model, embeds=embeds, lengths=lens)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    want = {"flash_prefill": cfg.n_layers,
            "flash_prefill/tensor_core": cfg.n_layers,
            "flash_prefill/cuda_core": 0}
    if any(counts[k] != n for k, n in want.items()) or any(
            counts[k] for k in ("flash_decode", "paged_flash_decode",
                                "wkv6")):
        raise AssertionError(f"hubert forward: launches {counts}, want "
                             f"{want} and no other")
    if logits.shape != (B, T, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"hubert forward: logits {tuple(logits.shape)}"
                             f" not finite / wrong shape")
    last, cache = tfm.prefill(cfg, model, lengths=lens, cache_len=T,
                              embeds=embeds)
    ref_last = logits[torch.arange(B, device=dev), lens.long() - 1]
    err = assert_close(torch, "hubert prefill last logits vs forward", last,
                       ref_last, HUBERT_LAST_TOL)
    del cache, logits
    prof = profile_steps(torch, f"{HUBERT_ARCH} full width and depth, "
                         f"forward B={B} T={T}", lambda: tfm.forward(
                             cfg, model, embeds=embeds, lengths=lens),
                         "flash_prefill", "flash_prefill", steps=3)
    log("vlm", f"{HUBERT_ARCH} forward: first call {first_s:.3f} s; "
        f"flash_prefill {counts['flash_prefill']} launches = "
        f"{cfg.n_layers} layers, all on the tensor-core body (Dh 80); "
        f"prefill(embeds=...) last-token logits against forward's at each "
        f"row's last position: max abs {err:.3g} (atol "
        f"{HUBERT_LAST_TOL['atol']:g}, rtol {HUBERT_LAST_TOL['rtol']:g})")
    del model
    return dict(launches=counts["flash_prefill"], profile=prof,
                last_logit_err=err, first_call_s=first_s)


def vlm_prompts(torch, cfg):
    """Token ids (padded to the longest prompt), lengths and each
    request's own vision embeddings (1600 x 1280, normal x 0.02)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    B, T = len(VLM_PROMPTS), max(VLM_PROMPTS)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                         device=dev, dtype=torch.int32)
    lens = torch.tensor(VLM_PROMPTS, dtype=torch.int32, device=dev)
    vis = (torch.randn((B, cfg.n_vision_tokens, cfg.d_vision),
                       generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    return toks, lens, vis


def vlm_serve(torch, cfg, model, toks, lens, vis, paged, steps=None):
    """Whole-prompt prefill of the 8 prompts, then ``steps`` (default
    ``VLM_STEPS``) greedy steps on the contiguous cache or on the paged
    pool (page 128; the prefill cache moved into it, the cross K/V per
    slot).  Returns (ids, counts, the cross layers' share of the counts,
    first logits, prefill wall s, step wall ms)."""
    from repro_torch.kernels import runtime
    from repro_torch.models import transformer as tfm
    S = cfg.max_seq_len
    runtime.reset_launch_counts()
    torch.cuda.synchronize()
    with cross_launches() as cross:
        t0 = time.perf_counter()
        logits, cache = tfm.prefill(cfg, model, toks, lens, cache_len=S,
                                    vision_embeds=vis)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        first = logits
        kw = {}
        if paged:
            cache = to_paged(torch, tfm, cfg, cache, 128)
            kw = dict(page_size=128, paged_len=S)
        tok = logits.argmax(-1).to(torch.int32)
        ids = [tok.tolist()]
        steps = steps or VLM_STEPS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = tfm.decode_step(cfg, model, tok, cache, **kw)
            tok = logits.argmax(-1).to(torch.int32)
            ids.append(tok.tolist())
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
    if not torch.isfinite(logits).all():
        raise AssertionError("vlm: non-finite logits")
    del cache
    return ids, launch_counts(), dict(cross), first, prefill_s, step_ms


def vlm_step_profile(torch, cfg, model, toks, lens, vis, paged):
    """``profile_steps`` of an eager decode step of the 8 prompts, right
    after their whole-prompt prefill, on the contiguous cache or the
    paged pool (page 128)."""
    from repro_torch.models import transformer as tfm
    S = cfg.max_seq_len
    logits, cache = tfm.prefill(cfg, model, toks, lens, cache_len=S,
                                vision_embeds=vis)
    kw = {}
    if paged:
        cache = to_paged(torch, tfm, cfg, cache, 128)
        kw = dict(page_size=128, paged_len=S)
    tok = logits.argmax(-1).to(torch.int32)
    del logits
    which = "paged, page 128" if paged else "contiguous"
    return profile_steps(torch, f"{VLM_PATH} decode step, B=8, {which}, "
                         f"eager", lambda: tfm.decode_step(
                             cfg, model, tok, cache, **kw),
                         "decode attention", "flash_decode", steps=8)


def vlm_run(torch):
    """llama-3.2-vision-90b at full width with ``VLM_LAYERS`` of its 100
    layers (bf16, seeded random weights, every cross gate set to
    ``VLM_GATE``, cache ``VLM_MAX_SEQ``): 8 prompts of 256-1024 tokens,
    each with its own vision embeddings, prefilled whole, then
    ``VLM_STEPS`` greedy steps on the contiguous cache and on the paged
    pool: ids equal, each kernel's launches exactly one a layer a
    prefill or step (the cross layers' decode on ``flash_decode`` on
    both; the cross layers' own launches counted apart), the first token
    ``forward``'s argmax at each row's last position; then the eager
    decode step of each cache profiled three times in alternating
    order."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    import dataclasses
    dev = torch.device("cuda")
    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS,
                              max_seq_len=VLM_MAX_SEQ)
    model = build_model(torch, VLM_ARCH, cfg, full)
    n_gates = set_cross_gates(torch, model, VLM_GATE)
    n_cross = cfg.n_layers // cfg.cross_attn_every
    n_self = cfg.n_layers - n_cross
    log("vlm", f"{VLM_ARCH}: depth cut from {full.n_layers} to "
        f"{cfg.n_layers} layers ({n_self} self-attention, {n_cross} "
        f"cross-attention), cache length {cfg.max_seq_len} (the config's "
        f"{full.max_seq_len} cut); {n_gates} cross gates set to {VLM_GATE} "
        f"after the seeded init (zero there, as the reference's)")
    toks, lens, vis = vlm_prompts(torch, cfg)
    B = len(VLM_PROMPTS)
    # a warm-up on both caches (the first calls' allocations and GEMM
    # choices stay out of the timed runs)
    for paged in (False, True):
        vlm_serve(torch, cfg, model, toks[:, :64].contiguous(),
                  lens.clamp(max=64), vis, paged, steps=2)
    runs = {}
    for paged in (False, True):
        runs[paged] = vlm_serve(torch, cfg, model, toks, lens, vis, paged)
    (ids_c, cnt_c, x_c, first_c, pf_c, st_c), \
        (ids_p, cnt_p, x_p, first_p, pf_p, st_p) = runs[False], runs[True]
    if ids_c != ids_p:
        raise AssertionError(f"vlm: paged ids {ids_p} differ from "
                             f"contiguous {ids_c}")
    want_c = {"flash_prefill": cfg.n_layers,
              "flash_prefill/tensor_core": cfg.n_layers,
              "flash_decode": cfg.n_layers * VLM_STEPS,
              "paged_flash_decode": 0}
    want_p = dict(want_c, flash_decode=n_cross * VLM_STEPS,
                  paged_flash_decode=n_self * VLM_STEPS)
    # the cross layers' own launches, on either cache: one prefill a
    # layer, one flash_decode a layer a step (the vision K/V stay per slot)
    want_x = {"flash_prefill": n_cross, "flash_decode": n_cross * VLM_STEPS,
              "paged_flash_decode": 0, "wkv6": 0}
    for label, counts, want, cross in (("contiguous", cnt_c, want_c, x_c),
                                       ("paged", cnt_p, want_p, x_p)):
        if any(counts[k] != n for k, n in want.items()) or counts["wkv6"]:
            raise AssertionError(f"vlm {label}: launches {counts}, want "
                                 f"{want}")
        if any(cross[k] != n for k, n in want_x.items()):
            raise AssertionError(f"vlm {label}: cross-layer launches "
                                 f"{cross}, want {want_x}")
    logits = tfm.forward(cfg, model, toks, vision_embeds=vis, lengths=lens)
    at_last = logits[torch.arange(B, device=dev), lens.long() - 1]
    del logits
    fwd_ids = at_last.argmax(-1).tolist()
    if fwd_ids != ids_c[0]:
        raise AssertionError(f"vlm: first tokens {ids_c[0]}, forward's "
                             f"argmax {fwd_ids}")
    gap = float((first_c - at_last).abs().max())
    # launches over both runs, the self-attention layers' apart from the
    # cross layers'
    launches = {}
    for name in ("flash_prefill", "flash_decode", "paged_flash_decode"):
        cross = x_c[name] + x_p[name]
        launches[f"{name} cross"] = cross
        launches[f"{name} self"] = cnt_c[name] + cnt_p[name] - cross
    log("vlm", f"{VLM_PATH}: 8 prompts {VLM_PROMPTS}, each with its own "
        f"{cfg.n_vision_tokens} x {cfg.d_vision} vision embeddings; "
        f"whole-prompt prefill {pf_c:.3f} s contiguous, {pf_p:.3f} s "
        f"paged; {VLM_STEPS} greedy steps at {st_c:.2f} ms (contiguous) "
        f"and {st_p:.2f} ms a step (paged, page 128): ids equal; first "
        f"tokens equal forward's argmax at each row's last position (max "
        f"abs logit gap {gap:.3g}); launches contiguous "
        f"{ {k: cnt_c[k] for k in want_c} } (cross layers "
        f"{ {k: x_c[k] for k in want_x} }), paged "
        f"{ {k: cnt_p[k] for k in want_p} } (cross layers "
        f"{ {k: x_p[k] for k in want_x} }); both runs, self / cross: "
        f"{launches}")
    # the eager step's wall, device busy and idle share on each cache,
    # three profiles each in alternating order (one reading says nothing
    # of the spread)
    prof = {False: [], True: []}
    for order in ((False, True), (True, False), (False, True)):
        for paged in order:
            prof[paged].append(vlm_step_profile(torch, cfg, model, toks,
                                                lens, vis, paged))
    steps = {}
    for paged, label in ((False, "contiguous"), (True, "paged")):
        walls = [r["wall_ms"] for r in prof[paged]]
        busy = [r.get("busy_ms") for r in prof[paged]]
        idle = [r.get("idle_share") for r in prof[paged]]
        steps[label] = dict(wall_ms=walls, busy_ms=busy, idle_share=idle,
                            serve_step_ms=st_c if not paged else st_p)
        log("vlm", f"{VLM_PATH} eager decode step, {label}: wall {walls} "
            f"ms (spread {max(walls) - min(walls):.2f}), device busy "
            f"{busy} ms, idle share {idle}; the serve run's 32-step mean "
            f"{steps[label]['serve_step_ms']:.2f} ms")
    del model
    return dict(launches=launches,
                prefill_s={"contiguous": pf_c, "paged": pf_p},
                step_ms={"contiguous": st_c, "paged": st_p},
                step_profiles=steps, first_logit_gap=gap)


def vision_phase(torch):
    """The encoder and the VLM: the kernels at their shapes, the smoke
    parity of the three new configs, hubert-xlarge at full width and
    depth, then llama-3.2-vision-90b at full width with its depth cut.
    Each model is freed before the next is made."""
    t0 = time.perf_counter()
    rows = vision_kernels(torch)
    vision_smoke(torch)
    hubert = hubert_run(torch)
    gc.collect()
    torch.cuda.empty_cache()
    vlm = vlm_run(torch)
    gc.collect()
    torch.cuda.empty_cache()
    log("vlm", f"done in {time.perf_counter() - t0:.1f} s")
    return dict(rows=rows, hubert=hubert, vlm=vlm)


# ------------------------------------------- nemotron at head dim 192 ---
# nemotron-4-340b's attention: G = 12 at Dh 192 (the tensor-core prefill
# body; G * Dh 2304 in the decode body), decode over 4096 slots
NEMOTRON_ATTN = dict(B=8, H=96, Hkv=8, Dh=192, S=4096)
# the full-width run: every width as published, the depth cut from 96
# layers to 4 (46.5 GB of bf16 weights), the cache to 4096
NEMOTRON_LAYERS = 4
NEMOTRON_MAX_SEQ = 4096
NEMOTRON_PROMPTS = [256, 1024, 512, 768, 384, 900, 640, 1000]
NEMOTRON_NEW = 32
NEMOTRON_PATH = f"{NEMOTRON_ARCH} ({NEMOTRON_LAYERS} of 96 layers)"


def dh192_kernels(torch):
    """The three attention kernels at nemotron-4-340b's widths (H = 96,
    Hkv = 8: G = 12 at Dh 192), f32 and bf16: a 512-token chunk at offset
    1536 over 4096 slots through the tensor-core body, both decode kernels
    over 4096 slots at context 2048 and at rows of every length and
    wrapped rings (two calls, same bits), and both int8 decode kernels
    at context 2048 (bit for bit the float kernel over the dequantized
    cache); each against its plain version, and in bf16 timed beside its
    bound and SDPA.  Returns the bf16 rows."""
    from repro_torch.kernels import cost, ops, ref, runtime
    from repro_torch.models.attention import quantize_kv
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    B, H, Hkv, Dh, S = (NEMOTRON_ATTN[k] for k in ("B", "H", "Hkv", "Dh",
                                                   "S"))
    ctx, page = 2048, 128
    deq = ref.dequantize_kv
    rows, worst = {}, {}
    for dt in ("float32", "bfloat16"):
        tol, timed = MAIN_TOL[dt], dt == "bfloat16"

        def rnd(shape):
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).to(getattr(torch, dt))
        Tc, off = 512, 1536
        q, k, v = rnd((1, Tc, H, Dh)), rnd((1, S, Hkv, Dh)), \
            rnd((1, S, Hkv, Dh))
        row = chunk_case(torch, q, k, v, off, tol, f"Dh 192 chunk {dt}",
                         timed)
        key = f"flash_prefill H={H} Hkv={Hkv} Dh={Dh} chunk 512@1536/4096"
        worst[f"{key} {dt}"] = row["max_abs_err"]
        if timed:
            rows[key] = row
        del q, k, v
        q = rnd((B, H, Dh))
        kc, vc = rnd((B, S, Hkv, Dh)), rnd((B, S, Hkv, Dh))
        kp, vp, bt = paged_copy(torch, kc, vc, page, gen)
        pos = torch.full((B,), ctx - 1, dtype=torch.int32, device=dev)
        case = decode_case(torch, q, kc, vc, kp, vp, bt, pos, tol,
                           f"Dh 192 {dt}", timed)
        for kname, r in case.items():
            key = f"{kname} B=8 H={H} Hkv={Hkv} Dh={Dh} ctx=2048" + (
                " page=128" if "paged" in kname else "")
            worst[f"{key} {dt}"] = r["max_abs_err"]
            if timed:
                rows[key] = r
        for label, posl, ring in DECODE_MIXED:
            pm = torch.tensor(posl, dtype=torch.int32, device=dev)
            (a, b), (a2, b2) = [
                (ops.flash_decode(q, kc, vc, pm, ring=ring),
                 ops.paged_flash_decode(q, kp, vp, bt, pm, s_len=S,
                                        ring=ring)) for _ in range(2)]
            worst[f"Dh 192 decode {label} {dt}"] = max(
                assert_close(torch, f"Dh 192 flash_decode {label} {dt}", a,
                             ref.flash_decode_ref(q, kc, vc, pm, ring=ring),
                             tol),
                assert_close(torch, f"Dh 192 paged_flash_decode {label} "
                             f"{dt}", b, ref.paged_flash_decode_ref(
                                 q, kp, vp, bt, pm, s_len=S, ring=ring), tol))
            if not (torch.equal(a, a2) and torch.equal(b, b2)):
                raise AssertionError(f"Dh 192 decode {label} {dt}: two "
                                     f"calls on the same inputs differ")
        # int8: codes and scales of the same cache, paged the same way
        kc8, ks = quantize_kv(kc)
        vc8, vs = quantize_kv(vc)
        pools = []
        for t in (kc8, vc8, ks, vs):
            pl = t.new_zeros((kp.shape[0], page) + tuple(t.shape[2:]))
            pl[bt.reshape(-1).long()] = t.reshape(
                (B * (S // page), page) + tuple(t.shape[2:]))
            pools.append(pl)
        want8 = ref.flash_decode_int8_ref(q, kc8, vc8, ks, vs, pos)
        calls8 = {
            "flash_decode_int8": (
                lambda: ops.flash_decode_int8(q, kc8, vc8, ks, vs, pos),
                lambda: ref.flash_decode_int8_ref(q, kc8, vc8, ks, vs, pos),
                lambda: ops.flash_decode(q, deq(kc8, ks, q.dtype),
                                         deq(vc8, vs, q.dtype), pos),
                dict()),
            "paged_flash_decode_int8": (
                lambda: ops.paged_flash_decode_int8(q, *pools, bt, pos,
                                                    s_len=S),
                lambda: ref.paged_flash_decode_int8_ref(q, *pools, bt, pos,
                                                        s_len=S),
                lambda: ops.paged_flash_decode(
                    q, deq(pools[0], pools[2], q.dtype),
                    deq(pools[1], pools[3], q.dtype), bt, pos, s_len=S),
                dict(page=page))}
        for kname, (call, plain, dq, tables) in calls8.items():
            key = f"{kname} B=8 H={H} Hkv={Hkv} Dh={Dh} ctx=2048" + (
                " page=128" if "paged" in kname else "")
            got = call()
            err = assert_close(torch, f"{key} {dt}", got, want8, tol)
            if not torch.equal(got, dq()):
                raise AssertionError(f"{key} {dt}: differs from the float "
                                     f"kernel over the dequantized cache")
            worst[f"{key} {dt}"] = err
            if timed:
                code_bytes = 2 * B * ctx * Hkv * Dh
                scale_bytes = 2 * 4 * B * ctx * Hkv
                b_ms, b_by = bound_ms(cost.decode(B, H, Hkv, Dh, 2, ctx,
                                                  int8=True, **tables), dt)
                dmask = (torch.arange(S, device=dev)[None]
                         <= pos[:, None])[:, None, None]
                kd, vd = deq(kc8, ks, q.dtype), deq(vc8, vs, q.dtype)
                sdpa_ms = time_ms(torch, lambda: sdpa(
                    q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
                    attn_mask=dmask, enable_gqa=True), 20)
                rows[key] = dict(
                    ms=time_ms(torch, call, 50),
                    plain_ms=time_ms(torch, plain, 10),
                    library_ms=sdpa_ms, bound_ms=b_ms, bound_by=b_by,
                    max_abs_err=err, plan=runtime.decode_plans[kname])
                del kd, vd
        del q, kc, vc, kp, vp, kc8, vc8, ks, vs, pools
        torch.cuda.empty_cache()
    log("nemotron", f"kernels at nemotron-4-340b's widths (H = {H}, Hkv = "
        f"{Hkv}: G = {H // Hkv} at Dh {Dh}) agree with the plain versions "
        f"(f32 atol 1e-4 rtol 1e-3; bf16 atol 2e-3 rtol 1e-2), the prefill "
        f"through the body its dtype names (bf16: tensor-core), decode "
        f"two calls the same bits, "
        f"int8 the float kernel's bits over the dequantized cache; max abs "
        f"err: " + "; ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    log_rows("nemotron", rows)
    return rows


def nemotron_check_launches(label, cfg, counts, steps, decode_kernel):
    """Each layer launches ``flash_prefill`` once a prefill chunk (the
    tensor-core body at Dh 192, none on the CUDA-core body) and
    ``decode_kernel`` once a decode step; nothing else of the kernels
    runs."""
    L = cfg.n_layers
    other = "flash_decode" if decode_kernel == "paged_flash_decode" else \
        "paged_flash_decode"
    if counts[decode_kernel] != L * steps["decode"] or \
            counts["flash_prefill"] != L * steps["prefill"] or \
            counts["flash_prefill/tensor_core"] != counts["flash_prefill"] \
            or counts["flash_prefill/cuda_core"] or \
            not steps["decode"] or counts[other] or counts["wkv6"]:
        raise AssertionError(f"{label}: launches {counts} for "
                             f"{steps['prefill']} prefill chunks and "
                             f"{steps['decode']} decode steps of {L} layers")
    plan = counts[f"{decode_kernel}/last plan"]
    log("nemotron", f"{label}: flash_prefill {counts['flash_prefill']} = "
        f"{L} x {steps['prefill']} chunks, all on the tensor-core body; "
        f"{decode_kernel} {counts[decode_kernel]} = {L} x {steps['decode']} "
        f"steps (last plan n_split {plan.n_split}, L {plan.L}, {plan.body} "
        f"body)")


def nemotron_phase(torch):
    """nemotron-4-340b: the kernels at its attention widths
    (``dh192_kernels``), then the model at every published width with its
    depth cut to ``NEMOTRON_LAYERS`` (bf16, seeded random weights, cache
    ``NEMOTRON_MAX_SEQ``): ``NEMOTRON_PROMPTS`` served through the engine
    with chunked prefill (512) on the paged pool and then on the
    contiguous pool, each eagerly and with both graphs (ids and launches
    identical, every page free), the paged ids equal to the contiguous
    ones.  Returns the kernel rows, the launches and the serve stats."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import default_pool_tokens
    import dataclasses
    t0 = time.perf_counter()
    rows = dh192_kernels(torch)
    dev = torch.device("cuda")
    full = get_config(NEMOTRON_ARCH)
    cfg = dataclasses.replace(full, n_layers=NEMOTRON_LAYERS,
                              max_seq_len=NEMOTRON_MAX_SEQ)
    model, wbytes = make_model(torch, NEMOTRON_ARCH, cfg)
    log("nemotron", f"depth cut from {full.n_layers} to {cfg.n_layers} "
        f"layers ({cfg.param_count() / 1e9:.2f} B of "
        f"{full.param_count() / 1e9:.1f} B parameters, {wbytes / 1e9:.2f} "
        f"GB), cache length {cfg.max_seq_len} (the config's "
        f"{full.max_seq_len} cut); every width as published: d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} at Dh "
        f"{cfg.d_head}, d_ff {cfg.d_ff} ({cfg.act}), vocab {cfg.vocab_size}")
    warm = make_engine(torch, cfg, model, wbytes, True, 2,
                       2 * cfg.max_seq_len, decode_graph=False)
    serve_run(torch, cfg, warm, requests([96, 700], 4), "nemotron warm-up")
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    pool_tokens = default_pool_tokens(cfg, model, dev)
    n = len(NEMOTRON_PROMPTS)
    ids, counts, stats = {}, {}, {}
    for paged, kernel in ((True, "paged_flash_decode"),
                          (False, "flash_decode")):
        pool = "paged" if paged else "contiguous"
        label = (f"{NEMOTRON_PATH} {pool} pool, chunk 512"
                 + (", page 128" if paged else "") + f", {n} slots")
        ids[pool] = {}
        counts[pool], stats[pool], steps = serve_pair(
            torch, cfg, lambda **g: make_engine(
                torch, cfg, model, wbytes, paged, n,
                pool_tokens if paged else None, **g),
            NEMOTRON_PROMPTS, NEMOTRON_NEW, label, ids_out=ids[pool])
        nemotron_check_launches(label, cfg, counts[pool], steps, kernel)
        gc.collect()
        torch.cuda.empty_cache()
    if ids["paged"] != ids["contiguous"]:
        bad = sorted(r for r in ids["paged"]
                     if ids["paged"][r] != ids["contiguous"].get(r))
        raise AssertionError(f"nemotron: paged ids differ from contiguous "
                             f"for requests {bad}")
    log("nemotron", f"{NEMOTRON_PATH}: {n} requests of "
        f"{NEMOTRON_PROMPTS} prompt tokens, {NEMOTRON_NEW} new each, on "
        f"both pools: paged ids == contiguous ids; no ValueError; done in "
        f"{time.perf_counter() - t0:.1f} s")
    del model
    return dict(rows=rows, launches={
        "flash_prefill": counts["paged"]["flash_prefill"],
        "paged_flash_decode": counts["paged"]["paged_flash_decode"],
        "flash_decode": counts["contiguous"]["flash_decode"]},
        serve=stats, pool_tokens=pool_tokens)


# ------------------------------------------------------------ training ---
TRAIN_ARCH = "qwen3-14b"
# Qwen3-14B at every published width with its depth cut from 40 to 8
# layers (4.20 B parameters: 8.4 GB of bf16 weights, 8.4 GB of gradients
# and 33.6 GB of f32 moments), batch 4 x 512 tokens of data/tokens.py's
# stream, remat on, 10 AdamW steps with a 2-step warm-up to a peak lr of
# 1e-4 (at the launcher's smoke default 1e-3 the loss rose from 12.49 to
# 16.10 at the second step, grad norm 211, and ended above its start)
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR = 10, 2, 1e-4
TRAIN_PATH = f"{TRAIN_ARCH} training ({TRAIN_LAYERS} of 40 layers)"
# the training step's attention: the forward sees seq - 1 tokens
TRAIN_ATTN = dict(B=TRAIN_BATCH, T=TRAIN_SEQ - 1, H=40, Hkv=8, Dh=128)
# rwkv6-3b at every published width and all 32 layers (3.1 B parameters;
# weights, gradients and f32 moments ~37 GB), batch 2 x 4096 tokens (the
# train_4k length; the forward sees 4095), remat on, 5 AdamW steps, a
# 1-step warm-up to lr 1e-4; its backward through wkv6_bwd
RWKV_TRAIN_ARCH = "rwkv6-3b"
WKV6_BWD_BODY = ("cuda_core (a head's rows over a thread-block cluster: "
                 "2 rows x 4 columns of S and G a thread; the state "
                 "checkpointed every 8 steps, each 8-step chunk replayed "
                 "into registers and unrolled, its partials folded once a "
                 "half chunk, dv summed over the cluster through "
                 "distributed shared memory)")
RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ, RWKV_TRAIN_STEPS = 2, 4096, 5
RWKV_TRAIN_PATH = (f"{RWKV_TRAIN_ARCH} training (32 layers, "
                   f"{RWKV_TRAIN_BATCH} x {RWKV_TRAIN_SEQ})")
# smoke f32 train steps, card against CPU
TRAIN_SMOKE_ARCHS = ("qwen3-14b", "rwkv6-3b", "recurrentgemma-2b",
                     MOE_ARCH)
# the kernels' autograd Functions against autograd through the plain
# versions (f32, smoke shapes): (B, Tq, Tk, H, Hkv, Dh, causal, window,
# lengths)
AUTOGRAD_PREFILL = {
    "causal": (2, 40, 40, 4, 2, 64, True, 0, (40, 29)),
    "windowed": (2, 48, 48, 4, 2, 64, True, 16, None),
    "non-causal Tq 24 over Tk 40": (2, 24, 40, 4, 2, 64, False, 0,
                                    (40, 31)),
}
AUTOGRAD_WKV = (2, 37, 2, 64)     # (B, T, H, hs): T off the 16-step tile
MAX_TRAIN_PEAK = 75e9             # bytes: cut the depth to 6 above this


def grads_with(torch, out, inputs, cot):
    outs = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(outs, [x for x in inputs if x is not None
                                      and x.requires_grad], cot)


def autograd_checks(torch):
    """The kernels under autograd at smoke shapes, f32: ``flash_prefill``
    (causal, windowed, non-causal with Tq != Tk) recorded on the card,
    launching its kernel once (counted) with its plain version's
    backward (one pass counted), and ``wkv6``, launching its kernel and
    its backward kernel ``wkv6_bwd`` once each (no plain pass); outputs
    and gradients against autograd through the plain versions on the
    same inputs; then the bf16
    grouped product's backward (``moe.GroupedMM``) at one full-width
    qwen3-moe layer's shapes (512 tokens x top 8) against autograd
    through ``grouped_mm_plain``, timed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cost, ops, ref, runtime
    from repro_torch.models import moe
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)

    def rnd(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype).requires_grad_(True)
    worst = {}
    tol = TOL["float32"]
    for label, (B, Tq, Tk, H, Hkv, Dh, causal, window, lens) in \
            AUTOGRAD_PREFILL.items():
        q, k, v = rnd((B, Tq, H, Dh)), rnd((B, Tk, Hkv, Dh)), \
            rnd((B, Tk, Hkv, Dh))
        lt = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device=dev)
        kw = dict(causal=causal, window=window)
        runtime.reset_launch_counts()
        out = ops.flash_prefill(q, k, v, lt, **kw)
        cot = torch.randn(out.shape, generator=gen, device=dev)
        got = grads_with(torch, out, (q, k, v), [cot])
        if runtime.launch_counts["flash_prefill"] != 1 or \
                runtime.autograd_counts["flash_prefill"] != 1:
            raise AssertionError(f"flash_prefill under autograd {label}: "
                                 f"launches {runtime.launch_counts}, "
                                 f"backward {runtime.autograd_counts}")
        want_out = ref.flash_prefill_ref(q, k, v, lt, **kw)
        want = grads_with(torch, want_out, (q, k, v), [cot])
        worst[f"flash_prefill {label}"] = max(
            [assert_close(torch, f"flash_prefill autograd {label} out", out,
                          want_out, tol)]
            + [assert_close(torch, f"flash_prefill autograd {label} d{n}",
                            g, w, tol) for n, g, w in zip("qkv", got, want)])
    B, T, H, hs = AUTOGRAD_WKV
    r, k, v = (rnd((B, T, H, hs)) for _ in range(3))
    w = torch.sigmoid(torch.randn((B, T, H, hs), generator=gen,
                                  device=dev)).requires_grad_(True)
    u, s0 = rnd((H, hs), scale=0.1), rnd((B, H, hs, hs), scale=0.1)
    args = (r, k, v, w, u, s0)
    runtime.reset_launch_counts()
    y, sT = ops.wkv6(*args)
    cots = [torch.randn(y.shape, generator=gen, device=dev),
            torch.randn(sT.shape, generator=gen, device=dev)]
    got = grads_with(torch, (y, sT), args, cots)
    if runtime.launch_counts["wkv6"] != 1 or \
            runtime.launch_counts["wkv6_bwd"] != 1 or \
            any(runtime.autograd_counts.values()):
        raise AssertionError(f"wkv6 under autograd: launches "
                             f"{runtime.launch_counts}, plain backward "
                             f"passes {runtime.autograd_counts}")
    want_out = ref.wkv6_ref(*args)
    want = grads_with(torch, want_out, args, cots)
    worst["wkv6"] = max(
        [assert_close(torch, "wkv6 autograd y", y, want_out[0], tol),
         assert_close(torch, "wkv6 autograd sT", sT, want_out[1], tol)]
        + [assert_close(torch, f"wkv6 autograd d{n}", g, wt, tol)
           for n, g, wt in zip(("r", "k", "v", "w", "u", "s0"), got, want)])

    # the grouped product's backward at a full-width qwen3-moe layer
    cfg = get_config(MOE_ARCH)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    rows = 512 * cfg.top_k
    cpu_gen = torch.Generator().manual_seed(31)
    ids = torch.sort(torch.randint(0, E, (rows,), generator=cpu_gen))[0]
    offs = moe.group_offsets(ids, E).to(dev)
    grouped = {}
    for proj, (K, N) in (("gate/up d -> f", (d, f)),
                         ("down f -> d", (f, d))):
        x = rnd((rows, K), torch.bfloat16)
        wt = rnd((E, K, N), torch.bfloat16, scale=K ** -0.5)
        dy = torch.randn((rows, N), generator=gen, device=dev).to(
            torch.bfloat16)

        def fused():
            return torch.autograd.grad(moe.grouped_mm(x, wt, offs), (x, wt),
                                       dy)

        def plain():
            xf = x.detach().float().requires_grad_(True)
            wf = wt.detach().float().requires_grad_(True)
            return torch.autograd.grad(moe.grouped_mm_plain(xf, wf, offs),
                                       (xf, wf), dy.float())
        runtime.reset_launch_counts()
        dx, dw = fused()
        if runtime.grouped_counts["grouped_mm"] != 1 or \
                runtime.autograd_counts["grouped_mm"] != 1:
            raise AssertionError(f"grouped product under autograd {proj}: "
                                 f"{runtime.grouped_counts}, "
                                 f"{runtime.autograd_counts}")
        pdx, pdw = plain()
        gtol = dict(atol=1e-1, rtol=2e-2)
        err = max(assert_close(torch, f"GroupedMM {proj} dx", dx, pdx, gtol),
                  assert_close(torch, f"GroupedMM {proj} dw", dw, pdw, gtol))
        # forward + backward: 3 products of the forward's FLOPs; bytes:
        # x, w, dy read, y, dx, dw written once, bf16
        fwd = cost.grouped_mm(rows, K, N, E, 2)
        b_ms, b_by = bound_ms(cost.Cost(3 * fwd.flops, 2 * fwd.bytes),
                              "bfloat16")
        grouped[proj] = dict(
            max_abs_err=err, ms=time_ms(torch, fused, 10),
            plain_ms=time_ms(torch, plain, 3, 1), bound_ms=b_ms,
            bound_by=b_by, experts_hit=int((torch.diff(torch.cat(
                [offs.new_zeros(1), offs])) > 0).sum()))
        del x, wt, dy, dx, dw, pdx, pdw
        torch.cuda.empty_cache()
    log("train", f"autograd on the card, f32, against autograd through the "
        f"plain versions (atol 1e-4 rtol 1e-3): each flash_prefill call "
        f"one kernel launch and one plain backward pass, the wkv6 call one "
        f"wkv6 and one wkv6_bwd launch; max abs err: "
        + "; ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    for proj, g in grouped.items():
        log("train", f"qwen3-moe grouped product {proj}, {rows} rows over "
            f"{E} experts ({g['experts_hit']} hit), bf16, forward + "
            f"backward (GroupedMM: dx grouped with w^T, dw the 2-D x 2-D "
            f"grouped form): {g['ms']:.4f} ms, plain masked loop in f32 "
            f"{g['plain_ms']:.4f} ms, bound {g['bound_ms']:.4f} ms "
            f"({g['bound_by']}); against autograd through grouped_mm_plain "
            f"max abs err {g['max_abs_err']:.3g} (atol 0.1 rtol 2e-2)")
    return dict(worst=worst, grouped=grouped)


def train_attention_row(torch):
    """``flash_prefill`` at the training step's attention shape (bf16,
    B = 4, T = 511, H = 40, Hkv = 8, causal): the kernel's forward
    against its plain version, timed beside its bound and SDPA's; then
    forward + backward under autograd (the kernel, then the plain
    version's backward) beside the plain version's and SDPA's forward +
    backward and their bound (12 pair-products of H Dh: 4 forward, 8
    backward)."""
    from repro_torch.kernels import cost, ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(37)
    B, T, H, Hkv, Dh = (TRAIN_ATTN[k] for k in ("B", "T", "H", "Hkv", "Dh"))

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16).requires_grad_(True)
    q, k, v = rnd((B, T, H, Dh)), rnd((B, T, Hkv, Dh)), rnd((B, T, Hkv, Dh))
    dout = torch.randn((B, T, H, Dh), generator=gen, device=dev).to(
        torch.bfloat16)
    with torch.no_grad():
        err = assert_close(torch, "flash_prefill training shape",
                           prefill(q, k, v), ref.flash_prefill_ref(q, k, v),
                           MAIN_TOL["bfloat16"])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fwd = cost.prefill(B, T, T, H, Hkv, Dh, 2)
    b_ms, b_by = bound_ms(fwd, "bfloat16")
    # forward and backward: three times the forward's products, every
    # input and output twice (the gradients of q, k, v and the output's)
    fb_ms, fb_by = bound_ms(cost.Cost(3 * fwd.flops, 2 * fwd.bytes),
                            "bfloat16")

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(), (q, k, v), dout)
    with torch.no_grad():
        row = dict(
            ms=time_ms(torch, lambda: ops.flash_prefill(q, k, v), 20),
            plain_ms=time_ms(torch, lambda: ref.flash_prefill_ref(q, k, v),
                             5, 1),
            library_ms=time_ms(torch, lambda: sdpa(
                qt, kt, vt, is_causal=True, enable_gqa=True), 20))
    row.update(
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        fwd_bwd_ms=time_ms(torch, fwd_bwd(lambda: ops.flash_prefill(
            q, k, v)), 5, 1),
        plain_fwd_bwd_ms=time_ms(torch, fwd_bwd(
            lambda: ref.flash_prefill_ref(q, k, v)), 5, 1),
        sdpa_fwd_bwd_ms=time_ms(torch, fwd_bwd(lambda: sdpa(
            qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)),
            10),
        fwd_bwd_bound_ms=fb_ms, fwd_bwd_bound_by=fb_by)
    log("train", f"flash_prefill at the training shape (bf16, B={B} T={T} "
        f"H={H} Hkv={Hkv} Dh={Dh}, causal): forward {row['ms']:.4f} ms "
        f"(plain {row['plain_ms']:.4f}, sdpa {row['library_ms']:.4f}, "
        f"bound {b_ms:.4f} {b_by}); forward + backward under autograd "
        f"{row['fwd_bwd_ms']:.4f} ms (plain {row['plain_fwd_bwd_ms']:.4f}, "
        f"sdpa {row['sdpa_fwd_bwd_ms']:.4f}, bound {fb_ms:.4f} {fb_by}); "
        f"max abs err {err:.3g}")
    return row


def train_smoke(torch):
    """One train step at f32, smoke size, for ``TRAIN_SMOKE_ARCHS`` on the
    card (the kernels under autograd; the MoE's f32 grouped products on
    the plain route) against the same step on the CPU from the same
    weights and batch: loss (rtol 1e-5), grad_norm (rtol 1e-4) and every
    updated parameter (atol 1e-5).  AdamW runs with eps 1e-3: the first
    step moves an element by lr g / (|g| + eps), and at the default eps
    1e-8 an element whose gradient is near eps moves by a fraction of lr
    that the gradient's last bits decide (the card's and the CPU's sums
    differ there); at 1e-3 the update is a smooth function of the
    gradient, and a missing or wrong update still moves an element by
    about lr |g| / eps, ~1e-4 and more."""
    from repro_torch import bridge
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import tokens as data_tokens
    from repro_torch.kernels import runtime
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer, train_loop
    res = []
    opt_cfg = optimizer.AdamWConfig(lr=1e-3, eps=1e-3, warmup_steps=1,
                                    total_steps=10)
    for arch in TRAIN_SMOKE_ARCHS:
        cfg = get_smoke_config(arch)
        cpu_model = tfm.init_params(cfg, seed=0, dtype=torch.float32,
                                    device="cpu")
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
        batch = next(data_tokens.batches(cfg, 2, 33, seed=3, device="cpu"))
        out = {}
        for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
            step = train_loop.make_train_step(cfg, opt_cfg)
            state = optimizer.init(bridge.leaves(model))
            runtime.reset_launch_counts()
            _, _, metrics = step(model, state, {
                k: t.to(dev) for k, t in batch.items()})
            torch.cuda.synchronize()
            out[dev] = ({k: float(v) for k, v in metrics.items()},
                        dict(runtime.launch_counts),
                        dict(runtime.autograd_counts))
        (mc, _, _), (mg, lg, ag) = out["cpu"], out["cuda"]
        if not math.isclose(mg["loss"], mc["loss"], rel_tol=1e-5) or \
                not math.isclose(mg["grad_norm"], mc["grad_norm"],
                                 rel_tol=1e-4):
            raise AssertionError(f"{arch} smoke train step: card {mg}, CPU "
                                 f"{mc}")
        worst = 0.0
        for (name, a), b in zip(cpu_model.named_parameters(),
                                gpu_model.parameters()):
            worst = max(worst, assert_close(
                torch, f"{arch} updated {name}", b.detach().cpu(),
                a.detach(), dict(atol=1e-5, rtol=0)))
        n_attn = sum(b in ("attn", "moe") for pat, reps in cfg.block_groups()
                     for b in pat for _ in range(reps))
        n_rwkv = sum(b == "rwkv" for pat, reps in cfg.block_groups()
                     for b in pat for _ in range(reps))
        if lg["flash_prefill"] != n_attn or lg["wkv6"] != n_rwkv or \
                lg["wkv6_bwd"] != n_rwkv or \
                ag["flash_prefill"] != n_attn:
            raise AssertionError(f"{arch} smoke train step: launches {lg}, "
                                 f"plain backward passes {ag}; want "
                                 f"{n_attn} flash_prefill (and as many "
                                 f"plain passes), {n_rwkv} wkv6 and "
                                 f"wkv6_bwd (no plain pass)")
        res.append(f"{arch} loss {mg['loss']:.6f} (CPU {mc['loss']:.6f}), "
                   f"grad_norm {mg['grad_norm']:.6f} ({mc['grad_norm']:.6f}),"
                   f" params max abs {worst:.3g}; flash_prefill "
                   f"{lg['flash_prefill']} launches and as many plain "
                   f"backward passes, wkv6 {lg['wkv6']} and wkv6_bwd "
                   f"{lg['wkv6_bwd']} launches")
        del cpu_model, gpu_model
    torch.cuda.empty_cache()
    log("train", "smoke f32 train step, card against CPU: " + "; ".join(res))
    return res


def split_step(torch, step_fn, model, state, batch):
    """One train step split by CUDA events into forward (``lm_loss``),
    backward (up to ``optimizer.apply``) and the AdamW update: returns
    (model, state, {part: ms})."""
    from repro_torch.train import optimizer, train_loop
    ev = {}
    saved_loss, saved_apply = train_loop.lm_loss, optimizer.apply

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev[name] = e

    def timed_loss(*a, **kw):
        mark("start")
        out = saved_loss(*a, **kw)
        mark("loss")
        return out

    def timed_apply(*a, **kw):
        mark("backward")
        out = saved_apply(*a, **kw)
        mark("update")
        return out
    try:
        train_loop.lm_loss, optimizer.apply = timed_loss, timed_apply
        model, state, _ = step_fn(model, state, batch)
        torch.cuda.synchronize()
    finally:
        train_loop.lm_loss, optimizer.apply = saved_loss, saved_apply
    return model, state, {
        "forward": ev["start"].elapsed_time(ev["loss"]),
        "backward": ev["loss"].elapsed_time(ev["backward"]),
        "update": ev["backward"].elapsed_time(ev["update"])}


def train_full(torch):
    """Qwen3-14B at every published width with ``TRAIN_LAYERS`` of its 40
    layers (bf16, seeded random weights), trained ``TRAIN_STEPS`` steps
    through ``train_loop.make_train_step`` (remat on) on batches of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens of ``data/tokens.py``'s
    stream: the loss finite at every step and the last below the first;
    step wall, tok/s, peak ``max_memory_allocated`` and the
    ``flash_prefill`` launches a step (forward and remat's recompute)
    and plain backward passes; then one step split by CUDA events into
    forward (``lm_loss``), backward and the AdamW update, and one under
    ``torch.profiler``: device busy, idle share, the attention kernel's
    and its plain backward's device time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.data import tokens as data_tokens
    from repro_torch.kernels import ops, runtime
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer, train_loop
    import dataclasses
    dev = torch.device("cuda")
    full = get_config(TRAIN_ARCH)
    layers = TRAIN_LAYERS
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(full, n_layers=layers)
    model = build_model(torch, TRAIN_ARCH, cfg, full, phase="train")
    n_params = sum(p.numel() for p in model.parameters())
    opt_cfg = optimizer.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                                    total_steps=TRAIN_STEPS)
    state = optimizer.init(bridge.leaves(model))
    step_fn = train_loop.make_train_step(cfg, opt_cfg, remat=True)
    it = data_tokens.batches(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=dev)
    losses, walls, launches, backs = [], [], [], []
    for i in range(TRAIN_STEPS):
        batch = next(it)
        torch.cuda.synchronize()
        runtime.reset_launch_counts()
        t0 = time.perf_counter()
        model, state, metrics = step_fn(model, state, batch)
        loss = float(metrics["loss"])
        walls.append((time.perf_counter() - t0) * 1e3)
        launches.append(runtime.launch_counts["flash_prefill"])
        backs.append(runtime.autograd_counts["flash_prefill"])
        losses.append(loss)
        log("train", f"{TRAIN_PATH} step {i}: loss={loss:.4f} "
            f"lr={float(metrics['lr']):.2e} grad_norm="
            f"{float(metrics['grad_norm']):.3f}, {walls[-1]:.1f} ms, "
            f"flash_prefill launches {launches[-1]}, plain backward passes "
            f"{backs[-1]}")
        if not math.isfinite(loss):
            raise AssertionError(f"{TRAIN_PATH}: loss {loss} at step {i}")
    peak = torch.cuda.max_memory_allocated()
    if losses[-1] >= losses[0]:
        raise AssertionError(f"{TRAIN_PATH}: loss {losses[0]} -> "
                             f"{losses[-1]} did not fall")
    if any(n != 2 * layers for n in launches) or \
            any(n != layers for n in backs):
        raise AssertionError(f"{TRAIN_PATH}: flash_prefill launches "
                             f"{launches}, plain backward passes {backs}; "
                             f"want {2 * layers} (forward + remat) and "
                             f"{layers} a step")
    if peak > MAX_TRAIN_PEAK:
        raise AssertionError(f"{TRAIN_PATH}: peak {peak / 1e9:.1f} GB over "
                             f"{MAX_TRAIN_PEAK / 1e9:.0f} GB")
    tokens = TRAIN_BATCH * (TRAIN_SEQ - 1)
    later = walls[1:]
    step_ms = sorted(later)[len(later) // 2]

    # one step split by CUDA events: forward (the loss), backward, update
    model, state, split = split_step(torch, step_fn, model, state, next(it))
    total = sum(split.values())

    # one step under the profiler, the plain attention backward in a range
    plain = ops._PREFILL_GRAD.plain

    def ranged_plain(*a, **kw):
        with record_function("train/plain attention backward"):
            return plain(*a, **kw)
    batch = next(it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, state, _ = step_fn(model, state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    batch = next(it)
    try:
        ops._PREFILL_GRAD.plain = ranged_plain
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model, state, _ = step_fn(model, state, batch)
            torch.cuda.synchronize()
    finally:
        ops._PREFILL_GRAD.plain = plain
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    kernels = [e for e in events if e.device_type == cuda
               and not e.name.startswith("train/")]
    prof_out = {}
    if kernels:
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3

        def launched_us(e):
            return sum(kk.duration for kk in e.kernels) + sum(
                launched_us(c) for c in e.cpu_children)
        plain_bwd = sum(launched_us(e) for e in events
                        if e.device_type != cuda and e.name ==
                        "train/plain attention backward") / 1e3
        attn_fwd = sum(e.time_range.elapsed_us() for e in kernels
                       if "flash_prefill" in e.name) / 1e3
        prof_out = dict(busy_ms=busy, idle_share=1 - busy / wall_ms,
                        wall_ms=wall_ms, plain_attention_backward_ms=plain_bwd,
                        flash_prefill_ms=attn_fwd, launches=len(kernels))
        log("train", f"{TRAIN_PATH} profiled step: {wall_ms:.1f} ms wall "
            f"(unprofiled), {busy:.1f} ms device busy (idle share "
            f"{1 - busy / wall_ms:.3f}), {len(kernels)} kernel launches; "
            f"flash_prefill kernels {attn_fwd:.2f} ms (forward and remat's "
            f"recompute), the plain attention backward {plain_bwd:.2f} ms "
            f"({plain_bwd / busy:.3f} of busy)")
    else:
        log("train", f"{TRAIN_PATH}: the profiler saw no device events "
            f"(device busy and idle share not measured)")
    log("train", f"{TRAIN_PATH}: {n_params / 1e9:.3f} B parameters, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, remat on; {TRAIN_STEPS} steps, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (finite at every step); step "
        f"wall first {walls[0]:.1f} ms, median of the rest {step_ms:.1f} ms "
        f"({tokens / step_ms * 1e3:.0f} tok/s); peak max_memory_allocated "
        f"{peak / 1e9:.2f} GB; flash_prefill {launches[0]} launches a step "
        f"({layers} forward + {layers} remat recompute), {backs[0]} plain "
        f"backward passes; a step split by CUDA events: forward "
        f"{split['forward']:.1f} ms ({split['forward'] / total:.3f}), "
        f"backward {split['backward']:.1f} ms "
        f"({split['backward'] / total:.3f}), AdamW update "
        f"{split['update']:.1f} ms ({split['update'] / total:.3f})")
    del model, state
    return dict(losses=losses, step_ms=walls, median_step_ms=step_ms,
                tok_s=tokens / step_ms * 1e3, peak_bytes=peak,
                launches_per_step=launches[0], plain_backward_per_step=backs[0],
                split_ms=split, profile=prof_out, n_params=n_params,
                launches=sum(launches))


def rwkv_step_count(torch, cfg, step_fn, model, state, batch, smi):
    """One full-width rwkv6-3b train step counted by
    ``launch/op_analysis.py`` on the real tensors (the kernels launch and
    count by their formulas; the step trains) and traced on fake
    ``cuda`` tensors: FLOPs, bytes, ops and kernel calls equal; the
    count's bound at the H100 peaks at most ``ANALYSIS_BOUND_SLACK`` x
    the CUDA-event time of a step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import bridge
    from repro_torch.kernels import runtime
    from repro_torch.launch import op_analysis as oa
    from repro_torch.launch.input_specs import params_shapes
    from repro_torch.train import optimizer
    runtime.reset_launch_counts()
    real = oa.count(step_fn, model, state, batch)
    torch.cuda.synchronize()
    launched = {k: v for k, v in runtime.launch_counts.items() if v}
    model, state = real.result[:2]
    t0 = time.perf_counter()
    with FakeTensorMode():
        fmodel = params_shapes(cfg, torch.bfloat16, "cuda")
        fake = oa.count(step_fn, fmodel,
                        optimizer.init(bridge.leaves(fmodel)),
                        fake_like(torch, batch, "cuda"))
    trace_s = time.perf_counter() - t0
    if not (real.stats == fake.stats and real.ops == fake.ops
            and real.kernels == fake.kernels):
        raise AssertionError(f"{RWKV_TRAIN_PATH}: real count {real.stats} "
                             f"{dict(real.kernels)} != fake cuda "
                             f"{fake.stats} {dict(fake.kernels)}; ops "
                             f"{count_diff(real, fake)}")
    n = cfg.n_layers
    if dict(real.kernels) != {"wkv6": 2 * n, "wkv6_bwd": n} or \
            launched != {"wkv6": 2 * n, "wkv6_bwd": n}:
        raise AssertionError(f"{RWKV_TRAIN_PATH} count: kernel calls "
                             f"{dict(real.kernels)}, launches {launched}")
    terms = oa.analyze(real, 1, 6.0 * cfg.active_param_count()
                       * RWKV_TRAIN_BATCH * (RWKV_TRAIN_SEQ - 1))
    ms = time_ms(torch, lambda: step_fn(model, state, batch), 1, 0)
    bound = max(terms.compute_s, terms.memory_s) * 1e3
    by = "compute" if terms.compute_s >= terms.memory_s else "memory"
    formulas = {k: (v.flops, v.bytes) for k, v in real.kernel_stats.items()}
    log("train", f"{RWKV_TRAIN_PATH}, one step under op_analysis.count: "
        f"real == fake cuda (traced in {trace_s:.1f} s): "
        f"{real.stats.flops:.6g} FLOP, {real.stats.bytes:.6g} B, "
        f"{sum(real.ops.values())} ops outside {dict(real.kernels)} kernel "
        f"calls (their formulas, FLOP and B: {formulas}); bound "
        f"{bound:.4f} ms ({by}; compute {terms.compute_s * 1e3:.4f}, "
        f"memory {terms.memory_s * 1e3:.4f} ms) against {ms:.4f} ms a "
        f"step by CUDA events: share {bound / ms:.4f} on {smi}")
    if bound > ANALYSIS_BOUND_SLACK * ms:
        raise AssertionError(f"{RWKV_TRAIN_PATH}: count's bound {bound:.4f}"
                             f" ms > {ANALYSIS_BOUND_SLACK} x measured "
                             f"{ms:.4f} ms: the count is wrong")
    return model, state, dict(
        flops=real.stats.flops, bytes=real.stats.bytes,
        compute_s=terms.compute_s, memory_s=terms.memory_s, step_ms=ms,
        share=bound / ms, launches=launched, trace_s=trace_s,
        memory=real.memory)


def train_rwkv(torch):
    """rwkv6-3b at every published width and depth (bf16, seeded random
    weights) trained ``RWKV_TRAIN_STEPS`` steps of ``RWKV_TRAIN_BATCH`` x
    ``RWKV_TRAIN_SEQ`` tokens with remat: the loss finite at every step
    and the last below the first; each step ``wkv6`` twice a layer
    (forward and remat's recompute) and its backward kernel ``wkv6_bwd``
    once, no plain backward pass; step wall, tok/s, peak
    ``max_memory_allocated``; one step split by CUDA events, one under
    ``torch.profiler`` (device busy, idle share, ``wkv6_bwd``'s and
    ``wkv6``'s device time), and one counted (``rwkv_step_count``).
    The first step's first ``wkv6`` backward call (its last layer's) is
    kept, and ``wkv6_train_rows`` checks and times both kernels on its
    operands once the model is gone."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.data import tokens as data_tokens
    from repro_torch.kernels import ops, runtime
    from repro_torch.train import optimizer, train_loop
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    cfg = get_config(RWKV_TRAIN_ARCH)
    entry, seen = ops._WKV6_GRAD.backward, []

    def keep_first(*operands):
        if not seen:
            seen.append([None if t is None else t.detach().clone()
                         for t in operands])
        return entry(*operands)
    n = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    model = build_model(torch, RWKV_TRAIN_ARCH, cfg, cfg, phase="train")
    n_params = sum(p.numel() for p in model.parameters())
    opt_cfg = optimizer.AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                    total_steps=RWKV_TRAIN_STEPS)
    state = optimizer.init(bridge.leaves(model))
    step_fn = train_loop.make_train_step(cfg, opt_cfg, remat=True)
    it = data_tokens.batches(cfg, RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ, seed=0,
                             device=dev)
    losses, walls, counts = [], [], []
    for i in range(RWKV_TRAIN_STEPS):
        batch = next(it)
        ops._WKV6_GRAD.backward = keep_first if i == 0 else entry
        torch.cuda.synchronize()
        runtime.reset_launch_counts()
        t0 = time.perf_counter()
        model, state, metrics = step_fn(model, state, batch)
        loss = float(metrics["loss"])
        walls.append((time.perf_counter() - t0) * 1e3)
        counts.append((runtime.launch_counts["wkv6"],
                       runtime.launch_counts["wkv6_bwd"],
                       sum(runtime.autograd_counts.values())))
        losses.append(loss)
        log("train", f"{RWKV_TRAIN_PATH} step {i}: loss={loss:.4f} "
            f"lr={float(metrics['lr']):.2e} grad_norm="
            f"{float(metrics['grad_norm']):.3f}, {walls[-1]:.1f} ms; "
            f"launches wkv6 {counts[-1][0]}, wkv6_bwd {counts[-1][1]}; "
            f"plain backward passes {counts[-1][2]}")
        if not math.isfinite(loss):
            raise AssertionError(f"{RWKV_TRAIN_PATH}: loss {loss} at step "
                                 f"{i}")
    ops._WKV6_GRAD.backward = entry
    peak = torch.cuda.max_memory_allocated()
    if losses[-1] >= losses[0]:
        raise AssertionError(f"{RWKV_TRAIN_PATH}: loss {losses[0]} -> "
                             f"{losses[-1]} did not fall")
    if any(c != (2 * n, n, 0) for c in counts):
        raise AssertionError(f"{RWKV_TRAIN_PATH}: (wkv6, wkv6_bwd, plain "
                             f"backward) a step {counts}, want "
                             f"{(2 * n, n, 0)}")
    tokens = RWKV_TRAIN_BATCH * (RWKV_TRAIN_SEQ - 1)
    step_ms = sorted(walls[1:])[len(walls[1:]) // 2]
    model, state, split = split_step(torch, step_fn, model, state,
                                     next(it))
    total = sum(split.values())
    batch = next(it)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model, state, _ = step_fn(model, state, batch)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    prof_out = {}
    if kernels:
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3

        def named(part):
            return sum(e.time_range.elapsed_us() for e in kernels
                       if part in e.name) / 1e3
        bwd, fwd = named("wkv6_bwd"), named("wkv6_kernel")
        prof_out = dict(busy_ms=busy, idle_share=1 - busy / step_ms,
                        wkv6_bwd_ms=bwd, wkv6_bwd_share=bwd / busy,
                        wkv6_ms=fwd, wkv6_share=fwd / busy,
                        launches=len(kernels))
        log("train", f"{RWKV_TRAIN_PATH} profiled step: {busy:.1f} ms "
            f"device busy (idle share {1 - busy / step_ms:.3f} of the "
            f"median step), {len(kernels)} kernel launches; wkv6_bwd "
            f"{bwd:.2f} ms ({bwd / busy:.3f} of busy, {bwd / n:.3f} ms a "
            f"layer), wkv6 {fwd:.2f} ms ({fwd / busy:.3f}; forward and "
            f"remat's recompute)")
    else:
        log("train", f"{RWKV_TRAIN_PATH}: the profiler saw no device "
            f"events (device busy, idle share and wkv6_bwd's share not "
            f"measured)")
    del prof, kernels
    model, state, count = rwkv_step_count(torch, cfg, step_fn, model, state,
                                          next(it), smi)
    log("train", f"{RWKV_TRAIN_PATH}: {n_params / 1e9:.3f} B parameters, "
        f"batch {RWKV_TRAIN_BATCH} x {RWKV_TRAIN_SEQ}, remat on; "
        f"{RWKV_TRAIN_STEPS} steps, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (finite at every step); step wall first "
        f"{walls[0]:.1f} ms, median of the rest {step_ms:.1f} ms "
        f"({tokens / step_ms * 1e3:.0f} tok/s); peak max_memory_allocated "
        f"{peak / 1e9:.2f} GB; wkv6 {2 * n} launches a step ({n} forward + "
        f"{n} remat recompute), wkv6_bwd {n}, 0 plain backward passes; a "
        f"step split by CUDA events: forward {split['forward']:.1f} ms "
        f"({split['forward'] / total:.3f}), backward "
        f"{split['backward']:.1f} ms ({split['backward'] / total:.3f}), "
        f"AdamW update {split['update']:.1f} ms "
        f"({split['update'] / total:.3f}); on {smi}")
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=walls, median_step_ms=step_ms,
                tok_s=tokens / step_ms * 1e3, peak_bytes=peak,
                split_ms=split, profile=prof_out, n_params=n_params,
                count=count, rows=wkv6_train_rows(torch, *seen[0]),
                launches={"wkv6": sum(c[0] for c in counts),
                          "wkv6_bwd": sum(c[1] for c in counts)})


def wkv6_train_rows(torch, r, k, v, w, u, s0, dy, dsT):
    """``wkv6_bwd`` and ``wkv6`` on the operands of a real rwkv6-3b
    training step (``train_rwkv``'s first backward call: B 2, T 4095, 40
    heads of 64, bf16 r/k/v, the model's decay, s0 zero, dsT absent since
    training drops sT, and the step's own dy): each against its plain
    version (the backward as ``wkv6_bwd_check``, the forward at
    ``WKV_TOL``), the backward bit-identical over two calls, and both
    timed beside their bounds and plain versions: the training path's
    rows of the kernels line, by kernel name."""
    from repro_torch.kernels import cost, ops, ref
    from repro_torch.kernels import wkv6 as wk
    args = (r, k, v, w, u, s0)
    B, T, H, hs = r.shape
    esz = r.element_size()
    if dsT is not None:
        raise AssertionError(f"{RWKV_TRAIN_PATH}: the backward got a dsT; "
                             f"training drops sT")
    label = f"wkv6_bwd train B={B} T={T}"
    err, rel = wkv6_bwd_check(torch, label, args, dy, None)
    one, two = ops.wkv6_bwd(*args, dy), ops.wkv6_bwd(*args, dy)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(one, two)):
        raise AssertionError(f"{label}: two calls differ")
    del one, two
    b_ms, b_by = bound_ms(cost.wkv6_bwd(B, T, H, hs, esz, state_grad=False),
                          "float32")
    rows = {"wkv6_bwd": dict(
        ms=time_ms(torch, lambda: ops.wkv6_bwd(*args, dy), 10),
        plain_ms=time_ms(torch, lambda: ref.wkv6_bwd_ref(*args, dy), 1, 0),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        plan=wkv6_bwd_plan_info(torch, B, H, hs, T))}
    torch.cuda.empty_cache()
    row = rows["wkv6_bwd"]
    log("train", f"{label} ({H} heads of {hs}, {r.dtype}, the operands of "
        f"a training step's last layer, dsT absent): kernel "
        f"{wkv6_bwd_plan_text(row['plan'])} "
        f"{row['ms']:.4f} ms, plain (ref.wkv6_bwd_ref) "
        f"{row['plain_ms']:.4f} ms (autograd through ref.wkv6_ref: the "
        f"chunk's row), bound {b_ms:.4f} ms ({b_by}), library null (no "
        f"PyTorch call computes this recurrence's gradient); max abs err "
        f"{err:.3g}, {rel:.3g} of a gradient's largest magnitude; two calls "
        f"identical")
    wkv6_bwd_plan_sweep(torch, label, args, dy)
    torch.cuda.empty_cache()
    label = f"wkv6 train B={B} T={T}"
    y, sT = ops.wkv6(*args)
    want_y, want_s = ref.wkv6_ref(*args)
    err = max(assert_close(torch, f"{label} y", y, want_y, WKV_TOL),
              assert_close(torch, f"{label} sT", sT, want_s, WKV_TOL))
    del y, sT, want_y, want_s
    b_ms, b_by = bound_ms(cost.wkv6(B, T, H, hs, esz), "float32")
    rows["wkv6"] = row = dict(
        ms=time_ms(torch, lambda: ops.wkv6(*args), 10),
        plain_ms=time_ms(torch, lambda: ref.wkv6_ref(*args), 1, 0),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        plan=wk.plan(B, H, hs, T))
    log("train", f"{label} (the same operands): kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"library null (no single PyTorch call computes this recurrence), "
        f"max abs err {err:.3g} (atol 1e-4 rtol 1e-3)")
    return rows


def train_phase(torch):
    """Training on the card: the autograd checks, the attention kernel at
    the training shape, the smoke f32 train steps against the CPU, then
    full-width Qwen3-14B with its depth cut (``train_full``) and
    full-width, full-depth rwkv6-3b at its 4096-token training length
    (``train_rwkv``)."""
    t0 = time.perf_counter()
    checks = autograd_checks(torch)
    row = train_attention_row(torch)
    smoke = train_smoke(torch)
    gc.collect()
    torch.cuda.empty_cache()
    run = train_full(torch)
    gc.collect()
    torch.cuda.empty_cache()
    rwkv = train_rwkv(torch)
    gc.collect()
    torch.cuda.empty_cache()
    log("train", f"done in {time.perf_counter() - t0:.1f} s")
    return dict(checks=checks, row=row, smoke=smoke, run=run, rwkv=rwkv)


# ------------------------------------------------------- distribution ---
DIST_ATTN = dict(B=8, H=40, Hkv=8, Dh=128, S=4096)  # Qwen3-14B decode rows
DIST_POS = {       # (positions, ring): rows of one shard and rows across
    "ctx 2048": ([2047] * 8, False),
    "mixed": ([0, 100, 511, 512, 1500, 2047, 3000, 4095], False),
    "ring": ([5000, 100, 4096, 8191, 0, 4095, 9000, 2047], True),
}
DIST_SHARDS = (2, 4, 8)
DIST_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
            "bfloat16": TOL["bfloat16"]}
LSE_TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
           "bfloat16": TOL["bfloat16"]}
DIST_PROMPTS = [256, 2048, 512, 1024, 100, 1800, 700, 1300]
DIST_STEPS = 8
DIST_SMOKE_EPS = 1e-3      # AdamW eps of the smoke EP step (train_smoke)


def lse_kernel_case(torch, q, kv, pos, ring, label, int8):
    """One contiguous decode kernel with ``lse_out`` against its plain
    version (output and log-sum-exp), its output bit for bit against the
    call without ``lse_out``, and the cache cut into m slot ranges, each
    through the kernel at its local positions, combined over the shard
    axis (``attention.combine_decode_partials``) against the unsharded
    kernel and the plain version.  Returns the largest errors."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention
    dt = str(q.dtype).split(".")[-1]
    fn = ops.flash_decode_int8 if int8 else ops.flash_decode
    plain = ref.flash_decode_int8_ref if int8 else ref.flash_decode_ref
    B, H, _ = q.shape
    S = kv[0].shape[1]
    lse = torch.empty((B, H), device=q.device)
    out = fn(q, *kv, pos, ring=ring, lse_out=lse)
    if not torch.equal(out, fn(q, *kv, pos, ring=ring)):
        raise AssertionError(f"{label}: output bits differ with lse_out")
    want_lse = torch.empty_like(lse)
    want = plain(q, *kv, pos, ring=ring, lse_out=want_lse)
    err = assert_close(torch, f"{label} out", out, want, DIST_TOL[dt])
    lse_err = assert_close(torch, f"{label} lse", lse, want_lse,
                           LSE_TOL[dt])
    comb_err = 0.0
    for m in DIST_SHARDS:
        Sl = S // m
        outs, lses = [], []
        for r in range(m):
            part = tuple(t[:, r * Sl:(r + 1) * Sl].contiguous() for t in kv)
            lr = torch.empty((B, H), device=q.device)
            outs.append(fn(q, *part, attention.seq_local_pos(
                pos, r * Sl, S, ring), ring=ring, lse_out=lr))
            lses.append(lr)
        comb = attention.combine_decode_partials(
            torch.stack(outs), torch.stack(lses), lambda t: t.amax(0),
            lambda t: t.sum(0)).to(q.dtype)
        comb_err = max(comb_err, assert_close(
            torch, f"{label} {m} shards vs kernel", comb, out, DIST_TOL[dt]),
            assert_close(torch, f"{label} {m} shards vs plain", comb, want,
                         DIST_TOL[dt]))
    return err, lse_err, comb_err


def lse_library(torch, q, kv, pos, want):
    """The library's attention that returns a log-sum-exp and reads each
    K/V slot once (GQA without copying the cache to every query head),
    timed on the kernel's inputs: the flash-attention forward over the
    cache as B sequences of S slots, each row's live length in
    ``seqused_k``.  Its output is held against the kernel's first;
    returns (ms or None, note)."""
    B, H, Dh = q.shape
    S, Hkv = kv[0].shape[1], kv[0].shape[2]
    n = torch.clamp(pos.long() + 1, max=S).to(torch.int32)   # no ring
    cu_q = torch.arange(B + 1, dtype=torch.int32, device=q.device)
    kf, vf = (t.reshape(B * S, Hkv, Dh) for t in kv)
    label = "flash-attention forward, varlen, seqused_k, softmax_lse"

    def call():
        return torch.ops.aten._flash_attention_forward(
            q, kf, vf, cu_q, cu_q * S, 1, S, 0.0, False, False,
            seqused_k=n)[0]
    try:
        err = float((call().float() - want).abs().max())
    except (RuntimeError, TypeError) as e:   # no such kernel here
        return None, f" ({label} refused: {str(e)[:120]})"
    if err > 2e-2:
        return None, f" ({label} disagrees with the kernel by {err:.3g})"
    return time_ms(torch, call, 50), f" ({label})"


def lse_timing(torch, q, kv, pos, int8):
    """The kernel at the main shape timed without and with ``lse_out``
    (in turns: without, with, with, without), its plain version with the
    log-sum-exp, the bound of the work (K/V or codes and scales of the
    live context read once, q read, the output and the log-sum-exp
    written) and the library's attention with its log-sum-exp on the
    same cache (``lse_library``)."""
    from repro_torch.kernels import cost, ops, ref
    fn = ops.flash_decode_int8 if int8 else ops.flash_decode
    plain = ref.flash_decode_int8_ref if int8 else ref.flash_decode_ref
    B, H, Dh = q.shape
    Hkv = kv[0].shape[2]
    lse = torch.empty((B, H), device=q.device)
    times = {"without": [], "with": []}
    for mode in ("without", "with", "with", "without"):
        extra = dict(lse_out=lse) if mode == "with" else {}
        times[mode].append(time_ms(torch, lambda: fn(q, *kv, pos,
                                                     **extra), 50))
    ctx = int(pos.max()) + 1
    work = cost.decode(B, H, Hkv, Dh, q.element_size(), ctx, int8=int8,
                       lse=True)
    nbytes = work.bytes
    b_ms, b_by = bound_ms(work, str(q.dtype).split(".")[-1])
    plain_ms = time_ms(torch, lambda: plain(q, *kv, pos, lse_out=lse), 10)
    library_ms, why = None, ""
    if not int8:
        library_ms, why = lse_library(torch, q, kv, pos,
                                      fn(q, *kv, pos).float())
    return dict(ms=min(times["with"]), ms_without=min(times["without"]),
                times=times, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, library_note=why, bytes=nbytes)


def dist_kernels(torch):
    """``lse_out`` of both contiguous decode kernels at Qwen3-14B's decode
    shape (B = 8 over 4096 slots, H 40, Hkv 8, Dh 128) in bf16 and f32,
    float and int8 caches, at context 2048, at rows of every length
    (three of them inside the first 512-slot shard) and on wrapped rings;
    the m-shard combine for m in 2, 4, 8; then the bf16 kernels timed
    without and with it."""
    from repro_torch.kernels import runtime
    dev = torch.device("cuda")
    B, H, Hkv, Dh, S = (DIST_ATTN[k] for k in ("B", "H", "Hkv", "Dh", "S"))
    gen = torch.Generator(device=dev).manual_seed(21)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[-1]
        q = torch.randn((B, H, Dh), generator=gen, device=dev).to(dtype)
        kc, vc = (torch.randn((B, S, Hkv, Dh), generator=gen,
                              device=dev).to(dtype) for _ in range(2))
        codes = [torch.randint(-127, 128, (B, S, Hkv, Dh), generator=gen,
                               device=dev, dtype=torch.int8)
                 for _ in range(2)]
        scales = [torch.rand((B, S, Hkv), generator=gen, device=dev) * 0.05
                  + 1e-3 for _ in range(2)]
        caches = {"flash_decode": (kc, vc),
                  "flash_decode_int8": (codes[0], codes[1], scales[0],
                                        scales[1])}
        for name, kv in caches.items():
            errs = [0.0, 0.0, 0.0]
            for case, (plist, ring) in DIST_POS.items():
                pos = torch.tensor(plist, dtype=torch.int32, device=dev)
                got = lse_kernel_case(torch, q, kv, pos, ring,
                                      f"{name} {dt} {case}",
                                      name.endswith("int8"))
                errs = [max(a, b) for a, b in zip(errs, got)]
            row = dict(max_abs_err=errs[0], lse_err=errs[1],
                       combine_err=errs[2])
            if dtype == torch.bfloat16:
                pos = torch.tensor(DIST_POS["ctx 2048"][0], dtype=torch.int32,
                                   device=dev)
                row.update(lse_timing(torch, q, kv, pos,
                                      name.endswith("int8")),
                           plan=runtime.decode_plans[name])
                log("dist", f"{name} bf16 B=8 ctx=2048 over {S} slots: "
                    f"{row['ms_without']:.4f} ms without lse_out, "
                    f"{row['ms']:.4f} ms with it (turns "
                    f"{row['times']}), bound {row['bound_ms']:.4f} ms "
                    f"({row['bound_by']}), plain {row['plain_ms']:.4f} "
                    f"ms, library {row['library_ms']}{row['library_note']}")
            rows[f"{name} {dt}"] = row
            log("dist", f"{name} {dt} lse_out over {list(DIST_POS)}: out "
                f"max abs err {errs[0]:.3g} (bits equal without lse_out), "
                f"lse {errs[1]:.3g}, {DIST_SHARDS}-shard combine "
                f"{errs[2]:.3g} against the unsharded kernel and the plain "
                f"version")
        del q, kc, vc, codes, scales, caches
    torch.cuda.empty_cache()
    return rows


def moe_ep_full(torch, mesh):
    """One qwen3-moe-235b-a22b layer at full width (bf16, 128 experts,
    top-8) through ``moe_ep`` over the one-rank NCCL group (its experts
    cut as ``shard_model`` cuts them: over ``data``, d_ff over ``model``,
    so the all-to-all and the f32 all-reduce run) against ``moe_local``
    at 8 and 512 tokens, both timed; and the dropless route (``moe_ep``'s
    dispatch at capacity N k, which ``moe.apply`` runs for
    ``moe_impl="local"`` on experts cut over data) against
    ``moe_local`` on the same inputs, timed.  On one rank the dispatch
    sends N k rows for N k pairs; over dp data ranks it sends dp N k
    rows, of which the grouped product computes the real ones only."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.sharding import partition
    dev = torch.device("cuda")
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(3)
    p = moe.Moe(cfg, torch.bfloat16, dev)
    with torch.no_grad():
        p.init_(gen)
    for name in ("w_gate", "w_up", "w_down", "router"):
        leaf = f"groups/0/0/moe/{name}"
        p[name].spec = partition.port_spec(leaf, partition.param_rule(
            name, (1,) + tuple(p[name].shape), mesh))
    res = {}
    for label, (B, T) in MOE_FFN_SHAPES.items():
        x = torch.randn((B, T, cfg.d_model), generator=gen, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
        got = moe.moe_ep(cfg, p, x, mesh)
        err = assert_close(torch, f"moe_ep {label}", got,
                           moe.moe_local(cfg, p, x), TOL["bfloat16"])
        cap = B * T * cfg.top_k                 # N k: no pair dropped
        dl_err = assert_close(torch, f"moe_ep dropless {label}",
                              moe.moe_ep(cfg, p, x, mesh, capacity=cap),
                              moe.moe_local(cfg, p, x), TOL["bfloat16"])
        ep_ms = time_ms(torch, lambda: moe.moe_ep(cfg, p, x, mesh), 10)
        local_ms = time_ms(torch, lambda: moe.moe_local(cfg, p, x), 10)
        dl_ms = time_ms(torch, lambda: moe.moe_ep(cfg, p, x, mesh,
                                                  capacity=cap), 10)
        res[label] = dict(ep_ms=ep_ms, local_ms=local_ms, max_abs_err=err,
                          dropless_ms=dl_ms, dropless_max_abs_err=dl_err,
                          dropless_rows_sent=cap, pairs=cap)
        log("dist", f"[{nvidia_smi_line()}] {MOE_ARCH} layer {label}: "
            f"moe_ep over the one-rank NCCL group (all-to-all, f32 "
            f"all-reduce) {ep_ms:.4f} ms, the dropless route (capacity "
            f"{cap}: {cap} rows sent for {cap} pairs) {dl_ms:.4f} ms, "
            f"moe_local {local_ms:.4f} ms; against moe_local max abs err "
            f"{err:.3g} (capacity factor {cfg.capacity_factor}), "
            f"{dl_err:.3g} (dropless)")
    del p
    torch.cuda.empty_cache()
    return res


def dist_smoke(torch, mesh):
    """Smoke f32 through the one-rank group on the card against the CPU
    without a mesh: yi-6b's forward; qwen3-moe's forward and one train
    step, EP on the card (capacity 4: nothing dropped) against the local
    path on the CPU (loss, grad norm, every parameter; AdamW eps 1e-3 as
    in ``train_smoke``)."""
    from repro_torch import bridge
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import tokens as data_tokens
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import partition
    from repro_torch.train import optimizer, train_loop
    cfg = get_smoke_config("yi-6b")
    cpu = tfm.init_params(cfg, seed=0, device="cpu")
    gpu = partition.shard_model(cfg, copy.deepcopy(cpu).to("cuda"), mesh)
    tok = torch.randint(0, cfg.vocab_size, (4, 48),
                        generator=torch.Generator().manual_seed(5))
    fwd_err = assert_close(torch, "yi-6b smoke forward under the mesh",
                           tfm.forward(cfg, gpu, tok.cuda(),
                                       mesh=mesh).cpu(),
                           tfm.forward(cfg, cpu, tok), SMOKE_LOGIT_TOL)
    cfg = get_smoke_config(MOE_ARCH, capacity_factor=4.0)
    opt_cfg = optimizer.AdamWConfig(lr=1e-3, eps=DIST_SMOKE_EPS,
                                    warmup_steps=1, total_steps=10)
    cpu = tfm.init_params(cfg, seed=0, device="cpu")
    gpu = partition.shard_model(cfg, copy.deepcopy(cpu).to("cuda"), mesh)
    moe_err = assert_close(torch, "qwen3-moe smoke EP forward under the "
                           "mesh", tfm.forward(cfg, gpu, tok.cuda(),
                                               moe_impl="ep",
                                               mesh=mesh).cpu(),
                           tfm.forward(cfg, cpu, tok), SMOKE_LOGIT_TOL)
    batch = next(data_tokens.batches(cfg, 2, 33, seed=3, device="cpu"))
    _, _, mc = train_loop.make_train_step(cfg, opt_cfg)(
        cpu, optimizer.init(bridge.leaves(cpu)), batch)
    _, _, mg = train_loop.make_train_step(cfg, opt_cfg, moe_impl="ep",
                                          mesh=mesh)(
        gpu, optimizer.init(bridge.leaves(gpu)),
        {k: t.cuda() for k, t in batch.items()})
    mc = {k: float(v) for k, v in mc.items()}
    mg = {k: float(v) for k, v in mg.items()}
    if not math.isclose(mg["loss"], mc["loss"], rel_tol=1e-5) or \
            not math.isclose(mg["grad_norm"], mc["grad_norm"], rel_tol=1e-4):
        raise AssertionError(f"EP smoke train step: card {mg}, CPU {mc}")
    worst = 0.0
    for (name, a), b in zip(cpu.named_parameters(), gpu.parameters()):
        worst = max(worst, assert_close(
            torch, f"EP step updated {name}", b.detach().cpu(), a.detach(),
            dict(atol=1e-5, rtol=0)))
    log("dist", f"smoke f32 under the one-rank mesh: yi-6b forward, card "
        f"against CPU max abs err {fwd_err:.3g}; qwen3-moe EP forward "
        f"against the CPU's local {moe_err:.3g}; qwen3-moe EP train step "
        f"loss {mg['loss']:.6f} (CPU local {mc['loss']:.6f}), grad_norm "
        f"{mg['grad_norm']:.6f} ({mc['grad_norm']:.6f}), params max abs "
        f"{worst:.3g}")
    return dict(forward_err=fwd_err, moe_forward_err=moe_err,
                loss=mg["loss"], cpu_loss=mc["loss"], params_err=worst)


def dist_generate(torch, cfg, model, toks, lens, mesh=None, seq=False,
                  label=""):
    """Prefill and ``DIST_STEPS`` greedy steps; the ids (B, 1 + steps),
    the launches of the run and the mean eager step wall; with a
    ``label``, then four more steps profiled (``profile_steps``, the
    NCCL kernels reported on their own)."""
    from repro_torch.kernels import runtime
    from repro_torch.models import transformer as tfm
    runtime.reset_launch_counts()
    cache = None
    if mesh is not None:
        cache = tfm.init_cache(cfg, toks.shape[0], cfg.max_seq_len,
                               model.dtype, "cuda", mesh)
        cache["seq_sharded"] = seq     # one shard: every slot on this rank
    logits, cache = tfm.prefill(cfg, model, toks, lens, cfg.max_seq_len,
                                cache=cache, mesh=mesh)
    ids = [logits.argmax(-1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DIST_STEPS):
        logits, cache = tfm.decode_step(cfg, model, ids[-1].to(torch.int32),
                                        cache, mesh=mesh)
        ids.append(logits.argmax(-1))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / DIST_STEPS
    counts = dict(runtime.launch_counts, **{
        f"{k} (lse_out)": v for k, v in runtime.lse_counts.items()})
    prof = None
    if label:
        tok = ids[-1].to(torch.int32)
        prof = profile_steps(torch, f"Qwen3-14B {label} decode step",
                             lambda: tfm.decode_step(cfg, model, tok, cache,
                                                     mesh=mesh),
                             "NCCL kernels", "nccl")
    del cache
    torch.cuda.empty_cache()
    return torch.stack(ids, 1).cpu(), counts, step_ms, prof


def dist_mesh_path(torch, cfg, model, mesh):
    """Qwen3-14B at full width (the serve phases' model) through the mesh
    (1, 1) code path: 8 prompts of 100-2048 tokens, prefill and 8 greedy
    steps with no mesh, then under the mesh (the vocab-sharded embedding
    and head, the column / row-parallel projections, every all-reduce and
    all-gather over the one-rank NCCL groups), then under the mesh with
    the cache marked cut along the sequence into one shard (each decode
    through ``distributed_decode_attention``: the kernel with
    ``lse_out`` and the NCCL max and sum combine); the same with an int8
    cache.  The ids of each run equal the no-mesh run's; each run
    launches one ``flash_prefill`` a layer and one decode kernel a layer
    a step, the sequence-cut runs each with its ``lse_out``."""
    import dataclasses
    from repro_torch.sharding import partition
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    B, T = len(DIST_PROMPTS), max(DIST_PROMPTS)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                         device=dev, dtype=torch.int32)
    lens = torch.tensor(DIST_PROMPTS, dtype=torch.int32, device=dev)
    L = cfg.n_layers
    res, launches = {}, {}
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    want = {"bf16": dist_generate(torch, cfg, model, toks, lens,
                                  label="bf16 no mesh"),
            "int8": dist_generate(torch, cfg8, model, toks, lens)}
    partition.shard_model(cfg, model, mesh)
    runs = (("bf16 mesh", cfg, False), ("bf16 mesh, sequence-cut", cfg, True),
            ("int8 mesh, sequence-cut", cfg8, True))
    for label, c, seq in runs:
        ids, counts, step_ms, prof = dist_generate(torch, c, model, toks,
                                                   lens, mesh, seq, label)
        kind = label.split()[0]
        kernel = "flash_decode_int8" if kind == "int8" else "flash_decode"
        if not torch.equal(ids, want[kind][0]):
            raise AssertionError(f"Qwen3-14B {label}: ids {ids.tolist()} "
                                 f"!= no mesh {want[kind][0].tolist()}")
        lse = counts[f"{kernel} (lse_out)"]
        if counts["flash_prefill"] != L or \
                counts[kernel] != L * DIST_STEPS or \
                lse != (L * DIST_STEPS if seq else 0):
            raise AssertionError(f"Qwen3-14B {label}: launches {counts}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        res[label] = dict(step_ms=step_ms, no_mesh_step_ms=want[kind][2],
                          launches=counts, profile=prof)
        log("dist", f"Qwen3-14B full width {label}: ids of 8 prompts x "
            f"(prefill + {DIST_STEPS} steps) equal the no-mesh run's; "
            f"eager step {step_ms:.1f} ms (no mesh {want[kind][2]:.1f} ms); "
            f"launches flash_prefill {counts['flash_prefill']}, {kernel} "
            f"{counts[kernel]}, with lse_out {lse}")
    res["bf16 no mesh"] = dict(step_ms=want["bf16"][2],
                               profile=want["bf16"][3])
    return res, launches


MESH_ENGINE_SLOTS = {"paged": 8, "contiguous": 8}


def mesh_engine_smoke(torch, mesh):
    """Smoke f32 qwen3-14b through the engine under the one-rank NCCL mesh
    on the card against the engine without a mesh on the CPU, on both
    pools, chunk 32, 4 slots, the graph smoke's 8 requests: ids equal,
    and every command's device half counted on the driver."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import partition
    cfg = get_smoke_config("qwen3-14b", max_seq_len=128)
    cpu = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gpu = partition.shard_model(cfg, copy.deepcopy(cpu).to("cuda"), mesh)
    out = {}
    for paged in (True, False):
        ids = {}
        for label, model, dev, m in (("cpu", cpu, "cpu", None),
                                     ("mesh", gpu, "cuda", mesh)):
            eng = make_engine(torch, cfg, model, 0, paged, 4, dev=dev,
                              chunk=32, hbm_bytes=2 ** 30, page=16,
                              decode_graph=False, mesh=m)
            reqs = requests(GRAPH_SMOKE_LENGTHS, 8)
            eng.submit(reqs)
            if len(eng.run(max_wall_s=600)) != len(reqs):
                raise AssertionError(f"mesh engine smoke {label}: not all "
                                     f"served")
            ids[label] = finished_ids(eng, reqs)
            if m is not None:
                sent = dict(eng.backend.channel.sent)
        pool = "paged" if paged else "contiguous"
        if ids["mesh"] != ids["cpu"]:
            raise AssertionError(f"mesh engine smoke {pool}: card under the "
                                 f"mesh {ids['mesh']} != CPU {ids['cpu']}")
        out[pool] = sent
    log("dist", f"smoke f32 qwen3-14b through the engine under the one-rank "
        f"NCCL mesh on the card == the engine without a mesh on the CPU, "
        f"{len(GRAPH_SMOKE_LENGTHS)} requests on each pool: ids equal; "
        f"commands {out}")
    return out


def mesh_retention_smoke(torch, mesh):
    """Smoke f32 qwen3-14b through the engine under the one-rank NCCL mesh
    on the card, with the prefix cache, with sessions and with the spill
    tier, against the engine without a mesh on the CPU with the same
    retention: the retention smoke's two workloads, then its sessions
    with TTL 0 over a host tier of 64 pages, so every finished turn's
    tail is spilled and restored.  Ids equal; hits, spills and restores
    where the run has them; every page and host slot back after
    ``clear``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import partition
    cfg = get_smoke_config("qwen3-14b", max_seq_len=1024)
    cpu = tfm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gpu = partition.shard_model(cfg, copy.deepcopy(cpu).to("cuda"), mesh)
    runs = smoke_retention_workloads(cfg)
    sessions = runs[1][1]
    runs.append(("spill", sessions, dict(pool_tokens=64 * 128),
                 dict(session_ttl=0.0, host_pool_tokens=64 * 128)))
    out = {}
    for name, make, pool, ret in runs:
        ids = {}
        for label, model, dev, m in (("cpu", cpu, "cpu", None),
                                     ("mesh", gpu, "cuda", mesh)):
            reqs = make()
            eng = make_engine(torch, cfg, model, 0, True, 4, dev=dev,
                              hbm_bytes=2 ** 30, decode_graph=False, mesh=m,
                              **pool, **ret)
            eng.submit(reqs)
            if len(eng.run(max_wall_s=600)) != len(reqs):
                raise AssertionError(f"mesh retention smoke {name} {label}: "
                                     f"not all served")
            res, a = eng.result, eng.backend.alloc
            hits = res.prefix_hits if name == "prefix" else res.session_hits
            spilled = (res.spilled_pages, res.restored_pages)
            if hits <= 0 or (name == "spill" and min(spilled) <= 0):
                raise AssertionError(f"mesh retention smoke {name} {label}: "
                                     f"hits {hits}, spilled and restored "
                                     f"{spilled}")
            eng.backend.retention.clear(a)
            if a.free_pages() != a.n_pages or \
                    a.free_host_slots() != a.host_pages:
                raise AssertionError(f"mesh retention smoke {name} {label}: "
                                     f"pages or host slots left after clear")
            ids[label] = finished_ids(eng, reqs)
        if ids["mesh"] != ids["cpu"]:
            raise AssertionError(f"mesh retention smoke {name}: card under "
                                 f"the mesh {ids['mesh']} != CPU "
                                 f"{ids['cpu']}")
        out[name] = dict(requests=len(ids["cpu"]), hits=hits,
                         spilled_restored=spilled)
    log("dist", f"smoke f32 qwen3-14b through the engine under the one-rank "
        f"NCCL mesh on the card with the prefix cache, sessions and the "
        f"spill tier == the engine without a mesh on the CPU: ids equal, "
        f"every page and host slot back after clear; {out}")
    return out


# the mesh session and spill runs: Qwen3-14B at full width with its depth
# cut from 40 layers to 10, to keep the script short (the eager step under
# the mesh is host-bound; chip_mesh_retention.py runs all 40 layers)
RET_MESH_LAYERS = 10


def depth_view(torch, cfg, model, n):
    """The first ``n`` layers of a one-group ``model`` as a model of its
    own over the same weights (embedding, head and the first ``n``
    blocks; nothing copied), with ``cfg`` cut to ``n`` layers."""
    import dataclasses
    view = copy.copy(model)
    view._parameters = dict(model._parameters)
    view._buffers = dict(model._buffers)
    view._modules = dict(model._modules)
    view.groups = torch.nn.ModuleList(
        torch.nn.ModuleList(torch.nn.ModuleList(list(slot)[:n])
                            for slot in group) for group in model.groups)
    view.cfg = dataclasses.replace(cfg, n_layers=n)
    return view.cfg, view


def mesh_session_requests(cfg):
    """The retention phase's 4 sessions x 3 turns with every first turn
    at t = 0: a turn then arrives when the one before it ends, so the
    batches follow the run's events and not the wall clock, and a run
    with a mesh forms the batches of a run without."""
    reqs = session_requests(cfg)
    for r in reqs:
        if r.turn == 0:
            r.arrival = 0.0
    return reqs


def mesh_retention_runs(torch, cfg, model, wbytes, pool_tokens, mesh=None):
    """Full-width Qwen3-14B, bf16, eager: the retention phase's sessions
    (4 x 3 turns, session TTL 1000 s, on ``pool_tokens``) and its spill
    run (the same workload over a 48-page pool with a 128-page host
    tier), every first turn at t = 0 (``mesh_session_requests``),
    through ``ServingEngine(mesh=mesh)`` or without a mesh; each run's
    ids, formed batches, steps, stats, launches and later-turn TTFT p50,
    with the gates: session hits, pages spilled and restored in the
    spill run, one ``flash_prefill`` a layer a chunk and one paged
    decode kernel a layer a step, every page (and host slot) back after
    ``clear``."""
    label = "mesh engine (1, 1)" if mesh is not None else "no mesh"
    L = cfg.n_layers
    label += f", {L} layers"
    out = {}
    for name, pool, kw in (
            ("sessions", pool_tokens, dict(session_ttl=1000.0)),
            ("spill", (RET_SPILL_PAGES + 1) * 128,
             dict(session_ttl=1000.0,
                  host_pool_tokens=RET_HOST_PAGES * 128))):
        eng = make_engine(torch, cfg, model, wbytes, True, 8, pool,
                          dev=model.device, decode_graph=False, mesh=mesh,
                          **kw)
        formed = record_formed(eng.sched).formed
        reqs = mesh_session_requests(cfg)
        counts, stats, steps = serve_run(
            torch, cfg, eng, reqs, f"Qwen3-14B {label}, {name} "
            f"({RET_SESSIONS} x {RET_TURNS} turns)")
        res, a = eng.result, eng.backend.alloc
        if res.session_hits <= 0 or (name == "spill" and not (
                res.spilled_pages > 0 and res.restored_pages > 0)):
            raise AssertionError(f"Qwen3-14B {label} {name}: session hits "
                                 f"{res.session_hits}, spilled "
                                 f"{res.spilled_pages}, restored "
                                 f"{res.restored_pages}")
        if counts["flash_prefill"] != L * steps["prefill"] or \
                counts["paged_flash_decode"] != L * steps["decode"] or \
                counts["flash_decode"]:
            raise AssertionError(f"Qwen3-14B {label} {name}: launches "
                                 f"{counts} for {steps}")
        if a.free_pages() + a.live_pages() != a.n_pages:
            raise AssertionError(f"Qwen3-14B {label} {name}: free + live "
                                 f"!= total pages")
        eng.backend.retention.clear(a)
        if a.free_pages() != a.n_pages or \
                a.free_host_slots() != a.host_pages:
            raise AssertionError(f"Qwen3-14B {label} {name}: pages or host "
                                 f"slots left after clear")
        run = dict(ids=finished_ids(eng, reqs), formed=formed, steps=steps,
                   stats=stats, launches={k: counts[k] for k in (
                       "flash_prefill", "paged_flash_decode")},
                   ttft_later={t: p50([r.ttft() for r in later(reqs, t)])
                               for t in (1, 2)},
                   turns=turn_records(reqs),
                   hits=(res.session_hits, res.session_lookups),
                   spilled=(res.spilled_pages, res.restored_pages),
                   holds=res.spill_hold_events,
                   preemptions=res.preempt_events, layers=L)
        if mesh is not None:
            run["commands"] = dict(eng.backend.channel.sent)
        out[name] = run
        del eng, a
        gc.collect()
        torch.cuda.empty_cache()
    return out


def turn_records(reqs):
    """Each later turn's (session, turn, TTFT s, the TTFT's phases from
    its latency ledger that took over 1 ms, the ledger's phase
    transitions): where a long TTFT waited."""
    return [(r.session_id, r.turn, round(r.ttft(), 4),
             {k: round(v, 4) for k, v in (r.ledger.ttft_phases or {}).items()
              if v > 1e-3}, "/".join(r.ledger.seq))
            for r in later(reqs, 1)]


def mesh_retention_compare(want, got):
    """The mesh runs' ids equal the no-mesh runs', and so do the session
    runs' formed batches (the spill run's 48-page pool is under page
    pressure: its restore holds and restart penalties end on the wall
    clock, so its batches may differ); the later-turn TTFT p50 both
    ways."""
    smi = nvidia_smi_line()
    for name in ("sessions", "spill"):
        a, b = want[name], got[name]
        for what in ("formed", "ids") if name == "sessions" else ("ids",):
            if a[what] != b[what]:
                raise AssertionError(f"Qwen3-14B {name} under the mesh: "
                                     f"{what} differ from the no-mesh run: "
                                     f"{b[what]} != {a[what]}")
        log("dist", f"[{smi}] Qwen3-14B full width, engine, paged pool, "
            f"{name}, {b['layers']} of 40 layers, {RET_SESSIONS} x "
            f"{RET_TURNS} turns, eager both: ids "
            f"equal, formed batches "
            f"{'equal' if a['formed'] == b['formed'] else 'not equal'} "
            f"({len(b['formed'])} batches); session hits {b['hits']}, pages "
            f"spilled / restored {b['spilled']}, restore holds "
            f"{b['holds']} ({a['holds']} without), preemptions "
            f"{b['preemptions']} ({a['preemptions']} without); TTFT p50 "
            f"turns >= 1 "
            f"{b['ttft_later'][1]:.4f} s under the (1, 1) mesh, "
            f"{a['ttft_later'][1]:.4f} s without; turns >= 2 "
            f"{b['ttft_later'][2]:.4f} s, {a['ttft_later'][2]:.4f} s; TPOT "
            f"p50 {b['stats']['tpot_p50'] * 1e3:.2f} ms, "
            f"{a['stats']['tpot_p50'] * 1e3:.2f} ms; {b['steps']['prefill']} "
            f"chunks, {b['steps']['decode']} decode steps; launches "
            f"{b['launches']}; commands {b['commands']}")
        for who, run in (("no mesh", a), ("(1, 1) mesh", b)):
            log("dist", f"Qwen3-14B {name}, {run['layers']} layers, {who}: "
                f"later turns (session, turn, TTFT s, TTFT phases, "
                f"ledger) {run['turns']}")


def mesh_engine_runs(torch, cfg, model, wbytes, mesh=None, pool_tokens=None):
    """The serve phase's 12 requests at t = 0 (32 new tokens) on the
    paged pool (8 slots, ``pool_tokens``) and the contiguous pool (8
    slots), eagerly, through ``ServingEngine(mesh=mesh)`` or without a
    mesh; each run's ids, launches, steps and stats, the decode command's
    host time under the mesh, every page back on the paged pool, and
    the gates: one ``flash_prefill`` a layer a chunk, one decode kernel a
    layer a step.  Under the mesh the paged engine's decode step is
    then profiled (the NCCL kernels' share)."""
    label = "mesh engine (1, 1)" if mesh is not None else "no mesh"
    L = cfg.n_layers
    res = {}
    for pool in ("paged", "contiguous"):
        paged = pool == "paged"
        eng = make_engine(torch, cfg, model, wbytes, paged,
                          MESH_ENGINE_SLOTS[pool],
                          pool_tokens if paged else None,
                          decode_graph=False, mesh=mesh)
        reqs = requests(SERVE_LENGTHS, 32)
        counts, stats, steps = serve_run(torch, cfg, eng, reqs,
                                         f"Qwen3-14B {label}, {pool}")
        be = eng.backend
        kernel = "paged_flash_decode" if paged else "flash_decode"
        other = "flash_decode" if paged else "paged_flash_decode"
        if counts["flash_prefill"] != L * steps["prefill"] or \
                counts[kernel] != L * steps["decode"] or counts[other]:
            raise AssertionError(f"Qwen3-14B {label} {pool}: launches "
                                 f"{counts} for {steps}")
        if paged and be.free_blocks() != be.alloc.n_pages:
            raise AssertionError(f"Qwen3-14B {label} paged: pages leaked")
        run = dict(ids=finished_ids(eng, reqs), stats=stats, steps=steps,
                   launches={k: counts[k] for k in ATTENTION_KERNELS})
        if mesh is not None:
            ch = be.channel
            run.update(command_ms=ch.host_ms("decode"),
                       commands=dict(ch.sent),
                       command_s={k: v for k, v in ch.seconds.items()})
            if paged:
                run["profile"] = profile_steps(
                    torch, "Qwen3-14B engine decode step under the (1, 1) "
                    "mesh, 8 slots", be._step, "NCCL kernels", "nccl")
        res[pool] = run
        del eng, be
        gc.collect()
        torch.cuda.empty_cache()
    return res


def mesh_engine_compare(want, got):
    """Ids of the mesh runs equal the no-mesh runs'; the TTFT / TPOT
    lines both ways."""
    smi = nvidia_smi_line()
    for pool in ("paged", "contiguous"):
        a, b = want[pool], got[pool]
        if a["ids"] != b["ids"]:
            bad = [rid for rid in a["ids"] if a["ids"][rid] != b["ids"][rid]]
            raise AssertionError(f"Qwen3-14B engine under the mesh, {pool}: "
                                 f"ids differ from the no-mesh run for rids "
                                 f"{bad}")
        if a["steps"] != b["steps"]:
            raise AssertionError(f"Qwen3-14B {pool}: steps {b['steps']} "
                                 f"under the mesh, {a['steps']} without")
        log("dist", f"[{smi}] Qwen3-14B full width, engine, {pool} pool, "
            f"12 requests at t = 0, eager both: ids equal; TPOT p50 "
            f"{b['stats']['tpot_p50'] * 1e3:.2f} ms under the (1, 1) mesh, "
            f"{a['stats']['tpot_p50'] * 1e3:.2f} ms without; TTFT p50 "
            f"{b['stats']['ttft_p50']:.4f} s, {a['stats']['ttft_p50']:.4f} "
            f"s; {b['steps']['prefill']} chunks, {b['steps']['decode']} "
            f"decode steps; launches {b['launches']}; the decode command's "
            f"host time {b['command_ms']:.4f} ms a step (gloo broadcast), "
            f"commands {b['commands']}")


def dist_phase(torch, cfg, model, wbytes, pool_tokens):
    """The distribution phase: a one-rank NCCL process group and the
    (1, 1) host mesh over it; the decode kernels' ``lse_out`` and the
    m-shard combine; ``moe_ep`` at full width; smoke f32 card against
    CPU, the model and the engine; then the main path, Qwen3-14B at full
    width through the mesh, its prefill and decode steps and then the
    engine under the mesh (rank 0 driving, on both pools) against the
    engine without a mesh, whose runs come first (the model is not yet
    cut).  The process group is destroyed at the end."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.sharding import partition
    t0 = time.perf_counter()
    rows = dist_kernels(torch)
    t1 = time.perf_counter()
    engine_want = mesh_engine_runs(torch, cfg, model, wbytes,
                                   pool_tokens=pool_tokens)
    vcfg, view = depth_view(torch, cfg, model, RET_MESH_LAYERS)
    vbytes = sum(p.numel() * p.element_size() for p in view.parameters())
    retention_want = mesh_retention_runs(torch, vcfg, view, vbytes,
                                         pool_tokens)
    engine_s = time.perf_counter() - t1
    with tempfile.TemporaryDirectory() as d:
        mesh_mod.init_distributed(1, 1, "cuda", rank=0, world_size=1,
                                  init_method=f"file://{d}/store")
        try:
            mesh = mesh_mod.make_host_mesh(1, 1)
            moe_res = moe_ep_full(torch, mesh)
            gc.collect()
            smoke = dist_smoke(torch, mesh)
            t1 = time.perf_counter()
            smoke["engine_commands"] = mesh_engine_smoke(torch, mesh)
            smoke["engine_retention"] = mesh_retention_smoke(torch, mesh)
            engine_s += time.perf_counter() - t1
            path, launches = dist_mesh_path(torch, cfg, model, mesh)
            t1 = time.perf_counter()
            engine = mesh_engine_runs(torch, cfg, model, wbytes, mesh,
                                      pool_tokens)
            mesh_engine_compare(engine_want, engine)
            partition.shard_model(vcfg, view, mesh)
            retention = mesh_retention_runs(torch, vcfg, view, vbytes,
                                            pool_tokens, mesh)
            mesh_retention_compare(retention_want, retention)
            engine_s += time.perf_counter() - t1
        finally:
            dist.destroy_process_group()
    for pool in engine:
        engine[pool]["no_mesh_stats"] = engine_want[pool]["stats"]
        engine[pool].pop("ids")
    for name in retention:
        retention[name]["no_mesh_ttft_later"] = \
            retention_want[name]["ttft_later"]
        retention[name]["no_mesh_stats"] = retention_want[name]["stats"]
        for k in ("ids", "formed"):
            retention[name].pop(k)
    launches.update({f"engine {k}": v for k, v in {
        "flash_prefill": engine["paged"]["launches"]["flash_prefill"],
        "paged_flash_decode": engine["paged"]["launches"][
            "paged_flash_decode"],
        "flash_decode": engine["contiguous"]["launches"][
            "flash_decode"]}.items()})
    launches.update({f"retention {k}": sum(
        r["launches"][k] for r in retention.values())
        for k in ("flash_prefill", "paged_flash_decode")})
    log("dist", f"phase took {time.perf_counter() - t0:.1f} s (the engine "
        f"runs and the engine smoke {engine_s:.1f} s)")
    return dict(rows=rows, moe_ep=moe_res, smoke=smoke, path=path,
                launches=launches, engine=engine, retention=retention)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import runtime

    smi = nvidia_smi_line()
    log("env", f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"
        f", devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    runtime.library()
    seconds = time.perf_counter() - t0
    log("build", f"nvcc sm_90a, {', '.join(runtime.SOURCES)}: built and "
        f"loaded {runtime.build().relative_to(ROOT)} in {seconds:.1f} s")
    n_hgmma = hgmma_count(runtime.build())
    if n_hgmma == 0:
        raise AssertionError("no HGMMA instruction in the prefill "
                             "tensor-core kernels")
    check_body_rule()
    log("build", f"cuobjdump -sass: {n_hgmma} HGMMA instructions in the "
        f"prefill tensor-core kernels (Dh 64, 80, 128, 192, 256); the "
        f"wrapper's body rule matches rt_flash_prefill_body for f32/bf16 x Dh "
        f"64/80/128/192/256")

    rows = kernel_phase(torch)
    rows.update(int8_kernel_phase(torch))
    prefill_phase_profile(torch)
    rows.update(wkv6_phase(torch))
    rows.update(wkv6_bwd_phase(torch))
    parity_phase(torch)
    rwkv_parity_phase(torch)
    graph_smoke(torch)
    paper_smoke(torch)
    int8_smoke(torch)
    launches, paged_stats, contig_stats, cfg, model, wbytes, pool_tokens = \
        serve_phase(torch)
    profile = {"qwen3-14b": profile_phase(torch, cfg, model),
               "qwen3-14b prefill": prefill_profile_phase(torch, cfg, model,
                                                          wbytes)}
    analysis = analysis_phase(torch, cfg, model)
    retention = retention_phase(torch, cfg, model, wbytes)
    recovery = recovery_phase(torch, cfg, model, wbytes)
    int8 = int8_phase(torch, cfg, model, wbytes, pool_tokens)
    launches.update(int8["serve"]["launches"])
    profile["qwen3-14b int8"] = int8["drift"].pop("profile")
    gc.collect()
    torch.cuda.empty_cache()
    dist = dist_phase(torch, cfg, model, wbytes, pool_tokens)
    del cfg, model
    gc.collect()
    torch.cuda.empty_cache()
    paper = paper_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()
    launches["wkv6"], rwkv_stats, cfg, model, want = rwkv_serve_phase(torch)
    profile["rwkv6-3b"] = rwkv_profile_phase(torch, cfg, model)
    rwkv_mesh = rwkv_mesh_engine(torch, cfg, model, want)
    del cfg, model
    gc.collect()
    torch.cuda.empty_cache()
    rg = rg_phase(torch)
    profile["recurrentgemma-2b"] = rg.pop("profile")
    gc.collect()
    torch.cuda.empty_cache()
    moe = moe_phase(torch)
    profile["qwen3-moe-235b-a22b"] = moe.pop("profile")
    gc.collect()
    torch.cuda.empty_cache()
    vision = vision_phase(torch)
    profile[HUBERT_ARCH] = vision["hubert"].pop("profile")
    vrows, vlm_n = vision["rows"], vision["vlm"]["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    nemo = nemotron_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()
    train = train_phase(torch)
    profile[TRAIN_PATH] = train["run"]["profile"]

    def entry(name, source, replaces, row, path="qwen3-14b", n=None):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": launches[name] if n is None else n,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "path": path}
    def decode_entry(name, source, replaces, row, **kw):
        p = row["plan"]
        return dict(entry(name, source, replaces, row, **kw),
                    body=f"{p.body} (split-KV, n_split {p.n_split}, L {p.L})")
    def wkv6_entry(row, H=WKV_MAIN["H"], B=WKV_MAIN["B"], **kw):
        from repro_torch.kernels import wkv6 as wk
        p = row["plan"]
        hs = WKV_MAIN["hs"]
        kw.setdefault("path", "rwkv6-3b")
        return dict(entry("wkv6", "src/repro_torch/csrc/wkv6.cu",
                          "src/repro/kernels/wkv6.py:58", row, **kw),
                    body=f"cuda_core (state split: {p.kr} rows x {p.vc} "
                         f"columns a thread, {p.cols} columns a block, "
                         f"{p.threads(hs)} threads, "
                         f"{p.blocks(B, H, hs)} blocks; "
                         f"cp.async ring of {wk.STAGES} x {wk.TILE_T} "
                         f"steps)")
    table = {"kernels": [
        dict(entry("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
                   "src/repro/kernels/flash_prefill.py:84",
                   rows["flash_prefill chunk 512@1536/4096"]),
             body="tensor_core (wgmma; bf16, Dh 128)"),
        decode_entry("paged_flash_decode",
                     "src/repro_torch/csrc/paged_decode_attn.cu",
                     "src/repro/kernels/paged_decode_attn.py:80",
                     rows["paged_flash_decode B=8 ctx=2048 page=128"]),
        decode_entry("flash_decode", "src/repro_torch/csrc/decode_attn.cu",
                     "src/repro/kernels/decode_attn.py:67",
                     rows["flash_decode B=8 ctx=2048"]),
        wkv6_entry(rows[f"wkv6 chunk B={WKV_MAIN['B']} T={WKV_MAIN['T']}"]),
        decode_entry("paged_flash_decode_int8",
                     "src/repro_torch/csrc/paged_decode_attn.cu",
                     "src/repro/models/attention.py:326",
                     rows["paged_flash_decode_int8 B=8 ctx=2048 page=128"]),
        decode_entry("flash_decode_int8", "src/repro_torch/csrc/decode_attn.cu",
                     "src/repro/models/attention.py:597",
                     rows["flash_decode_int8 B=8 ctx=2048"]),
        # recurrentgemma-2b's path: its widths, its runs' launches
        dict(entry("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
                   "src/repro/kernels/flash_prefill.py:84",
                   rg["rows"][f"flash_prefill H=10 Hkv=1 Dh=256 "
                              f"T={RG_PREFILL_T} window 2048"],
                   path="recurrentgemma-2b",
                   n=rg["launches"]["flash_prefill"]),
             body="tensor_core (wgmma; bf16, Dh 256 on two warpgroups, "
                  "window 2048)"),
        decode_entry("paged_flash_decode",
                     "src/repro_torch/csrc/paged_decode_attn.cu",
                     "src/repro/kernels/paged_decode_attn.py:80",
                     rg["rows"]["paged_flash_decode B=8 H=10 Hkv=1 Dh=256 "
                                "ring 2048 page=128"],
                     path="recurrentgemma-2b",
                     n=rg["launches"]["paged_flash_decode"]),
        decode_entry("flash_decode", "src/repro_torch/csrc/decode_attn.cu",
                     "src/repro/kernels/decode_attn.py:67",
                     rg["rows"]["flash_decode B=8 H=10 Hkv=1 Dh=256 ring "
                                "2048"],
                     path="recurrentgemma-2b",
                     n=rg["launches"]["flash_decode"]),
        # the same requests through ServingEngine(mesh=...) on the
        # one-rank NCCL mesh (eager), launches of those runs
        dict(entry("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
                   "src/repro/kernels/flash_prefill.py:84",
                   rg["rows"][f"flash_prefill H=10 Hkv=1 Dh=256 "
                              f"T={RG_PREFILL_T} window 2048"],
                   path=RG_MESH_PATH,
                   n=rg["mesh"]["paged"]["launches"]["flash_prefill"]
                   + rg["mesh"]["contiguous"]["launches"]["flash_prefill"]),
             body="tensor_core (wgmma; bf16, Dh 256 on two warpgroups, "
                  "window 2048)"),
        decode_entry("paged_flash_decode",
                     "src/repro_torch/csrc/paged_decode_attn.cu",
                     "src/repro/kernels/paged_decode_attn.py:80",
                     rg["rows"]["paged_flash_decode B=8 H=10 Hkv=1 Dh=256 "
                                "ring 2048 page=128"],
                     path=RG_MESH_PATH,
                     n=rg["mesh"]["paged"]["launches"]["paged_flash_decode"]),
        decode_entry("flash_decode", "src/repro_torch/csrc/decode_attn.cu",
                     "src/repro/kernels/decode_attn.py:67",
                     rg["rows"]["flash_decode B=8 H=10 Hkv=1 Dh=256 ring "
                                "2048"],
                     path=RG_MESH_PATH,
                     n=rg["mesh"]["contiguous"]["launches"]["flash_decode"]),
        # the same kernels at a --model 2 rank's shapes (5 of the 10
        # query heads over the one kv head, G = 5): timed and checked
        # here; no run on one card launches them at these shapes
        dict(entry("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
                   "src/repro/kernels/flash_prefill.py:84",
                   rg["rows"][f"flash_prefill H={RG_RANK_H} Hkv=1 Dh=256 "
                              f"T={RG_PREFILL_T} window 2048"],
                   path="recurrentgemma-2b", n=0),
             role=RG_RANK_ROLE,
             body="tensor_core (wgmma; bf16, Dh 256 on two warpgroups, "
                  "window 2048)"),
        dict(decode_entry("paged_flash_decode",
                          "src/repro_torch/csrc/paged_decode_attn.cu",
                          "src/repro/kernels/paged_decode_attn.py:80",
                          rg["rows"][f"paged_flash_decode B=8 H={RG_RANK_H} "
                                     f"Hkv=1 Dh=256 ring 2048 page=128"],
                          path="recurrentgemma-2b", n=0),
             role=RG_RANK_ROLE),
        dict(decode_entry("flash_decode",
                          "src/repro_torch/csrc/decode_attn.cu",
                          "src/repro/kernels/decode_attn.py:67",
                          rg["rows"][f"flash_decode B=8 H={RG_RANK_H} Hkv=1 "
                                     f"Dh=256 ring 2048"],
                          path="recurrentgemma-2b", n=0),
             role=RG_RANK_ROLE),
        # wkv6 on rwkv6-3b's serve run under the one-rank NCCL mesh
        dict(wkv6_entry(rows[f"wkv6 chunk B={WKV_MAIN['B']} "
                             f"T={WKV_MAIN['T']}"],
                        path="rwkv6-3b engine under the (1, 1) mesh",
                        n=rwkv_mesh["launches"]["wkv6"])),
        # wkv6 at a --model 4 rank's heads (10 of 40), as above
        dict(wkv6_entry(rows[f"wkv6 chunk B={WKV_MAIN['B']} "
                             f"T={WKV_MAIN['T']} H={WKV_RANK_H}"],
                        WKV_RANK_H, n=0),
             role="a --model 4 rank's heads (10 of 40): timed and checked "
                  "here; no run on one card launches it at this shape"),
        # qwen3-moe-235b-a22b's path (8 of its 94 layers): G = 16 at Dh 128
        dict(entry("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
                   "src/repro/kernels/flash_prefill.py:84",
                   moe["rows"]["flash_prefill H=64 Hkv=4 chunk "
                               "512@1536/4096"],
                   path=MOE_PATH, n=moe["launches"]["flash_prefill"]),
             body="tensor_core (wgmma; bf16, Dh 128, G = 16)"),
        decode_entry("paged_flash_decode",
                     "src/repro_torch/csrc/paged_decode_attn.cu",
                     "src/repro/kernels/paged_decode_attn.py:80",
                     moe["rows"]["paged_flash_decode B=8 H=64 Hkv=4 "
                                 "ctx=2048 page=128"],
                     path=MOE_PATH, n=moe["launches"]["paged_flash_decode"]),
        decode_entry("flash_decode", "src/repro_torch/csrc/decode_attn.cu",
                     "src/repro/kernels/decode_attn.py:67",
                     moe["rows"]["flash_decode B=8 H=64 Hkv=4 ctx=2048"],
                     path=MOE_PATH, n=moe["launches"]["flash_decode"]),
        # the same requests through ServingEngine(mesh=...) on the
        # one-rank NCCL mesh (eager), launches of those runs
        dict(entry("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
                   "src/repro/kernels/flash_prefill.py:84",
                   moe["rows"]["flash_prefill H=64 Hkv=4 chunk "
                               "512@1536/4096"],
                   path=MOE_MESH_PATH,
                   n=moe["mesh"]["paged"]["launches"]["flash_prefill"]
                   + moe["mesh"]["contiguous"]["launches"]["flash_prefill"]),
             body="tensor_core (wgmma; bf16, Dh 128, G = 16)"),
        decode_entry("paged_flash_decode",
                     "src/repro_torch/csrc/paged_decode_attn.cu",
                     "src/repro/kernels/paged_decode_attn.py:80",
                     moe["rows"]["paged_flash_decode B=8 H=64 Hkv=4 "
                                 "ctx=2048 page=128"],
                     path=MOE_MESH_PATH,
                     n=moe["mesh"]["paged"]["launches"]["paged_flash_decode"]),
        decode_entry("flash_decode", "src/repro_torch/csrc/decode_attn.cu",
                     "src/repro/kernels/decode_attn.py:67",
                     moe["rows"]["flash_decode B=8 H=64 Hkv=4 ctx=2048"],
                     path=MOE_MESH_PATH,
                     n=moe["mesh"]["contiguous"]["launches"]["flash_decode"]),
        # hubert-xlarge's forward: non-causal, Dh 80, ragged lengths
        dict(entry("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
                   "src/repro/kernels/flash_prefill.py:84",
                   vrows["flash_prefill B=8 T=1500 H=16 Dh=80 non-causal "
                         "ragged"],
                   path=HUBERT_ARCH, n=vision["hubert"]["launches"]),
             body="tensor_core (wgmma; bf16, Dh 80 with P·V at N 128, "
                  "non-causal, key lengths)"),
        # llama-3.2-vision-90b (20 of 100 layers): each kernel of the
        # self-attention layers and of the cross layers on its own row,
        # with the launches of its layers over the contiguous and paged
        # runs
        dict(entry("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
                   "src/repro/kernels/flash_prefill.py:84",
                   vrows["flash_prefill self B=8 T=1024 H=64 Hkv=8 causal "
                         "ragged"],
                   path=VLM_PATH, n=vlm_n["flash_prefill self"]),
             role="self-attention",
             body="tensor_core (wgmma; bf16, Dh 128, causal, key lengths)"),
        dict(entry("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
                   "src/repro/kernels/flash_prefill.py:84",
                   vrows["flash_prefill cross B=8 Tq=1024 Tk=1600 H=64 "
                         "Hkv=8"],
                   path=VLM_PATH, n=vlm_n["flash_prefill cross"]),
             role="cross-attention",
             body="tensor_core (wgmma; bf16, Dh 128, non-causal, Tq != Tk)"),
        dict(decode_entry("flash_decode", "src/repro_torch/csrc/decode_attn.cu",
                          "src/repro/kernels/decode_attn.py:67",
                          vrows["flash_decode B=8 H=64 Hkv=8 ctx=2048"],
                          path=VLM_PATH, n=vlm_n["flash_decode self"]),
             role="self-attention"),
        dict(decode_entry("flash_decode", "src/repro_torch/csrc/decode_attn.cu",
                          "src/repro/kernels/decode_attn.py:67",
                          vrows["flash_decode cross B=8 H=64 Hkv=8 over 1600 "
                                "keys"],
                          path=VLM_PATH, n=vlm_n["flash_decode cross"]),
             role="cross-attention"),
        dict(decode_entry("paged_flash_decode",
                          "src/repro_torch/csrc/paged_decode_attn.cu",
                          "src/repro/kernels/paged_decode_attn.py:80",
                          vrows["paged_flash_decode B=8 H=64 Hkv=8 ctx=2048 "
                                "page=128"],
                          path=VLM_PATH, n=vlm_n["paged_flash_decode self"]),
             role="self-attention"),
        # nemotron-4-340b (4 of 96 layers): G = 12 at Dh 192
        dict(entry("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
                   "src/repro/kernels/flash_prefill.py:84",
                   nemo["rows"]["flash_prefill H=96 Hkv=8 Dh=192 chunk "
                                "512@1536/4096"],
                   path=NEMOTRON_PATH, n=nemo["launches"]["flash_prefill"]),
             body="tensor_core (wgmma; bf16, Dh 192 on two warpgroups, "
                  "G = 12)"),
        decode_entry("paged_flash_decode",
                     "src/repro_torch/csrc/paged_decode_attn.cu",
                     "src/repro/kernels/paged_decode_attn.py:80",
                     nemo["rows"]["paged_flash_decode B=8 H=96 Hkv=8 Dh=192 "
                                  "ctx=2048 page=128"],
                     path=NEMOTRON_PATH,
                     n=nemo["launches"]["paged_flash_decode"]),
        decode_entry("flash_decode", "src/repro_torch/csrc/decode_attn.cu",
                     "src/repro/kernels/decode_attn.py:67",
                     nemo["rows"]["flash_decode B=8 H=96 Hkv=8 Dh=192 "
                                  "ctx=2048"],
                     path=NEMOTRON_PATH, n=nemo["launches"]["flash_decode"]),
        # the distribution slice: the contiguous decode kernels with
        # their log-sum-exp output, the local body of the
        # sequence-sharded decode (full-width Qwen3-14B through the
        # mesh path, its cache marked cut into one shard)
        dict(decode_entry("flash_decode", "src/repro_torch/csrc/decode_attn.cu",
                          "src/repro/kernels/decode_attn.py:67",
                          dist["rows"]["flash_decode bfloat16"],
                          path="qwen3-14b mesh (1, 1), sequence-cut cache",
                          n=dist["launches"]["flash_decode (lse_out)"]),
             role="lse_out (models/attention.py:"
                  "distributed_decode_attention)",
             ms_without_lse=dist["rows"]["flash_decode bfloat16"][
                 "ms_without"]),
        dict(decode_entry("flash_decode_int8",
                          "src/repro_torch/csrc/decode_attn.cu",
                          "src/repro/models/attention.py:597",
                          dist["rows"]["flash_decode_int8 bfloat16"],
                          path="qwen3-14b mesh (1, 1), sequence-cut int8 "
                               "cache",
                          n=dist["launches"]["flash_decode_int8 (lse_out)"]),
             role="lse_out (models/attention.py:"
                  "distributed_decode_attention)",
             ms_without_lse=dist["rows"]["flash_decode_int8 bfloat16"][
                 "ms_without"]),
        # the engine under a mesh: full-width Qwen3-14B's 12 requests
        # served through ServingEngine(mesh=...) on the one-rank NCCL
        # mesh, rank 0 driving (paged and contiguous pools, eager); the
        # kernels at the serve phase's widths and shapes
        dict(entry("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
                   "src/repro/kernels/flash_prefill.py:84",
                   rows["flash_prefill chunk 512@1536/4096"],
                   path="qwen3-14b engine under the (1, 1) mesh",
                   n=dist["launches"]["engine flash_prefill"]),
             body="tensor_core (wgmma; bf16, Dh 128)"),
        decode_entry("paged_flash_decode",
                     "src/repro_torch/csrc/paged_decode_attn.cu",
                     "src/repro/kernels/paged_decode_attn.py:80",
                     rows["paged_flash_decode B=8 ctx=2048 page=128"],
                     path="qwen3-14b engine under the (1, 1) mesh",
                     n=dist["launches"]["engine paged_flash_decode"]),
        decode_entry("flash_decode", "src/repro_torch/csrc/decode_attn.cu",
                     "src/repro/kernels/decode_attn.py:67",
                     rows["flash_decode B=8 ctx=2048"],
                     path="qwen3-14b engine under the (1, 1) mesh",
                     n=dist["launches"]["engine flash_decode"]),
        # the paged pool replicated over data with KV retention: the
        # session and spill runs through ServingEngine(mesh=...) on the
        # one-rank NCCL mesh (every decode write gathered over data,
        # prefill rows cut over data)
        dict(entry("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
                   "src/repro/kernels/flash_prefill.py:84",
                   rows["flash_prefill chunk 512@1536/4096"],
                   path="qwen3-14b (10 of 40 layers) engine under the "
                        "(1, 1) mesh, sessions and spill",
                   n=dist["launches"]["retention flash_prefill"]),
             body="tensor_core (wgmma; bf16, Dh 128)"),
        decode_entry("paged_flash_decode",
                     "src/repro_torch/csrc/paged_decode_attn.cu",
                     "src/repro/kernels/paged_decode_attn.py:80",
                     rows["paged_flash_decode B=8 ctx=2048 page=128"],
                     path="qwen3-14b (10 of 40 layers) engine under the "
                          "(1, 1) mesh, sessions and spill",
                     n=dist["launches"]["retention paged_flash_decode"]),
        # the training step: the forward kernel under autograd (its
        # backward is the plain version's), launches over the 10 steps
        dict(entry("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
                   "src/repro/kernels/flash_prefill.py:84", train["row"],
                   path=TRAIN_PATH, n=train["run"]["launches"]),
             role="training forward (backward: the plain version)",
             body="tensor_core (wgmma; bf16, Dh 128, causal)",
             fwd_bwd_ms=train["row"]["fwd_bwd_ms"],
             plain_fwd_bwd_ms=train["row"]["plain_fwd_bwd_ms"],
             library_fwd_bwd_ms=train["row"]["sdpa_fwd_bwd_ms"],
             fwd_bwd_bound_ms=train["row"]["fwd_bwd_bound_ms"]),
        # wkv6's backward kernel (the gradient of the reference's
        # wkv_scan, which XLA compiles; no Pallas kernel) and the forward
        # kernel under autograd: the rwkv6-3b training run's launches, at
        # its shape, timed on the operands of one of its steps
        dict(entry("wkv6_bwd", "src/repro_torch/csrc/wkv6_bwd.cu",
                   "src/repro/models/rwkv.py:72",
                   train["rwkv"]["rows"]["wkv6_bwd"],
                   path=RWKV_TRAIN_PATH,
                   n=train["rwkv"]["launches"]["wkv6_bwd"]),
             role="training backward of wkv6 (kernels/autograd.py)",
             body=wkv6_bwd_body(train["rwkv"]["rows"]["wkv6_bwd"])),
        dict(wkv6_entry(train["rwkv"]["rows"]["wkv6"], B=RWKV_TRAIN_BATCH,
                        path=RWKV_TRAIN_PATH,
                        n=train["rwkv"]["launches"]["wkv6"]),
             role="training forward and remat's recompute (backward: "
                  "wkv6_bwd)"),
        # the backward at the serve chunk's shape and a --model 4 rank's
        # heads: checked and timed in the kernel phase, launched by no run
        dict(entry("wkv6_bwd", "src/repro_torch/csrc/wkv6_bwd.cu",
                   "src/repro/models/rwkv.py:72",
                   rows[f"wkv6_bwd chunk B={WKV_MAIN['B']} "
                        f"T={WKV_MAIN['T']}"],
                   path=RWKV_TRAIN_PATH, n=0),
             role="rwkv6-3b's chunk shape (B 8, T 512): timed and checked "
                  "here; no run launches the backward at this shape",
             body=wkv6_bwd_body(rows[f"wkv6_bwd chunk B={WKV_MAIN['B']} "
                                     f"T={WKV_MAIN['T']}"])),
        dict(entry("wkv6_bwd", "src/repro_torch/csrc/wkv6_bwd.cu",
                   "src/repro/models/rwkv.py:72",
                   rows[f"wkv6_bwd chunk B={WKV_MAIN['B']} "
                        f"T={WKV_MAIN['T']} H={WKV_RANK_H}"],
                   path=RWKV_TRAIN_PATH, n=0),
             role="a --model 4 rank's heads (10 of 40): timed and checked "
                  "here; no run on one card launches it at this shape",
             body=wkv6_bwd_body(rows[f"wkv6_bwd chunk B={WKV_MAIN['B']} "
                                     f"T={WKV_MAIN['T']} H={WKV_RANK_H}"])),
        # the analysis phase's counts on real tensors: a decode step and a
        # 512 x 8 chunk, each kernel counted by its formula as it launched
        dict(decode_entry("paged_flash_decode",
                          "src/repro_torch/csrc/paged_decode_attn.cu",
                          "src/repro/kernels/paged_decode_attn.py:80",
                          rows["paged_flash_decode B=8 ctx=2048 page=128"],
                          path=ANALYSIS_PATH,
                          n=analysis["decode"]["launches"][
                              "paged_flash_decode"]),
             role="a decode step under launch/op_analysis.count"),
        dict(entry("flash_prefill", "src/repro_torch/csrc/flash_prefill.cu",
                   "src/repro/kernels/flash_prefill.py:84",
                   rows["flash_prefill chunk 512@1536/4096"],
                   path=ANALYSIS_PATH,
                   n=analysis["chunk"]["launches"]["flash_prefill"]),
             role="a 512 x 8 chunk under launch/op_analysis.count",
             body="tensor_core (wgmma; bf16, Dh 128)"),
    ]}
    log("time", "seconds from the start to each tag's first and last "
        "line: " + json.dumps({k: [round(a, 1), round(b, 1)]
                               for k, (a, b) in SPANS.items()}))
    log("serve", f"qwen3-14b paged {paged_stats}; contiguous "
        f"{contig_stats}; rwkv6-3b {rwkv_stats}; rwkv6-3b under the "
        f"(1, 1) mesh {rwkv_mesh}")
    log("profile", json.dumps(profile))
    log("retention", f"{retention}")
    log("recovery", f"{recovery}")
    log("int8", f"{int8}")
    log("paper", json.dumps(paper))
    log("rg", json.dumps(rg, default=str))
    log("moe", json.dumps(moe, default=str))
    log("vlm", json.dumps(vision, default=str))
    log("nemotron", json.dumps(nemo, default=str))
    log("train", json.dumps(train, default=str))
    log("dist", json.dumps(dist, default=str))
    log("analysis", json.dumps({k: v for k, v in analysis.items()
                                if not k.startswith("dryrun")},
                               default=str))
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
