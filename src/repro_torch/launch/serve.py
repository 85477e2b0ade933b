"""Serving launcher: BucketServe on the unified serving loop, PyTorch
backend or the analytic cost model.

    PYTHONPATH=src python -m repro_torch.launch.serve --backend torch \\
        --arch qwen3-14b --max-seq-len 4096 [--smoke] [--device cuda|cpu] \\
        [--backend torch|sim] [--dtype bf16|f32] [--chunk 512] \\
        [--paged --page-size 128] [--kv-dtype bf16|int8] \\
        [--requests 16] [--dataset mixed] [--rps 8] \\
        [--trigger waste|majority] [--prefix-cache --prefix-scenarios 2] \\
        [--sessions 4 --turns 3 --session-ttl 60] \\
        [--kv-spill --host-pool-tokens N --spill-dtype bf16|int8|int4] \\
        [--sched goodput --slice-tokens 16] [--fault-plan SPEC] \\
        [--trace-record PATH | --trace-replay PATH] [--trace-out PATH] \\
        [--burst-factor F] [--drain-after T] [--data D --model M]

``--backend torch`` runs the real engine (``core/engine.py``): eager
prefill and decode with slot-pool continuous batching, the attention
products on the hand-written CUDA kernels when ``--device cuda`` (the
default; it raises without a card).  ``--chunk N`` enables chunked
prefill, ``--paged`` swaps the per-slot KV caches for the shared page
pool (the scheduler then runs the ceil-to-page Eq.-(6) memory model).
``--kv-dtype int8`` stores K/V as int8 codes with f32 per-(token, head)
scales (the reference's int8 KV variant): the pool is sized in bytes,
so the same ``--pool-tokens`` buys about twice the pages, and decode
runs the int8 decode kernels, which dequantize in registers.
``--smoke`` serves the reduced config with the plain PyTorch path
running on the CPU when ``--device cpu`` is given.  ``--arch rwkv6-3b``
serves RWKV6 on the contiguous slot pool (its per-slot carry has no K/V
to page, so ``--paged`` is refused), through the hand-written WKV6
kernel on the card.  The MoE configs (``--arch qwen3-moe-235b-a22b``,
``--arch llama4-scout-17b-a16e``) are served with ``moe_impl="local"``,
as the reference launcher serves them; at full depth neither fits one
80 GB card.  ``--arch hubert-xlarge`` (an encoder, no decode step) exits
on either backend with the reference launcher's message; the engine
cannot serve ``--arch llama-3.2-vision-90b`` (its prefill takes token
ids only, as the reference engine's, and a VLM needs its image), so
``--backend torch`` refuses it before building a model, while ``--backend
sim`` runs it and ``nemotron-4-340b`` as the reference's does.

``--data``/``--model`` are the reference launcher's mesh axes: the cost
model never reads them (as in the reference); ``--backend torch`` serves
on a D x M mesh of ranks (``launch/mesh.py``) through the engine under a
mesh (``core/driver.py``): rank 0 runs the loop and sends each device
call to every rank.  Each rank builds the seeded whole model and cuts
its shard (``sharding.partition.shard_model``); rank 0 prints the
reference's ``mesh: {...}; params sharded`` line, the usual summary
lines and a ``mesh ...`` line (the steps run eagerly: both CUDA graphs
are off under a mesh; the command channel's host time a decode step),
and the other ranks print nothing but errors.  The scheduler's budget
counts D x M devices, each of this card's memory, as the reference's
launcher counts its devices; the default paged pool counts a rank's
share of each page (its kv heads, every page: the pool is replicated
over ``--data``, so it does not shrink as D grows, and with
``--kv-spill`` each data rank holds its own copy of the host tier).
``--paged``, ``--prefix-cache``, ``--sessions`` and ``--kv-spill`` are
served under any D x M, prefill rows cut over ``--data`` where it
divides a batch.  Under ``torchrun --nproc-per-node D*M`` the ranks
come from torchrun's environment; without it the launcher spawns D*M
local ranks itself (a ``file://`` store in a temporary directory; gloo
ranks of one torch thread each with ``--device cpu``, one rank a card on
the card, where fewer cards than ranks exit 2).  Every config the
engine serves on one device it serves under any D x M: an MoE config
whose experts ``--data`` cuts runs ``moe_impl="local"`` through the
expert dispatch at a capacity that drops nothing (``models/moe.py``),
and RWKV6 and recurrentgemma run tensor-parallel over ``--model``.

``--backend sim`` drives the same scheduler through the analytic cost
model (``core/simulator.py``, the reference's, on its ``A100X4`` spec)
in virtual time, and prints the reference launcher's ``[sim]`` lines;
``--drain-after T`` runs the reference's drain/resume smoke on it
(checkpoint at T virtual seconds, JSON round trip, cold resume, token
ids equal to an uninterrupted run) and is refused on ``--backend
torch``.  No device is touched on this backend.

The workload is the reference launcher's: ``--dataset`` at ``--rps``
(``data/workload.py``), prompts clipped at ``max_seq_len - 16`` and
generated tokens capped at 8; ``--trigger`` picks the bucket split rule
(``waste``, the paper's Eq. 1-4 padding-waste rule, by default).  Given
the same flags, this launcher and the reference's build the same
scheduler and the same requests.  Two defaults differ on purpose:
``--arch`` (the port's main model, qwen3-14b, against the reference's
yi-6b) and ``--requests`` (16, a full-width run on one card, against
32).

KV retention (``core/retention.py``): ``--prefix-cache`` shares cached
full prompt pages across requests (``--prefix-scenarios N`` draws every
prompt from N shared system prompts of ``--prefix-tokens``);
``--sessions N --turns T`` serves multi-turn conversations whose next
turn resumes past the retained transcript for ``--session-ttl`` seconds;
``--kv-spill`` adds the host spill tier (``--host-pool-tokens``, default
4x the device pool; ``--spill-dtype``).  Spill implies the prefix cache,
which implies ``--paged``.

Recovery and telemetry (``core/faults.py``, ``core/recovery.py``,
``core/telemetry.py``, ``data/trace.py``): ``--slice-tokens N`` keeps a
preempted decode's generated tokens up to the last multiple of N and
resumes it after a re-prefill; ``--fault-plan SPEC`` arms the seeded
fault injector and prints the recovery counters; ``--trace-record``
writes the request stream as a JSONL trace that ``--trace-replay``
serves again (either package's trace reads in the other), both printing
the formed-batch log; ``--trace-out`` exports the event timeline as
Perfetto JSON and exits non-zero if it breaks the schema;
``--burst-factor F > 1`` draws the three-class mix with bursty arrivals.

At full width on one 80 GB card, pass ``--max-seq-len 4096``: with the
config's 32768 the per-job prefill cache alone (slots x 32768 tokens x
160 KiB for Qwen3-14B) does not fit beside the weights.  Without
``--pool-tokens`` the paged pool takes 40% of the device memory left
free after the weights.

The output keeps the reference launcher's lines (``served N/N requests,
T tokens in Xs; prefill shapes: ...; buckets: [...]``, the ``tails:``
line with its per-class lines, and the kv util / padding waste / blame
line) and adds one line with each kernel's launch count.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import sys
import tempfile
import time

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import (BucketServeScheduler, GoodputScheduler,
                              MemoryBudget, SchedulerConfig)
from repro_torch.core import driver
from repro_torch.core.engine import ServingEngine, check_servable, kv_shards
from repro_torch.core.faults import FaultPlan
from repro_torch.core.recovery import LoopCheckpoint
from repro_torch.core.simulator import A100X4, CostModel, Simulator
from repro_torch.core.telemetry import Tracer, validate_perfetto
from repro_torch.data.trace import TraceRecorder, TraceWorkload
from repro_torch.data.workload import DEFAULT_CLASS_MIX, WorkloadSpec, generate
from repro_torch.device import resolve_device
from repro_torch.kernels import runtime
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer as tfm
from repro_torch.sharding import context, partition

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _make_sched(cfg, budget, args):
    """``--sched`` picks the queue policy: arrival-order BucketServe or
    the deadline-slack goodput scheduler, on the same buckets and the
    same Eq.-(6) controller; ``--trigger`` the bucket split rule."""
    cls = GoodputScheduler if args.sched == "goodput" \
        else BucketServeScheduler
    return cls(cfg, budget, SchedulerConfig(
        max_batch=args.slots, trigger=args.trigger,
        memory_model="paged" if args.paged else "sum",
        page_size=args.page_size))


def device_memory_bytes(device: torch.device) -> int:
    """Device memory the budget may plan with: free plus what this
    process already holds (its weights count against the budget through
    ``weight_bytes``).  The CPU path has no device memory to read and
    plans with the reference's 16 GiB."""
    if device.type != "cuda":
        return 16 * 2 ** 30
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_allocated(device)


def default_pool_tokens(cfg, model, device: torch.device, mesh=None):
    """Paged pool size when none is given: 40% of the device memory still
    free after the weights (a rank's shard of them under a mesh), the
    rest left to the per-job prefill cache and activations, at a rank's
    share of each token's K/V (``engine.kv_shards``).  None on the CPU,
    where the engine's default (slots x cache length) stands."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    per_tok = cfg.kv_bytes_per_token(model.embed.element_size())
    return int(0.4 * free) * kv_shards(cfg, mesh) // per_tok


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="torch", choices=["torch", "sim"],
                    help="the PyTorch engine or the analytic cost model "
                         "(virtual time, no device)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--arch", default="qwen3-14b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--chunk", type=int, default=None,
                    help="chunked-prefill span in tokens (default: whole "
                         "prompt)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV decode pool (block-table admission)")
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--pool-tokens", type=int, default=None,
                    help="total pooled KV tokens (default on the card: "
                         "40%% of the memory free after the weights; on "
                         "the CPU: slots x max_seq_len)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--dataset", default="mixed",
                    help="workload length distribution (data/workload.py)")
    ap.add_argument("--rps", type=float, default=8.0,
                    help="mean arrival rate in requests per second")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--data", type=int, default=1,
                    help="mesh axes, as the reference launcher's: no "
                         "effect on --backend sim; --backend torch serves "
                         "on data x model ranks (spawned here, or "
                         "torchrun's)")
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--trigger", default="waste",
                    choices=["majority", "waste"],
                    help="bucket split rule: the paper's padding-waste "
                         "rule (Eq. 1-4) or the majority rule")
    ap.add_argument("--max-seq-len", type=int, default=None,
                    help="cache length per request (default: the "
                         "config's; 256 with --smoke)")
    ap.add_argument("--sched", default="bucket",
                    choices=["bucket", "goodput"])
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cross-request prefix cache on the paged pool "
                         "(radix lookup + refcounted shared pages; "
                         "implies --paged)")
    ap.add_argument("--prefix-scenarios", type=int, default=0,
                    help="shared-prefix workload: N distinct system "
                         "prompts with Zipf reuse (0 = length-only "
                         "workload)")
    ap.add_argument("--prefix-tokens", type=int, default=128,
                    help="tokens per shared system prompt (with "
                         "--prefix-scenarios)")
    ap.add_argument("--sessions", type=int, default=0,
                    help="multi-turn conversation workload: N sessions "
                         "of --turns turns each; enables session "
                         "retention (implies --prefix-cache)")
    ap.add_argument("--turns", type=int, default=3,
                    help="turns per session (with --sessions)")
    ap.add_argument("--session-ttl", type=float, default=60.0,
                    help="seconds a finished conversation's KV stays "
                         "pinned awaiting the next turn")
    ap.add_argument("--think-time", type=float, default=0.0,
                    help="mean think-time gap (s) between a session's "
                         "turns; above --session-ttl the tail expires "
                         "(with --kv-spill the next turn restores it)")
    ap.add_argument("--kv-spill", action="store_true",
                    help="host-memory spill tier under the retention "
                         "layer: evicted retained pages are copied to the "
                         "host and restored on a later hit (implies "
                         "--prefix-cache)")
    ap.add_argument("--host-pool-tokens", type=int, default=None,
                    help="host spill budget in KV tokens (default: 4x "
                         "the device pool); implies --kv-spill")
    ap.add_argument("--spill-bw", type=float, default=16.0,
                    help="host<->device link bandwidth in GB/s used to "
                         "price spill and restore transfers")
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"],
                    help="device KV pool precision: int8 codes with f32 "
                         "per-(token, head) scales take about half the "
                         "bytes a token, so the same byte budget holds "
                         "about twice the pages")
    ap.add_argument("--spill-dtype", default="bf16",
                    choices=["bf16", "int8", "int4"],
                    help="host spill tier precision: int8/int4 keep more "
                         "pages in the same host budget, lossily")
    ap.add_argument("--trace-record", default=None, metavar="PATH",
                    help="record this run's request stream to a versioned "
                         "JSONL trace (data/trace.py) that replays through "
                         "either package")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export the run's event timeline as Chrome "
                         "trace-event / Perfetto JSON (core/telemetry.py "
                         "Tracer), validated against the schema")
    ap.add_argument("--trace-replay", default=None, metavar="PATH",
                    help="serve a recorded trace instead of generating a "
                         "workload (arrivals preserved, no clamps: the "
                         "trace is authoritative)")
    ap.add_argument("--burst-factor", type=float, default=1.0,
                    help="> 1 draws the chat/longctx/batch class mix with "
                         "bursty arrivals peaking at this multiple of the "
                         "rate")
    ap.add_argument("--slice-tokens", type=int, default=None,
                    help="slice-boundary preemption: a preempted decode "
                         "keeps its generated tokens up to the last "
                         "multiple of N and resumes after a re-prefill "
                         "instead of restarting")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="arm the seeded fault injector (core/faults.py), "
                         "e.g. 'seed=7,decode_step=0.02,prefill_chunk=0.05'")
    ap.add_argument("--ids-out", default=None, metavar="PATH",
                    help="write every served request's generated token "
                         "ids as JSON ({rid: [ids]})")
    ap.add_argument("--drain-after", type=float, default=None, metavar="T",
                    help="drain/resume smoke on --backend sim: checkpoint "
                         "a run at T virtual seconds, JSON round trip, "
                         "resume on a cold loop and require token ids "
                         "equal to an uninterrupted run")
    return ap


def make_config(args):
    max_seq = args.max_seq_len or (256 if args.smoke else None)
    if args.smoke:
        cfg = get_smoke_config(args.arch, max_seq_len=max_seq)
    else:
        cfg = get_config(args.arch)
        if max_seq:
            cfg = dataclasses.replace(cfg, max_seq_len=max_seq)
    if args.kv_dtype == "int8" and cfg.kv_cache_dtype != "int8":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    return cfg


def make_requests(cfg, args, max_new: int = 8):
    """The reference launcher's workload: ``--dataset`` at ``--rps``,
    generated tokens capped at ``max_new`` and prompts clipped at
    ``max_seq_len - 16``; ``--burst-factor > 1`` draws the three-class
    mix with bursty arrivals under the same clamps; with ``--sessions``,
    conversations whose turns are sized to fit the window up front (the
    loop composes each turn's prompt from the transcript, which must
    come to ``prompt_len`` exactly, so nothing is clipped); with
    ``--trace-replay``, the recorded requests as they are."""
    if args.trace_replay:
        tw = TraceWorkload(args.trace_replay)
        reqs = tw.requests()
        print(f"replaying {len(reqs)} recorded requests from "
              f"{args.trace_replay} (meta: {tw.meta})")
        return reqs
    if args.sessions:
        per_turn = max(cfg.max_seq_len // (2 * args.turns) - 8, 8)
        return generate(WorkloadSpec(
            dataset=args.dataset, rps=args.rps,
            max_model_len=cfg.max_seq_len, vocab_size=cfg.vocab_size,
            sessions=args.sessions, turns=args.turns,
            utterance_tokens=per_turn, max_new_tokens=max_new,
            think_time_s=args.think_time))
    burst = dict(class_mix=DEFAULT_CLASS_MIX,
                 burst_factor=args.burst_factor) \
        if args.burst_factor > 1.0 else {}
    reqs = generate(WorkloadSpec(
        dataset=args.dataset, rps=args.rps, n_requests=args.requests,
        max_model_len=cfg.max_seq_len, prefix_groups=args.prefix_scenarios,
        prefix_tokens=args.prefix_tokens, vocab_size=cfg.vocab_size,
        **burst))
    for r in reqs:
        r.max_new_tokens = min(r.max_new_tokens, max_new)
        r.prompt_len = min(r.prompt_len, cfg.max_seq_len - 16)
    return reqs


def serve(cfg, model, reqs, args, device: torch.device, mesh=None):
    """Serve ``reqs`` and print the launcher's summary lines; returns
    (engine, finished requests, seconds).  Under ``mesh`` every rank
    calls it; a worker rank (its ``reqs`` unused) answers the driver's
    commands and returns (engine, [], 0.0)."""
    n_dev = 1 if mesh is None else args.data * args.model
    driving = mesh is None or torch.distributed.get_rank() == 0
    budget = MemoryBudget(hbm_bytes_per_device=device_memory_bytes(device),
                          n_devices=n_dev,
                          weight_bytes=cfg.param_count()
                          * model.embed.element_size())
    sched = _make_sched(cfg, budget, args) if driving else None
    pool_tokens = args.pool_tokens
    if args.paged and pool_tokens is None:
        pool_tokens = default_pool_tokens(cfg, model, device, mesh)
        if mesh is not None and pool_tokens is not None:
            # each rank's free memory differs: the pool every rank holds
            pool_tokens = driver.channel(mesh).agree_min(pool_tokens)
    plan = FaultPlan.parse(args.fault_plan) if args.fault_plan else None
    # the recorder doubles as the replay checker: a recorded run and its
    # replay both print the formed-batch log
    recorder = TraceRecorder() if (args.trace_record
                                   or args.trace_replay) else None
    tracer = Tracer() if args.trace_out else None
    host_tokens = None
    if args.kv_spill:
        host_tokens = args.host_pool_tokens or 4 * (
            pool_tokens or args.slots * cfg.max_seq_len)
    engine = ServingEngine(cfg, model, sched, max_slots=args.slots,
                           cache_len=cfg.max_seq_len,
                           chunk_tokens=args.chunk, paged=args.paged,
                           page_size=args.page_size,
                           kv_pool_tokens=pool_tokens,
                           prefix_cache=args.prefix_cache,
                           session_ttl=args.session_ttl if args.sessions
                           else None,
                           host_pool_tokens=host_tokens,
                           spill_bw=args.spill_bw * 1e9,
                           spill_dtype=args.spill_dtype,
                           slice_tokens=args.slice_tokens,
                           recorder=recorder, tracer=tracer,
                           fault_plan=plan, device=device,
                           prefill_rows=args.slots, moe_impl="local",
                           mesh=mesh)
    runtime.reset_launch_counts()
    if not driving:
        engine.run()
        return engine, [], 0.0
    engine.submit(reqs)
    t0 = time.perf_counter()
    done = engine.run(max_wall_s=900)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(r.generated for r in done)
    paged_info = ""
    if args.paged:
        be = engine.backend
        paged_info = (f"pages: {be.alloc.n_pages} x {be.page_size} tok "
                      f"({args.kv_dtype} pool), free {be.free_blocks()}; "
                      f"peak pool {engine.result.peak_pool}; "
                      f"preemptions {engine.result.preempt_events}; ")
        paged_info += retention_info(engine.result, args)
    pg = engine.backend.prefill_graph
    print(f"served {len(done)}/{len(reqs)} requests, {toks} tokens in "
          f"{dt:.1f}s; prefill shapes: {engine.n_prefill_shapes} (prefill "
          f"graphs: {len(pg) if pg else 0}, pool "
          f"{pg.pool_bytes if pg else 0} B); "
          f"decode steps interleaved between prefill chunks: "
          f"{engine.interleaved_decode_steps}; {paged_info}"
          f"buckets: {[(b.low, b.up) for b in sched.buckets.buckets]}")
    res = engine.result
    print(_tail_line(res))
    print(_util_line(res))
    if args.slice_tokens:
        print(f"slice yields {res.slice_yields}")
    print("kernel launches: " + ", ".join(
        f"{k} {v}" for k, v in runtime.launch_counts.items()))
    if mesh is not None:
        ch = engine.backend.channel
        ms = ch.host_ms("decode")
        print(f"mesh {mesh.shape}: eager steps (the decode and prefill "
              f"graphs are off under a mesh); {sum(ch.sent.values())} "
              f"commands, host time a decode step's "
              f"{'-' if ms is None else f'{ms:.3f}'} ms")
    if plan is not None:
        print(_fault_line(res, plan))
    if args.ids_out:
        with open(args.ids_out, "w") as f:
            json.dump({str(r.rid): [int(t) for t in engine.outputs[r.rid]]
                       for r in done}, f)
    _finish_trace(args, recorder)
    _finish_timeline(args, tracer)
    return engine, done, dt


def _tail_line(res) -> str:
    """Percentile tails, overall and per class, with each class's SLO
    attainment and goodput (the reference launcher's line)."""
    out = (f"tails: TTFT p50/p95/p99 {res.p50('ttft'):.3f}/"
           f"{res.p95('ttft'):.3f}/{res.p99('ttft'):.3f} s, "
           f"TPOT p50/p95/p99 {res.p50('tpot') * 1e3:.1f}/"
           f"{res.p95('tpot') * 1e3:.1f}/{res.p99('tpot') * 1e3:.1f} ms, "
           f"{res.incomplete()} incomplete")
    for c in res.classes():
        out += (f"\nclass {c}: TTFT p50/p95/p99 "
                f"{res.p50('ttft', c):.3f}/{res.p95('ttft', c):.3f}/"
                f"{res.p99('ttft', c):.3f} s, TPOT p99 "
                f"{res.p99('tpot', c) * 1e3:.1f} ms, "
                f"attainment {res.slo_attainment(c):.2f}, "
                f"goodput {res.goodput(c):.3f} req/s")
    if res.classes():
        out += (f"\ngoodput {res.goodput():.3f} req/s "
                f"({res.server_rps():.3f} finished req/s)")
    return out


def _util_line(res) -> str:
    """Time-weighted KV utilisation, padding waste (what the buckets
    exist to cut) and the latency blame per phase."""
    return (f"kv util (time-weighted) {res.kv_util_time_weighted:.2f}; "
            f"padding waste {res.padding_waste_ratio():.3f}; "
            f"blame {_fmt_blame(res.blame())}")


def _fmt_blame(b) -> str:
    return "{" + ", ".join(f"{k}: {v:.3f}s" for k, v in b.items()) + "}"


def _make_sim(cfg, args, plan=None, recorder=None, tracer=None):
    """The cost model on the reference launcher's ``A100X4`` spec, so
    that the two launchers print the same ``[sim]`` lines."""
    hw = A100X4
    budget = MemoryBudget(hbm_bytes_per_device=hw.hbm_bytes,
                          n_devices=hw.decode_chips,
                          weight_bytes=cfg.param_count() * 2)
    sched = _make_sched(cfg, budget, args)
    sim = Simulator(sched, CostModel(cfg, hw), mode="disagg",
                    decode_slot_cap=args.slots, chunk_tokens=args.chunk,
                    paged=args.paged, page_size=args.page_size,
                    kv_pool_tokens=args.pool_tokens,
                    prefix_cache=args.prefix_cache,
                    session_ttl=args.session_ttl if args.sessions else None,
                    host_pool_tokens=args.host_pool_tokens,
                    spill_bw=args.spill_bw * 1e9,
                    spill_dtype=args.spill_dtype,
                    slice_tokens=args.slice_tokens,
                    recorder=recorder, tracer=tracer,
                    fault_plan=plan)
    return sim, sched


def _run_sim(cfg, args, reqs, recorder=None, tracer=None, plan=None):
    """One cost-model pass over the workload, printing the ``[sim]``
    lines."""
    sim, sched = _make_sim(cfg, args, plan, recorder, tracer)
    # recovery backoff and restart penalties stretch the virtual
    # makespan under an armed plan: give the storm room to finish
    res = sim.run(reqs, time_limit=40000.0 if plan is not None else 3600.0)
    info = ""
    if args.prefix_cache:
        info = (f"prefix hits {res.prefix_hits}/{res.prefix_lookups} "
                f"({res.prefix_hit_rate():.2f}), "
                f"{res.prefill_tokens_skipped} prompt tokens "
                f"skipped, {res.prefix_pages_saved} pages saved; ")
    if args.sessions:
        info += (f"session hits {res.session_hits}/{res.session_lookups}, "
                 f"{res.session_hit_tokens} transcript tokens restored, "
                 f"{res.tail_pages_reused} tails reused, "
                 f"{res.sessions_expired} expired; ")
    if args.kv_spill:
        info += (f"spill[{args.spill_dtype}]: {res.spilled_pages} pages "
                 f"({res.spilled_bytes} B) out, "
                 f"{res.restored_pages} back ({res.restored_tokens} tokens, "
                 f"{res.restored_bytes} B), {res.spill_drops} dropped, "
                 f"{res.spill_hold_events} holds; ")
    print(f"[sim] served {len(res.finished())}/{len(reqs)} requests in "
          f"{res.makespan:.2f} virtual s; {res.throughput_tok_s():.0f} tok/s; "
          f"SLO {res.slo_attainment():.2f}; OOM {res.oom_events}; "
          f"peak pool {res.peak_pool}; preemptions {res.preempt_events}; "
          f"{info}"
          f"buckets: {[(b.low, b.up) for b in sched.buckets.buckets]}")
    print(f"[sim] {_tail_line(res)}")
    print(f"[sim] {_util_line(res)}")
    if plan is not None:
        print(f"[sim] {_fault_line(res, plan)}")
    return res


def _transcript(backend, r):
    """A request's whole token path: the prompt (slice promotion
    included) and the generated ids past the promoted boundary."""
    toks = [] if r.tokens is None else \
        [int(t) for t in r.tokens[:r.prompt_len]]
    gen = backend.generated_tokens(r)[r.sliced_tokens:]
    return toks + [int(t) for t in gen]


def _drain_resume_sim(cfg, args, reqs, plan):
    """``--drain-after``: an uninterrupted run, a second run drained at T
    virtual seconds (checkpoint through JSON), then a cold loop resuming
    the checkpoint.  Every request must finish exactly once across the
    drained and resumed pair with token ids equal to the uninterrupted
    run's, else the launcher exits non-zero."""
    t = args.drain_after
    ref_sim, _ = _make_sim(cfg, args, plan)
    ref = ref_sim.run(copy.deepcopy(reqs), time_limit=40000.0)
    want = {r.rid: _transcript(ref_sim.loop.backend, r)
            for r in ref.requests if r.finished >= 0 and not r.dropped}

    sim1, _ = _make_sim(cfg, args, plan)
    res1 = sim1.run(copy.deepcopy(reqs), time_limit=40000.0, drain_at=t)
    ck = LoopCheckpoint.from_json(sim1.loop.drain().to_json())
    sim2, _ = _make_sim(cfg, args, plan)
    res2 = sim2.run(ck.restore_requests(), time_limit=40000.0,
                    resume_clock=ck.now)

    done1 = {r.rid: r for r in res1.requests
             if r.finished >= 0 and not r.dropped}
    done2 = {r.rid: r for r in res2.requests
             if r.finished >= 0 and not r.dropped}
    print(f"[drain] checkpoint at t={ck.now:.2f}s: {len(done1)} finished "
          f"pre-drain, {len(ck.requests)} in-flight/queued + "
          f"{len(ck.held_turns)} held turns serialized, "
          f"{len(done2)} finished after cold resume")
    if plan is not None:
        print(f"[drain] {_fault_line(res2, plan)}")
    errs = []
    if set(done1) & set(done2):
        errs.append(f"duplicated rids {sorted(set(done1) & set(done2))}")
    if set(done1) | set(done2) != set(want):
        lost = set(want) - (set(done1) | set(done2))
        extra = (set(done1) | set(done2)) - set(want)
        errs.append(f"lost {sorted(lost)} / extra {sorted(extra)}")
    for rid, r in done1.items():
        if rid in want and _transcript(sim1.loop.backend, r) != want[rid]:
            errs.append(f"rid {rid} diverged pre-drain")
    for rid, r in done2.items():
        if rid in want and _transcript(sim2.loop.backend, r) != want[rid]:
            errs.append(f"rid {rid} diverged after resume")
    if errs:
        raise SystemExit("[drain] resume NOT work-preserving: "
                         + "; ".join(errs))
    print(f"[drain] drain-resume token ids identical "
          f"({len(done1)}+{len(done2)}/{len(want)} requests, "
          f"checkpoint {len(ck.to_json())} B)")


def _fault_line(res, plan) -> str:
    """Recovery counters under an armed plan (the reference launcher's
    line: replays of the same SPEC print it verbatim)."""
    return (f"faults[{plan.spec()}]: {res.fault_events} injected, "
            f"{res.fault_retries} retried, {res.fault_kills} killed, "
            f"{res.quarantined} quarantined; restore channel: "
            f"{res.restore_stalls} stalls, {res.restore_retries} retries, "
            f"{res.restore_failures} failures, {res.restore_sheds} sheds, "
            f"{res.restore_timeouts} timeouts, "
            f"{res.corruptions} corruptions")


def _finish_trace(args, recorder) -> None:
    """Print the formed-batch log and save the recorded trace."""
    if recorder is None:
        return
    print("batch log:", recorder.batch_log)
    if args.trace_record:
        recorder.save(args.trace_record,
                      meta={"arch": args.arch, "backend": args.backend,
                            "burst_factor": args.burst_factor})
        print(f"recorded {len(recorder.snapshots)} requests -> "
              f"{args.trace_record}")


def _finish_timeline(args, tracer) -> None:
    """Export the Perfetto timeline (``--trace-out``) and validate it
    against the schema; any violation exits non-zero."""
    if tracer is None:
        return
    doc = tracer.save(args.trace_out)
    errs = validate_perfetto(doc)
    n_ev = sum(1 for e in doc["traceEvents"] if e.get("ph") != "M")
    if errs:
        for e in errs[:10]:
            print(f"[trace] INVALID: {e}")
        raise SystemExit(f"--trace-out produced an invalid trace "
                         f"({len(errs)} schema violations)")
    print(f"[trace] {n_ev} events on {len(tracer._tracks)} tracks -> "
          f"{args.trace_out} (open in ui.perfetto.dev)")


def retention_info(r, args) -> str:
    """The summary line's retention fields (the reference launcher's)."""
    out = ""
    if args.prefix_cache:
        out += (f"prefix hits {r.prefix_hits}/{r.prefix_lookups} "
                f"({r.prefix_hit_rate():.2f}), {r.prefill_tokens_skipped} "
                f"prompt tokens skipped, {r.prefix_pages_saved} pages "
                f"saved, {r.shared_pages_peak} peak shared; ")
    if args.sessions:
        out += (f"session hits {r.session_hits}/{r.session_lookups}, "
                f"{r.session_hit_tokens} transcript tokens restored, "
                f"{r.tail_pages_reused} tails reused, "
                f"{r.sessions_retained} retained; ")
    if args.kv_spill:
        out += (f"spill[{args.spill_dtype}]: {r.spilled_pages} pages "
                f"({r.spilled_bytes} B) out, "
                f"{r.restored_pages} back ({r.restored_tokens} tokens, "
                f"{r.restored_bytes} B), {r.spill_drops} dropped, "
                f"{r.spill_hold_events} holds; ")
    return out


def _flags(args) -> None:
    """The implied flags: an explicit host budget turns the tier on;
    spill rides on the prefix cache, which rides on the paged pool."""
    args.kv_spill = args.kv_spill or args.host_pool_tokens is not None
    args.prefix_cache = (args.prefix_cache or args.sessions > 0
                         or args.kv_spill)
    args.paged = args.paged or args.prefix_cache


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.drain_after is not None and args.backend != "sim":
        raise SystemExit("--drain-after is a cost-model smoke: "
                         "use --backend sim")
    _flags(args)
    cfg = make_config(args)
    # an encoder is refused on either backend, as the reference's launcher
    # refuses it; a VLM on the engine only (the cost model runs it)
    if not cfg.has_decode or args.backend != "sim":
        try:
            check_servable(cfg)
        except ValueError as e:     # before a model is built for nothing
            raise SystemExit(str(e)) from None
    world = args.data * args.model
    if args.paged and not tfm.supports_paged_decode(cfg):
        ap.error(f"--paged: {cfg.name} has no self-attention KV to page; "
                 f"serve it on the contiguous slot pool (without --paged)")
    if args.backend == "sim":
        main_sim(cfg, args)
        return
    device = resolve_device(args.device)
    if world > 1:
        if "RANK" in os.environ:              # under torchrun
            return serve_rank(cfg, args)
        if device.type == "cuda" and torch.cuda.device_count() < world:
            print(f"--data {args.data} --model {args.model}: {world} ranks "
                  f"need a CUDA card each; {torch.cuda.device_count()} "
                  f"found", file=sys.stderr)
            raise SystemExit(2)
        argv = sys.argv[1:] if argv is None else argv
        with tempfile.TemporaryDirectory() as d:
            torch.multiprocessing.start_processes(
                _rank_main, args=(argv, world, os.path.join(d, "store")),
                nprocs=world, start_method="spawn")
        return
    model = tfm.init_params(cfg, seed=0, dtype=DTYPES[args.dtype],
                            device=device)
    serve(cfg, model, make_requests(cfg, args), args, device)


def _rank_main(rank: int, argv, world: int, store: str) -> None:
    """A spawned rank of ``--data D --model M``: one torch thread on the
    CPU, then ``serve_rank``."""
    args = build_parser().parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
    _flags(args)
    serve_rank(make_config(args), args, rank=rank, world=world,
               init_method="file://" + store)


def serve_rank(cfg, args, rank=None, world=None, init_method=None) -> None:
    """One rank of a mesh run: its place in the mesh, the seeded whole
    model cut to its shard, then ``serve`` (rank 0 drives and prints;
    the other ranks answer its commands and print nothing but errors)."""
    device = resolve_device(args.device)
    if rank is not None and device.type == "cuda":
        os.environ["LOCAL_RANK"] = str(rank)
    device = mesh_mod.init_distributed(
        args.data, args.model, device.type, rank=rank, world_size=world,
        init_method=init_method, timeout=driver.TIMEOUT)
    quiet = torch.distributed.get_rank() != 0
    try:
        with contextlib.ExitStack() as stack:
            if quiet:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            _serve_on_mesh(cfg, args, device, quiet)
    finally:
        context.set_mesh(None)
        torch.distributed.destroy_process_group()


def _serve_on_mesh(cfg, args, device, quiet: bool) -> None:
    mesh = mesh_mod.make_host_mesh(args.data, args.model, device.type)
    context.set_mesh(mesh)
    model = tfm.init_params(cfg, seed=0, dtype=DTYPES[args.dtype],
                            device=device)
    partition.shard_model(cfg, model, mesh)
    print(f"mesh: {mesh.shape}; params sharded", flush=True)
    serve(cfg, model, [] if quiet else make_requests(cfg, args), args,
          device, mesh)
    sys.stdout.flush()


def main_sim(cfg, args) -> None:
    """``--backend sim``: the reference launcher's cost-model path, its
    host spill budget defaulting to 4x the pool as the reference's."""
    if args.kv_spill and args.host_pool_tokens is None:
        args.host_pool_tokens = 4 * (args.pool_tokens
                                     or args.slots * cfg.max_seq_len)
    if not args.kv_spill:
        args.host_pool_tokens = None
    plan = FaultPlan.parse(args.fault_plan) if args.fault_plan else None
    reqs = make_requests(cfg, args)
    if args.drain_after is not None:
        _drain_resume_sim(cfg, args, reqs, plan)
        return
    recorder = TraceRecorder() if (args.trace_record
                                   or args.trace_replay) else None
    tracer = Tracer() if args.trace_out else None
    _run_sim(cfg, args, reqs, recorder, tracer, plan)
    _finish_trace(args, recorder)
    _finish_timeline(args, tracer)


if __name__ == "__main__":
    main()
