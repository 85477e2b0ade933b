"""Serving launcher: BucketServe on the unified serving loop, PyTorch
backend.

    PYTHONPATH=src python -m repro_torch.launch.serve --backend torch \\
        --arch qwen3-14b --max-seq-len 4096 [--smoke] [--device cuda|cpu] \\
        [--dtype bf16|f32] [--chunk 512] [--paged --page-size 128] \\
        [--requests 16]

``--backend torch`` runs the real engine (``core/engine.py``): eager
prefill and decode with slot-pool continuous batching, the attention
products on the hand-written CUDA kernels when ``--device cuda`` (the
default; it raises without a card).  ``--chunk N`` enables chunked
prefill, ``--paged`` swaps the per-slot KV caches for the shared page
pool (the scheduler then runs the ceil-to-page Eq.-(6) memory model).
``--smoke`` serves the reduced config with the plain PyTorch path
running on the CPU when ``--device cpu`` is given.  ``--arch rwkv6-3b``
serves RWKV6 on the contiguous slot pool (its per-slot carry has no K/V
to page, so ``--paged`` is refused), through the hand-written WKV6
kernel on the card.

At full width on one 80 GB card, pass ``--max-seq-len 4096``: with the
config's 32768 the per-job prefill cache alone (slots x 32768 tokens x
160 KiB for Qwen3-14B) does not fit beside the weights.  Without
``--pool-tokens`` the paged pool takes 40% of the device memory left
free after the weights.

The output keeps the reference launcher's greppable line
(``served N/N requests, T tokens in Xs; prefill shapes: ...; buckets:
[...]``) and adds one line with each kernel's launch count.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import (BucketServeScheduler, GoodputScheduler,
                              MemoryBudget, SchedulerConfig)
from repro_torch.core.engine import ServingEngine
from repro_torch.data.workload import WorkloadSpec, generate
from repro_torch.device import resolve_device
from repro_torch.kernels import runtime
from repro_torch.models import transformer as tfm

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _make_sched(cfg, budget, args):
    cls = GoodputScheduler if args.sched == "goodput" \
        else BucketServeScheduler
    return cls(cfg, budget, SchedulerConfig(
        max_batch=args.slots, memory_model="paged" if args.paged else "sum",
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


def default_pool_tokens(cfg, model, device: torch.device):
    """Paged pool size when none is given: 40% of the device memory still
    free after the weights, the rest left to the per-job prefill cache
    and activations.  None on the CPU, where the engine's default (slots
    x cache length) stands."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return int(0.4 * free) // cfg.kv_bytes_per_token(
        model.embed.element_size())


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="torch", choices=["torch"],
                    help="the PyTorch engine (the cost model arrives with "
                         "a later slice)")
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
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=None,
                    help="cache length per request (default: the "
                         "config's; 256 with --smoke)")
    ap.add_argument("--sched", default="bucket",
                    choices=["bucket", "goodput"])
    return ap


def make_config(args):
    max_seq = args.max_seq_len or (256 if args.smoke else None)
    if args.smoke:
        return get_smoke_config(args.arch, max_seq_len=max_seq)
    cfg = get_config(args.arch)
    if max_seq:
        cfg = dataclasses.replace(cfg, max_seq_len=max_seq)
    return cfg


def make_requests(cfg, args, max_new: int = 8):
    """The reference launcher's mixed workload (8 req/s), generated
    tokens capped at ``max_new`` and prompts clipped to the window."""
    spec = WorkloadSpec(dataset="mixed", rps=8.0, n_requests=args.requests,
                        max_model_len=cfg.max_seq_len,
                        vocab_size=cfg.vocab_size)
    reqs = generate(spec)
    for r in reqs:
        r.max_new_tokens = min(r.max_new_tokens, max_new)
        r.prompt_len = min(r.prompt_len, cfg.max_seq_len - max_new - 1)
    return reqs


def serve(cfg, model, reqs, args, device: torch.device):
    """Serve ``reqs`` and print the launcher's summary lines; returns
    (engine, finished requests, seconds)."""
    budget = MemoryBudget(hbm_bytes_per_device=device_memory_bytes(device),
                          n_devices=1,
                          weight_bytes=cfg.param_count()
                          * model.embed.element_size())
    sched = _make_sched(cfg, budget, args)
    pool_tokens = args.pool_tokens
    if args.paged and pool_tokens is None:
        pool_tokens = default_pool_tokens(cfg, model, device)
    engine = ServingEngine(cfg, model, sched, max_slots=args.slots,
                           cache_len=cfg.max_seq_len,
                           chunk_tokens=args.chunk, paged=args.paged,
                           page_size=args.page_size,
                           kv_pool_tokens=pool_tokens, device=device)
    runtime.reset_launch_counts()
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
        paged_info = (f"pages: {be.alloc.n_pages} x {be.page_size} tok, "
                      f"free {be.free_blocks()}; "
                      f"peak pool {engine.result.peak_pool}; "
                      f"preemptions {engine.result.preempt_events}; ")
    print(f"served {len(done)}/{len(reqs)} requests, {toks} tokens in "
          f"{dt:.1f}s; prefill shapes: {engine.n_prefill_shapes}; "
          f"decode steps interleaved between prefill chunks: "
          f"{engine.interleaved_decode_steps}; {paged_info}"
          f"buckets: {[(b.low, b.up) for b in sched.buckets.buckets]}")
    res = engine.result
    print(f"tails: TTFT p50/p95/p99 {res.p50('ttft'):.3f}/"
          f"{res.p95('ttft'):.3f}/{res.p99('ttft'):.3f} s, "
          f"TPOT p50/p99 {res.p50('tpot') * 1e3:.1f}/"
          f"{res.p99('tpot') * 1e3:.1f} ms")
    print("kernel launches: " + ", ".join(
        f"{k} {v}" for k, v in runtime.launch_counts.items()))
    return engine, done, dt


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = make_config(args)
    if args.paged and not tfm.supports_paged_decode(cfg):
        ap.error(f"--paged: {cfg.name} has no self-attention KV to page; "
                 f"serve it on the contiguous slot pool (without --paged)")
    model = tfm.init_params(cfg, seed=0, dtype=DTYPES[args.dtype],
                            device=device)
    serve(cfg, model, make_requests(cfg, args), args, device)


if __name__ == "__main__":
    main()
