"""Quickstart: BucketServe serving a tiny model end to end.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--arch qwen3-14b] [--chunk 32] [--device cuda|cpu]

Twin of the reference's ``examples/quickstart.py``.  Builds the reduced
config, initializes seeded random weights on the device, submits a burst
of mixed-length requests and serves them through the full stack:
adaptive bucketing -> memory-safe batch formation -> prefill (eager;
one shape per bucket pad and batch) -> slot-based continuous-batching
decode, captured as a CUDA graph on the card, all orchestrated by the
event-driven ``ServingLoop`` (``core/serving_loop.py``).  ``--chunk N``
turns on chunked prefill: decode iterations interleave between N-token
prompt chunks instead of stalling behind a whole long prefill.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.core import (BucketServeScheduler, MemoryBudget, Request,
                              SchedulerConfig, TaskType)
from repro_torch.core.engine import ServingEngine
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=None,
                    help="chunked-prefill span in tokens")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch, max_seq_len=128)
    print(f"arch={cfg.name} family={cfg.arch_type} "
          f"layers={cfg.n_layers} d_model={cfg.d_model} device={device}")
    model = tfm.init_params(cfg, seed=0, device=device)

    budget = MemoryBudget(hbm_bytes_per_device=2 ** 30, n_devices=1,
                          weight_bytes=0)
    sched = BucketServeScheduler(cfg, budget,
                                 SchedulerConfig(max_batch=args.slots))
    engine = ServingEngine(cfg, model, sched, max_slots=args.slots,
                           cache_len=128, chunk_tokens=args.chunk,
                           device=device)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt_len=int(rng.choice([12, 16, 60, 90])),
                    max_new_tokens=int(rng.integers(4, 12)),
                    arrival=0.0, task_type=TaskType.ONLINE)
            for i in range(args.requests)]
    engine.submit(reqs)
    t0 = time.perf_counter()
    done = engine.run(max_wall_s=600)
    dt = time.perf_counter() - t0

    tokens = sum(r.generated for r in done)
    print(f"\nserved {len(done)}/{len(reqs)} requests, {tokens} tokens "
          f"in {dt:.1f}s ({tokens / dt:.1f} tok/s on {device.type})")
    print(f"buckets now: {[(b.low, b.up) for b in sched.buckets.buckets]}")
    print(f"prefill shapes: {engine.n_prefill_shapes} (bucketing bounds "
          f"the shapes a prefill takes)")
    if args.chunk:
        print(f"decode steps interleaved between prefill chunks: "
              f"{engine.interleaved_decode_steps}")
    for r in done[:5]:
        print(f"  rid={r.rid:3d} S={r.prompt_len:3d} new={r.generated:2d} "
              f"out={engine.outputs[r.rid][:8]}")
    return done


if __name__ == "__main__":
    main()
