"""Long-context serving across architecture families.

    PYTHONPATH=src python -m repro_torch.examples.long_context_serving \\
        [--device cuda|cpu]

Twin of the reference's ``examples/long_context_serving.py``.  Serves
requests through reduced RWKV6 (O(1) state), recurrentgemma
(window-bounded: RG-LRU carries and local-attention ring caches) and a
sliding-window dense variant — the three long-context families — and
prints the per-request live-memory accounting the Eq.-(6) batcher uses
for each.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import (BucketServeScheduler, MemoryBudget, Request,
                              SchedulerConfig, TaskType)
from repro_torch.core.engine import ServingEngine
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm

FAMILIES = (("rwkv6-3b", {}), ("recurrentgemma-2b", {}),
            ("qwen3-14b", {"sliding_window": 48}))


def memory_models():
    """(name, arch type, live GiB of a 32k-token request, window, state
    KiB) at full config scale, bf16."""
    rows = []
    for arch in ("qwen3-14b", "rwkv6-3b", "recurrentgemma-2b"):
        for variant in ("", "swa"):
            cfg = get_config(arch, variant=variant)
            win = cfg.sliding_window or (
                cfg.local_window if cfg.arch_type == "hybrid" else 0)
            tokens = min(32768, win) if win else 32768
            live = cfg.kv_bytes_per_token() * tokens + cfg.state_bytes()
            rows.append((cfg.name, cfg.arch_type, live / 2 ** 30, win,
                         cfg.state_bytes() // 1024))
            if cfg.arch_type in ("ssm", "hybrid"):
                break   # no separate swa variant
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("Eq.-(6) memory models at FULL config scale (per 32k-token "
          "request, bf16):")
    for name, kind, gib, win, state in memory_models():
        print(f"  {name:24s} [{kind:6s}] {gib:7.3f} GiB  "
              f"({'window ' + str(win) if win else 'full cache'}"
              f"{', state ' + str(state) + 'KiB' if state else ''})")

    print(f"\nServing 8 long-ish prompts through each family (reduced "
          f"configs, on {device.type}):")
    rng = np.random.default_rng(0)
    served = {}
    for arch, kw in FAMILIES:
        cfg = get_smoke_config(arch, max_seq_len=256, **kw)
        model = tfm.init_params(cfg, seed=0, device=device)
        sched = BucketServeScheduler(
            cfg, MemoryBudget(2 ** 30, 1, 0), SchedulerConfig(max_batch=4))
        eng = ServingEngine(cfg, model, sched, max_slots=4, cache_len=256,
                            device=device)
        reqs = [Request(rid=i, prompt_len=int(rng.integers(100, 200)),
                        max_new_tokens=6, arrival=0.0,
                        task_type=TaskType.OFFLINE) for i in range(8)]
        eng.submit(reqs)
        done = eng.run(max_wall_s=600)
        served[cfg.name] = {r.rid: list(eng.outputs[r.rid]) for r in done}
        print(f"  {cfg.name:28s} served {len(done)}/8, "
              f"outputs e.g. {eng.outputs[done[0].rid]}")
    return served


if __name__ == "__main__":
    main()
