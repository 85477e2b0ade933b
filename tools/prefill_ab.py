#!/usr/bin/env python3
"""Time the bf16 ``flash_prefill`` kernel of one or more checkouts on
one card, in turns, at the prefill shapes of ``chip_smoke.py``'s kernel
rows.

    python tools/prefill_ab.py --trees OLD . . OLD [--out FILE]

Each entry of ``--trees`` is the root of a checkout (for instance a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists); each runs in a process of its own, in the order
given, with that checkout's ``src`` first on the path, so its kernels
are built from its own sources.  A run prints one JSON line a shape:
the CUDA-event ms of one call (the mean of 20 back-to-back calls after
3, queued behind a sleep kernel as ``chip_smoke.py:time_ms`` does, so
the host's launch time hides), the body the wrapper counted, and the
largest difference from the plain version.  The parent prints, for
each shape, every turn's ms and each checkout's mean, and writes them
with the card's name and power limit to ``--out``.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# (name, B, Tq, Tk, H, Hkv, Dh, causal, window, q_offset, lengths)
SHAPES = [
    ("qwen3-14b T=2048", 1, 2048, 2048, 40, 8, 128, True, 0, 0, [2048]),
    ("qwen3-14b chunk 512@1536/4096", 1, 512, 4096, 40, 8, 128, True, 0,
     1536, None),
    ("hubert-xlarge B=8 T=1500 Dh=80 non-causal", 8, 1500, 1500, 16, 16, 80,
     False, 0, 0, [1500, 1200, 900, 600] * 2),
    ("nemotron-4-340b chunk 512@1536/4096 Dh=192", 1, 512, 4096, 96, 8, 192,
     True, 0, 1536, None),
    ("recurrentgemma-2b T=4096 window 2048 H=10 Dh=256", 1, 4096, 4096, 10, 1,
     256, True, 2048, 0, [4096]),
    ("recurrentgemma-2b --model 2 rank H=5", 1, 4096, 4096, 5, 1, 256, True,
     2048, 0, [4096]),
]
ITERS, WARMUP = 20, 3


def time_ms(torch, fn) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    cycles_per_ms = 2e7 / start.elapsed_time(end)
    torch.cuda._sleep(int(cycles_per_ms * (2 * ITERS * host_ms + 1.0)))
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def worker() -> int:
    import torch
    import repro_torch
    from repro_torch.kernels import ops, ref, runtime
    dev = torch.device("cuda")
    runtime.library()
    for name, B, Tq, Tk, H, Hkv, Dh, causal, window, off, lens in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(11)
        q, k, v = (torch.randn(s, generator=gen, device=dev).bfloat16()
                   for s in ((B, Tq, H, Dh), (B, Tk, Hkv, Dh),
                             (B, Tk, Hkv, Dh)))
        lt = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device=dev)

        def call():
            return ops.flash_prefill(q, k, v, lt, causal=causal,
                                     window=window, q_offset=off)
        runtime.reset_launch_counts()
        got = call()
        body = [b for b, n in runtime.prefill_body_counts.items() if n]
        want = ref.flash_prefill_ref(q, k, v, lt, causal=causal,
                                     window=window, q_offset=off)
        if lt is not None:      # rows past a length are not compared
            rows = torch.arange(Tq, device=dev)[None] < lt[:, None]
            got, want = got[rows], want[rows]
        err = float((got.float() - want.float()).abs().max())
        print(json.dumps(dict(shape=name, ms=time_ms(torch, call),
                              body=body, max_abs_err=err,
                              package=repro_torch.__file__)), flush=True)
        del q, k, v, got, want
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        return worker()
    import torch
    if not torch.cuda.is_available():
        print("prefill_ab: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    turns = []
    for tree in args.trees:
        root = Path(tree).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        p = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker"],
            env=env, cwd=root, capture_output=True, text=True)
        if p.returncode:
            print(p.stdout + p.stderr, file=sys.stderr)
            return p.returncode
        rows = [json.loads(x) for x in p.stdout.splitlines()
                if x.startswith("{")]
        turns.append(dict(tree=tree, rows=rows))
        for r in rows:
            print(f"{tree}: {r['shape']}: {r['ms']:.4f} ms, body "
                  f"{'/'.join(r['body'])}, max abs err "
                  f"{r['max_abs_err']:.3g}", flush=True)
    means = {}
    for name, *_ in SHAPES:
        for tree in dict.fromkeys(args.trees):
            ms = [r["ms"] for t in turns if t["tree"] == tree
                  for r in t["rows"] if r["shape"] == name]
            means.setdefault(name, {})[tree] = sum(ms) / len(ms)
        print(f"{name}: " + ", ".join(f"{t} {m:.4f} ms"
                                      for t, m in means[name].items()))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, turns=turns,
                                            means=means), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
