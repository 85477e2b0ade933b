#!/usr/bin/env python3
"""Time ``wkv6``'s backward kernel (``csrc/wkv6_bwd.cu``) of one or more
checkouts on one card, in turns, at rwkv6-3b's three shapes: a training
step's (B 2, T 4095, 40 heads of 64), the serving chunk's (B 8, T 512, 40
heads) and a ``--model 4`` rank's chunk (B 8, T 512, 10 heads).

    python tools/wkv6_bwd_ab.py --trees OLD . . OLD [--out FILE] \\
        [--phases] [--nc]

Each entry of ``--trees`` is the root of a checkout (for instance a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists); each runs in a process of its own, in the order
given, with that checkout's ``src`` first on the path, so its kernels
are built from its own sources.  The operands are bf16 r, k, v, the
model's decay exp(-exp(x - 0.5)), a random s0 and dy, dsT absent (as in
training).  A run prints one JSON line a shape: the CUDA-event ms of one
``ops.wkv6_bwd`` call (the mean of 10 back-to-back calls after 2,
queued behind a sleep kernel so the host's launch time hides), the
clock cycles that makes a step (ms times the SM clock, measured by the
sleep kernel, over T), the bound (``kernels/cost.py:wkv6_bwd`` at the
f32 CUDA-core peak, 67 TFLOP/s), the largest error of each gradient
relative to its largest magnitude against ``ref.wkv6_bwd_ref``, whether
two calls gave the same bits, and the plan (cluster size and threads a
block, with the blocks an SM from ``cudaOccupancyMaxActiveClusters``)
where the checkout has one.  With ``--nc``, a checkout with the
cluster entry (``rt_wkv6_bwd_nc``) also times each cluster size its
head size allows, checked the same way.  With ``--phases``, a checkout
whose kernel has the phase profile (``RT_WKV_BWD_PHASES``) also builds
``wkv6_bwd.cu`` alone with it and prints, for each shape, lane 0's
clock cycles a chunk in each phase: the forward pass's advance, loads
and stores, and block barrier; the reverse pass's previous rows out
with the rank-1 dots, replay, store of the next operands, backward
steps, folds and pushes, wait for the previous chunk's dv partials,
previous dv out, next loads, and block barrier.  The
parent prints every turn's ms and each checkout's mean, and writes them
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

# (name, B, T, H, hs)
SHAPES = [
    ("training B=2 T=4095 H=40", 2, 4095, 40, 64),
    ("chunk B=8 T=512 H=40", 8, 512, 40, 64),
    ("rank B=8 T=512 H=10", 8, 512, 10, 64),
]
ITERS, WARMUP = 10, 2
F32_FLOPS = 67e12                 # H100 SXM f32 CUDA cores
HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
# csrc/wkv6_bwd.cu: kBwdPhases, in their order
PHASES = ("fwd advance", "fwd loads", "fwd barrier", "rows out+rank-1",
          "replay", "put", "backward", "fold+push", "dv wait", "dv out",
          "fetch", "block barrier")
FWD_PHASES = 3
# each gradient's error over its largest magnitude (chip_smoke.py:
# WKV_BWD_REL; dr, dk, dv are bf16 here)
REL = {"dr": 8e-3, "dk": 8e-3, "dv": 8e-3, "dw": 1e-4, "du": 1e-4,
       "ds0": 1e-4}


def cycles_per_ms(torch) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 2e7 / start.elapsed_time(end)


def time_ms(torch, fn, clock) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(clock * (2 * ITERS * host_ms + 1.0)))
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def errors(torch, got, want) -> dict:
    """Each gradient's largest error over its largest magnitude."""
    out = {}
    for name, g, w in zip(REL, got, want):
        if g.shape != w.shape or g.dtype != w.dtype or \
                not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: {g.dtype} {tuple(g.shape)} "
                                 f"against {w.dtype} {tuple(w.shape)}")
        scale = float(w.abs().max())
        out[name] = float((g.double() - w.double()).abs().max()) / scale \
            if scale else 0.0
    return out


def nc_call(torch, lib, args, dy, nc):
    """One launch of ``rt_wkv6_bwd_nc`` (counts no launch); returns the
    six gradients."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels import wkv6 as wk
    r, k, v, w, u, s0 = args
    B, T, H, hs = r.shape
    f32 = dict(dtype=torch.float32, device=r.device)
    ckpt = torch.empty(B * H * -(-T // wk.BWD_CHUNK) * hs * hs, **f32)
    du_part = torch.empty(B * H * hs, **f32)
    out = [torch.empty_like(x) for x in (r, k, v)] + [
        torch.empty(r.shape, **f32), torch.empty((H, hs), **f32),
        torch.empty_like(s0)]
    err = lib.rt_wkv6_bwd_nc(
        *(x.data_ptr() for x in (r, k, v, w, u, s0, dy)), None,
        *(x.data_ptr() for x in out), ckpt.data_ptr(), du_part.data_ptr(),
        B, T, H, hs, runtime.DTYPE_CODES[r.dtype], nc,
        runtime.stream_ptr(r.device))
    if err:
        raise RuntimeError(f"rt_wkv6_bwd_nc nc={nc}: error {err}")
    return out


def occupancy(lib, hs, nc):
    """(threads, shared memory bytes, blocks an SM, registers) of the
    cluster size on this card."""
    import ctypes
    import torch
    from repro_torch.kernels import runtime
    out = (ctypes.c_int * 4)()
    if lib.rt_wkv6_bwd_occupancy(hs, runtime.DTYPE_CODES[torch.bfloat16],
                                 nc, out):
        raise RuntimeError(f"rt_wkv6_bwd_occupancy nc={nc} failed")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return out[0], out[1], out[2] * nc / sms, out[3]


def phase_profile(torch, plib, args, dy, nc):
    """{phase: cycles a chunk (lane 0 of a warp)} of one call of the
    instrumented build at cluster size ``nc``."""
    import ctypes
    n = len(PHASES)
    counts = (ctypes.c_ulonglong * (n + 3))()
    nc_call(torch, plib, args, dy, nc)
    torch.cuda.synchronize()
    if plib.rt_wkv6_bwd_phases(None, 1):
        raise RuntimeError("rt_wkv6_bwd_phases reset failed")
    nc_call(torch, plib, args, dy, nc)
    torch.cuda.synchronize()
    if plib.rt_wkv6_bwd_phases(ctypes.addressof(counts), 0):
        raise RuntimeError("rt_wkv6_bwd_phases read failed")
    fwd, rev = counts[n], counts[n + 1]
    return {p: counts[i] / (fwd if i < FWD_PHASES else rev)
            for i, p in enumerate(PHASES)}


def worker(phases: bool, every_nc: bool) -> int:
    import ctypes
    import torch
    import repro_torch
    from repro_torch.kernels import cost, ops, ref, runtime
    from repro_torch.kernels import wkv6 as wk
    dev = torch.device("cuda")
    lib = runtime.library()
    has_plan = hasattr(wk, "bwd_plan")
    plib = None
    if phases and "RT_WKV_BWD_PHASES" in (runtime.CSRC /
                                          "wkv6_bwd.cu").read_text():
        plib = ctypes.CDLL(str(runtime.build(
            sources=("wkv6_bwd.cu",), defines=("RT_WKV_BWD_PHASES",))))
        plib.rt_wkv6_bwd_nc.argtypes = runtime._SIGNATURES["rt_wkv6_bwd_nc"]
        plib.rt_wkv6_bwd_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    clock = cycles_per_ms(torch)
    for name, B, T, H, hs in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(35)

        def rnd(shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale
        r, k, v = (rnd((B, T, H, hs)).to(torch.bfloat16) for _ in range(3))
        w = torch.exp(-torch.exp(rnd((B, T, H, hs)) - 0.5))
        args = (r, k, v, w, rnd((H, hs), 0.1), rnd((B, H, hs, hs), 0.1))
        dy = rnd((B, T, H, hs))
        got, again = ops.wkv6_bwd(*args, dy), ops.wkv6_bwd(*args, dy)
        want = ref.wkv6_bwd_ref(*args, dy)
        rel = errors(torch, got, want)
        ms = time_ms(torch, lambda: ops.wkv6_bwd(*args, dy), clock)
        work = cost.wkv6_bwd(B, T, H, hs, 2, state_grad=False)
        row = dict(
            shape=name, ms=ms, cycles_a_step=ms * clock / T,
            bound_ms=max(work.flops / F32_FLOPS,
                         work.bytes / HBM_BYTES_PER_S) * 1e3,
            rel_err=rel, ok=all(rel[g] <= REL[g] for g in REL),
            same_bits_twice=all(torch.equal(a, b)
                                for a, b in zip(got, again)),
            sm_clock_mhz=clock / 1e3, package=repro_torch.__file__)
        del got, again
        if has_plan:
            p = wk.bwd_plan(B, H, hs, T)
            row["plan"] = dict(nc=p.nc, threads=p.threads,
                               blocks=B * H * p.nc)
            row["plan"].update(zip(("threads", "smem_bytes",
                                    "blocks_an_sm", "registers"),
                                   occupancy(lib, hs, p.nc)))
            sweep = {}
            for nc in (wk.BWD_CLUSTERS if every_nc else ()):
                if not wk.bwd_valid(hs, nc):
                    continue
                e = errors(torch, nc_call(torch, lib, args, dy, nc), want)
                if any(e[g] > REL[g] for g in REL):
                    row["ok"] = False
                sweep[nc] = dict(ms=time_ms(
                    torch, lambda: nc_call(torch, lib, args, dy, nc), clock),
                    max_rel_err=max(e.values()),
                    blocks_an_sm=occupancy(lib, hs, nc)[2])
            if sweep:
                row["sweep"] = sweep
            if plib is not None:
                row["phase_cycles"] = phase_profile(torch, plib, args, dy,
                                                    p.nc)
        print(json.dumps(row), flush=True)
        del args, dy, want, r, k, v, w
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--nc", action="store_true")
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.phases, args.nc)
    import torch
    if not torch.cuda.is_available():
        print("wkv6_bwd_ab: needs a CUDA card", file=sys.stderr)
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
            [sys.executable, str(Path(__file__).resolve()), "--worker"]
            + (["--phases"] if args.phases else [])
            + (["--nc"] if args.nc else []),
            env=env, cwd=root, capture_output=True, text=True)
        if p.returncode:
            print(p.stdout + p.stderr, file=sys.stderr)
            return p.returncode
        rows = [json.loads(x) for x in p.stdout.splitlines()
                if x.startswith("{")]
        turns.append(dict(tree=tree, rows=rows))
        for r in rows:
            plan = r.get("plan")
            print(f"{tree}: {r['shape']}: {r['ms']:.4f} ms "
                  f"({r['cycles_a_step']:.0f} cycles a step at "
                  f"{r['sm_clock_mhz']:.0f} MHz), bound {r['bound_ms']:.4f}"
                  f" ms, largest relative error "
                  f"{max(r['rel_err'].values()):.3g}, same bits twice "
                  f"{r['same_bits_twice']}"
                  + (f", plan NC {plan['nc']}, {plan['threads']} threads, "
                     f"{plan['blocks']} blocks, {plan['smem_bytes']} B "
                     f"shared, {plan['registers']} registers, "
                     f"{plan['blocks_an_sm']:.2f} blocks an SM"
                     if plan else ""), flush=True)
            for nc, s in r.get("sweep", {}).items():
                print(f"{tree}: {r['shape']}: NC {nc}: {s['ms']:.4f} ms, "
                      f"{s['blocks_an_sm']:.2f} blocks an SM, largest "
                      f"relative error {s['max_rel_err']:.3g}", flush=True)
            if "phase_cycles" in r:
                print(f"{tree}: {r['shape']}: clock cycles a chunk (lane 0 "
                      f"of a warp) " + ", ".join(
                          f"{p} {c:.0f}" for p, c in
                          r["phase_cycles"].items()), flush=True)
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
    bad = [(t["tree"], r["shape"]) for t in turns for r in t["rows"]
           if not (r["ok"] and r["same_bits_twice"])]
    if bad:
        print(f"wkv6_bwd_ab: wrong or unrepeatable gradients at {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
