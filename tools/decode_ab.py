#!/usr/bin/env python3
"""Time the two int8 decode kernels of one or more checkouts on one card,
in turns, at the int8 kernel rows' shapes of ``chip_smoke.py``, beside
the bf16 kernel of the same pool over the dequantized cache.

    python tools/decode_ab.py --trees OLD . . OLD [--out FILE] [--phases]

Each entry of ``--trees`` is the root of a checkout (for instance a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists); each runs in a process of its own, in the order
given, with that checkout's ``src`` first on the path, so its kernels
are built from its own sources.  A run prints one JSON line a shape:
the CUDA-event ms of one int8 call and of one bf16 call (the mean of 50
back-to-back calls after 3, queued behind a sleep kernel as
``chip_smoke.py:time_ms`` does, so the host's launch time hides), the
bound (``kernels/cost.py:decode(int8=True)`` at 3.35 TB/s), the largest
difference from the plain int8 version, whether the int8 kernel gave
the bf16 kernel's bits over the dequantized cache and the same bits
twice, and the plan.  The parent prints, for each shape, every turn's
ms and each checkout's mean, and writes them with the card's name and
power limit to ``--out``.  With ``--phases``, each run whose checkout has
the int8 body's phase profile (``csrc/decode_common.cuh``,
``RT_DECODE_PHASES``) also builds ``decode_attn.cu`` alone with it and
prints, for each contiguous shape, the clock cycles lane 0 of a warp
spends in each phase: before the slot loop and in the merge a warp, and
a step's copies, wait and body a tile.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# (name, B, S, H, Hkv, Dh, live slots a row, page; 0: contiguous)
SHAPES = [
    ("qwen3-14b B=8 ctx=2048 page=128", 8, 4096, 40, 8, 128, 2048, 128),
    ("qwen3-14b B=8 ctx=2048 contiguous", 8, 4096, 40, 8, 128, 2048, 0),
    ("qwen3-14b serve step B=8 ctx=1024 page=128", 8, 4096, 40, 8, 128,
     1024, 128),
    ("qwen3-14b serve step B=8 ctx=1024 contiguous", 8, 4096, 40, 8, 128,
     1024, 0),
    ("nemotron-4-340b Dh=192 G=12 B=8 ctx=2048 page=128", 8, 4096, 96, 8,
     192, 2048, 128),
    ("nemotron-4-340b Dh=192 G=12 B=8 ctx=2048 contiguous", 8, 4096, 96, 8,
     192, 2048, 0),
]
ITERS, WARMUP = 50, 3
HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
# csrc/decode_common.cuh: kDecPhases, in their order
PHASES = ("start", "issue", "wait", "body", "finish")


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


def phase_profile(torch, lib, q, kc, vc, ks, vs, pos, plan):
    """{phase: cycles} of one rt_flash_decode_int8 call of the build with
    the profile: ``start`` and ``finish`` a warp, the rest a tile."""
    import ctypes
    from repro_torch.kernels import runtime
    dev = q.device
    B, H, Dh = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    out = torch.empty_like(q)
    part = torch.empty((B, H, plan.n_split, Dh + 2), device=dev)
    arrivals = torch.zeros(B * Hkv, dtype=torch.int32, device=dev)

    def call():
        err = lib.rt_flash_decode_int8(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), ks.data_ptr(),
            vs.data_ptr(), pos.data_ptr(), out.data_ptr(), None,
            part.data_ptr(), arrivals.data_ptr(), B, S, H, Hkv, Dh, 0,
            plan.L, plan.n_split, runtime.DTYPE_CODES[q.dtype],
            runtime.stream_ptr(dev))
        if err:
            raise RuntimeError(f"instrumented flash_decode_int8: {err}")
    n = len(PHASES)
    counts = (ctypes.c_ulonglong * (n + 2))()
    call()
    torch.cuda.synchronize()
    if lib.rt_decode_phases(None, 1):
        raise RuntimeError("rt_decode_phases reset failed")
    call()
    torch.cuda.synchronize()
    if lib.rt_decode_phases(ctypes.addressof(counts), 0):
        raise RuntimeError("rt_decode_phases read failed")
    tiles, warps = counts[n], counts[n + 1]
    return {p: counts[i] / (warps if p in ("start", "finish") else tiles)
            for i, p in enumerate(PHASES)}


def worker(phases: bool) -> int:
    import ctypes
    import torch
    import repro_torch
    from repro_torch.kernels import cost, ops, ref, runtime
    from repro_torch.models.attention import quantize_kv
    dev = torch.device("cuda")
    runtime.library()
    plib = None
    if phases and "RT_DECODE_PHASES" in (runtime.CSRC /
                                         "decode_common.cuh").read_text():
        plib = ctypes.CDLL(str(runtime.build(
            sources=("decode_attn.cu",), defines=("RT_DECODE_PHASES",))))
        plib.rt_flash_decode_int8.argtypes = \
            runtime._SIGNATURES["rt_flash_decode_int8"]
        plib.rt_decode_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    bf16 = torch.bfloat16
    for name, B, S, H, Hkv, Dh, ctx, page in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(34)

        def rnd(shape):
            return torch.randn(shape, generator=gen, device=dev)
        q = rnd((B, H, Dh)).to(bf16)
        kc, ks = quantize_kv(rnd((B, S, Hkv, Dh)))
        vc, vs = quantize_kv(rnd((B, S, Hkv, Dh)))
        pos = torch.full((B,), ctx - 1, dtype=torch.int32, device=dev)
        if page:
            n_p = S // page
            bt = torch.randperm(B * n_p + 1, generator=gen, device=dev)[
                :B * n_p].reshape(B, n_p).to(torch.int32)
            pools = []
            for t in (kc, vc, ks, vs):
                pl = t.new_zeros((B * n_p + 1, page) + tuple(t.shape[2:]))
                pl[bt.reshape(-1).long()] = t.reshape(
                    (B * n_p, page) + tuple(t.shape[2:]))
                pools.append(pl)
            kd = ref.dequantize_kv(pools[0], pools[2], bf16)
            vd = ref.dequantize_kv(pools[1], pools[3], bf16)
            kernel = "paged_flash_decode_int8"

            def int8():
                return ops.paged_flash_decode_int8(q, *pools, bt, pos,
                                                   s_len=S)

            def float_():
                return ops.paged_flash_decode(q, kd, vd, bt, pos, s_len=S)
        else:
            kd = ref.dequantize_kv(kc, ks, bf16)
            vd = ref.dequantize_kv(vc, vs, bf16)
            kernel = "flash_decode_int8"

            def int8():
                return ops.flash_decode_int8(q, kc, vc, ks, vs, pos)

            def float_():
                return ops.flash_decode(q, kd, vd, pos)
        got, again = int8(), int8()
        want = ref.flash_decode_int8_ref(q, kc, vc, ks, vs, pos)
        work = cost.decode(B, H, Hkv, Dh, 2, ctx, int8=True, page=page)
        plan = runtime.decode_plans[kernel]
        extra = {}
        if plib is not None and not page:
            extra["phase_cycles"] = phase_profile(torch, plib, q, kc, vc, ks,
                                                  vs, pos, plan)
        print(json.dumps(dict(
            shape=name, int8_ms=time_ms(torch, int8),
            bf16_ms=time_ms(torch, float_),
            bound_ms=work.bytes / HBM_BYTES_PER_S * 1e3,
            max_abs_err=float((got.float() - want.float()).abs().max()),
            same_bits_as_bf16=bool(torch.equal(got, float_())),
            same_bits_twice=bool(torch.equal(got, again)),
            plan=[plan.n_split, plan.L, plan.body],
            package=repro_torch.__file__, **extra)), flush=True)
        del q, kc, vc, ks, vs, kd, vd, got, again, want
        if page:
            del pools
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.phases)
    import torch
    if not torch.cuda.is_available():
        print("decode_ab: needs a CUDA card", file=sys.stderr)
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
            + (["--phases"] if args.phases else []),
            env=env, cwd=root, capture_output=True, text=True)
        if p.returncode:
            print(p.stdout + p.stderr, file=sys.stderr)
            return p.returncode
        rows = [json.loads(x) for x in p.stdout.splitlines()
                if x.startswith("{")]
        turns.append(dict(tree=tree, rows=rows))
        for r in rows:
            print(f"{tree}: {r['shape']}: int8 {r['int8_ms']:.4f} ms, bf16 "
                  f"{r['bf16_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, "
                  f"plan {r['plan']}, max abs err {r['max_abs_err']:.3g}, "
                  f"bf16's bits {r['same_bits_as_bf16']}, same bits twice "
                  f"{r['same_bits_twice']}", flush=True)
            if "phase_cycles" in r:
                print(f"{tree}: {r['shape']}: clock cycles " + ", ".join(
                    f"{p} {c:.0f}" for p, c in r["phase_cycles"].items())
                    + " (start and finish a warp, the rest a tile)",
                    flush=True)
    means = {}
    for name, *_ in SHAPES:
        for tree in dict.fromkeys(args.trees):
            rows = [r for t in turns if t["tree"] == tree
                    for r in t["rows"] if r["shape"] == name]
            means.setdefault(name, {})[tree] = {
                k: sum(r[k] for r in rows) / len(rows)
                for k in ("int8_ms", "bf16_ms")}
        print(f"{name}: " + ", ".join(
            f"{t} int8 {m['int8_ms']:.4f} / bf16 {m['bf16_ms']:.4f} ms"
            for t, m in means[name].items()))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, turns=turns,
                                            means=means), indent=1))
    bad = [r["shape"] for t in turns for r in t["rows"]
           if not (r["same_bits_as_bf16"] and r["same_bits_twice"])]
    if bad:
        print(f"decode_ab: the int8 kernel broke its bit identities at "
              f"{bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
