#!/usr/bin/env python3
"""Where ``wkv6``'s backward kernel (``csrc/wkv6_bwd.cu``) spends its
time: copies of the kernel with one part taken out, timed in turns at the
training and chunk shapes of ``tools/wkv6_bwd_ab.py``, and the SMs the
launch's blocks ran on.

    PYTHONPATH=src python tools/wkv6_bwd_ablate.py [--out FILE]

Each variant is this checkout's ``wkv6_bwd.cu`` with some text replaced
(each replacement must match exactly once, so the tool stops when the
kernel changes under it), built alone with ``runtime.NVCC_FLAGS`` into a
temporary directory (every variant's ``nvcc`` started together) and
launched through ``rt_wkv6_bwd_nc`` at the plan's cluster size.  A
variant's gradients are wrong by design: only its time is read (CUDA
events, ``wkv6_bwd_ab.time_ms``).  The variants:

* ``base``: the kernel as it is;
* ``no_checkpoints``: the forward pass stores no checkpoint and the
  reverse pass copies none in;
* ``no_output``: no gradient of a row or of dv is stored;
* ``no_folds``: the shuffle trees return at once;
* ``forward_only``, ``forward_only_no_checkpoints``: the kernel ends
  after its forward pass.

``smid`` (not timed) records the SM of each block (``%smid``); the tool
prints how many SMs ran how many of the launch's blocks.  Needs one CUDA
card.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import wkv6_bwd_ab as ab  # noqa: E402

_STORE_CKPT = ("      if (c > 0) {\n#pragma unroll\n"
               "        for (int i = 0; i < KR; ++i)\n")
_FWD_END = """  for (int c = cl; c >= 0; --c) {
    const int slot = c % kBwdStages, b2 = c & 1;"""
_PATCHES = {
    "no_checkpoints": [
        (_STORE_CKPT, _STORE_CKPT.replace("c > 0", "false")),
        ("    if (c > 0) ck_issue(c - 1);\n", "")],
    "no_output": [
        ("""        dr[off] = rt::from_f<T>(tot[0] + uu * kk * vd);
        dk[off] = rt::from_f<T>(tot[R] + uu * rr * vd);
        dw[off] = tot[2 * R];""",
         "        if (tot[0] + tot[R] + tot[2 * R] == 1e30f) dw[off] = uu;"),
        ("""        dv[row_off(t0 + tl) + j] =
            rt::from_f<T>(fmaf(DYt[tl * HS + j], CB[b2 * C + tl], s));""",
         """        if (fmaf(DYt[tl * HS + j], CB[b2 * C + tl], s) == 1e30f)
          dw[0] = s;""")],
    "no_folds": [
        ("""__device__ __forceinline__ void fold(float (&a)[NV], int lg) {
  if constexpr (NL > 1) {""",
         """__device__ __forceinline__ void fold(float (&a)[NV], int lg) {
  if constexpr (NL < 0) {""")],
    "forward_only": [
        (_FWD_END, """  if (n_t > 0) {
    store_state(ds0 + static_cast<size_t>(bh) * HS * HS, S);
    return;
  }
""" + _FWD_END)],
}
_PATCHES["forward_only_no_checkpoints"] = (
    _PATCHES["forward_only"] + _PATCHES["no_checkpoints"][:1])
_SMID = [
    ("""  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;""",
     """  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  if (tid == 0 && blockIdx.x < 65536) {
    int id;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
    g_smid[blockIdx.x] = id;
  }"""),
    ("""template <typename T, int HS, int NC>
__global__ void __launch_bounds__""",
     """__device__ int g_smid[65536];

template <typename T, int HS, int NC>
__global__ void __launch_bounds__""")]
_SMID_ENTRY = """
extern "C" int rt_wkv6_bwd_smid(int* out, int n) {
  return cudaMemcpyFromSymbol(out, g_smid, sizeof(int) * n);
}
"""
VARIANTS = ["base", "no_checkpoints", "no_output", "no_folds",
            "forward_only", "forward_only_no_checkpoints"]


def variant_source(text: str, name: str) -> str:
    """The kernel's source with the variant's replacements."""
    for old, new in _SMID if name == "smid" else _PATCHES.get(name, []):
        if text.count(old) != 1:
            raise ValueError(f"{name}: {text.count(old)} matches of "
                             f"{old.strip()[:60]!r} in wkv6_bwd.cu")
        text = text.replace(old, new)
    return text + (_SMID_ENTRY if name == "smid" else "")


def build_all(names, tmp: Path) -> dict:
    """{variant: path of its shared library}, every nvcc started
    together."""
    from repro_torch.kernels import runtime
    text = (runtime.CSRC / "wkv6_bwd.cu").read_text()
    procs = {}
    for name in names:
        d = tmp / name
        d.mkdir()
        (d / "wkv6_bwd.cu").write_text(variant_source(text, name))
        cmd = (f"{runtime._nvcc()} {' '.join(runtime.NVCC_FLAGS)} -I "
               f"{runtime.CSRC} -c {d / 'wkv6_bwd.cu'} -o {d / 'k.o'} && "
               f"{runtime._nvcc()} {' '.join(runtime.NVCC_FLAGS)} -shared "
               f"{d / 'k.o'} -o {d / 'lib.so'}")
        procs[name] = subprocess.Popen(cmd, shell=True, text=True,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    return {name: tmp / name / "lib.so" for name in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("wkv6_bwd_ablate: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import runtime
    from repro_torch.kernels import wkv6 as wk
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        paths = build_all(VARIANTS + ["smid"], Path(tmp))
        libs = {}
        for name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            lib.rt_wkv6_bwd_nc.argtypes = \
                runtime._SIGNATURES["rt_wkv6_bwd_nc"]
            libs[name] = lib
        clock = ab.cycles_per_ms(torch)
        for shape, B, T, H, hs in ab.SHAPES[:2]:
            gen = torch.Generator(device=dev).manual_seed(35)

            def rnd(s, scale=1.0):
                return torch.randn(s, generator=gen, device=dev) * scale
            r, k, v = (rnd((B, T, H, hs)).to(torch.bfloat16)
                       for _ in range(3))
            w = torch.exp(-torch.exp(rnd((B, T, H, hs)) - 0.5))
            a = (r, k, v, w, rnd((H, hs), 0.1), rnd((B, H, hs, hs), 0.1))
            dy = rnd((B, T, H, hs))
            nc = wk.bwd_plan(B, H, hs, T).nc
            ms = collections.defaultdict(list)
            for _ in range(2):
                for name in VARIANTS:
                    ms[name].append(ab.time_ms(
                        torch, lambda: ab.nc_call(torch, libs[name], a, dy,
                                                  nc), clock))
            ab.nc_call(torch, libs["smid"], a, dy, nc)
            torch.cuda.synchronize()
            n = B * H * nc
            ids = (ctypes.c_int * n)()
            if libs["smid"].rt_wkv6_bwd_smid(ids, n):
                raise RuntimeError("rt_wkv6_bwd_smid failed")
            per_sm = collections.Counter(ids)
            hist = collections.Counter(per_sm.values())
            row = dict(shape=shape, nc=nc, ms={m: sum(x) / len(x)
                                               for m, x in ms.items()},
                       blocks=n, sms_used=len(per_sm),
                       sms=torch.cuda.get_device_properties(0)
                       .multi_processor_count,
                       sms_with_blocks=dict(sorted(hist.items())))
            rows.append(row)
            base = row["ms"]["base"]
            print(f"{shape} (NC {nc}): " + ", ".join(
                f"{m} {t:.4f} ms ({t / base - 1:+.1%})"
                for m, t in row["ms"].items()), flush=True)
            print(f"{shape}: {n} blocks on {row['sms_used']} of "
                  f"{row['sms']} SMs; SMs by blocks they ran: "
                  f"{row['sms_with_blocks']}", flush=True)
            del a, dy, r, k, v, w
            torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, rows=rows),
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
