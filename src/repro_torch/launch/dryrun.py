"""Multi-pod dry-run: trace every (architecture x input-shape x mesh)
combination on fake tensors (no allocation) as rank 0 of the production
mesh, and record its memory sizes and roofline terms.

PyTorch counterpart of ``repro/launch/dryrun.py``.  The reference lowers
and compiles each step with ``ShapeDtypeStruct`` stand-ins on 512 fake
XLA devices and parses the HLO; here each pair starts torch's ``"fake"``
process group (collectives that move nothing) as rank 0 of 256 ranks
(16 x 16) or 512 (2 pods of 16 x 16), builds the host mesh over it, and
under ``FakeTensorMode`` on ``--device`` builds the model's shapes
(``input_specs.params_shapes``), cuts it (``partition.shard_model``) and
counts one step with ``op_analysis.count``: training is
``make_train_step(remat=True)`` with AdamW state, prefill is
``prefill(cache_len=T)``, decode is ``decode_step`` on
``init_cache(mesh=...)``.  The device of the trace decides the branches
the model takes: fake ``cuda`` tensors (on a machine with a CUDA build of
torch) trace the card's program, fake ``cpu`` tensors the CPU's.

Each record has the reference's fields, with ``trace_s`` for
``compile_s`` and the traced ``device``: ``roofline`` is the deployment
(the kernels and the grouped product by formula, ``fused_kernels=True``;
a train step's ``wkv6`` backward is its kernel's formula,
``cost.wkv6_bwd``), ``roofline_plain`` the plain versions traced op by
op (the reference's unfused ``roofline``), skipped with its reason where
the plain version is the per-step ``wkv6`` loop (forward, or forward and
backward in a train step) over more than ``PLAIN_WKV_MAX_T`` steps.  A
pair that fails is recorded as ``error``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --arch qwen3-14b --shape decode_32k [--multi-pod] [--all] \\
        [--out results/dryrun_torch.json]

``--all`` takes every shape and both meshes (and every assigned arch
unless ``--arch`` names one); ``--both-meshes`` both meshes.  Records
merge into ``--out`` by ``arch|shape|mesh`` key, so a sweep can run
incrementally; a recorded pair is traced again only after an error.
``--jobs N`` traces N pairs at a time, each in a spawned process of its
own (the trace is host work, one core a pair).
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
import traceback

import torch

from repro_torch import bridge
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.launch import op_analysis
from repro_torch.launch.input_specs import (SHAPES, applicable, input_specs,
                                            model_flops, params_shapes)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.config import BLOCK_RWKV
from repro_torch.sharding import partition
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_loop

DTYPE = torch.bfloat16
PLAIN_WKV_MAX_T = 512       # the plain wkv6 is a Python loop over steps
MESH = dict(data=16, model=16)


def _cfg_for(arch: str, shape: str, extra_variant: str = ""):
    cfg = get_config(arch, variant=extra_variant)
    ok, why = applicable(cfg, shape)
    variant = extra_variant
    if not ok and shape == "long_500k" and cfg.has_decode:
        variant = ("swa+" + extra_variant) if extra_variant else "swa"
        cfg = get_config(arch, variant=variant)  # serving variant (DESIGN §4)
        ok, why = applicable(cfg, shape)
    return cfg, ok, why, variant


def _wkv6_loop(cfg, shape: str, kinds) -> str:
    """Why a count of a pair of ``kinds`` is not traced: it would run
    the plain ``wkv6``, a Python loop over more than
    ``PLAIN_WKV_MAX_T`` steps ("" when it is traced)."""
    T, kind = SHAPES[shape]["seq_len"], SHAPES[shape]["kind"]
    rwkv = any(BLOCK_RWKV in pattern for pattern, _ in cfg.block_groups())
    if rwkv and kind in kinds and T > PLAIN_WKV_MAX_T:
        return (f"the plain wkv6 is a loop over {T} steps (traced only up "
                f"to {PLAIN_WKV_MAX_T})")
    return ""


def start_fake_group(world: int) -> None:
    """torch's fake process group as rank 0 of ``world`` ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _step(cfg, shape: str, model, mesh, device, moe_impl: str):
    """(fn, args, kwargs) of the pair's step on fake inputs."""
    info = SHAPES[shape]
    B, T, kind = info["global_batch"], info["seq_len"], info["kind"]
    specs = input_specs(cfg, shape, DTYPE, device)
    if kind == "train":
        opt_state = opt_mod.init(bridge.leaves(model))
        step = train_loop.make_train_step(cfg, opt_mod.AdamWConfig(),
                                          moe_impl=moe_impl, mesh=mesh,
                                          remat=True)
        return step, (model, opt_state, specs["batch"]), {}
    if kind == "prefill":
        return tfm.prefill, (cfg, model), dict(
            cache_len=T, moe_impl=moe_impl, mesh=mesh, **specs)
    cache = tfm.init_cache(cfg, B, T, DTYPE, device, mesh)
    return tfm.decode_step, (cfg, model, specs["token"], cache), dict(
        moe_impl=moe_impl, mesh=mesh)


def trace_one(arch: str, shape: str, multi_pod: bool, device: str = "cuda",
              variant: str = "") -> dict:
    """The record of one pair (a ``skipped`` record where the pair does
    not apply).  Starts and ends its own fake process group."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg, ok, why, variant = _cfg_for(arch, shape, variant)
    mesh_name = "multi" if multi_pod else "single"
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "skipped": why}
    pod = 2 if multi_pod else 1
    n_dev = pod * MESH["data"] * MESH["model"]
    start_fake_group(n_dev)
    try:
        mesh = make_host_mesh(MESH["data"], MESH["model"], device, pod=pod)
        mi = "ep" if cfg.n_experts else "local"
        with FakeTensorMode():
            model = partition.shard_model(
                cfg, params_shapes(cfg, DTYPE, device), mesh)
            fn, args, kw = _step(cfg, shape, model, mesh, device, mi)
            t0 = time.time()
            fused = op_analysis.count(fn, *args, fused_kernels=True, **kw)
            trace_s = time.time() - t0
            skip = _wkv6_loop(cfg, shape, ("prefill", "train"))
            if not skip:
                fn, args, kw = _step(cfg, shape, model, mesh, device, mi)
                plain = op_analysis.count(fn, *args, fused_kernels=False,
                                          **kw)
    finally:
        dist.destroy_process_group()
    mf = model_flops(cfg, shape)
    return {
        "arch": arch, "shape": shape, "variant": variant, "mesh": mesh_name,
        "n_devices": n_dev, "device": str(torch.device(device)),
        "trace_s": round(trace_s, 1),
        "memory": dict(fused.memory),
        "roofline": op_analysis.analyze(fused, n_dev, mf).as_dict(),
        "roofline_plain": ({"skipped": skip} if skip else
                           op_analysis.analyze(plain, n_dev, mf).as_dict()),
        "collectives": dict(fused.stats.coll),
        "kernels": dict(fused.kernels),
    }


def _trace_or_error(pair) -> dict:
    """``trace_one`` of ``(arch, shape, multi_pod, device)``, or the
    pair's ``error`` record (the reference's)."""
    arch, shape, mp, device = pair
    try:
        return trace_one(arch, shape, mp, device)
    except Exception as e:          # recorded, as the reference
        traceback.print_exc()
        return {"arch": arch, "shape": shape,
                "mesh": "multi" if mp else "single",
                "error": f"{type(e).__name__}: {e}"}


def _print(rec: dict) -> None:
    print(f"=== {rec['arch']} x {rec['shape']} x {rec['mesh']} ===")
    if "error" in rec:
        print(f"  FAIL: {rec['error']}")
        return
    if "skipped" in rec:
        print(f"  SKIP: {rec['skipped']}")
        return
    m = rec["memory"]
    print(f"  traced in {rec['trace_s']}s on {rec['device']}; args/dev="
          f"{m['argument_bytes'] / 2 ** 30:.2f}GiB "
          f"temp/dev={m['temp_bytes'] / 2 ** 30:.2f}GiB")
    for tag in ("roofline", "roofline_plain"):
        r = rec[tag]
        if "skipped" in r:
            print(f"  {tag}: skipped: {r['skipped']}")
            continue
        print(f"  {tag}: compute={r['compute_s']:.4f}s "
              f"memory={r['memory_s']:.4f}s "
              f"collective={r['collective_s']:.4f}s "
              f"dominant={r['dominant']} useful={r['useful_ratio']:.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default="results/dryrun_torch.json")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ASSIGNED)
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]

    try:
        with open(args.out) as f:
            results = {tuple(k.split("|")): v
                       for k, v in json.load(f).items()}
    except (FileNotFoundError, json.JSONDecodeError):
        results = {}

    todo = [(arch, shape, mp, args.device) for arch in archs
            for shape in shapes for mp in meshes
            if "error" in results.get((arch, shape,
                                       "multi" if mp else "single"),
                                      {"error": ""})]

    def save(rec):
        results[(rec["arch"], rec["shape"], rec["mesh"])] = rec
        _print(rec)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"|".join(k): v for k, v in results.items()}, f,
                      indent=1)

    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.jobs) as pool:
            for rec in pool.imap_unordered(_trace_or_error, todo):
                save(rec)
    else:
        for pair in todo:
            save(_trace_or_error(pair))

    n_err = sum(1 for v in results.values() if "error" in v)
    print(f"\n{len(results)} records, {n_err} errors -> {args.out}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
