"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --smoke --steps 50 [--batch 8 --seq 128] [--ckpt results/ckpt.npz] \\
        [--lr 1e-3] [--device cuda|cpu] [--dtype f32|bf16] [--layers N]

PyTorch counterpart of ``repro/launch/train.py``.  ``--smoke`` trains
the reduced config (real steps, the loss must drop; ``--device cpu``
runs the plain PyTorch path); without it the full config, with
activation checkpointing a block group's repetition (``remat = not
smoke``, as the reference), on the card (``--device cuda``, the
default): the attention and ``wkv6`` forwards on the hand-written
kernels, the attention's backward through its plain version and
``wkv6``'s through its backward kernel (rwkv6-3b at every width and
depth: ``--arch rwkv6-3b --batch 2 --seq 4096 --lr 1e-4``).  Weights are seeded
random (``init_params``); ``--layers`` cuts the depth, which one 80 GB
card needs at full width (Qwen3-14B: ``--layers 8 --batch 4 --seq 512
--lr 1e-4``; the default lr 1e-3 is the reference's smoke setting, and
at full width it makes the loss rise).  The batches are ``data/tokens.py``'s synthetic
stream.  Prints the reference's lines: ``step N loss=... lr=...`` every
10 steps and the last, then ``N steps in Xs (T tok/s); loss a -> b``.

``--data D --model M`` (the reference's mesh axes) train on a D x M
mesh of ranks (``launch/mesh.py``): data-parallel over ``data``,
tensor-parallel over ``model``, MoE configs expert-parallel (``moe_impl=
"ep"``, as the reference's launcher).  Each rank builds the seeded whole
model and cuts its shard (``sharding.partition.shard_model``); every
rank draws the same batches and trains on its rows.  Under ``torchrun
--nproc-per-node D*M`` the ranks come from torchrun's environment;
without it the launcher spawns D*M local ranks itself (a ``file://``
store in a temporary directory): gloo ranks with ``--device cpu``, or one
rank a card on the card, where fewer cards than ranks exit 2.  Rank 0
prints the lines (after a ``mesh: {...}; params sharded`` line) and
writes ``--ckpt`` from the gathered whole model.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import torch

from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data import tokens as data_tokens
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer as tfm
from repro_torch.sharding import context, partition
from repro_torch.train import checkpoint, optimizer, train_loop

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                    help="parameter dtype (default: f32 with --smoke, "
                         "bf16 otherwise)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    world = args.data * args.model
    if world > 1 and "RANK" not in os.environ:
        if args.device == "cuda" and torch.cuda.device_count() < world:
            print(f"--data {args.data} --model {args.model}: {world} ranks "
                  f"need a CUDA card each; {torch.cuda.device_count()} "
                  f"found", file=sys.stderr)
            return 2
        with tempfile.TemporaryDirectory() as d:
            torch.multiprocessing.start_processes(
                _rank_main, args=(argv, world, os.path.join(d, "store")),
                nprocs=world, start_method="spawn")
        return 0
    return train(args)


def _rank_main(rank: int, argv, world: int, store: str) -> None:
    """A spawned rank: its place in the mesh, then ``train``."""
    if rank:                          # rank 0 alone prints
        sys.stdout = open(os.devnull, "w")
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    train(build_parser().parse_args(argv), rank=rank, world=world,
          init_method="file://" + store)


def train(args, rank=None, world=None, init_method=None) -> int:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    device = resolve_device(args.device)
    mesh = None
    if rank is not None or args.data * args.model > 1:
        if rank is not None and device.type == "cuda":
            os.environ["LOCAL_RANK"] = str(rank)
        device = mesh_mod.init_distributed(args.data, args.model, device.type,
                                           rank=rank, world_size=world,
                                           init_method=init_method)
        mesh = mesh_mod.make_host_mesh(args.data, args.model, device.type)
        context.set_mesh(mesh)
    dtype = DTYPES[args.dtype or ("f32" if args.smoke else "bf16")]
    model = tfm.init_params(cfg, seed=0, dtype=dtype, device=device)
    if mesh is not None:
        partition.shard_model(cfg, model, mesh)
        print(f"mesh: {mesh.shape}; params sharded", flush=True)
    opt_cfg = optimizer.AdamWConfig(lr=args.lr, warmup_steps=10,
                                    total_steps=args.steps)
    opt_state = optimizer.init(bridge.leaves(model))
    mi = "ep" if cfg.n_experts and mesh is not None else "local"
    step_fn = train_loop.make_train_step(cfg, opt_cfg, moe_impl=mi,
                                         remat=not args.smoke, mesh=mesh)

    it = data_tokens.batches(cfg, args.batch, args.seq, device=device)
    t0 = time.perf_counter()
    first_loss = last_loss = None
    for step in range(args.steps):
        model, opt_state, metrics = step_fn(model, opt_state, next(it))
        if step == 0:
            first_loss = float(metrics["loss"])
        last_loss = float(metrics["loss"])
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={last_loss:.4f} "
                  f"lr={float(metrics['lr']):.2e}", flush=True)
    dt = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s); "
          f"loss {first_loss:.3f} -> {last_loss:.3f}", flush=True)
    if args.ckpt:
        if mesh is not None:
            model, opt_state = _whole(cfg, model, opt_state, mesh, dtype)
        if mesh is None or torch.distributed.get_rank() == 0:
            checkpoint.save(args.ckpt, model, opt_state,
                            meta={"steps": args.steps})
            print(f"checkpoint -> {args.ckpt}")
    if mesh is not None:
        context.set_mesh(None)
        torch.distributed.destroy_process_group()
    return 0


def _whole(cfg, model, opt_state, mesh, dtype):
    """The whole model and optimizer state, gathered from the shards."""
    specs = model.shard_specs
    flat = partition.unshard_leaves(bridge.leaves(model), specs, mesh)
    whole = bridge.params_from_numpy(
        bridge.unflatten({k: bridge.stack(v) for k, v in flat.items()}),
        cfg, device=model.device, dtype=dtype)
    state = {part: partition.unshard_leaves(opt_state[part], specs, mesh)
             for part in ("m", "v")}
    state["step"] = opt_state["step"]
    return whole, state


if __name__ == "__main__":
    sys.exit(main())
