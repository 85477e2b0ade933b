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
kernels, their backward through the plain versions.  Weights are seeded
random (``init_params``); ``--layers`` cuts the depth, which one 80 GB
card needs at full width (Qwen3-14B: ``--layers 8 --batch 4 --seq 512
--lr 1e-4``; the default lr 1e-3 is the reference's smoke setting, and
at full width it makes the loss rise).  The batches are ``data/tokens.py``'s synthetic
stream.  ``--data``/``--model`` (the reference's mesh axes) arrive with
the distribution slice and are refused.  Prints the reference's lines:
``step N loss=... lr=...`` every 10 steps and the last, then ``N steps
in Xs (T tok/s); loss a -> b``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data import tokens as data_tokens
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.train import checkpoint, optimizer, train_loop

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def main(argv=None):
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
    args = ap.parse_args(argv)
    if args.data * args.model > 1:
        print("--data/--model (a device mesh) arrive with the distribution "
              "slice of the port; this launcher trains on one device",
              file=sys.stderr)
        return 2

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype or ("f32" if args.smoke else "bf16")]
    model = tfm.init_params(cfg, seed=0, dtype=dtype, device=device)
    opt_cfg = optimizer.AdamWConfig(lr=args.lr, warmup_steps=10,
                                    total_steps=args.steps)
    opt_state = optimizer.init(bridge.leaves(model))
    step_fn = train_loop.make_train_step(cfg, opt_cfg, moe_impl="local",
                                         remat=not args.smoke)

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
          f"loss {first_loss:.3f} -> {last_loss:.3f}")
    if args.ckpt:
        checkpoint.save(args.ckpt, model, opt_state,
                        meta={"steps": args.steps})
        print(f"checkpoint -> {args.ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
