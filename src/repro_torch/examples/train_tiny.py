"""Train a ~100M-parameter dense model for a few hundred steps, with
checkpointing.

    PYTHONPATH=src python -m repro_torch.examples.train_tiny \\
        [--steps 300] [--device cuda|cpu]

Twin of the reference's ``examples/train_tiny.py``: qwen3-14b's family
reduced to 8 layers, d = 512, d_ff 2048 and a vocabulary of 8192, the
synthetic token stream of ``data/tokens.py``, AdamW with warm-up, the
loss must drop, then a checkpoint round trip (``train/checkpoint.py``,
the reference's npz format).  Defaults to the card; ``--device cpu``
runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data import tokens as data_tokens
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import reduced
from repro_torch.train import checkpoint, optimizer, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="results/train_tiny.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ~100M params: 8 layers, d=512, ff=2048, vocab 8192
    cfg = dataclasses.replace(
        reduced(get_config("qwen3-14b")),
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, d_head=64,
        d_ff=2048, vocab_size=8192, max_seq_len=args.seq,
        name="qwen3-tiny-100m")
    n_params = cfg.param_count()
    print(f"model={cfg.name}: ~{n_params/1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq} on {device}")

    it = data_tokens.batches(cfg, args.batch, args.seq, device=device)
    t0 = time.perf_counter()
    losses = []

    def log(rec):
        losses.append(rec["loss"])
        print(f"  step {rec['step']:4d} loss={rec['loss']:.4f} "
              f"lr={rec['lr']:.2e} gnorm={rec['grad_norm']:.3f}")

    model, opt_state, hist = train_loop.train(
        cfg, args.steps, it,
        opt_cfg=optimizer.AdamWConfig(lr=1e-3, warmup_steps=20,
                                      total_steps=args.steps),
        callback=log, log_every=25, device=device)
    dt = time.perf_counter() - t0
    print(f"\ntrained {args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s "
          f"{device.type})")
    assert losses[-1] < losses[0], "loss must decrease"
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}  (decreased)")

    checkpoint.save(args.ckpt, model, opt_state,
                    meta={"steps": args.steps})
    model2 = tfm.init_params(cfg, seed=1, device=device)
    checkpoint.restore(args.ckpt, model2)
    pairs = zip(model.parameters(), model2.parameters())
    assert all(torch.equal(a, b) for a, b in pairs)
    print(f"checkpoint round-trip OK -> {args.ckpt}")


if __name__ == "__main__":
    main()
