"""AdamW + cosine schedule + global-norm clipping over a model's
parameters.

PyTorch counterpart of ``repro/train/optimizer.py``.  Parameters, their
gradients and the moments are trees keyed by the reference's flattened
key paths (``bridge.leaves``): a top-level leaf is a tensor, a block
leaf the list of its per-repetition tensors, as the model holds them.
The state is ``{"m", "v", "step"}``; the moments are float32 whatever
the parameter's dtype, and the update runs in f32 and is cast back, as
the reference's.  ``apply`` updates the parameters in place.

The decoupled weight decay applies to the leaves whose rank is at least
2 *in the reference*, which stacks every block leaf on a repetition
axis: a block's RMSNorm scale, RWKV's mix vectors and bonus, RG-LRU's
``lam`` (1-D here, 2-D there) are decayed, a cross layer's gate (0-d
here, ``(reps,)`` there) is not; top-level leaves keep their own rank
(``bridge.reference_ndim``).

The update is elementwise, so it runs over flat chunks of at most
``CHUNK`` elements a leaf: its f32 temporaries stay small beside a
full-width embedding (778 M elements for Qwen3-14B).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.bridge import reference_ndim
from repro_torch.sharding import collectives

CHUNK = 1 << 25        # elements of a leaf updated at once


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio`` of the peak:
    a 0-d f32 tensor on ``step``'s device, computed in f32 as the
    reference's."""
    step = step.to(torch.float32)
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), _f32(1.0, step))
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _map(fn, tree):
    """``fn`` over the tensors of a tree of ``bridge.leaves``' shape."""
    return {k: [fn(t) for t in v] if isinstance(v, list) else fn(v)
            for k, v in tree.items()}


def _tensors(leaf):
    return leaf if isinstance(leaf, list) else [leaf]


def init(params) -> dict:
    """Zero f32 moments shaped like ``params`` and step 0 (int32)."""
    zeros = _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params)
    dev = next(t for leaf in params.values() for t in _tensors(leaf)).device
    return {"m": zeros, "v": _map(torch.clone, zeros),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _chunks(t: torch.Tensor):
    """Flat chunks of ``t``: views of a contiguous tensor (written in
    place), of a copy otherwise (read only)."""
    flat = t.reshape(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


def global_norm(tree, cut=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every element's square, in f32 (a leaf's
    gradient None counts as zeros).  Under a mesh, ``cut`` maps a leaf's
    key to the axes its tensors are cut over (``partition.shard_model``'s
    specs): their squares are summed over those axes' groups, so each
    shard counts once and each replicated leaf once."""
    sums = {}
    for key, leaf in tree.items():
        axes = tuple(sorted(cut.get(key, ()))) if cut else ()
        for t in _tensors(leaf):
            if t is None:
                continue
            for c in _chunks(t):
                sq = torch.sum(torch.square(c.float()))
                sums[axes] = sq if axes not in sums else sums[axes] + sq
    total = None
    for axes in sorted(sums):
        sq = sums[axes]
        for a in axes:
            sq = collectives.all_reduce(sq, mesh.group(a))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply(cfg: AdamWConfig, params, grads, state, cut=None, mesh=None):
    """One AdamW step: ``params`` updated in place from ``grads`` (a tree
    of the same keys; a None gradient is zeros).  Returns (params, new
    state, {"grad_norm", "lr"}).  Under a mesh the tensors are this
    rank's shards and ``cut``/``mesh`` make the clipping norm global
    (``global_norm``); the update is elementwise and needs nothing
    else."""
    step = state["step"] + 1
    gnorm = global_norm(grads, cut, mesh)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(cfg.b1, stepf), stepf)
    bc2 = 1 - torch.pow(_f32(cfg.b2, stepf), stepf)
    for key, leaf in params.items():
        decay = reference_ndim(leaf) >= 2
        for p, g, m, v in zip(_tensors(leaf), _tensors(grads[key]),
                              _tensors(state["m"][key]),
                              _tensors(state["v"][key])):
            gs = [None] * len(_chunks(p)) if g is None else _chunks(g)
            for pc, mc, vc, gc in zip(_chunks(p), _chunks(m), _chunks(v),
                                      gs):
                gf = (torch.zeros_like(mc) if gc is None
                      else gc.float()) * scale
                mc.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
                vc.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
                delta = (mc / bc1) / (torch.sqrt(vc / bc2) + cfg.eps)
                if decay:
                    delta = delta + cfg.weight_decay * pc.float()
                pc.copy_(pc.float() - lr * delta)
    return params, {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr}
