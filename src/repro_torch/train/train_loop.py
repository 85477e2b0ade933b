"""Causal-LM training step and loop.

PyTorch counterpart of ``repro/train/train_loop.py``.
``make_train_step(cfg, opt_cfg)`` builds the (model, opt_state, batch)
-> (model, opt_state, metrics) step used by the launcher, the example
and the tests: ``lm_loss`` through the model's ``forward`` with
gradients on, ``backward``, then one AdamW step over ``bridge.leaves``
(the parameters are updated in place).  Batches are dicts of tensors on
the model's device: {"tokens": (B,T) int, "loss_mask": (B,T) float or
absent, and for audio: "embeds" (B,T,d), "labels" (B,T); for a VLM: +
"vision_embeds"}.  Float inputs are cast to the model's dtype.

On the card the attention and ``wkv6`` forwards are the hand-written
kernels, the attention's backward its plain version's and ``wkv6``'s
its backward kernel (``kernels/autograd.py``); the MoE's bf16 grouped products carry the
reference's backward (``models/moe.py:GroupedMM``).  ``moe_impl`` is
``"local"``, ``"ref"`` or, under a mesh, the expert-parallel ``"ep"``.

Under a mesh (data-parallel over ``data``, tensor-parallel over
``model``, experts over ``data``; the model cut by
``sharding.partition.shard_model``) every rank is given the same global
batch and takes its own rows (``sharding.rows``).  Its loss is
its rows' summed token losses over the batch's whole token count
(all-reduced over the batch axes, ``pod`` and ``data``, as the
reference's GSPMD sums over every batch axis), so the ranks' losses sum
to the global token mean.  After the backward, the gradient of each leaf
is all-reduced (summed) over each batch axis the leaf is not cut over:
an expert leaf, cut over ``data``, already holds its pod's whole
gradient over ``data`` (the all-to-all's backward brings it every data
rank's share) and is summed over ``pod`` only.  The clipping norm counts
each shard once and each replicated leaf once; the AdamW arithmetic is
the reference's, on each rank's shards.
"""
from __future__ import annotations

import torch

from repro_torch import bridge
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import collectives, rows

from . import optimizer


def _in_dtype(model, x):
    return None if x is None else x.to(model.dtype)


def lm_loss(cfg: ModelConfig, model, batch, moe_impl="local", remat=False,
            mesh=None):
    """Next-token cross entropy (frame cross entropy for encoders), in
    f32: returns (loss, {"loss", "tokens"}).  The correct-class logit is
    gathered, not summed against a one-hot: the same sum, without a
    (B,T,V) one-hot.  Under a mesh ``batch`` is the global batch and the
    returned loss this rank's share of the global token mean (the
    metrics hold the global mean and token count)."""
    mesh = tfm.resolve_mesh(cfg, model, mesh)
    cut = False
    if mesh is not None:
        B = next(iter(batch.values())).shape[0]
        cut = bool(rows.batch_tuple(mesh, B))
        batch = {k: rows.local_rows(v, mesh, B) for k, v in batch.items()}
    if cfg.is_encoder:
        logits = tfm.forward(cfg, model,
                             embeds=_in_dtype(model, batch["embeds"]),
                             moe_impl=moe_impl, remat=remat, mesh=mesh,
                             local_batch=True)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
    else:
        tokens = batch["tokens"]
        logits = tfm.forward(
            cfg, model, tokens=tokens[:, :-1],
            vision_embeds=_in_dtype(model, batch.get("vision_embeds")),
            moe_impl=moe_impl, remat=remat, mesh=mesh, local_batch=True)
        labels = tokens[:, 1:]
        mask = batch.get("loss_mask")
        mask = mask[:, 1:] if mask is not None else None
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    correct = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - correct
    mask = torch.ones_like(nll) if mask is None else mask.float()
    if mesh is None:
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss, {"loss": loss.detach(), "tokens": mask.sum()}
    count = _sum_over_batch_axes(mask.sum(), mesh)
    loss = (nll * mask).sum() / torch.clamp(count, min=1.0)
    return loss, {"loss": _sum_over_batch_axes(loss.detach(), mesh),
                  "tokens": count if cut else mask.sum()}


def _batch_axes(mesh):
    """The batch axes of ``mesh`` (``pod``, ``data``) that it has."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _sum_over_batch_axes(x, mesh, skip=()):
    """``x`` summed over each batch axis of ``mesh`` not in ``skip``
    (no gradient)."""
    for a in _batch_axes(mesh):
        if a not in skip:
            x = collectives.all_reduce(x, mesh.group(a))
    return x


def make_train_step(cfg: ModelConfig, opt_cfg: optimizer.AdamWConfig,
                    moe_impl="local", remat=False, mesh=None):
    """The step ``(model, opt_state, batch) -> (model, opt_state,
    metrics)``; ``metrics`` holds ``loss``, ``tokens``, ``grad_norm`` and
    ``lr`` as 0-d tensors (nothing is read back to the host).  Under
    ``mesh`` the model is this rank's shard, ``batch`` the global batch,
    and each leaf's gradient is summed over the batch axes it is not cut
    over (``sum_grads_over_batch``)."""
    moe_mod.check_impl(moe_impl, mesh)

    def train_step(model, opt_state, batch):
        model.requires_grad_(True)
        loss, metrics = lm_loss(cfg, model, batch, moe_impl, remat, mesh)
        loss.backward()
        params = bridge.leaves(model)
        grads = {k: [p.grad for p in v] if isinstance(v, list) else v.grad
                 for k, v in params.items()}
        cut = None
        if mesh is not None:
            cut = {k: {a for e in spec if e is not None
                       for a in ((e,) if isinstance(e, str) else e)}
                   for k, spec in model.shard_specs.items()}
            sum_grads_over_batch(grads, cut, mesh)
        _, opt_state, opt_metrics = optimizer.apply(
            opt_cfg, params, grads, opt_state, cut, mesh)
        model.zero_grad(set_to_none=True)
        return model, opt_state, dict(metrics, **opt_metrics)

    return train_step


@torch.no_grad()
def sum_grads_over_batch(grads, cut, mesh) -> None:
    """Sum, in place, each leaf's gradient over the batch axes (``pod``,
    ``data``) its tensors are not cut over (``cut``: leaf key -> axes):
    an expert leaf, its data rank's own, over ``pod`` only."""
    for key, leaf in grads.items():
        if set(_batch_axes(mesh)) <= cut[key]:
            continue
        for t in (leaf if isinstance(leaf, list) else [leaf]):
            if t is not None:
                t.copy_(_sum_over_batch_axes(t, mesh, cut[key]))


def train(cfg: ModelConfig, steps: int, batch_iter, seed: int = 0,
          opt_cfg: optimizer.AdamWConfig | None = None, model=None,
          log_every: int = 10, callback=None, moe_impl="local",
          device="cuda"):
    """Single-device training loop (the example and smoke scale); an f32
    model is made from ``seed`` (``init_params``) on ``device`` unless
    one is given.  Returns (model, opt_state, history of the logged
    steps' metrics as floats)."""
    opt_cfg = opt_cfg or optimizer.AdamWConfig(total_steps=steps)
    if model is None:
        model = tfm.init_params(cfg, seed, device=device)
    opt_state = optimizer.init(bridge.leaves(model))
    step_fn = make_train_step(cfg, opt_cfg, moe_impl=moe_impl)
    history = []
    for step in range(steps):
        batch = next(batch_iter)
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            rec = {k: float(v) for k, v in metrics.items()}
            rec["step"] = step
            history.append(rec)
            if callback:
                callback(rec)
    return model, opt_state, history
