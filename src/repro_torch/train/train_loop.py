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
kernels and their backward the plain versions'
(``kernels/autograd.py``); the MoE's bf16 grouped products carry the
reference's backward (``models/moe.py:GroupedMM``).  ``moe_impl`` is
``"local"`` or ``"ref"``; the expert-parallel ``"ep"`` waits for the
distribution slice.
"""
from __future__ import annotations

import torch

from repro_torch import bridge
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig

from . import optimizer


def _in_dtype(model, x):
    return None if x is None else x.to(model.dtype)


def lm_loss(cfg: ModelConfig, model, batch, moe_impl="local", remat=False):
    """Next-token cross entropy (frame cross entropy for encoders), in
    f32: returns (loss, {"loss", "tokens"}).  The correct-class logit is
    gathered, not summed against a one-hot: the same sum, without a
    (B,T,V) one-hot."""
    if cfg.is_encoder:
        logits = tfm.forward(cfg, model,
                             embeds=_in_dtype(model, batch["embeds"]),
                             moe_impl=moe_impl, remat=remat)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
    else:
        tokens = batch["tokens"]
        logits = tfm.forward(
            cfg, model, tokens=tokens[:, :-1],
            vision_embeds=_in_dtype(model, batch.get("vision_embeds")),
            moe_impl=moe_impl, remat=remat)
        labels = tokens[:, 1:]
        mask = batch.get("loss_mask")
        mask = mask[:, 1:] if mask is not None else None
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    correct = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - correct
    mask = torch.ones_like(nll) if mask is None else mask.float()
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, {"loss": loss.detach(), "tokens": mask.sum()}


def make_train_step(cfg: ModelConfig, opt_cfg: optimizer.AdamWConfig,
                    moe_impl="local", remat=False):
    """The step ``(model, opt_state, batch) -> (model, opt_state,
    metrics)``; ``metrics`` holds ``loss``, ``tokens``, ``grad_norm`` and
    ``lr`` as 0-d tensors (nothing is read back to the host)."""
    moe_mod.check_impl(moe_impl)

    def train_step(model, opt_state, batch):
        model.requires_grad_(True)
        loss, metrics = lm_loss(cfg, model, batch, moe_impl, remat)
        loss.backward()
        params = bridge.leaves(model)
        grads = {k: [p.grad for p in v] if isinstance(v, list) else v.grad
                 for k, v in params.items()}
        _, opt_state, opt_metrics = optimizer.apply(opt_cfg, params, grads,
                                                    opt_state)
        model.zero_grad(set_to_none=True)
        return model, opt_state, dict(metrics, **opt_metrics)

    return train_step


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
