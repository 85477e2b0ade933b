"""Stand-in inputs for every (arch x input-shape) pair.

PyTorch counterpart of ``repro/launch/input_specs.py``.  The reference
returns ``jax.ShapeDtypeStruct``s and builds a decode cache's with
``jax.eval_shape``; here the inputs are tensors made under the caller's
``torch._subclasses.fake_tensor.FakeTensorMode`` (shapes and dtypes on
a device, nothing allocated), and a decode cache is ``tfm.init_cache``
under the same mode.  Called outside a fake mode they are real (empty
or zeroed) tensors.

Shapes (task spec):
    train_4k     seq 4096   global_batch 256   train_step
    prefill_32k  seq 32768  global_batch 32    prefill
    decode_32k   seq 32768  global_batch 128   serve_step (1 token + cache)
    long_500k    seq 524288 global_batch 1     serve_step, sub-quadratic only
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped).  Encoder-only archs have no decode;
    full-attention archs need the SWA variant for long_500k."""
    kind = SHAPES[shape]["kind"]
    if kind == "decode" and not cfg.has_decode:
        return False, "encoder-only: no autoregressive decode step"
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "full attention at 524k context: requires +swa variant"
    return True, ""


def input_specs(cfg: ModelConfig, shape: str, dtype=torch.bfloat16,
                device="cuda") -> dict:
    """The inputs of ``shape``'s step: ``{"batch": ...}`` for training,
    the prefill's keyword inputs, or a decode step's ``token`` and its
    (whole, unsharded) ``cache`` covering ``seq_len`` of context."""
    info = SHAPES[shape]
    B, T, kind = info["global_batch"], info["seq_len"], info["kind"]

    def tok(*s):
        return torch.empty(s, dtype=torch.int32, device=device)

    def emb(*s):
        return torch.empty(s, dtype=dtype, device=device)

    if kind in ("train", "prefill"):
        out = {} if kind == "train" else {"lengths": tok(B)}
        if cfg.is_encoder:
            out["embeds"] = emb(B, T, cfg.d_model)
            if kind == "train":
                out["labels"] = tok(B, T)
        else:
            out["tokens"] = tok(B, T)
            if cfg.arch_type == "vlm":
                out["vision_embeds"] = emb(B, cfg.n_vision_tokens,
                                           cfg.d_vision)
        return {"batch": out} if kind == "train" else out

    # decode: ONE new token + cache covering `seq_len` context
    return {"token": tok(B), "cache": tfm.init_cache(cfg, B, T, dtype,
                                                     device)}


def params_shapes(cfg: ModelConfig, dtype=torch.bfloat16, device="cuda"):
    """The whole model's parameters, shapes only: ``Transformer(cfg,
    dtype, device)`` with no draws (under a fake mode, nothing
    allocated)."""
    return tfm.Transformer(cfg, dtype, device)


def model_flops(cfg: ModelConfig, shape: str) -> float:
    """MODEL_FLOPS per §Roofline: 6·N_active·D for training, 2·N_active·D
    for inference forward passes (D = tokens processed)."""
    info = SHAPES[shape]
    B, T, kind = info["global_batch"], info["seq_len"], info["kind"]
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * B * T
    if kind == "prefill":
        return 2.0 * n * B * T
    return 2.0 * n * B          # decode: one token per sequence
