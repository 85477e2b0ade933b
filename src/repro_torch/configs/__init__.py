"""Architecture registry.

``get_config(arch_id)`` returns the exact assigned full config;
``get_config(arch_id, variant="swa")`` returns the sliding-window serving
variant used for long_500k on full-attention archs (DESIGN.md §4);
``get_smoke_config(arch_id)`` returns the reduced same-family variant used
by CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig, reduced

_MODULES = {
    "yi-6b": "yi_6b",
    "rwkv6-3b": "rwkv6_3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "stablelm-1.6b": "stablelm_1_6b",
    "hubert-xlarge": "hubert_xlarge",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "nemotron-4-340b": "nemotron_4_340b",
    "qwen3-14b": "qwen3_14b",
    "llama2-13b": "llama2_13b",          # the paper's own model
}

ASSIGNED = tuple(k for k in _MODULES if k != "llama2-13b")
SWA_WINDOW = 8192


def get_config(arch: str, variant: str = "") -> ModelConfig:
    """variant: "" | "swa" | "int8" | "swa+int8" (serving variants)."""
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg: ModelConfig = mod.CONFIG
    for v in (p for p in variant.split("+") if p):
        if v == "swa":
            if cfg.arch_type in ("ssm", "hybrid"):
                continue  # already sub-quadratic
            cfg = dataclasses.replace(cfg, sliding_window=SWA_WINDOW,
                                      name=cfg.name + "+swa")
        elif v == "int8":
            cfg = dataclasses.replace(cfg, kv_cache_dtype="int8",
                                      name=cfg.name + "+int8")
        else:
            raise ValueError(f"unknown variant {v!r}")
    return cfg


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)


def list_archs():
    return list(_MODULES)
