"""Qwen3-MoE 235B-A22B — 128 experts, top-8, GQA, qk-norm [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", arch_type="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab_size=151936, act="silu", qk_norm=True,
    n_experts=128, top_k=8, d_ff_expert=1536, router_norm_topk=True,
    source="hf:Qwen/Qwen3-30B-A3B",
)
