"""Llama-4-Scout 17B-A16E — MoE 16 experts top-1 + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", arch_type="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=202048, act="silu",
    n_experts=16, top_k=1, d_ff_expert=8192, shared_expert=True,
    router_norm_topk=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
