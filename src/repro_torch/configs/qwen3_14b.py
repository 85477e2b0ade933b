"""Qwen3-14B — dense decoder, GQA, qk-norm [hf:Qwen/Qwen3-14B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", arch_type="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=17408, vocab_size=151936, act="silu", qk_norm=True,
    source="hf:Qwen/Qwen3-14B",
)
