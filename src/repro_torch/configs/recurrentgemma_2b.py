"""RecurrentGemma-2B (Griffin) — RG-LRU + local attention, 1 attn : 2 rec
[arXiv:2402.19427]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", arch_type="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_head=256,
    d_ff=7680, vocab_size=256000, act="gelu",
    hybrid_pattern=("rec", "rec", "attn"), lru_width=2560, conv_width=4,
    local_window=2048, rope_theta=1e4,
    source="arXiv:2402.19427",
)
