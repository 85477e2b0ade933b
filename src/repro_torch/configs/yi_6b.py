"""Yi-6B — llama-architecture dense decoder with GQA [arXiv:2403.04652]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", arch_type="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=11008, vocab_size=64000, act="silu", rope_theta=5e6,
    source="arXiv:2403.04652",
)
