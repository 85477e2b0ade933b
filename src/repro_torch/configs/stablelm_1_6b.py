"""StableLM-2 1.6B — dense decoder, MHA (kv=32) [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", arch_type="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=5632, vocab_size=100352, act="silu", rope_theta=1e4,
    source="hf:stabilityai/stablelm-2-1_6b",
)
