"""Llama-2-13B — the paper's own evaluation model [arXiv:2307.09288]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-13b", arch_type="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=40, d_head=128,
    d_ff=13824, vocab_size=32000, act="silu", rope_theta=1e4,
    max_seq_len=4096,
    source="arXiv:2307.09288",
)
