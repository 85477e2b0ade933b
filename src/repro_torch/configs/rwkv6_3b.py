"""RWKV6 "Finch" 3B — attention-free SSM, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", arch_type="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_head=64,
    d_ff=8960, vocab_size=65536, rwkv_head_size=64, rwkv_lora_decay=64,
    source="arXiv:2404.05892",
)
