"""Nemotron-4 340B — dense decoder, GQA, squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", arch_type="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_head=192,
    d_ff=73728, vocab_size=256000, act="sq_relu", rope_theta=1e4,
    source="arXiv:2402.16819",
)
