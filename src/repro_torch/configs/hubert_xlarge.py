"""HuBERT-XLarge — encoder-only audio backbone [arXiv:2106.07447].

The conv/mel frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, T, 1280).  Encoder-only: no decode step (decode shapes are
skipped — DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", arch_type="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_head=80,
    d_ff=5120, vocab_size=504, act="gelu", is_encoder=True,
    source="arXiv:2106.07447",
)
