"""Llama-3.2-Vision 90B — dense decoder with gated cross-attention image
layers every 5th block [hf:meta-llama/Llama-3.2-11B-Vision].

The ViT vision encoder is a STUB: input_specs() provides patch embeddings
(B, 1600, 1280); the projector (d_vision -> d_model) is part of this model.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", arch_type="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=28672, vocab_size=128256, act="silu",
    cross_attn_every=5, n_vision_tokens=1600, d_vision=1280,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
