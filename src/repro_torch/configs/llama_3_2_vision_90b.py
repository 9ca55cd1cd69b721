"""llama-3.2-vision-90b [vlm] — cross-attn image layers.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
100 layers = 20 super-blocks of (4 self-attn + 1 gated cross-attn); the
vision frontend is a stub (input_specs supplies patch embeddings).
"""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    rope_theta=500000.0,
    cross_attn_every=5,
    n_image_tokens=4096,
    optimizer="adafactor",
    notes="vision frontend stubbed: precomputed patch embeddings",
)
