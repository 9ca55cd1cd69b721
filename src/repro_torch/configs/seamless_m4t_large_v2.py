"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal. 24L d_model=1024
16H (kv=16) d_ff=8192 vocab=256206. [arXiv:2308.11596; hf]

Audio frontend stubbed: input_specs supplies precomputed frame embeddings.
Decoder length = seq_len // dec_ratio (frames dominate the sequence budget).
Vocab padded 256206 -> 256256 (multiple of 16) for TP sharding, the standard
Megatron-style embedding pad; padded ids are never emitted as labels.
"""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,          # decoder depth
    n_enc_layers=24,      # encoder depth
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=8192,
    vocab=256256,  # 256206 padded to a multiple of 16 (TP divisibility)
    head_dim=64,
    dec_ratio=4,
    notes="audio frontend stubbed: precomputed frame embeddings",
)
