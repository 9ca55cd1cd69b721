"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attn blocks.

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000 ssm_state=64.
[arXiv:2411.15242; hf]

54 Mamba2 layers in 9 groups of 6, one weight-shared attention+MLP block
applied after each group (simplified from the release's two alternating
shared blocks, as in the reference).
"""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    notes="long_500k runs: SSM state O(1) + shared-attn KV caches",
)
