"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 + 1 shared.

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840.
[arXiv:2501.kimi2; unverified]

Simplifications, as in the reference's config: all 61 layers are MoE (the
release keeps layer 0 dense), and GQA replaces MLA. About 1 T parameters:
it does not fit one card, so the port runs its reduced config only.
"""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv=8,
    d_ff=2048,
    moe_d_ff=2048,
    n_experts=384,
    top_k=8,
    n_shared_experts=1,
    vocab=163840,
    head_dim=128,
    rope_theta=50000.0,
    optimizer="adafactor",
)
