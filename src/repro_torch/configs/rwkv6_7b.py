"""rwkv6-7b [ssm] — Finch, attention-free, data-dependent decay.

32L d_model=4096 d_ff=14336 vocab=65536. [arXiv:2404.05892; hf]
"""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,            # wkv heads = d_model / 64
    n_kv=64,
    d_ff=14336,
    vocab=65536,
    head_dim=64,
    ssm_head_dim=64,
    is_rwkv=True,
    notes="attention-free; long_500k runs with O(1) recurrent state",
)
