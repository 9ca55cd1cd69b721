"""qwen1.5-4b [dense] — QKV bias. 40L d_model=2560 20H (kv=20) d_ff=6912
vocab=151936. [hf:Qwen/Qwen1.5-0.5B; hf]

The only ported config with a QKV bias (``qkv_bias``): the bias is added in
fp32 after the float product (``layers.linear.linear``).
"""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv=20,
    d_ff=6912,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
)
