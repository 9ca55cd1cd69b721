"""qwen1.5-110b [dense] — QKV bias. 80L d_model=8192 64H (kv=8) d_ff=49152
vocab=152064. [hf:Qwen/Qwen1.5-0.5B; hf]"""

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=49152,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1000000.0,
    optimizer="adafactor",
)
