"""qwen1.5-32b [dense] — MHA with QKV bias.

64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064
[hf:Qwen/Qwen1.5-32B]  head_dim = 5120/40 = 128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
