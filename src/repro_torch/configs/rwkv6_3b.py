"""rwkv6-3b [ssm] — Finch, attention-free with data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536  [arXiv:2404.05892]
Internal WKV heads: head_dim 64 -> 40 heads. n_heads/n_kv_heads are unused
by the rwkv block but kept consistent for tooling.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    head_dim=64,
)
