"""internvl2-76b [vlm] — InternViT frontend STUB + LLaMA-3-70B-class
language backbone (the assignment specifies the backbone only).

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 [arXiv:2404.16821]
input_specs supplies precomputed patch embeddings [B, P, D] prepended to
the text tokens.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    frontend="vision_stub",
)
