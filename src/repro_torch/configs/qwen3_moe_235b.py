"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8, no dense MLP.

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936
[hf:Qwen/Qwen3-235B-A22B]  head_dim 128 (decoupled from d_model/n_heads).
"""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab=151936,
    head_dim=128,
    rope_theta=1_000_000.0,
    moe=MoESpec(n_experts=128, top_k=8, d_expert=1536),
)
