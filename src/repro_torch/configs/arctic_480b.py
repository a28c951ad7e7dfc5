"""arctic-480b [moe] — Snowflake Arctic: dense FFN residual *in parallel*
with a 128-expert top-2 MoE.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2
[hf:Snowflake/snowflake-arctic-base]  head_dim = 7168/56 = 128.
"""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    head_dim=128,
    moe=MoESpec(n_experts=128, top_k=2, d_expert=4864, dense_parallel=True),
)
