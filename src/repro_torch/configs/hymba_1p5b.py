"""hymba-1.5b [hybrid] — parallel attention + Mamba heads per layer.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16
[arXiv:2411.13676]. SWA (window 1024) everywhere except 3 full-attention
layers (first / middle / last); 128 learned meta tokens prepended.
"""
from repro_torch.configs.base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    sliding_window=1024,
    global_layers=(0, 16, 31),
    n_prefix_tokens=128,
    ssm=SSMSpec(state_dim=16, n_heads=25, head_dim=64),
)
