"""smollm-360m [dense] — llama-arch small model, tied embeddings.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
[hf:HuggingFaceTB/SmolLM-360M]  head_dim = 960/15 = 64.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
    head_dim=64,
    tie_embeddings=True,
)
