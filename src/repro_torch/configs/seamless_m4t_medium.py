"""seamless-m4t-medium [audio] — encoder-decoder, multimodal frontend STUB.

12L enc + 12L dec, d_model=1024 16H (MHA) d_ff=4096 vocab=256206
[arXiv:2308.11596]. The speech frontend is a stub per the assignment:
input_specs supplies precomputed frame embeddings [B, T, D].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    head_dim=64,
    frontend="audio_stub",
)
