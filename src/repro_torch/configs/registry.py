"""Architecture registry: --arch <id> resolution."""
from __future__ import annotations

from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.deepseek_7b import CONFIG as _deepseek
from repro_torch.configs.h2o_danube3_4b import CONFIG as _danube
from repro_torch.configs.hymba_1p5b import CONFIG as _hymba
from repro_torch.configs.internvl2_76b import CONFIG as _internvl
from repro_torch.configs.qwen15_32b import CONFIG as _qwen15
from repro_torch.configs.qwen3_moe_235b import CONFIG as _qwen3
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless
from repro_torch.configs.smollm_360m import CONFIG as _smollm

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        _danube, _smollm, _qwen15, _deepseek, _rwkv6,
        _seamless, _arctic, _qwen3, _hymba, _internvl,
    ]
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(
            f"unknown arch '{name}'; available: {sorted(ARCHS)}")
    return ARCHS[name]
