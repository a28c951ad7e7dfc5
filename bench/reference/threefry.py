"""Threefry-2x32 and the draws the models make from it, in plain torch.

A frozen copy of the arithmetic of ``jax.random`` under
``jax_threefry_partitionable`` (x64 off): keys are int64 tensors
``[..., 2]`` holding two uint32 words, and every add is masked to 32
bits.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int, device) -> torch.Tensor:
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def hash2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, of the counters (x1, x2) under (k1, k2)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = (((x2 << r) & MASK) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def fold_in(k: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    data = data.to(torch.int64) & MASK
    y1, y2 = hash2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], -1)


def split(k: torch.Tensor, num: int) -> torch.Tensor:
    """[..., num, 2] subkeys."""
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    y1, y2 = hash2x32(k[..., 0, None], k[..., 1, None],
                      torch.zeros_like(lo), lo)
    return torch.stack([y1, y2], -1)


def bits(k: torch.Tensor, count: int | None) -> torch.Tensor:
    """32 random bits: [...] for count None, else [..., count]."""
    if count is None:
        z = torch.zeros((), dtype=torch.int64, device=k.device)
        y1, y2 = hash2x32(k[..., 0], k[..., 1], z, z)
    else:
        lo = torch.arange(count, dtype=torch.int64, device=k.device)
        y1, y2 = hash2x32(k[..., 0, None], k[..., 1, None],
                          torch.zeros_like(lo), lo)
    return y1 ^ y2


def uniform(k: torch.Tensor, count: int | None = None) -> torch.Tensor:
    """float32 uniforms in [0, 1)."""
    b = bits(k, count)
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def randint(k: torch.Tensor, span: int) -> torch.Tensor:
    """int64 integers in [0, span), one per key, for 0 < span < 2^31."""
    sub = split(k, 2)
    higher, lower = bits(sub[..., 0, :], None), bits(sub[..., 1, :], None)
    mult = ((1 << 16) % span) ** 2 % (1 << 32) % span
    hi = higher % span
    prod = ((((hi >> 16) * mult) & 0xFFFF) << 16) + (hi & 0xFFFF) * mult
    return ((prod & MASK) + lower % span) % (1 << 32) % span
