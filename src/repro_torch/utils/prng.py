"""PRNG stream discipline, bit for bit with ``jax.random``.

The protocol binds all randomness to a task at *creation* time: a task's
key is ``fold_in(base_key, global_task_index)``, so the realized draws are
a pure function of (seed, task index) and can never depend on execution
order. That is what makes wavefront execution equal sequential execution,
and — because this module reproduces ``jax.random``'s threefry2x32
streams exactly (impl ``threefry2x32``, ``jax_threefry_partitionable=True``,
x64 off) — it also makes the port's engines equal the JAX package's.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words (torch's
``uint32`` lacks most operations, on CUDA above all); a leading batch of
keys (the per-task keys SIS keeps in its recipes are ``[W, 2]``) maps
elementwise. Every add and multiply is masked to 32 bits.

Mirrors of jax/_src/prng.py and jax/_src/random.py:
  key          ``threefry_seed``: ``[0, seed & 0xFFFFFFFF]``
  fold_in      ``threefry_2x32(key, [0, data])``
  split        the fold-like split: one hash of the iota ``(0, i)``
  random_bits  partitionable bits: ``bits1 ^ bits2`` over a flat iota
  randint      two 32-bit draws folded into the span, multiplier
               ``(2^16 mod span)^2`` wrapped mod 2^32; ``maxval <= minval``
               gives span 1
  uniform      ``bits >> 9 | 0x3F800000`` as float32, minus 1.0
"""
from __future__ import annotations

import math

import torch

from repro_torch.utils.device import resolve_device

MASK = 0xFFFFFFFF
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int, device=None) -> torch.Tensor:
    """Raw key of an integer seed, as ``jax.random.key(seed)`` holds it."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=resolve_device(device))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2)
    under the key (k1, k2); all operands broadcast, values are uint32
    held in int64."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Keys ``[..., 2]`` for ``data`` (an int or integer tensor, taken as
    uint32); key and data broadcast against each other."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``[..., num, 2]`` subkeys (the fold-like split of
    ``jax_threefry_partitionable``)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """32 random bits per element: ``[B..., *shape]`` for keys
    ``[B..., 2]`` (int64 holding uint32)."""
    shape = tuple(int(s) for s in shape)
    iota = torch.arange(math.prod(shape), dtype=torch.int64,
                        device=key.device)
    hi, lo = (iota >> 32).reshape(shape), (iota & MASK).reshape(shape)
    lead = key.shape[:-1] + (1,) * len(shape)
    y1, y2 = threefry2x32(key[..., 0].reshape(lead),
                          key[..., 1].reshape(lead), hi, lo)
    return y1 ^ y2


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod 2^32 for a, b < 2^32, without leaving int64's range."""
    return (((((a >> 16) * b) & 0xFFFF) << 16) + (a & 0xFFFF) * b) & MASK


def _on_device(bound, key: torch.Tensor) -> torch.Tensor:
    """An int64 bound on the key's device. A Python number is filled in on
    the device: a host-built scalar would be a blocking copy, a host sync
    per call."""
    if isinstance(bound, torch.Tensor):
        return bound.to(device=key.device, dtype=torch.int64)
    return torch.full((), int(bound), dtype=torch.int64, device=key.device)


def randint(key: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """int32 integers in [minval, maxval): ``[B..., *shape]`` for keys
    ``[B..., 2]``; the bounds are ints or tensors that broadcast to that
    shape (a per-row bound is ``[B...]`` with ``shape=()``)."""
    shape = tuple(int(s) for s in shape)
    ks = split(key)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    lo, hi = _on_device(minval, key), _on_device(maxval, key)
    out_of_range = hi > _INT32_MAX
    lo = lo.clamp(_INT32_MIN, _INT32_MAX)
    hi = hi.clamp(_INT32_MIN, _INT32_MAX)
    span = (hi - lo) & MASK
    span = torch.where(hi <= lo, torch.ones_like(span), span)
    span = torch.where(out_of_range & (hi > lo), (span + 1) & MASK, span)
    # span 0 (the full 2^32 range) leaves the offset as drawn
    full = span == 0
    div = torch.where(full, torch.ones_like(span), span)

    def rem(x):
        return torch.where(full, x, x % div)

    multiplier = rem(torch.full_like(span, 1 << 16))
    multiplier = rem((multiplier * multiplier) & MASK)
    offset = (_mul32(rem(higher), multiplier) + rem(lower)) & MASK
    offset = rem(offset)
    out = (lo + offset) & MASK
    out = torch.where(out > _INT32_MAX, out - (1 << 32), out)
    return out.to(torch.int32)


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval): ``[B..., *shape]`` for keys
    ``[B..., 2]``."""
    bits = random_bits(key, shape)
    floats = (((bits >> 9) | 0x3F800000).to(torch.int32)
              .view(torch.float32) - 1.0)
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)

