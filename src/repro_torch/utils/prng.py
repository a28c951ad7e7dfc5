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
  binomial     ``_binomial``: inversion where count·q <= 10 (or the count
               is NaN or negative), BTRS otherwise, q = min(p, 1 - p), in
               float32; each branch's rounds drawn from its own chain of
               ``split``s of the same key
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


# ------------------------------------------------------------------ binomial
#: Rounds drawn per binomial sample. The reference loops until every
#: sample is accepted; a device loop here would need a host sync per round,
#: so both branches draw this many rounds at once and a sample that needs
#: more fails an assertion (on the device, without a sync). Inversion needs
#: k + 1 rounds for a sample k of mean count·q <= 10 (P(k >= 63) < 1e-29);
#: BTRS accepts a round with probability above 0.7 (0.3^64 < 1e-33).
BINOMIAL_ROUNDS = 64

#: ``_stirling_approx_tail``'s table: log k! minus its Stirling
#: approximation at k = 0..9
_STIRLING_TAIL = (0.0810614667953272, 0.0413406959554092,
                  0.0276779256849983, 0.02079067210376509,
                  0.0166446911898211, 0.0138761288230707,
                  0.0118967099458917, 0.0104112652619720,
                  0.00925546218271273, 0.00833056343336287)


def _c(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a float32 tensor like ``x``: jnp rounds a Python
    number to float32 before the op, and so does this. (Written out
    because torch computes ``number / tensor`` as a reciprocal times the
    number, which is not IEEE division.)"""
    return torch.full_like(x, value)


def _stirling_approx_tail(k: torch.Tensor) -> torch.Tensor:
    """The reference's tail, quirk included: k is clamped to [0, 9]
    before the approximation, so above 9 it returns the approximation at
    k = 9 (never taken: the table covers k <= 9). The table is selected
    entry by entry on the device (a host-built table would be a blocking
    copy, a host sync)."""
    use_table = k <= 9
    k = k.clamp(0.0, 9.0)
    kp1sq = (k + 1) * (k + 1)
    approx = ((_c(k, 1.0 / 12) - (_c(k, 1.0 / 360)
                                  - _c(k, 1.0 / 1260) / kp1sq) / kp1sq)
              / (k + 1))
    k = torch.floor(k)
    tail = approx
    for j, value in enumerate(_STIRLING_TAIL):
        tail = torch.where(use_table & (k == j), _c(k, value), tail)
    return tail


def _round_keys(key: torch.Tensor, rounds: int):
    """The per-round subkeys of both branches, ``[..., rounds, 2]`` each:
    inversion's ``subkey, key = split(key)`` and BTRS's ``key, subkey_0,
    subkey_1 = split(key, 3)``, each a chain from ``key``. (A split's
    i-th key does not depend on how many are made, so one 3-way split per
    step serves both chains.)"""
    chains = torch.stack([key, key])               # [2, ..., 2]
    inv, b0, b1 = [], [], []
    for _ in range(rounds):
        s = split(chains, 3)                       # [2, ..., 3, 2]
        inv.append(s[0, ..., 0, :])
        b0.append(s[1, ..., 1, :])
        b1.append(s[1, ..., 2, :])
        chains = torch.stack([s[0, ..., 1, :], s[1, ..., 0, :]])
    return (torch.stack(inv, -2), torch.stack(b0, -2), torch.stack(b1, -2))


def _binomial_inversion(sub, count, prob):
    """``_binomial_inversion``: geometric gaps summed until they pass the
    count; the sample is the number of rounds that started at or below
    it, minus 1. Returns (sample, whether the rounds sufficed)."""
    log1minusprob = torch.log1p(-prob)
    u = uniform(sub)                                # [..., R]
    geom = torch.ceil(torch.log(u) / log1minusprob[..., None])
    geom_sum = torch.zeros_like(prob)
    num_geom = torch.zeros_like(prob)
    one = torch.ones_like(prob)
    for r in range(geom.shape[-1]):                # float32 sums, in order
        num_geom = torch.where(geom_sum <= count, num_geom + one, num_geom)
        geom_sum = geom_sum + geom[..., r]
    return num_geom - one, ~(geom_sum <= count)


def _btrs(sub0, sub1, count, prob):
    """``_btrs``, the transformed rejection of Hörmann (1993): the sample
    of the first accepted round. Returns (sample, whether one was)."""
    stddev = torch.sqrt(count * prob * (1 - prob))
    b = 1.15 + 2.53 * stddev
    a = -0.0873 + 0.0248 * b + 0.01 * prob
    c = count * prob + 0.5
    v_r = 0.92 - _c(b, 4.2) / b
    r = prob / (1 - prob)
    alpha = (2.83 + _c(b, 5.1) / b) * stddev
    m = torch.floor((count + 1) * prob)
    count, prob, b, a, c, v_r, r, alpha, m = (
        x[..., None] for x in (count, prob, b, a, c, v_r, r, alpha, m))

    u = uniform(sub0) - 0.5                         # [..., R]
    v = uniform(sub1)
    us = 0.5 - torch.abs(u)
    accept1 = (us >= 0.07) & (v <= v_r)
    k = torch.floor((2 * a / us + b) * u + c)
    reject = (k < 0) | (k > count)
    v = torch.log(v * alpha / (a / (us * us) + b))
    ub = ((m + 0.5) * torch.log((m + 1) / (r * (count - m + 1)))
          + (count + 1) * torch.log((count - m + 1) / (count - k + 1))
          + (k + 0.5) * torch.log(r * (count - k + 1) / (k + 1))
          + _stirling_approx_tail(m)
          + _stirling_approx_tail(count - m)
          - _stirling_approx_tail(k)
          - _stirling_approx_tail(count - k))
    accept = accept1 | (~reject & (v <= ub))
    first = torch.argmax(accept.to(torch.uint8), dim=-1, keepdim=True)
    return torch.gather(k, -1, first)[..., 0], accept.any(dim=-1)


def _on_device_f32(x, key: torch.Tensor) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=key.device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=key.device)


def binomial(key: torch.Tensor, count, prob) -> torch.Tensor:
    """float32 Binomial(count, prob) samples, ``jax.random.binomial(key,
    count, prob)`` bit for bit (float32, x64 off): shape ``[B...]`` for
    keys ``[B..., 2]``, count and prob numbers or tensors that broadcast
    to it, each sample drawn as the reference draws one from its own key
    (as under ``vmap``). The count passes through float32 and is floored;
    a NaN or negative count or a NaN or negative q gives NaN, an infinite
    count inf. Neither branch syncs the host."""
    count = _on_device_f32(count, key)
    prob = _on_device_f32(prob, key)
    shape = torch.broadcast_shapes(key.shape[:-1], count.shape, prob.shape)
    key = key.expand(shape + (2,))
    count, prob = count.expand(shape), prob.expand(shape)

    p_lt_half = prob < 0.5
    q = torch.where(p_lt_half, prob, 1.0 - prob)
    count_nan_or_neg = torch.isnan(count) | (count < 0.0)
    count_inf = torch.isinf(count)
    q_is_nan = torch.isnan(q)
    q_l_0 = q < 0.0
    q = torch.where(q_is_nan | q_l_0, _c(q, 0.01), q)
    use_inversion = count_nan_or_neg | (count * q <= 10.0)
    count = torch.floor(count)

    count_inv = torch.where(use_inversion, count, _c(count, 0.0))
    count_btrs = torch.where(use_inversion, _c(count, 1e4), count)
    q_btrs = torch.where(use_inversion, _c(q, 0.5), q)
    rounds = BINOMIAL_ROUNDS
    inv_sub, b_sub0, b_sub1 = _round_keys(key, rounds)
    k_inv, inv_done = _binomial_inversion(inv_sub, count_inv, q)
    k_btrs, btrs_done = _btrs(b_sub0, b_sub1, count_btrs, q_btrs)
    samples = torch.where(use_inversion, k_inv, k_btrs)
    done = torch.where(use_inversion, inv_done, btrs_done)

    invalid = q_l_0 | q_is_nan | count_nan_or_neg
    torch._assert_async(
        (done | invalid | count_inf).all(),
        f"binomial: a sample needed more than {rounds} rounds")
    samples = torch.where(invalid, _c(samples, float("nan")), samples)
    samples = torch.where(count_inf & ~invalid, _c(samples, float("inf")),
                          samples)
    return torch.where(p_lt_half | count_nan_or_neg | q_is_nan | count_inf,
                       samples, count - samples)
