"""Plain version of the Barabási–Albert attachment kernel: a different
algorithm over the same draws, so the two check each other.

It pre-draws ``rounds`` rejection rounds for every arrival at once with
the vectorized ``prng`` (each round's slot from ``randint(sub, (), 0,
span_i)`` along the chain ``kk, sub = split(kk)`` from ``fold_in(key,
t)``), gathers their candidates, then walks the arrivals in a host loop
of integer lookups. An arrival that rejects every pre-drawn round
continues its chain with a host mirror of the hash (``_draw``), as many
rounds as it needs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import prng

_M = prng.MASK

#: rejection rounds the arrivals used, summed over every call (a
#: diagnostic: the work the kernel does on the same draws)
rounds_drawn = 0
#: the longest chain of target-on-target lookups of the last call: an
#: arrival that reads a target of an earlier arrival of the same call is
#: one link past it (the kernel's critical path, in dependent lookups)
chain_depth = 0


def blocks(count: int, warm: int | None, block: int | None) -> tuple[int,
                                                                    int]:
    """(warm, block) of a call: ``warm`` exact arrivals (default all of
    them), then frozen blocks of ``block`` (default one of the rest)."""
    warm = count if warm is None else int(warm)
    block = max(count - warm, 1) if block is None else int(block)
    if not 0 <= warm <= count or block < 1:
        raise ValueError(f"need 0 <= warm <= count and block >= 1: warm "
                         f"{warm}, count {count}, block {block}")
    return warm, block


def _threefry(k1, k2, x1, x2):
    """Threefry-2x32 on Python ints (prng.threefry2x32's arithmetic)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1, x2 = (x1 + k1) & _M, (x2 + k2) & _M
    for i in range(5):
        for r in prng._ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M
            x2 = (((x2 << r) & _M) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M
    return x1, x2


def _bits(k):
    y1, y2 = _threefry(*k, 0, 0)
    return y1 ^ y2


def _draw(kk, span):
    """One round: (next kk, slot) — ``kk, sub = split(kk)`` then
    ``randint(sub, (), 0, span)``."""
    sub, kk = _threefry(*kk, 0, 1), _threefry(*kk, 0, 0)
    higher = _bits(_threefry(*sub, 0, 0))
    lower = _bits(_threefry(*sub, 0, 1))
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M) % span
    offset = (((higher % span) * mult & _M) + lower % span) & _M
    return kk, offset % span


def attach_plain(key: torch.Tensor, ends: torch.Tensor, *, first: int,
                 count: int, fill: int, m: int, warm: int | None = None,
                 block: int | None = None,
                 rounds: int | None = None) -> torch.Tensor:
    """The kernel's function on any device: writes the arrivals' slabs
    into ``ends`` and returns targets [count, m] int32. Arrival i draws
    from ``ends[:span_i]``: span_i = fill + 2m·i for i < warm, then fill +
    2m·(warm + block·⌊(i − warm)/block⌋) (see ``blocks``). ``rounds``
    rounds are pre-drawn per arrival (default m + 2), and their
    candidates gathered from ``ends`` as it stands; a candidate in a slab
    this call writes is read from the slabs on the host."""
    global rounds_drawn, chain_depth
    warm, block = blocks(count, warm, block)
    dev = ends.device
    rounds = m + 2 if rounds is None else int(rounds)
    i = torch.arange(count, dtype=torch.int64, device=dev)
    at = torch.where(i < warm, i, warm + block * ((i - warm) // block))
    fills = fill + 2 * m * at
    kk = prng.fold_in(key.to(dev), first + i)                  # [A, 2]
    subs = []
    for _ in range(rounds):
        s = prng.split(kk)
        kk, sub = s[:, 0], s[:, 1]
        subs.append(sub)
    if subs:
        slots = prng.randint(torch.stack(subs, 1), (), 0, fills[:, None])
        cands = ends[slots.long()].cpu().tolist()
        slots = slots.cpu().tolist()
    else:
        slots = cands = [[] for _ in range(count)]
    chain = kk.cpu().tolist()          # each arrival's key after the rounds
    spans = fills.cpu().tolist()
    slabs = []                         # what this call writes from fill on
    depth = [0] * count                # links of each arrival's chain
    out = np.empty((count, m), dtype=np.int32)
    for a in range(count):
        span, sel, d = spans[a], [], 0
        r = 0
        while len(sel) < m:
            if r < rounds:
                slot, cand = slots[a][r], cands[a][r]
            else:
                chain[a], slot = _draw(chain[a], span)
                cand = None if slot >= fill else int(ends[slot])
            r += 1
            if slot >= fill:
                p = slot - fill
                cand = slabs[p]
                if p % (2 * m) < m:    # a target, not the source t
                    d = max(d, depth[p // (2 * m)] + 1)
            if cand not in sel:
                sel.append(cand)
        rounds_drawn += r
        depth[a] = d
        slabs += sel + [first + a] * m
        out[a] = sel
    chain_depth = max(depth, default=0)
    ends[fill:fill + 2 * m * count] = torch.tensor(slabs, dtype=torch.int32)
    return torch.from_numpy(out).to(dev)
