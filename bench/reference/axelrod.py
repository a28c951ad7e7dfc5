"""Plain reference of Axelrod cultural dynamics (paper §4.1), in torch.

The chain of one run is a list of calls, each of ``tasks`` tasks drawn
from its own seed; tasks run in chain order, one call after the other on
the same traits. A task draws its source uniformly and its target
uniformly among the other agents, then (bounded confidence) with
probability o = (features in common) / F, if 0 < o < 1 and o >= 1 - ω,
the target copies the source's trait at the first maximum of uniforms
drawn over the features in which they differ.

The chain is cut into runs of consecutive tasks of which no later one
touches an agent that an earlier one writes, or writes an agent that an
earlier one reads: the tasks of such a run commute, so running them as
one vector update equals running them one by one.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import threefry

#: tasks drawn and executed per block (the draws of a block are [B, F])
BLOCK = 32768


def create(base: torch.Tensor, start: int, count: int, n: int, f: int):
    """(src, tgt, u, pick uniforms [count, f]) of tasks [start, start +
    count) of a call."""
    idx = start + torch.arange(count, dtype=torch.int64, device=base.device)
    ks, kt, kx = threefry.split(threefry.fold_in(base, idx), 3).unbind(-2)
    src = threefry.randint(ks, n)
    tgt = threefry.randint(kt, n - 1)
    tgt = torch.where(tgt >= src, tgt + 1, tgt)
    ku, kf = threefry.split(kx, 2).unbind(-2)
    return src, tgt, threefry.uniform(ku), threefry.uniform(kf, f)


def _last_before(ids: np.ndarray, query: np.ndarray) -> np.ndarray:
    """For each j, the last p < j with ids[p] == query[j], else -1."""
    t = ids.shape[0]
    pos = np.arange(t, dtype=np.int64)
    keys = np.sort(ids.astype(np.int64) * t + pos)
    at = np.searchsorted(keys, query.astype(np.int64) * t + pos) - 1
    hit = keys[np.maximum(at, 0)]
    ok = (at >= 0) & (hit // t == query)
    return np.where(ok, hit % t, -1)


def runs(src: np.ndarray, tgt: np.ndarray) -> list[tuple[int, int]]:
    """Cut tasks into runs [a, b) in which no task reads or writes the
    target of an earlier task of the run, or writes its source."""
    last = np.maximum.reduce([_last_before(tgt, src), _last_before(tgt, tgt),
                              _last_before(src, tgt)])
    out, a, t = [], 0, src.shape[0]
    while a < t:
        b = t
        hits = np.flatnonzero(last[a + 1:] >= a)
        if hits.size:
            b = a + 1 + int(hits[0])
        out.append((a, b))
        a = b
    return out


def run(traits: torch.Tensor, call_seeds, tasks: int, *, omega: float,
        dtype=torch.float32):
    """The traits after the chain, and the number of tasks run. ``dtype``
    is the precision of the draws, the overlap and the comparisons:
    float32 as the model states it, or lower for the control."""
    traits = traits.clone()
    n, f = traits.shape
    dev = traits.device
    nf = torch.full((), float(f), dtype=torch.float32, device=dev)
    lo = torch.full((), 1.0 - omega, dtype=torch.float32, device=dev)
    lo = lo.to(dtype)
    ran = 0
    for seed in call_seeds:
        base = threefry.key(seed, dev)
        for start in range(0, tasks, BLOCK):
            count = min(BLOCK, tasks - start)
            src, tgt, u, g = create(base, start, count, n, f)
            u, g = u.to(dtype), g.to(dtype)
            for a, b in runs(src.cpu().numpy(), tgt.cpu().numpy()):
                s_row, t_row = traits[src[a:b]], traits[tgt[a:b]]
                eq = s_row == t_row
                o = (eq.sum(1).to(torch.float32) / nf).to(dtype)
                act = (u[a:b] < o) & (o < 1) & (o >= lo)
                pick = torch.where(eq, torch.full_like(g[a:b], -1),
                                   g[a:b]).argmax(1)
                rows = torch.arange(b - a, device=dev)
                new = torch.where(act, s_row[rows, pick], t_row[rows, pick])
                traits[tgt[a:b], pick] = new
            ran += count
    return traits, ran
