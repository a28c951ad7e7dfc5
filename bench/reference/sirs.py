"""Plain reference of SIRS on the ring (paper §4.2), in torch.

N agents on a ring of degree k are cut into M = N / s subsets of s. The
chain of a call repeats steps of 2M tasks: M computes A_0..A_{M-1}, then
M commits B_0..B_{M-1}. A_i gives each agent of subset i its next state
from the current states, with its own uniform (S -> I with probability
p_SI times the infected share of its k neighbours, I -> R with p_IR,
R -> S with p_RS) into a buffer; B_i copies subset i's buffer into the
states. Task j of a call (chain index j) draws s uniforms from the key
fold_in(key(seed), j). A run of computes reads only states and a run of
commits writes each subset once, so each runs as one vector update.
"""
from __future__ import annotations

import torch

from bench.reference import threefry

S, I, R = 0, 1, 2
#: compute tasks whose uniforms are drawn together
DRAW_BLOCK = 8192


def run(states: torch.Tensor, new_states: torch.Tensor, call_seeds,
        tasks: int, *, k: int, subset_size: int, p_si: float, p_ir: float,
        p_rs: float, dtype=torch.float32):
    """(states, new_states) after the chain, and the number of tasks run.
    ``dtype`` is the precision of the uniforms, the infected share and
    the comparisons: float32 as the model states it, or lower for the
    control."""
    states, new_states = states.clone(), new_states.clone()
    n, s, dev = states.shape[0], subset_size, states.device
    m = n // s
    half = k // 2
    offs = torch.tensor([d for d in range(-half, half + 1) if d],
                        dtype=torch.int64, device=dev)
    nbrs = (torch.arange(n, dtype=torch.int64, device=dev)[:, None]
            + offs) % n
    kf, psi, pir, prs = (torch.full((), float(x), dtype=torch.float32,
                                    device=dev) for x in (k, p_si, p_ir, p_rs))
    psi, pir, prs = psi.to(dtype), pir.to(dtype), prs.to(dtype)
    group = max(1, DRAW_BLOCK // m)
    ran = 0
    for seed in call_seeds:
        base = threefry.key(seed, dev)
        steps = list(range(0, tasks, 2 * m))
        for g0 in range(0, len(steps), group):
            starts = steps[g0:g0 + group]
            counts = [min(m, tasks - c) for c in starts]
            idx = torch.cat([c + torch.arange(cnt, device=dev)
                             for c, cnt in zip(starts, counts)])
            u_all = threefry.uniform(threefry.fold_in(base, idx), s)
            u_all = u_all.to(dtype)
            at = 0
            for c, a_cnt in zip(starts, counts):
                u = u_all[at:at + a_cnt].reshape(-1)
                at += a_cnt
                agents = slice(0, a_cnt * s)
                cur = states[agents]
                share = ((states[nbrs[agents]] == I).to(torch.float32)
                         .sum(1) / kf).to(dtype)
                nxt = torch.where(
                    (cur == S) & (u < psi * share), I,
                    torch.where((cur == I) & (u < pir), R,
                                torch.where((cur == R) & (u < prs), S, cur)))
                new_states[agents] = nxt.to(torch.int8)
                b_cnt = max(0, min(m, tasks - c - m))
                states[:b_cnt * s] = new_states[:b_cnt * s]
                ran += a_cnt + b_cnt
    return states, new_states, ran
