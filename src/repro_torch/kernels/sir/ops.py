"""Public wrapper for one SIRS wave of type-A updates on the ring.

A CUDA tensor launches the hand-written kernel (sir.py), which reads the
ring halo straight from the agent states; a CPU tensor takes the plain
version (ref.py), which gathers the halo first. ``backend`` forces one:
``"cuda"`` (the kernel — CUDA tensors only) or ``"torch"`` (the plain
version on the tensors' own device, as the kernel's parity checks use
it). ``work`` is the kernel's work in bytes and operations, which the
CUDA branch reports to an installed cost recorder (``obs/costs.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.sir.ref import sir_wave_plain
from repro_torch.kernels.sir.sir import sir_wave_cuda
from repro_torch.obs.costs import current_recorder


def work(subsets: torch.Tensor, *, n_agents: int, k: int,
         subset_size: int) -> tuple[int, int]:
    """(bytes, operations) of one wave over ``subsets``: every distinct
    ring state the subsets' halos read (1 byte each), the uniforms (4),
    the next states (1) and the subset ids (4 a row); a compare and an
    add per neighbour and agent. Data-dependent: it counts the distinct
    halo agents on the device (a host sync)."""
    w, half = subsets.shape[0], k // 2
    halo = (subsets.long()[:, None] * subset_size - half
            + torch.arange(subset_size + 2 * half,
                           device=subsets.device)) % n_agents
    halo_bytes = int(torch.unique(halo).numel())
    return halo_bytes + w * (5 * subset_size + 4), 2 * k * w * subset_size


def sir_wave(states, subsets, u, *, n_agents: int, k: int,
             subset_size: int, p_si: float, p_ir: float, p_rs: float,
             backend: str | None = None) -> torch.Tensor:
    """Next states [W, s] int8 of each subset's agents on the ring of
    degree k.

    states [N] — ring states (S=0, I=1, R=2); subsets [W] int32 — subset
    ids; u [W, s] float32 — the agents' uniforms.
    """
    if states.shape != (n_agents,) or u.shape[1:] != (subset_size,):
        raise ValueError(f"states {tuple(states.shape)} and u "
                         f"{tuple(u.shape)} do not match N={n_agents}, "
                         f"s={subset_size}")
    states = states.to(torch.int8).contiguous()
    subsets = subsets.to(torch.int32).contiguous()
    u = u.to(torch.float32).contiguous()
    if backend is None:
        backend = "cuda" if use_kernel(states) else "torch"
    if backend == "cuda":
        out = sir_wave_cuda(states, subsets, u, k=k, p_si=p_si, p_ir=p_ir,
                            p_rs=p_rs)
        rec = current_recorder()
        if rec is not None:
            rec.kernel("sir_wave", *work(subsets, n_agents=n_agents, k=k,
                                         subset_size=subset_size))
        return out
    if backend == "torch":
        return sir_wave_plain(states, subsets, u, n_agents=n_agents, k=k,
                              subset_size=subset_size, p_si=p_si,
                              p_ir=p_ir, p_rs=p_rs)
    raise ValueError(f"unknown sir backend {backend!r}")
