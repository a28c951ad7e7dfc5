"""Plain PyTorch versions of one SIRS wave of type-A updates on the ring.

  sir_wave_ref     counterpart of ``repro/kernels/sir/ref.py``: the
                   transition on halo rows ``[W, s + k]`` gathered by the
                   caller
  sir_wave_plain   the ops-level function (``repro/kernels/sir/ops.py``):
                   gathers the ring halo ``(subset·s − k/2 + j) mod N``
                   and calls ``sir_wave_ref``; int8 next states, the
                   kernel's output

The float32 arithmetic is the reference's: the infected count is a float32
sum of 0/1 over the k shifts (exact), divided by k, and the rates are
rounded to float32 (jnp's weak-typed scalars). Scalars are filled on the
tensors' device: PyTorch's CUDA division by a host scalar multiplies by
its reciprocal, which would not be the reference's division.
"""
from __future__ import annotations

import torch

S, I, R = 0, 1, 2


def sir_wave_ref(ext_states: torch.Tensor, u: torch.Tensor, *, k: int,
                 subset_size: int, p_si: float, p_ir: float,
                 p_rs: float) -> torch.Tensor:
    """ext_states [W, s + k] (the ring slice covering each subset plus k/2
    halo cells on each side), u [W, s] float32 -> [W, s] int32 next
    states."""
    half, s = k // 2, subset_size
    dev = ext_states.device
    kf, psi, pir, prs = (torch.full((), float(x), dtype=torch.float32,
                                    device=dev)
                         for x in (k, p_si, p_ir, p_rs))
    acc = torch.zeros(ext_states[:, :s].shape, dtype=torch.float32,
                      device=dev)
    for d in range(2 * half + 1):
        if d != half:  # skip self
            acc = acc + (ext_states[:, d:d + s] == I).to(torch.float32)
    inf_frac = acc / kf
    cur = ext_states[:, half:half + s].to(torch.int32)
    uu = u[:, :s]
    return torch.where(
        (cur == S) & (uu < psi * inf_frac), I,
        torch.where(
            (cur == I) & (uu < pir), R,
            torch.where((cur == R) & (uu < prs), S, cur),
        ),
    ).to(torch.int32)


def sir_wave_plain(states: torch.Tensor, subsets: torch.Tensor,
                   u: torch.Tensor, *, n_agents: int, k: int,
                   subset_size: int, p_si: float, p_ir: float,
                   p_rs: float) -> torch.Tensor:
    """states [N], subsets [W] int32, u [W, s] float32 -> [W, s] int8 next
    states of each subset's agents."""
    half, s = k // 2, subset_size
    offs = torch.arange(s + 2 * half, dtype=torch.int64,
                        device=states.device)
    idx = (subsets.to(torch.int64)[:, None] * s - half
           + offs[None, :]) % n_agents
    return sir_wave_ref(states[idx], u, k=k, subset_size=s, p_si=p_si,
                        p_ir=p_ir, p_rs=p_rs).to(torch.int8)
