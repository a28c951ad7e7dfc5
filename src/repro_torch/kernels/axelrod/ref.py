"""Plain PyTorch version of one Axelrod wave on gathered trait rows.

Counterpart of ``repro/kernels/axelrod/ref.py::axelrod_wave_ref``, on
unpadded ``[W, F]`` rows (the reference pads F to the TPU's 128 lanes).
The float32 arithmetic is the reference's: the overlap is a float32 count
divided by F, ``1 - omega`` is formed in Python doubles and rounded to
float32 (jnp's weak-typed scalar), and the picked feature is the first
maximum of the differing features' uniforms. Scalars are filled on the
tensors' device: PyTorch's CUDA division by a host scalar multiplies by
its reciprocal, which would not be the reference's division.
"""
from __future__ import annotations

import torch


def axelrod_wave_ref(s_tr: torch.Tensor, t_tr: torch.Tensor,
                     u: torch.Tensor, gumbel: torch.Tensor,
                     mask: torch.Tensor, *, omega: float,
                     n_features: int) -> tuple[torch.Tensor, torch.Tensor]:
    """s_tr, t_tr [W, F] int32 (source / target traits), u [W] float32,
    gumbel [W, F] float32, mask [W] bool -> (new_t [W, F] int32,
    interact [W] bool)."""
    dev = s_tr.device
    nf, lo = (torch.full((), x, dtype=torch.float32, device=dev)
              for x in (float(n_features), 1.0 - omega))
    eq = s_tr == t_tr
    overlap = eq.sum(dim=-1).to(torch.float32) / nf
    interact = mask & (u < overlap) & (overlap < 1.0) & (overlap >= lo)
    scores = torch.where(eq, -1.0, gumbel)
    feat = scores.argmax(dim=-1)
    onehot = (torch.arange(s_tr.shape[1], device=dev)[None, :]
              == feat[:, None])
    new_t = torch.where(onehot & interact[:, None], s_tr, t_tr)
    return new_t, interact
