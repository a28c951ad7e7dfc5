"""AdamW with float32 moments.

Port of ``repro/train/optim.py``. A parameter tree is an ``nn.Module``
(its ``named_parameters``) or a dict of named tensors; moments and
gradients are dicts keyed by the same names. Unlike the reference, which
returns new trees, ``adamw_update`` writes the parameters, the moments
and the count **in place** and returns them: the moments of a 3 B model
take 23 GB, and a second copy would not fit beside them.

Everything stays on the parameters' device — the clip scale
``min(1, clip / (gnorm + 1e-9))``, the bias corrections ``1 - b ** count``
in float32, the learning rate when it is a tensor — so an update makes
no host sync. Each element goes through the reference's operations in
the reference's order, rounded to float32 at each.

Weight decay follows the reference's rule, ``p.ndim >= 2``, on the
**reference's** rank: the reference stacks a segment's layers into one
leaf ``[L, ...]``, so every per-layer vector there (norm scales, the RWKV
lerps ``mu_*``, ``w0``, ``u``, ``ln_scale``) is a matrix and decays,
while ``final_norm.scale`` does not. The port keeps one module per layer,
so the rank is ``utils.pytree.reference_ndim``'s, not the tensor's own.

On a mesh (``train/step.py::place_train_state``) the parameters, the
gradients and the moments are DTensors, the moments placed by ZeRO-1
(``distributed/sharding.py::zero1_pspec``: the parameter's spec plus the
data axes on one more dim). Each leaf's update then runs on the moment's
shard: the gradient is reduced straight into that placement (a
reduce-scatter of its partial sums), the parameter sliced to it, the same
element-wise operations applied to the local shards, and the new values
gathered back into the parameter's own placement. The global norm is
DTensor's sum over the logical gradients.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.distributed.spmd import full_tensor, is_dtensor, local
from repro_torch.utils.pytree import named_leaves, reference_ndim


def _named(tree) -> dict[str, torch.Tensor]:
    """name -> tensor of a parameter (or gradient) tree."""
    return dict(named_leaves(tree))


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    count: torch.Tensor             # int32 [], on the parameters' device


def adamw_init(params) -> OptState:
    named = _named(params)

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    p0 = next(iter(named.values()))
    device = local(p0).device
    return OptState(mu={k: zeros(p) for k, p in named.items()},
                    nu={k: zeros(p) for k, p in named.items()},
                    count=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, leaf by
    leaf in the tree's order (the reference's Python ``sum``)."""
    leaves = _named(tree).values()
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves))


def _on_moment(p, g, m):
    """(p, g) as local tensors on the moment's shard (``m``'s placements)
    and a function writing the new parameter values back into ``p``."""
    if not is_dtensor(p):
        return p, g, p.copy_
    zp = m.placements
    g = g.redistribute(placements=zp).to_local()
    pl = p.redistribute(placements=zp).to_local() \
        if p.placements != zp else p.to_local()

    def write(new):
        if p.placements != zp:
            from torch.distributed.tensor import DTensor

            new = DTensor.from_local(new.to(p.dtype), m.device_mesh, zp,
                                     run_check=False).redistribute(
                placements=p.placements).to_local()
        p.to_local().copy_(new)

    return pl, g, write


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState, lr):
    """Returns (params, state, metrics), the first two updated in place;
    metrics ``{"grad_norm", "lr"}``."""
    named = _named(params)
    g_named = _named(grads)
    gnorm = full_tensor(global_norm(g_named))
    scale = torch.clamp(torch.div(gnorm.new_full((), cfg.grad_clip),
                                  gnorm + 1e-9), max=1.0)
    count = local(state.count.add_(1))
    c1 = 1.0 - torch.pow(cfg.b1, count.float())
    c2 = 1.0 - torch.pow(cfg.b2, count.float())
    lr = local(lr)
    for name, p in named.items():
        p_, g, write = _on_moment(p, g_named[name], state.mu[name])
        m, v = local(state.mu[name]), local(state.nu[name])
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if reference_ndim(name, p) >= 2:    # decoupled decay, matrices
            step = step + cfg.weight_decay * p_.float()
        write(p_.float() - lr * step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
