"""Train-step builder: loss, gradients and AdamW, with microbatching.

Port of ``repro/train/step.py``.

``make_train_step(model, hp)`` returns ``step_fn(state, batch) ->
(state, metrics)``. The batch holds tensors on the state's device; the
state is updated in place and returned; the metrics (``ce``, ``loss``,
``grad_norm``, ``lr``) are device tensors. A step makes no host sync.

On a mesh: ``train_state_shardings`` gives every leaf its spec (the
reference's: parameters by ``param_pspec``, moments by ZeRO-1's
``zero1_pspec``, the counters replicated), ``place_train_state`` makes
the state DTensors so placed, and the same ``step_fn`` runs on it, the
batch placed by ``train_batch_shardings``: DTensor propagates the
placements through the model (``distributed/spmd.py``), and the loss and
the metrics come back as plain tensors, alike on every rank.

Microbatching (gradient accumulation) runs the microbatch slices one
after another, sums their gradients in float32 and divides by their
count, as the reference's ``lax.scan``; the metrics are the mean over
the microbatches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.distributed.sharding import (
    batch_shardings,
    distribute,
    opt_state_shardings,
    params_shardings,
    place,
    place_module,
    replicated,
)
from repro_torch.distributed.spmd import full_tensor, local
from repro_torch.obs.costs import current_recorder, loop as cost_loop
from repro_torch.train.optim import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
)
from repro_torch.train.schedule import cosine_schedule
from repro_torch.utils.pytree import named_leaves


class TrainState(NamedTuple):
    params: Any                     # the model's LMParams, requires_grad
    opt: OptState
    step: torch.Tensor              # int32 [], on the parameters' device


@dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    microbatches: int = 1
    adamw: AdamWConfig = AdamWConfig()


def init_train_state(model, key, *, device=None) -> TrainState:
    """Parameters drawn from ``key`` (a seed or a ``torch.Generator``) on
    ``device``, which must be the model's (``None`` = the card, raising
    without one), with gradients on; zero moments and step."""
    params = model.init(key, device=device)
    params.requires_grad_(True)
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def loss_grads(model):
    """Returns ``grads_of(params, leaves, batch) -> (grads, metrics)``:
    the loss's gradients with respect to ``leaves`` (the parameters'
    named leaves, in order) on one batch or microbatch, and its metrics
    (``loss`` and the model's), detached."""

    def grads_of(params, leaves, batch):
        loss, metrics = model.loss(params, batch)
        loss = full_tensor(loss)    # on a mesh: the logical loss
        # a parameter the loss does not reach (seamless-m4t's encoder, as
        # planned in the reference) gets a zero gradient, as jax.grad's
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(
                     loss, leaves, allow_unused=True))]
        return grads, {**{k: full_tensor(v).detach()
                          for k, v in metrics.items()},
                       "loss": loss.detach()}

    return grads_of


def apply_update(hp: TrainHParams, state: TrainState, named: dict, grads,
                 metrics: dict):
    """AdamW on ``grads`` (in ``named``'s order) at the step's learning
    rate; the state updated in place. Returns (state, metrics with the
    optimizer's)."""
    lr = cosine_schedule(local(state.step), peak_lr=hp.peak_lr,
                         warmup_steps=hp.warmup_steps,
                         total_steps=hp.total_steps)
    params, opt, opt_metrics = adamw_update(
        hp.adamw, state.params, dict(zip(named, grads)), state.opt, lr)
    metrics.update(opt_metrics)
    with torch.no_grad():
        state.step.add_(1)
    return TrainState(params, opt, state.step), metrics


def make_train_step(model, hp: TrainHParams):
    """Returns step_fn(state, batch) -> (state, metrics)."""
    grads_of = loss_grads(model)

    def step_fn(state: TrainState, batch):
        named = dict(named_leaves(state.params))
        leaves = list(named.values())
        n_micro = hp.microbatches
        if n_micro > 1:
            rows = {k: v.shape[0] for k, v in batch.items()}
            if any(r % n_micro for r in rows.values()):
                raise ValueError(f"batch rows {rows} do not split into "
                                 f"{n_micro} microbatches")
            gsum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in leaves]
            ms = []
            with cost_loop(current_recorder(), n_micro):
                for i in range(n_micro):
                    mb = {k: v[i * (v.shape[0] // n_micro):
                               (i + 1) * (v.shape[0] // n_micro)]
                          for k, v in batch.items()}
                    g, m = grads_of(state.params, leaves, mb)
                    for acc, gi in zip(gsum, g):
                        acc.add_(gi)        # gi rounded up to float32
                    ms.append(m)
                    del g
            grads = [acc.div_(n_micro) for acc in gsum]
            metrics = {k: torch.stack([m[k] for m in ms]).mean(dim=0)
                       for k in ms[0]}
        else:
            grads, metrics = grads_of(state.params, leaves, batch)
        return apply_update(hp, state, named, grads, metrics)

    return step_fn


# ------------------------------------------------------------- shardings
def train_state_shardings(state: TrainState, cfg, mesh) -> TrainState:
    """The reference's ``train_state_shardings``: a ``TrainState`` of
    {leaf name: NamedSharding} (parameters by ``param_pspec``, moments by
    ``zero1_pspec``), the counters replicated. ``state`` may be a meta
    state (its shapes are all the rules read)."""
    psh = params_shardings(state.params, cfg, mesh)
    zsh = opt_state_shardings(state.params, cfg, mesh)
    rep = replicated(mesh)
    return TrainState(params=psh,
                      opt=OptState(mu=zsh, nu=dict(zsh), count=rep),
                      step=rep)


def train_batch_shardings(batch: dict, mesh, *, layout: str = "tp"):
    return batch_shardings(batch, mesh, layout=layout)


def place_train_state(state: TrainState, shardings: TrainState
                      ) -> TrainState:
    """The state as DTensors placed by ``shardings`` on its
    ``DeviceMesh``: the parameters in place (each ``nn.Parameter`` becomes
    a DTensor parameter, gradients kept on), the moments and counters
    anew. Every rank holds the same full state; each keeps its shards."""
    place_module(state.params, shardings.params)
    return TrainState(
        params=state.params,
        opt=OptState(mu=place(state.opt.mu, shardings.opt.mu),
                     nu=place(state.opt.nu, shardings.opt.nu),
                     count=distribute(state.opt.count, shardings.opt.count)),
        step=distribute(state.step, shardings.step))
