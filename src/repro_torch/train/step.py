"""Train-step builder: loss, gradients and AdamW, with microbatching.

Port of ``repro/train/step.py`` for one device (the pjit shardings of
the reference's ``train_state_shardings`` come with the sharded LM
modules, ROADMAP.md, queue 1, item D.6).

``make_train_step(model, hp)`` returns ``step_fn(state, batch) ->
(state, metrics)``. The batch holds tensors on the state's device; the
state is updated in place and returned; the metrics (``ce``, ``loss``,
``grad_norm``, ``lr``) are device tensors. A step makes no host sync.

Microbatching (gradient accumulation) runs the microbatch slices one
after another, sums their gradients in float32 and divides by their
count, as the reference's ``lax.scan``; the metrics are the mean over
the microbatches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

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


def make_train_step(model, hp: TrainHParams):
    """Returns step_fn(state, batch) -> (state, metrics)."""

    def grads_of(params, leaves, batch):
        loss, metrics = model.loss(params, batch)
        # a parameter the loss does not reach (seamless-m4t's encoder, as
        # planned in the reference) gets a zero gradient, as jax.grad's
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(
                     loss, leaves, allow_unused=True))]
        return grads, {**{k: v.detach() for k, v in metrics.items()},
                       "loss": loss.detach()}

    def step_fn(state: TrainState, batch):
        named = dict(named_leaves(state.params))
        leaves = list(named.values())
        n_micro = hp.microbatches
        if n_micro > 1:
            rows = {k: v.shape[0] for k, v in batch.items()}
            if any(r % n_micro for r in rows.values()):
                raise ValueError(f"batch rows {rows} do not split into "
                                 f"{n_micro} microbatches")
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves]
            ms = []
            for i in range(n_micro):
                mb = {k: v[i * (v.shape[0] // n_micro):
                           (i + 1) * (v.shape[0] // n_micro)]
                      for k, v in batch.items()}
                g, m = grads_of(state.params, leaves, mb)
                for acc, gi in zip(gsum, g):
                    acc.add_(gi)            # gi rounded up to float32
                ms.append(m)
                del g
            grads = [acc.div_(n_micro) for acc in gsum]
            metrics = {k: torch.stack([m[k] for m in ms]).mean(dim=0)
                       for k in ms[0]}
        else:
            grads, metrics = grads_of(state.params, leaves, batch)

        lr = cosine_schedule(state.step, peak_lr=hp.peak_lr,
                             warmup_steps=hp.warmup_steps,
                             total_steps=hp.total_steps)
        params, opt, opt_metrics = adamw_update(
            hp.adamw, state.params, dict(zip(named, grads)), state.opt, lr)
        metrics.update(opt_metrics)
        with torch.no_grad():
            state.step.add_(1)
        return TrainState(params, opt, state.step), metrics

    return step_fn
