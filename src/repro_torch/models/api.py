"""Public model API — one ``Model`` object per architecture config.

Port of ``repro/models/api.py`` for the decoder-only dense family and the
ssm family (RWKV6). As in the reference the methods take the parameters
and the streaming states as arguments (``params`` is the ``LMParams``
module tree that ``init`` returns); unlike it, ``prefill`` and
``decode_step`` update the states' tensors **in place** and return the
same dict. The serving path (``init_states``, ``prefill``,
``decode_step``) runs under ``torch.inference_mode``; the training path
(``apply_train``, ``loss``) runs under whatever grad mode the caller
set, so ``torch.autograd.grad`` reaches the parameters through it.

``Model(cfg, device)`` places everything it makes on ``device``; with
``device=None`` that is the card, and without one it raises (the port's
device policy, ``utils/device.py``). ``EncDecModel`` and ``input_specs``
come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import Init, cross_entropy, dtype_of, embed
from repro_torch.models.transformer import (
    LMParams,
    forward_hidden,
    init_params,
    init_states,
    logits_head,
    plan_segments,
)
from repro_torch.utils.device import resolve_device


class Model:
    """Decoder-only dense and ssm families (``attn`` and ``rwkv``
    segments)."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.segments = plan_segments(cfg)

    # ----------------------------------------------------------- params
    def init(self, key: int | torch.Generator = 0, *,
             device=None) -> LMParams:
        """Random parameters (the reference's shapes and scales) drawn
        from ``key``: a seed, or a ``torch.Generator`` on the model's
        device. ``device`` must name the model's device (``None`` = the
        card, as everywhere in the port)."""
        dev = resolve_device(device)
        if dev != self.device:
            raise ValueError(f"init on {dev} for a model on {self.device}")
        gen = key
        if not isinstance(key, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(key))
        with torch.no_grad():
            return init_params(self.cfg, Init(dev, gen))

    def empty_params(self) -> LMParams:
        """The parameter tree, uninitialized (for ``bridge`` to fill)."""
        return init_params(self.cfg, Init(self.device, None))

    # ------------------------------------------------------------ train
    def _embed_inputs(self, params: LMParams, batch,
                      include_prefix: bool = True):
        """Returns (x [B, T, D], n_prefix). The prefixes of the reference
        (vision patches, meta tokens) belong to later families."""
        if include_prefix and "patch_embeds" in batch:
            raise NotImplementedError(
                "vision-stub patch embeddings come with the vision slice "
                "(ROADMAP.md, queue 1, item 13)")
        return embed(params.embed, batch["tokens"]), 0

    def apply_train(self, params: LMParams, batch):
        """Training-mode forward (no cache): (logits [B, T, V], aux).
        Differentiable: with grad enabled each layer runs under
        ``torch.utils.checkpoint`` when ``cfg.remat`` is set."""
        cfg = self.cfg
        x, n_prefix = self._embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        hidden, _, aux = forward_hidden(params, x, cfg, positions=positions,
                                        mode="train")
        hidden = hidden[:, n_prefix:]
        return logits_head(params, hidden, cfg), aux

    def loss(self, params: LMParams, batch):
        """(mean cross-entropy, metrics ``{"ce"}``). The dense and
        RWKV6 families have no auxiliary loss (the reference adds one only
        for MoE)."""
        logits, _ = self.apply_train(params, batch)
        ce = cross_entropy(logits, batch["labels"])
        return ce, {"ce": ce}

    # ---------------------------------------------------------- serving
    @torch.inference_mode()
    def init_states(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        return {
            "segs": init_states(cfg, batch, max_len,
                                dtype_of(cfg.param_dtype), self.device),
            "pos": torch.zeros((batch,), dtype=torch.int32,
                               device=self.device),  # per-request timeline
        }

    @torch.inference_mode()
    def prefill(self, params: LMParams, batch, states, *,
                chunked: bool = False, include_prefix: bool = True):
        """Prompt pass; returns (last-token logits [B, V], states).

        chunked=False (one-shot): attention over the prompt through
        ``cfg.attn_impl`` ("pallas": the flash kernel), then the tail of
        the prompt's KV written into an empty ring. chunked=True: the
        continuation-safe path of the serving engine — the chunk attends
        against the (possibly non-empty) cache. An ``rwkv`` layer runs
        the same way in both: its time-mix carries the state through
        ``cfg.attn_impl`` ("pallas": the wkv6 kernel).
        """
        cfg = self.cfg
        x, _ = self._embed_inputs(params, batch, include_prefix)
        t = x.shape[1]
        positions = (states["pos"][:, None]
                     + torch.arange(t, device=x.device,
                                    dtype=torch.int32)[None, :])
        hidden, _, _ = forward_hidden(
            params, x, cfg, positions=positions, states=states["segs"],
            mode="chunk" if chunked else "prefill")
        logits = logits_head(params, hidden[:, -1:], cfg)[:, 0]
        states["pos"].add_(t)
        return logits, states

    @torch.inference_mode()
    def decode_step(self, params: LMParams, token, states, *,
                    commit: torch.Tensor | None = None):
        """token [B, 1] -> (logits [B, V], states). ``commit`` ([B] bool,
        None = all) names the rows whose state advances; the others come
        out unchanged (the serving engine's masked merge)."""
        cfg = self.cfg
        x = embed(params.embed, token)
        positions = states["pos"][:, None]
        hidden, _, _ = forward_hidden(
            params, x, cfg, positions=positions, states=states["segs"],
            mode="decode", commit=commit)
        logits = logits_head(params, hidden[:, -1:], cfg)[:, 0]
        if commit is None:
            states["pos"].add_(1)
        else:
            states["pos"].add_(commit.to(torch.int32))
        return logits, states


def build_model(cfg, device=None) -> Model:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder model is a later slice of "
            f"the port (ROADMAP.md, queue 1, item 13)")
    return Model(cfg, device)
