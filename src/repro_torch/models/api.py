"""Public model API — one ``Model`` object per architecture config.

Port of ``repro/models/api.py``. As in the reference the methods take
the parameters and the streaming states as arguments (``params`` is the
``LMParams`` module tree that ``init`` returns); unlike it, ``prefill``
and ``decode_step`` update the states' tensors **in place** and return
the same dict. The serving path (``init_states``, ``prefill``,
``decode_step``) runs under ``torch.inference_mode`` (``no_grad`` when
the parameters are DTensors on a mesh); the training path
(``apply_train``, ``loss``) runs under whatever grad mode the caller
set, so ``torch.autograd.grad`` reaches the parameters through it.

``Model`` serves the decoder-only families (dense, moe, ssm, hybrid,
vlm), ``EncDecModel`` the encoder-decoder (seamless-m4t, with the audio
frontend stubbed by precomputed ``src_embeds``); ``input_specs`` gives
meta-device stand-ins of every input of a shape cell
(``configs/shapes.py``).

``Model(cfg, device)`` places everything it makes on ``device``; with
``device=None`` that is the card, and without one it raises (the port's
device policy, ``utils/device.py``).
"""
from __future__ import annotations

import functools
from typing import Any

import torch

from repro_torch.distributed.spmd import is_dtensor, like
from repro_torch.models.layers import Init, cross_entropy, dtype_of, embed
from repro_torch.models.transformer import (
    LMParams,
    forward_hidden,
    init_params,
    init_states,
    logits_head,
    plan_segments,
    run_encoder,
)
from repro_torch.utils.device import resolve_device


def _serving(fn):
    """Run a serving method without autograd: under ``inference_mode``,
    or ``no_grad`` when the parameters are DTensors (a mesh), whose views
    ``inference_mode`` does not allow."""
    @functools.wraps(fn)
    def run(self, params, *args, **kwargs):
        placed = is_dtensor(params.embed.table)
        with torch.no_grad() if placed else torch.inference_mode():
            return fn(self, params, *args, **kwargs)

    return run


class Model:
    """Decoder-only families (dense / moe / ssm / hybrid / vlm)."""

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
        """Returns (x [B, Tfull, D], n_prefix): the prefix — vision-stub
        patch embeddings and/or the meta tokens, in that order outward —
        prepended before the text."""
        cfg = self.cfg
        x = embed(params.embed, batch["tokens"])
        n_prefix = 0
        if include_prefix and cfg.frontend == "vision_stub" \
                and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(x.dtype)
            x = torch.cat([pe, x], dim=1)
            n_prefix += pe.shape[1]
        if include_prefix and cfg.n_prefix_tokens:
            pref = params.prefix[None].expand(
                (x.shape[0],) + params.prefix.shape).to(x.dtype)
            x = torch.cat([pref, x], dim=1)
            n_prefix += pref.shape[1]
        return x, n_prefix

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
        """(total loss, metrics). The total is the mean cross-entropy,
        plus for MoE 0.01 x the load-balance loss and ``router_z_loss`` x
        the router's z-loss; the metrics are ``ce`` and, for MoE, the
        three aux values (the reference's)."""
        logits, aux = self.apply_train(params, batch)
        ce = cross_entropy(logits, batch["labels"])
        total = ce
        metrics = {"ce": ce}
        if self.cfg.moe is not None:
            total = (total + 0.01 * aux["load_balance_loss"]
                     + self.cfg.moe.router_z_loss * aux["router_z_loss"])
            metrics.update(aux)
        return total, metrics

    # ---------------------------------------------------------- serving
    @torch.inference_mode()
    def init_states(self, batch: int, max_len: int) -> dict:
        """Empty streaming states for ``batch`` rows of up to ``max_len``
        tokens (meta tokens included)."""
        cfg = self.cfg
        return {
            "segs": init_states(cfg, batch, max_len,
                                dtype_of(cfg.param_dtype), self.device),
            "pos": torch.zeros((batch,), dtype=torch.int32,
                               device=self.device),  # per-request timeline
        }

    def _prefill_hidden(self, params, batch, states, chunked,
                        include_prefix, enc_out=None):
        x, _ = self._embed_inputs(params, batch, include_prefix)
        t = x.shape[1]
        positions = (states["pos"][:, None]
                     + like(states["pos"], torch.arange(
                         t, device=x.device, dtype=torch.int32)[None, :]))
        hidden, _, _ = forward_hidden(
            params, x, self.cfg, positions=positions, states=states["segs"],
            mode="chunk" if chunked else "prefill", enc_out=enc_out)
        states["pos"].add_(t)
        return logits_head(params, hidden[:, -1:], self.cfg)[:, 0]

    @_serving
    def prefill(self, params: LMParams, batch, states, *,
                chunked: bool = False, include_prefix: bool = True):
        """Prompt pass; returns (last-token logits [B, V], states).

        chunked=False (one-shot): attention over the prompt through
        ``cfg.attn_impl`` ("pallas": the flash kernel), then the tail of
        the prompt's KV written into an empty ring. chunked=True: the
        continuation-safe path of the serving engine — the chunk attends
        against the (possibly non-empty) cache. The prefix (meta tokens,
        patches) goes in front when ``include_prefix`` (the first chunk);
        ``pos`` counts it. An ``rwkv`` layer, and hymba's SSM branch, run
        the same way in both: they carry their state.
        """
        logits = self._prefill_hidden(params, batch, states, chunked,
                                      include_prefix)
        return logits, states

    def _decode_hidden(self, params, token, states, commit, enc_out=None):
        x = embed(params.embed, token)
        positions = states["pos"][:, None]
        hidden, _, _ = forward_hidden(
            params, x, self.cfg, positions=positions, states=states["segs"],
            mode="decode", commit=commit, enc_out=enc_out)
        if commit is None:
            states["pos"].add_(1)
        else:
            states["pos"].add_(commit.to(torch.int32))
        return logits_head(params, hidden[:, -1:], self.cfg)[:, 0]

    @_serving
    def decode_step(self, params: LMParams, token, states, *,
                    commit: torch.Tensor | None = None):
        """token [B, 1] -> (logits [B, V], states). ``commit`` ([B] bool,
        None = all) names the rows whose state advances; the others come
        out unchanged (the serving engine's masked merge). Every row is
        computed: MoE routes all of them, so idle rows compete for
        capacity as in the reference."""
        return self._decode_hidden(params, token, states, commit), states


class EncDecModel(Model):
    """Encoder-decoder (seamless-m4t): the audio frontend is a stub, its
    frame embeddings come as ``batch["src_embeds"]`` [B, S, D]. The
    states hold the encoder's output as ``enc_out``."""

    @torch.inference_mode()
    def init_states(self, batch: int, max_len: int,
                    src_len: int | None = None) -> dict:
        st = super().init_states(batch, max_len)
        st["enc_out"] = torch.zeros(
            (batch, src_len or max_len, self.cfg.d_model),
            dtype=dtype_of(self.cfg.param_dtype), device=self.device)
        return st

    def _encode(self, params, batch):
        return run_encoder(params, batch["src_embeds"].to(
            dtype_of(self.cfg.param_dtype)), self.cfg)

    def apply_train(self, params: LMParams, batch):
        cfg = self.cfg
        enc_out = self._encode(params, batch)
        x = embed(params.embed, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        hidden, _, aux = forward_hidden(params, x, cfg, positions=positions,
                                        mode="train", enc_out=enc_out)
        return logits_head(params, hidden, cfg), aux

    @_serving
    def prefill(self, params: LMParams, batch, states, *,
                chunked: bool = False, include_prefix: bool = True):
        """As ``Model.prefill``, after the encoder over ``src_embeds``;
        ``states["enc_out"]`` becomes its output (the entry is replaced:
        the source length is the batch's, not ``init_states``')."""
        enc_out = self._encode(params, batch)
        logits = self._prefill_hidden(params, batch, states, chunked,
                                      include_prefix, enc_out)
        states["enc_out"] = enc_out
        return logits, states

    @_serving
    def decode_step(self, params: LMParams, token, states, *,
                    commit: torch.Tensor | None = None):
        return self._decode_hidden(params, token, states, commit,
                                   states["enc_out"]), states


def build_model(cfg, device=None) -> Model:
    if cfg.is_encdec:
        return EncDecModel(cfg, device)
    return Model(cfg, device)


# ------------------------------------------------------------ input specs
def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape, *, for_decode_states: bool = False
                ) -> dict[str, Any]:
    """Stand-ins for every model input of the given shape cell
    (``configs/shapes.py::ShapeSpec``), as tensors on the ``meta`` device
    (shape and dtype, no storage): the reference's ``ShapeDtypeStruct``s.
    Frontend stubs (audio frames, vision patches) appear as precomputed
    embedding inputs."""
    b, t = shape.global_batch, shape.seq_len
    tok = torch.int32

    if shape.kind == "train":
        batch: dict[str, Any] = {"tokens": _spec((b, t), tok),
                                 "labels": _spec((b, t), tok)}
        if cfg.frontend == "vision_stub":
            # patches replace a prefix of the text budget
            n_patch = min(1024, t // 4)
            batch["tokens"] = _spec((b, t - n_patch), tok)
            batch["labels"] = _spec((b, t - n_patch), tok)
            batch["patch_embeds"] = _spec((b, n_patch, cfg.d_model),
                                          torch.bfloat16)
        if cfg.is_encdec:
            # audio stub: frame embeddings on the encoder side
            batch["src_embeds"] = _spec((b, t, cfg.d_model), torch.bfloat16)
            batch["tokens"] = _spec((b, t), tok)
            batch["labels"] = _spec((b, t), tok)
        return batch

    if shape.kind == "prefill":
        batch = {"tokens": _spec((b, t), tok)}
        if cfg.frontend == "vision_stub":
            n_patch = min(1024, t // 4)
            batch["tokens"] = _spec((b, t - n_patch), tok)
            batch["patch_embeds"] = _spec((b, n_patch, cfg.d_model),
                                          torch.bfloat16)
        if cfg.is_encdec:
            batch["src_embeds"] = _spec((b, t, cfg.d_model), torch.bfloat16)
        return batch

    # decode: one new token against a cache of length t-1
    return {"token": _spec((b, 1), tok)}
