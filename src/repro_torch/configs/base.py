"""Architecture configuration dataclasses.

The port's copy of ``repro/configs/base.py``: one ``ArchConfig`` instance
per architecture (configs/<id>.py), plus ``reduced()`` variants used by
the CPU tests. The fields and their meaning are the reference's, so one
config means the same thing in both packages; in the port
``attn_impl="pallas"`` selects the hand-written CUDA kernels (flash in
attention, kernels/flash; wkv6 in the RWKV6 time-mix, kernels/wkv6). The sharding knobs (``gqa_expand`` aside) are read by
the reference's multi-device paths only and are kept for equality.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int                 # expert FFN hidden size
    dense_parallel: bool = False  # Arctic: dense FFN residual in parallel
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3


@dataclass(frozen=True)
class SSMSpec:
    state_dim: int = 16           # per-head SSM state (hymba)
    n_heads: int = 0              # 0 -> derive from d_model / head_dim
    head_dim: int = 64
    chunk: int = 256              # chunked-scan length


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | ssm | moe | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default: d_model // n_heads
    qkv_bias: bool = False                  # qwen1.5
    sliding_window: Optional[int] = None    # SWA width (danube, hymba local)
    global_layers: Tuple[int, ...] = ()     # hymba: full-attention layers
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    enc_layers: int = 0                     # seamless: encoder depth
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    frontend: Optional[str] = None          # "audio_stub" | "vision_stub"
    frontend_len: int = 0                   # stub prefix length (patches/frames)
    n_prefix_tokens: int = 0                # hymba meta tokens
    param_dtype: str = "bfloat16"
    # execution knobs (not architecture): overridable per run
    attn_impl: str = "chunked"              # ref | chunked | pallas
    attn_chunk: int = 256
    remat: bool = True
    use_scan: bool = True
    gqa_expand: bool = False                # expand KV to H heads before
    # attention so TP can shard H when Hkv doesn't divide the model axis
    # (set by the launcher from the mesh; train/prefill paths only)
    moe_impl: str = "dense"                 # dense | shard_map (§Perf)
    layout: str = "tp"                      # tp | dp — "dp" folds the model
    # axis into data parallelism (replicated params, ZeRO over all axes);
    # wins for small attention-free models whose heads don't divide the
    # model axis (rwkv6: measured §Perf)
    seq_shard_cache: bool = False           # decode KV cache: shard the seq
    # dim over model when kv_heads don't divide it (flash-decode style)
    tp_shard_map: bool = False              # manual Megatron-SP block via
    # shard_map (models/block_sharded.py); train path, dense/vlm kinds,
    # requires n_heads % model == 0
    seq_parallel: bool = False              # Megatron-SP: residual stream
    # sequence-sharded over model between blocks; GSPMD turns the per-layer
    # all-reduces into reduce-scatter + all-gather pairs (≈2× less wire)
    kv_cache_dtype: str = "bfloat16"        # bfloat16 | float8_e4m3fn —
    # fp8 KV halves decode cache memory/bandwidth (upcast on read)

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM state, hybrid, or sliding-window KV."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    def n_params(self) -> int:
        """Analytic parameter count (matches init to within ties/norms)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hq, hkv, hd = self.n_heads, self.n_kv_heads, self.hd
        attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
        if self.qkv_bias:
            attn += hq * hd + 2 * hkv * hd
        if self.family == "ssm":
            # rwkv6: time-mix (r,k,v,g,o: 5 d² + decay lora) + channel-mix
            attn = 5 * d * d + d * 96 + 96 * d
            mlp = 2 * d * f
        elif self.moe is not None:
            e = self.moe
            mlp = e.n_experts * 3 * d * e.d_expert + d * e.n_experts
            if e.dense_parallel:
                mlp += 3 * d * f
        else:
            mlp = 3 * d * f
        if self.family == "hybrid" and self.ssm is not None:
            nh = self.ssm.n_heads or d // self.ssm.head_dim
            p = self.ssm.head_dim
            # in-proj (x, z, B, C, dt) + out-proj
            attn += d * (2 * nh * p + 2 * nh * self.ssm.state_dim + nh) \
                + nh * p * d
        layers = L * (attn + mlp)
        if self.is_encdec:
            # decoder adds cross-attention per layer
            layers += self.n_layers * attn  # cross-attn in decoder layers
            layers += self.enc_layers * (attn + mlp)
        emb = v * d * (1 if self.tie_embeddings else 2)
        return layers + emb

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.n_params()
        e = self.moe
        total = self.n_params()
        expert_params = self.n_layers * e.n_experts * 3 * self.d_model * e.d_expert
        active = self.n_layers * e.top_k * 3 * self.d_model * e.d_expert
        return total - expert_params + active

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            vocab=512,
            head_dim=32,
            enc_layers=2 if self.is_encdec else 0,
            frontend_len=16 if self.frontend else 0,
            n_prefix_tokens=8 if self.n_prefix_tokens else 0,
            sliding_window=64 if self.sliding_window else None,
            global_layers=(0,) if self.global_layers else (),
            param_dtype="float32",
            attn_impl="ref",
            attn_chunk=64,
            use_scan=True,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=min(self.moe.top_k, 2),
                d_expert=64)
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state_dim=8, head_dim=32, n_heads=4, chunk=32)
        return dataclasses.replace(self, **changes)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
