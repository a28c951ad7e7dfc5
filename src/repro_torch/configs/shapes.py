"""The shape cells of the dry-run matrix, per architecture.

The port's copy of ``repro/configs/shapes.py`` (pure data):

  train_4k     seq 4096,   global batch 256  -> train_step
  prefill_32k  seq 32768,  global batch 32   -> serve_prefill
  decode_32k   KV len 32768, batch 128       -> serve_step (1 new token)
  long_500k    KV len 524288, batch 1        -> serve_step; sub-quadratic
               archs only (ssm / hybrid / sliding-window)
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason if not): 40 cells, of which the pure
    full-attention architectures skip long_500k."""
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False, (
            "pure full-attention architecture: 500k decode requires "
            "sub-quadratic attention (unbounded KV cache does not fit)")
    return True, ""


def reduced_shape(shape: ShapeSpec) -> ShapeSpec:
    """Tiny variant of a shape for CPU smoke tests."""
    return ShapeSpec(shape.name, shape.kind,
                     seq_len=min(shape.seq_len, 128),
                     global_batch=min(shape.global_batch, 2))
