"""Error-feedback int8 gradient compression for cross-pod data parallelism.

Port of ``repro/distributed/compress.py``. The pod axis crosses the slow
inter-pod links, so gradients reduced across pods are quantized to int8
with a per-leaf scale and an error-feedback residual that re-injects the
quantization error into the next step (Seide et al. 2014; error feedback
keeps SGD's convergence guarantees). Within a pod gradients stay as they
are.

The float32 operations are the reference's, in its order, and
``torch.round`` rounds half to even as ``jnp.round`` does, so a leaf
compresses to the same bits in both packages.

A gradient tree is anything ``utils.pytree.named_leaves`` walks (a dict
of named tensors, a module); the compressed gradients and the residuals
are dicts keyed by the leaf names.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.distributed.collectives import axis_group, psum
from repro_torch.utils.pytree import named_leaves


class EFState(NamedTuple):
    residual: dict      # leaf name -> float32 tensor, shaped as the grad


def ef_init(grads_like) -> EFState:
    return EFState(residual={
        k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for k, g in named_leaves(grads_like)})


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_leaf(g, r):
    """Error-feedback compression of one gradient leaf: (the compressed
    gradient in g's dtype, the new float32 residual). The caller reduces
    the compressed gradient across pods; the residual stays local."""
    gf = g.float() + r
    q, scale = quantize_int8(gf)
    deq = dequantize_int8(q, scale)
    return deq.to(g.dtype), gf - deq


def compress_grads(grads, ef: EFState) -> tuple[dict, EFState]:
    out, res = {}, {}
    for k, g in named_leaves(grads):
        out[k], res[k] = compress_leaf(g, ef.residual[k])
    return out, EFState(res)


def crosspod_allreduce_compressed(grads, ef: EFState, *, mesh,
                                  axis: str = "pod") -> tuple[dict, Any]:
    """Each rank's local gradients: compress, sum over the ``axis``
    ranks of ``mesh`` (a ``DeviceMesh``), average. Returns (the averaged
    compressed gradients, the new residuals)."""
    cg, ef = compress_grads(grads, ef)
    group = axis_group(mesh, axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    return {k: psum(g, group) / n for k, g in cg.items()}, ef
