"""Hand-written Hopper kernels for the hot spots.

Each subpackage keeps the reference's three files:
  <name>.py — the ctypes binding of the CUDA kernel in ``csrc/<name>.cu``
              (built for sm_90a at first use, kernels/_build.py), with
              its launch counter
  ops.py    — the public wrapper; dispatches on the tensors' device
  ref.py    — the plain PyTorch version of the same function

Dispatch policy (``use_kernel``): a CUDA tensor launches the kernel, a CPU
tensor takes the plain version. There is no other path: a kernel that
fails to build or launch raises, it never falls back. No kernel has a
backward: flash and wkv6, called with grad enabled on an input that
requires grad, raise on either device (``refuse_grad``).

Kernels:
  conflict — W×W prefix-conflict matrix over task id footprints (the
             protocol's O(W²) record check, paper §3.5), and the Wi×Wj
             cross-window block of the overlapped engine
  levels   — wave levels over the conflict matrix (the level recurrence)
  axelrod  — one Axelrod wave on gathered trait rows: overlap, bounded-
             confidence gate, first-maximum feature pick (every Axelrod
             ``execute_wave``)
  sir      — one SIRS wave of type-A updates on the ring, reading each
             subset's halo straight from the agent states (every SIRS
             ``execute_wave`` on the paper's ring)
  flash    — fused attention (causal / sliding-window, GQA, online
             softmax): the one-shot prefill with ``attn_impl="pallas"``
  wkv6     — the RWKV6 time-mix recurrence with data-dependent decay and
             a carried state: every rwkv time-mix (one-shot prefill,
             chunked prefill, decode) with ``attn_impl="pallas"``
"""
from __future__ import annotations

import torch


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (take the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would need a backward of kernel ``name``: grad
    mode on and any input requiring grad. The reference's Pallas kernels
    have no backward either (``jax.grad`` through them fails), so neither
    has the port's, and no call falls back to the plain version: training
    runs the plain math through ``attn_impl="chunked"`` or ``"ref"``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (nor has the reference's Pallas "
            f"kernel); train with attn_impl='chunked' or 'ref'")


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is what a kernel takes: on ``device``, of
    ``dtype`` and ``shape``, contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
