"""Binding of the CUDA flash-attention kernel (``csrc/flash.cu``).

Port of ``repro/kernels/flash/flash.py::flash_attention_pallas``: fused
attention with an online softmax in float32, causal and sliding-window
masks, GQA through the kv head index, queries aligned to the end of the
keys when S > T, and tiles the masks leave empty never visited (see the
source's note for the design and what bounds it). Unlike the TPU kernel
it takes any T and S, with no block multiples: the kernel masks the
ragged tails. T > S (the encoder-decoder's cross-attention when the
decoder's tokens outnumber the source frames) is taken without a mask
only: under a causal mask or a window the first T − S rows would see no
key, a case no model reaches, so the binding refuses it. The
source holds two kernels, chosen by dtype: bfloat16 runs both products on
the tensor cores (mma.sync), float32 on the CUDA cores in float32 (TF32
would not meet its tolerance). ``launches`` counts the launches of this
wrapper; nothing else changes it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, check_tensor

#: number of kernel launches made through ``flash_attention_cuda``
launches = 0

#: widest head the kernels take (float32: 4 values a lane of a warp; bf16:
#: heads padded to 32, 64 or 128); csrc/flash.cu checks the same bound
MAX_HEAD_DIM = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def check_masked_rows(t: int, s: int, causal: bool, window) -> None:
    """Refuse the shapes whose rows could see no key: S = 0, and T > S
    under a causal mask or a window (queries aligned to the end of the
    keys put the first T − S rows before key 0)."""
    if s < 1:
        raise ValueError(f"attention needs at least one key: S={s}")
    if t > s and (causal or window is not None):
        raise ValueError(f"T > S is taken without a mask only (the first "
                         f"T - S rows would see no key): T={t}, S={s}, "
                         f"causal={causal}, window={window}")


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("flash")
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, n_q_heads: int, n_kv_heads: int, causal: bool,
                         window: int | None, scale: float) -> torch.Tensor:
    """q [B·H, T, D]; k, v [B·Hkv, S, D]; float32 or bfloat16, one dtype,
    contiguous on one CUDA device; S >= 1, T <= S under a causal mask or
    a window (any T without either), D <= 128. Returns o
    [B·H, T, D] in q's dtype (float32 accumulation)."""
    global launches
    if q.device.type != "cuda":
        raise ValueError("flash_attention_cuda takes CUDA tensors; the "
                         "plain version is kernels/flash/ref.py")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q and k must be 3-d, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    bh, t, d = q.shape
    bkv, s = k.shape[0], k.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside the kernel's "
                         f"1..{MAX_HEAD_DIM}")
    h, hkv = n_q_heads, n_kv_heads
    if h <= 0 or hkv <= 0 or h % hkv or bh % h or bkv != bh // h * hkv:
        raise ValueError(f"heads do not match: q {bh} rows of H={h}, kv "
                         f"{bkv} rows of Hkv={hkv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    check_masked_rows(t, s, causal, window)
    dev = q.device
    check_tensor("q", q, q.dtype, (bh, t, d), dev)
    check_tensor("k", k, q.dtype, (bkv, s, d), dev)
    check_tensor("v", v, q.dtype, (bkv, s, d), dev)
    out = torch.empty_like(q)
    if t == 0 or bh == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # ctypes rounds the scale to float32, as jnp rounds a weak-typed
        # Python float against float32 logits
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, h, hkv, t, s, d, int(causal),
            -1 if window is None else int(window), float(scale),
            _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
