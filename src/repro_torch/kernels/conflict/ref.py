"""Plain PyTorch version of the prefix-conflict kernel.

Footprint model: each task i declares read-ids R_i ([W, n_read]) and
write-ids W_i ([W, n_write]); an id < 0 is an unused slot. Later task i
conflicts with earlier task j (j < i) iff

    W_j ∩ R_i ≠ ∅                      (flow hazard — the paper's record)
    ∪ (W_j ∩ W_i) ∪ (W_i ∩ R_j) ≠ ∅    when strict (output + anti closure)

Broadcast over [W, W, n_a, n_b]; the CPU path and the kernel's parity
checks use it.
"""
from __future__ import annotations

import torch


def _any_match(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: [W, na], b: [W, nb] -> [W, W] bool: rows i of a vs rows j of b."""
    eq = a[:, None, :, None] == b[None, :, None, :]      # [W, W, na, nb]
    used = (a[:, None, :, None] >= 0) & (b[None, :, None, :] >= 0)
    return (eq & used).any(dim=3).any(dim=2)


def conflict_matrix_ref(read_ids: torch.Tensor, write_ids: torch.Tensor,
                        valid: torch.Tensor, *,
                        strict: bool = True) -> torch.Tensor:
    """[W, W] bool, strictly lower-triangular prefix-conflict matrix."""
    w = read_ids.shape[0]
    conf = _any_match(read_ids, write_ids)       # W_j ∩ R_i (i rows, j cols)
    if strict:
        conf = conf | _any_match(write_ids, write_ids)   # W_j ∩ W_i
        conf = conf | _any_match(write_ids, read_ids)    # W_i ∩ R_j
    lower = torch.ones((w, w), dtype=torch.bool,
                       device=read_ids.device).tril(diagonal=-1)
    return conf & lower & valid[:, None] & valid[None, :]
