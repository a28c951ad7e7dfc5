"""Plain PyTorch versions of the conflict kernels.

Footprint model: each task i declares read-ids R_i ([W, n_read]) and
write-ids W_i ([W, n_write]); an id < 0 is an unused slot. Later task i
conflicts with earlier task j (j < i) iff

    W_j ∩ R_i ≠ ∅                      (flow hazard — the paper's record)
    ∪ (W_j ∩ W_i) ∪ (W_i ∩ R_j) ≠ ∅    when strict (output + anti closure)

``conflict_block_ref`` applies the same hazard algebra to two different
windows: rows are the later window's tasks, columns the earlier window's,
each side with its own slot counts. Every column task precedes every row
task in chain order, so the block is the full rectangle, masked by
validity only.

Broadcast over [Wi, Wj, n_a, n_b]; the CPU path and the kernels' parity
checks use them.
"""
from __future__ import annotations

import torch


def _any_match(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: [Wi, na], b: [Wj, nb] -> [Wi, Wj] bool: rows i of a vs rows j
    of b."""
    eq = a[:, None, :, None] == b[None, :, None, :]      # [Wi, Wj, na, nb]
    used = (a[:, None, :, None] >= 0) & (b[None, :, None, :] >= 0)
    return (eq & used).any(dim=3).any(dim=2)


def conflict_matrix_ref(read_ids: torch.Tensor, write_ids: torch.Tensor,
                        valid: torch.Tensor, *,
                        strict: bool = True) -> torch.Tensor:
    """[W, W] bool, strictly lower-triangular prefix-conflict matrix."""
    w = read_ids.shape[0]
    lower = torch.ones((w, w), dtype=torch.bool,
                       device=read_ids.device).tril(diagonal=-1)
    return conflict_block_ref(read_ids, write_ids, read_ids, write_ids,
                              valid, valid, strict=strict) & lower


def conflict_block_ref(reads_i: torch.Tensor, writes_i: torch.Tensor,
                       reads_j: torch.Tensor, writes_j: torch.Tensor,
                       valid_i: torch.Tensor, valid_j: torch.Tensor, *,
                       strict: bool = True) -> torch.Tensor:
    """[Wi, Wj] bool cross-window block: later task i (reads_i [Wi, nr_i],
    writes_i [Wi, nw_i]) against earlier task j (reads_j [Wj, nr_j],
    writes_j [Wj, nw_j]); no triangle, validity mask only."""
    conf = _any_match(reads_i, writes_j)             # flow   W_j ∩ R_i
    if strict:
        conf = conf | _any_match(writes_i, writes_j)  # output W_j ∩ W_i
        conf = conf | _any_match(writes_i, reads_j)   # anti   W_i ∩ R_j
    return conf & valid_i[:, None] & valid_j[None, :]
