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

The id matches are a join on the ids (``_any_match``), so the memory is
that of the ids and the matches at any footprint width; the CPU path and
the kernels' parity checks use them.
"""
from __future__ import annotations

import torch


def _used(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(row, id) of every used slot (id >= 0) of x [W, n]."""
    rows, cols = (x >= 0).nonzero(as_tuple=True)
    return rows, x[rows, cols]


def _any_match(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: [Wi, na], b: [Wj, nb] -> [Wi, Wj] bool: some id >= 0 lies in
    both row i of a and row j of b. Each used slot of a meets the used
    slots of b that hold its id (b sorted by id, a range per slot of a)."""
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.bool,
                      device=a.device)
    rows_a, ids_a = _used(a)
    rows_b, ids_b = _used(b)
    ids_b, order = torch.sort(ids_b)
    rows_b = rows_b[order]
    lo = torch.searchsorted(ids_b, ids_a)
    count = torch.searchsorted(ids_b, ids_a, right=True) - lo
    # slot s of a meets b's sorted slots lo[s], ..., lo[s] + count[s] - 1
    s = torch.repeat_interleave(torch.arange(ids_a.numel(), device=a.device),
                                count)
    start = torch.cumsum(count, 0) - count
    k = torch.arange(s.numel(), device=a.device) + (lo - start)[s]
    out[rows_a[s], rows_b[k]] = True
    return out


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
