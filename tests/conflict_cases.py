"""The conflict kernels' hard inputs, made with numpy from a seed: the
footprints on which a join over the ids differs most from comparing every
pair of slots. Shared by test_torch_conflict.py (the port's plain versions
against the reference's oracles on the CPU) and test_torch_cuda.py (the
kernels against their plain versions on the card); imports neither JAX
nor the port.

Each kind gives one side's (reads [w, nr], writes [w, nw], valid [w]):
  random      ids over max(4, w) values, 20 % of the slots unused, an
              invalid tail;
  chain       every task writes id 0 (the join enumerates every pair);
  hot         every id over 4 values;
  duplicates  each row repeats its ids across its slots;
  self_read   every task reads the id it writes;
  near_max    ids within 8 of 2^31 - 1, the largest int32;
  unused      every slot unused (an all-zero result);
  invalid     every task invalid (an all-zero result).
"""
import numpy as np

KINDS = ("random", "chain", "hot", "duplicates", "self_read", "near_max",
         "unused", "invalid")
INT32_MAX = 2**31 - 1


def footprint(kind, w, nr, nw, seed):
    rng = np.random.RandomState(seed)
    span = 4 if kind == "hot" else max(4, w)
    reads = rng.randint(0, span, (w, nr)).astype(np.int32)
    writes = rng.randint(0, span, (w, nw)).astype(np.int32)
    if kind not in ("hot", "chain"):
        reads[rng.rand(w, nr) < 0.2] = -1
        writes[rng.rand(w, nw) < 0.2] = -1
    valid = np.arange(w) < w - w // 7
    if kind == "chain":
        writes[:] = -1
        writes[:, 0] = 0
    elif kind == "duplicates":
        reads[:] = reads[:, :1]
        writes[:] = writes[:, :1]
    elif kind == "self_read":
        reads[:, 0] = writes[:, 0]
    elif kind == "near_max":
        used_r, used_w = reads >= 0, writes >= 0
        reads = np.where(used_r, INT32_MAX - reads % 8, -1).astype(np.int32)
        writes = np.where(used_w, INT32_MAX - writes % 8,
                          -1).astype(np.int32)
    elif kind == "unused":
        reads[:] = -1
        writes[:] = -1
    elif kind == "invalid":
        valid[:] = False
    return reads, writes, valid


def block(kind, wi, wj, seed):
    """(reads_i, writes_i, reads_j, writes_j, valid_i, valid_j): a later
    window of wi tasks (3 reads, 2 writes) and an earlier one of wj tasks
    (2 reads, 1 write)."""
    ri, wri, vi = footprint(kind, wi, 3, 2, seed)
    rj, wrj, vj = footprint(kind, wj, 2, 1, seed + 1)
    return ri, wri, rj, wrj, vi, vj
