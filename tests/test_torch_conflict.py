"""The conflict kernels' plain versions against the reference's oracles on
the CPU, on the inputs hardest for a join over the ids (conflict_cases.py:
a chain, hot ids, ids repeated within a row, tasks that read what they
write, ids near 2^31 - 1, every slot unused, every task invalid, and
random footprints), for the prefix matrix and the cross-window block at
odd widths, under both hazard rules: equal cell for cell. The same inputs
hold the CUDA kernels against these plain versions on the card
(test_torch_cuda.py). Also the binding's table sizing, which needs no
card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax.numpy as jnp  # noqa: E402
from conflict_cases import KINDS, block, footprint  # noqa: E402

from repro.kernels.conflict.ref import conflict_block_ref as j_block_ref  # noqa: E402
from repro.kernels.conflict.ref import conflict_matrix_ref as j_matrix_ref  # noqa: E402
from repro_torch.kernels.conflict import conflict as conflict_kernel  # noqa: E402
from repro_torch.kernels.conflict.ops import (  # noqa: E402
    conflict_block,
    conflict_matrix,
)


def _check_kind(kind, want, valid_pairs, strict):
    """The case is as hard as its kind says."""
    if kind in ("unused", "invalid"):
        assert not want.any()
    elif kind == "chain" and strict:  # every valid pair writes id 0
        assert np.array_equal(want, valid_pairs)
    else:
        assert want.any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("w", [37, 129])
def test_prefix_plain_matches_reference_on_hard_inputs(kind, strict, w):
    reads, writes, valid = footprint(kind, w, 3, 2, seed=w)
    got = conflict_matrix(torch.as_tensor(reads), torch.as_tensor(writes),
                          torch.as_tensor(valid), strict=strict)
    want = np.asarray(j_matrix_ref(jnp.asarray(reads), jnp.asarray(writes),
                                   jnp.asarray(valid), strict=strict))
    np.testing.assert_array_equal(got.numpy(), want)
    _check_kind(kind, want, np.tril(np.outer(valid, valid), k=-1), strict)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("wi,wj", [(37, 129), (129, 37)])
def test_block_plain_matches_reference_on_hard_inputs(kind, strict, wi, wj):
    args = block(kind, wi, wj, seed=wi)
    got = conflict_block(*(torch.as_tensor(x) for x in args), strict=strict)
    want = np.asarray(j_block_ref(*(jnp.asarray(x) for x in args),
                                  strict=strict))
    assert want.shape == (wi, wj)
    np.testing.assert_array_equal(got.numpy(), want)
    _check_kind(kind, want, np.outer(args[4], args[5]), strict)


def test_table_slots_hold_a_side_at_most_an_eighth_full():
    """Each table has the least power of two of slots of at least 8 x its
    side's write slots, from the shapes alone."""
    slots = conflict_kernel.table_slots
    assert slots(1, 1) == 8
    assert slots(4096, 1) == 32768
    assert slots(4097, 1) == 65536
    assert slots(37, 2) == 1024       # 592 -> 1024
    assert slots(16384, 1) == 131072
    for w in (1, 3, 37, 129, 1000, 4095, 4096, 4097, 16384):
        for nw in (1, 2, 3):
            s = slots(w, nw)
            assert s & (s - 1) == 0
            assert 8 * w * nw <= s < 16 * w * nw


def test_scratch_bytes_cover_the_header_and_the_tables():
    """The prefix matrix takes one table; the block its column side's and,
    under the strict rule, its row side's; each slot is a bucket key, 8
    task indices and a count, after a header."""
    k = conflict_kernel
    assert k.TABLE_SLOT_BYTES == 8 + 8 * 4 + 4
    assert k.scratch_bytes(8) == k.SCRATCH_HEADER_BYTES + 8 * 44
    assert k.scratch_bytes(32768, 0) == k.scratch_bytes(32768)
    assert k.scratch_bytes(32768, 8192) == (k.SCRATCH_HEADER_BYTES
                                            + (32768 + 8192) * 44)
    # the second table starts 32-byte aligned, as the kernel's int4 loads
    # of its buckets need
    for s in (8, 16, 1024, 32768):
        assert (k.SCRATCH_HEADER_BYTES + s * k.TABLE_SLOT_BYTES) % 32 == 0
