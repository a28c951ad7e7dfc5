"""The port's conflict and levels kernels.

On the CPU the wrappers take the plain PyTorch versions; those are held
bit for bit against the reference's oracles and its Pallas kernels run in
interpret mode. The dispatch tests pin the policy: CPU tensors take the
plain version without touching the launch counters, and the kernel path
refuses CPU tensors instead of falling back. The kernels themselves are
held against the plain versions on the card in test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax.numpy as jnp  # noqa: E402

from repro.core import records as jrecords  # noqa: E402
from repro.kernels.conflict.conflict import conflict_matrix_pallas  # noqa: E402
from repro.kernels.conflict.ref import conflict_matrix_ref as jconflict_ref  # noqa: E402
from repro.kernels.levels.levels import wave_levels_pallas  # noqa: E402
from repro.kernels.levels.ref import wave_levels_ref as jlevels_ref  # noqa: E402
from repro_torch.core import records  # noqa: E402
from repro_torch.kernels.conflict import conflict as conflict_kernel  # noqa: E402
from repro_torch.kernels.conflict.ops import conflict_matrix  # noqa: E402
from repro_torch.kernels.conflict.ref import conflict_matrix_ref  # noqa: E402
from repro_torch.kernels.levels import levels as levels_kernel  # noqa: E402
from repro_torch.kernels.levels.ops import wave_levels  # noqa: E402
from repro_torch.kernels.levels.ref import wave_levels_ref  # noqa: E402


def _footprint(seed, w, nr, nw):
    """Random ids with -1 slots and an invalid tail."""
    rng = np.random.RandomState(seed)
    ids = max(4, w // 2)
    reads = rng.randint(0, ids, (w, nr)).astype(np.int32)
    writes = rng.randint(0, ids, (w, nw)).astype(np.int32)
    reads[rng.rand(w, nr) < 0.2] = -1
    writes[rng.rand(w, nw) < 0.2] = -1
    valid = np.arange(w) < w - w // 7
    return reads, writes, valid


def _levels_window(seed, w, density, *, lower=True, with_base=False):
    rng = np.random.RandomState(seed)
    conf = rng.rand(w, w) < density
    if lower:
        conf = np.tril(conf, k=-1)
    valid = rng.rand(w) < 0.85
    base = rng.randint(0, 4, w).astype(np.int32) if with_base else None
    return conf, valid, base


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


# ------------------------------------------------------- conflict matrix
@pytest.mark.parametrize("w", [1, 37, 128, 200])
@pytest.mark.parametrize("nr", [1, 5])
@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("strict", [True, False])
def test_conflict_plain_matches_reference(w, nr, nw, strict):
    reads, writes, valid = _footprint(w * 10 + nr + nw, w, nr, nw)
    got = conflict_matrix(_t(reads), _t(writes), _t(valid), strict=strict)
    assert got.dtype == torch.bool and got.shape == (w, w)
    want = np.asarray(jconflict_ref(_j(reads), _j(writes), _j(valid),
                                    strict=strict))
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(conflict_matrix_pallas(
        _j(reads), _j(writes), _j(valid), strict=strict, interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas.astype(bool))


# ----------------------------------------------------------- wave levels
@pytest.mark.parametrize("w", [1, 37, 129, 256])
@pytest.mark.parametrize("density", [0.02, 0.3])
@pytest.mark.parametrize("with_base", [False, True])
def test_levels_plain_matches_reference(w, density, with_base):
    conf, valid, base = _levels_window(w + int(density * 100), w, density,
                                       with_base=with_base)
    got = wave_levels(_t(conf), _t(valid), base=_t(base))
    assert got.dtype == torch.int32
    want = np.asarray(jlevels_ref(_j(conf), _j(valid), _j(base)))
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(wave_levels_pallas(_j(conf), _j(valid), _j(base),
                                           interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("seed", range(3))
def test_levels_plain_not_triangular(seed):
    """Entries at or above the diagonal, and entries pointing at invalid
    tasks, count for nothing — as in the reference."""
    conf, valid, _ = _levels_window(seed, 150, 0.1, lower=False)
    got = wave_levels(_t(conf), _t(valid))
    want = np.asarray(jlevels_ref(_j(conf), _j(valid)))
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(wave_levels_pallas(_j(conf), _j(valid),
                                           interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_records_match_reference():
    """records.window-level helpers on top of the kernels."""
    conf, valid, _ = _levels_window(5, 96, 0.05)
    lv = records.wave_levels(_t(conf), _t(valid))
    np.testing.assert_array_equal(
        lv.numpy(), np.asarray(jrecords.wave_levels(_j(conf), _j(valid))))
    assert records.critical_path_length(_t(conf), _t(valid)) == \
        jrecords.critical_path_length(_j(conf), _j(valid))
    for n_workers in (1, 3, 16):
        np.testing.assert_array_equal(
            records.wave_levels_capped(conf, valid, n_workers),
            jrecords.wave_levels_capped(conf, valid, n_workers))


# -------------------------------------------------------------- dispatch
def test_cpu_dispatch_takes_plain_version_without_launching():
    conflict_kernel.launches = 0
    levels_kernel.launches = 0
    reads, writes, valid = _footprint(0, 64, 3, 1)
    conf = conflict_matrix(_t(reads), _t(writes), _t(valid))
    np.testing.assert_array_equal(
        conf.numpy(), conflict_matrix_ref(_t(reads), _t(writes),
                                          _t(valid)).numpy())
    lv = wave_levels(conf, _t(valid))
    np.testing.assert_array_equal(lv.numpy(),
                                  wave_levels_ref(conf, _t(valid)).numpy())
    assert conflict_kernel.launches == 0
    assert levels_kernel.launches == 0


def test_kernel_path_refuses_cpu_tensors():
    """A forced kernel on CPU tensors raises: no silent fallback."""
    reads, writes, valid = _footprint(1, 16, 2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        conflict_matrix(_t(reads), _t(writes), _t(valid), backend="cuda")
    conf = torch.zeros((16, 16), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        wave_levels(conf, _t(valid), backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        wave_levels(conf, _t(valid), backend="pallas")
    assert conflict_kernel.launches == 0 and levels_kernel.launches == 0
