"""The port at any footprint width and any window, against the JAX package
on the CPU.

The CUDA conflict kernels take any footprint width and the levels kernel
any window; on the CPU the wrappers take the plain versions, which are
held here against the reference's oracles past the first kernels' limits
(192 slots of a footprint, W = 8192): conflict prefix matrices and
cross-window blocks at 193 and 600 read slots, levels at W = 8193, and
SIS on a graph whose hub has more than 192 neighbours, through both
windowed engines, state and stats bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as J  # noqa: E402
from repro import mabs as JM  # noqa: E402
from repro import topology as JT  # noqa: E402
from repro.kernels.conflict.ref import conflict_block_ref as j_block_ref  # noqa: E402
from repro.kernels.conflict.ref import conflict_matrix_ref as j_matrix_ref  # noqa: E402
from repro.kernels.levels.ref import wave_levels_ref as j_levels_ref  # noqa: E402
from repro_torch import core as P  # noqa: E402
from repro_torch import mabs as PM  # noqa: E402
from repro_torch.bridge import state_to_numpy, topology_from_numpy  # noqa: E402
from repro_torch.kernels.conflict.ops import (  # noqa: E402
    conflict_block,
    conflict_matrix,
)
from repro_torch.kernels.levels.ops import wave_levels  # noqa: E402
from repro_torch.utils import prng  # noqa: E402

CPU = "cpu"


def _footprint(rng, w, nr, nw):
    """Ids over 8·nr·nw values (some pairs of tasks collide, most not),
    -1 slots and an invalid tail."""
    ids = 8 * nr * nw
    reads = rng.randint(0, ids, (w, nr)).astype(np.int32)
    writes = rng.randint(0, ids, (w, nw)).astype(np.int32)
    reads[rng.rand(w, nr) < 0.2] = -1
    writes[rng.rand(w, nw) < 0.2] = -1
    return reads, writes, np.arange(w) < w - w // 7


# ------------------------------------------------------- conflict width
@pytest.mark.parametrize("nr", [193, 600])
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("kind", ["prefix", "block"])
def test_wide_conflict_plain_matches_reference(nr, strict, kind):
    rng = np.random.RandomState(nr + 2 * strict)
    if kind == "prefix":
        reads, writes, valid = _footprint(rng, 48, nr, 2)
        got = conflict_matrix(torch.as_tensor(reads),
                              torch.as_tensor(writes),
                              torch.as_tensor(valid), strict=strict)
        want = j_matrix_ref(jnp.asarray(reads), jnp.asarray(writes),
                            jnp.asarray(valid), strict=strict)
    else:
        side_i = _footprint(rng, 40, nr, 2)
        side_j = _footprint(rng, 56, nr // 2, 1)
        args = (side_i[0], side_i[1], side_j[0], side_j[1], side_i[2],
                side_j[2])
        got = conflict_block(*(torch.as_tensor(x) for x in args),
                             strict=strict)
        want = j_block_ref(*(jnp.asarray(x) for x in args), strict=strict)
    want = np.asarray(want)
    assert 0 < want.sum() < want.size  # cells that conflict and cells not
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------- levels window
@pytest.mark.parametrize("case", ["sparse", "base", "invalid tail"])
def test_levels_plain_past_8192_matches_reference(case):
    w = 8193
    rng = np.random.RandomState(w)
    conf = np.tril(rng.rand(w, w) < 2e-4, k=-1)
    valid = np.ones(w, dtype=bool)
    base = None
    if case == "base":
        base = rng.randint(0, 5, w).astype(np.int32)
    if case == "invalid tail":
        valid = (np.arange(w) < w - w // 7) & (rng.rand(w) < 0.9)
    got = wave_levels(torch.as_tensor(conf), torch.as_tensor(valid),
                      base=None if base is None else torch.as_tensor(base))
    want = np.asarray(j_levels_ref(jnp.asarray(conf), jnp.asarray(valid),
                                   None if base is None
                                   else jnp.asarray(base)))
    assert want.max() >= 2  # the window has chains
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------- SIS on a hub graph
def _hub_graph(n=300, hub_degree=240):
    """A path over n nodes plus a hub (node 0) with hub_degree random
    neighbours: SIS tasks read up to 1 + hub_degree ids."""
    rng = np.random.RandomState(5)
    path = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    hub = np.stack([np.zeros(hub_degree, np.int64),
                    rng.choice(np.arange(1, n), hub_degree, replace=False)],
                   1)
    return JT.from_edges(n, jnp.asarray(np.concatenate([path, hub]),
                                        jnp.int32))


@pytest.mark.parametrize("engine", ["wavefront", "wavefront_overlap"])
def test_sis_hub_graph_matches_reference(engine):
    jt = _hub_graph()
    assert jt.max_degree > 192
    pt = topology_from_numpy(np.asarray(jt.neighbors), np.asarray(jt.degrees),
                             CPU)
    jm, pm = JM.SISModel(jt), PM.SISModel(pt)
    js0 = jm.init_state(jax.random.key(7))
    ps0 = pm.init_state(prng.key(7, device=CPU), device=CPU)
    total, window = 4 * 64 + 17, 64
    j_out, j_stats = J.run_engine(jm, js0, total, seed=3,
                                  config=J.ProtocolConfig(window=window),
                                  engine=engine)
    p_out, p_stats = P.run_engine(pm, ps0, total, seed=3,
                                  config=P.ProtocolConfig(window=window),
                                  engine=engine, device=CPU)
    j_or = J.run_oracle(jm, js0, total, seed=3,
                        config=J.ProtocolConfig(window=window))
    got = state_to_numpy(p_out)["states"]
    np.testing.assert_array_equal(got, np.asarray(j_out["states"]))
    np.testing.assert_array_equal(got, np.asarray(j_or["states"]))
    assert p_stats == j_stats
    assert p_stats["total_waves"] > p_stats["n_windows"]  # hubs conflict
