"""The port's cross-window overlap against the JAX package, bit for bit
on the CPU (no tolerance: blocks, levels and states are integers, and the
one float stat, ``carry_frontier_mean``, is the reference's float32
division).

The conflict block's plain version against the reference's Pallas block
kernel in interpret mode and its jnp version; ``cross_window_conflicts``
and ``carry_frontier`` on real windows of voter and SIS and through the
predicate-only route; the boundary step's levels and stats; and
``wavefront_overlap`` against the reference's ``wavefront_overlap`` and
oracle for voter, SIS, Axelrod and SIRS over full, partial and
single-window totals, including windows that drain completely during
their predecessor's drain. The in-process checks of the reference's
differential harness (tests/test_engine_differential.py) are ported
last, with its monotone envelope of the overlap stats."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as J  # noqa: E402
from repro import mabs as JM  # noqa: E402
from repro import topology as JT  # noqa: E402
from repro.core import records as JR  # noqa: E402
from repro.engine import make_engine as j_make_engine  # noqa: E402
from repro.kernels.conflict.conflict import conflict_block_pallas  # noqa: E402
from repro.kernels.conflict.ops import conflict_block_jnp  # noqa: E402
from repro_torch import core as P  # noqa: E402
from repro_torch import mabs as PM  # noqa: E402
from repro_torch import topology as PT  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    recipes_from_numpy,
    state_to_numpy,
    topology_from_numpy,
)
from repro_torch.engine import make_engine  # noqa: E402
from repro_torch.kernels.conflict import conflict as conflict_kernel  # noqa: E402
from repro_torch.kernels.conflict.ops import conflict_block  # noqa: E402
from repro_torch.utils import prng  # noqa: E402

CPU = "cpu"


def assert_states_equal(port_state, ref_state):
    assert set(port_state) == set(ref_state)
    for k, v in ref_state.items():
        got = state_to_numpy(port_state)[k]
        assert got.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


def assert_overlap_stats_monotone(stats, *, window, barrier_stats=None):
    """The reference's envelope of the overlap stats
    (tests/conftest.py::assert_overlap_stats_monotone): depths bounded by
    the window, counters non-negative and consistent, and never more
    waves than the matching barrier run."""
    assert stats.get("overlap") is True
    assert stats["n_boundaries"] == max(stats["n_windows"] - 1, 0)
    assert 0 <= stats["mean_overlap_depth"] <= window
    assert 0 <= stats["max_overlap_depth"] <= window
    assert stats["mean_overlap_depth"] <= stats["max_overlap_depth"] or (
        stats["n_boundaries"] == 0)
    assert stats["overlap_tasks_early"] >= 0
    assert stats["overlap_tasks_early"] <= stats["total_tasks"]
    assert 0 <= stats["carry_frontier_mean"] <= stats["carry_frontier_max"] \
        or stats["n_boundaries"] == 0
    assert stats["carry_frontier_max"] <= window
    if stats["max_overlap_depth"] == 0:
        assert stats["overlap_tasks_early"] == 0
    if barrier_stats is not None:
        assert stats["total_waves"] <= barrier_stats["total_waves"], (
            "overlapped run executed more waves than the barrier run")
        assert stats["total_tasks"] == barrier_stats["total_tasks"]


def _pair(name, n=50):
    """The same model in both packages, on Watts-Strogatz(n, 4, 0.2)."""
    jt = JT.connect_isolated(
        JT.watts_strogatz(n, 4, 0.2, jax.random.key(21)), jax.random.key(22))
    pt = topology_from_numpy(np.asarray(jt.neighbors),
                             np.asarray(jt.degrees), CPU)
    if name == "voter":
        return JM.VoterModel(jt), PM.VoterModel(pt)
    if name == "sis":
        return JM.SISModel(jt), PM.SISModel(pt)
    if name == "axelrod":
        return (JM.AxelrodModel(JM.AxelrodConfig(n_agents=n)),
                PM.AxelrodModel(PM.AxelrodConfig(n_agents=n), device=CPU))
    if name == "sirs":
        jc = JM.SIRConfig(n_agents=n, k=4, subset_size=10)
        pc = PM.SIRConfig(n_agents=n, k=4, subset_size=10)
        return JM.SIRModel(jc, topology=jt), PM.SIRModel(pc, topology=pt)
    raise ValueError(name)


def _states(jm, pm, seed):
    js0 = jm.init_state(jax.random.key(seed))
    ps0 = pm.init_state(prng.key(seed, device=CPU), device=CPU)
    assert_states_equal(ps0, js0)
    return js0, ps0


def _port_recipes(jrec):
    return recipes_from_numpy(
        {k: (jax.random.key_data(v) if k == "key" else np.asarray(v))
         for k, v in jrec.items()}, CPU)


# ------------------------------------------------------------ the block
def _footprint(rng, w, nr, nw, ids):
    reads = rng.randint(0, ids, (w, nr)).astype(np.int32)
    writes = rng.randint(0, ids, (w, nw)).astype(np.int32)
    reads[rng.rand(w, nr) < 0.2] = -1
    writes[rng.rand(w, nw) < 0.2] = -1
    return reads, writes, np.arange(w) < w - w // 7  # an invalid tail


@pytest.mark.parametrize("wi,wj", [(1, 1), (37, 129), (128, 64), (200, 37)])
@pytest.mark.parametrize("slots_i,slots_j",
                         [((1, 1), (1, 1)), ((5, 2), (5, 2)),
                          ((1, 1), (5, 2)), ((5, 2), (1, 1))])
def test_conflict_block_plain_matches_reference(wi, wj, slots_i, slots_j):
    rng = np.random.RandomState(wi * 1000 + wj + 7 * slots_i[0]
                                + slots_j[0])
    ids = max(4, (wi + wj) // 4)
    ri, wri, vi = _footprint(rng, wi, *slots_i, ids)
    rj, wrj, vj = _footprint(rng, wj, *slots_j, ids)
    for strict in (True, False):
        got = conflict_block(*(torch.as_tensor(x)
                               for x in (ri, wri, rj, wrj, vi, vj)),
                             strict=strict)
        assert got.dtype == torch.bool and got.shape == (wi, wj)
        jargs = [jnp.asarray(x) for x in (ri, wri, rj, wrj, vi, vj)]
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(conflict_block_jnp(*jargs,
                                                       strict=strict)))
        pallas = conflict_block_pallas(*jargs, strict=strict, interpret=True)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(pallas).astype(bool))


def test_conflict_block_cpu_dispatch():
    """CPU tensors take the plain version without launching; the forced
    kernel refuses them."""
    rng = np.random.RandomState(3)
    args = [torch.as_tensor(x) for x in _footprint(rng, 20, 3, 1, 8)[:2]
            + _footprint(rng, 30, 2, 2, 8)[:2]]
    vi, vj = torch.ones(20, dtype=torch.bool), torch.ones(30, dtype=torch.bool)
    conflict_kernel.block_launches = 0
    assert conflict_block(*args, vi, vj).shape == (20, 30)
    with pytest.raises(ValueError, match="CUDA"):
        conflict_block(*args, vi, vj, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        conflict_block(*args, vi, vj, backend="pallas")
    assert conflict_kernel.block_launches == 0


# ------------------------------------------------------ records, boundary
class _PredicateVoter(PM.VoterModel):
    """Voter without footprints: the predicate-only route."""

    def task_footprint(self, recipes):
        return None

    def conflicts(self, a, b, *, strict=True):
        c = (a["u"] == b["v"]) | (a["v"] == b["v"])
        if strict:
            c = c | (a["v"] == b["u"])
        return c


class _JPredicateVoter(JM.VoterModel):
    def task_footprint(self, recipes):
        return None

    def conflicts(self, a, b, *, strict=True):
        c = (a["u"] == b["v"]) | (a["v"] == b["v"])
        if strict:
            c = c | (a["v"] == b["u"])
        return c


def _windows(jm, w=16, count_b=10):
    """Two consecutive windows of the reference's recipes (the second
    partial) and the first window's levels, rebased as if one wave had
    drained."""
    key = jax.random.key(5)
    rec_a, rec_b = jm.create_tasks(key, 0, w), jm.create_tasks(key, w, w)
    valid_a = np.ones(w, bool)
    valid_b = np.arange(w) < count_b
    lv_a = np.asarray(J.wave_levels(J.window_conflicts(jm, rec_a, valid_a),
                                    valid_a))
    lv_a = np.where(lv_a >= 1, lv_a - 1, -1).astype(np.int32)
    return rec_a, lv_a, rec_b, valid_b


@pytest.mark.parametrize("name", ["voter", "sis", "predicate", "sirs"])
@pytest.mark.parametrize("strict", [True, False])
def test_cross_window_conflicts_and_carry_match_reference(name, strict):
    if name == "predicate":
        jm0, pm0 = _pair("voter")
        jm, pm = _JPredicateVoter(jm0.topology), _PredicateVoter(pm0.topology)
    else:
        jm, pm = _pair(name)
    rec_a, lv_a, rec_b, valid_b = _windows(jm)
    alive = lv_a >= 0
    jcross = JR.cross_window_conflicts(jm, rec_a, alive, rec_b, valid_b,
                                      strict=strict)
    pcross = P.cross_window_conflicts(
        pm, _port_recipes(rec_a), torch.as_tensor(alive),
        _port_recipes(rec_b), torch.as_tensor(valid_b), strict=strict)
    assert pcross.dtype == torch.bool
    np.testing.assert_array_equal(pcross.numpy(), np.asarray(jcross))
    assert pcross.any(), "the windows should conflict somewhere"
    carry = P.carry_frontier(pcross, torch.as_tensor(lv_a))
    assert carry.dtype == torch.int32
    np.testing.assert_array_equal(
        carry.numpy(), np.asarray(JR.carry_frontier(jcross,
                                                   jnp.asarray(lv_a))))


def test_carry_frontier_edges():
    """Drained columns (-1) impose nothing; an empty tail gives zeros."""
    cross = torch.tensor([[True, True], [False, True], [False, False]])
    lv = torch.tensor([-1, 2], dtype=torch.int32)
    assert P.carry_frontier(cross, lv).tolist() == [3, 3, 0]
    assert P.carry_frontier(torch.zeros((3, 0), dtype=torch.bool),
                            torch.zeros(0, dtype=torch.int32)).tolist() \
        == [0, 0, 0]


@pytest.mark.parametrize("name", ["voter", "sis", "axelrod", "sirs"])
def test_boundary_step_matches_reference(name):
    """The boundary step's floored levels and its four stats, the float32
    carry mean included."""
    jm, pm = _pair(name)
    rec_a, lv_a, rec_b, valid_b = _windows(jm)
    conf_b = J.window_conflicts(jm, rec_b, valid_b)
    jeng = j_make_engine("wavefront_overlap", jm, window=16)
    j_lv, j_b = jeng._make_boundary()(rec_a, jnp.asarray(lv_a), rec_b,
                                      jnp.asarray(valid_b), conf_b)
    peng = make_engine("wavefront_overlap", pm, window=16, device=CPU)
    p_lv, p_b = peng._boundary(_port_recipes(rec_a), torch.as_tensor(lv_a),
                               _port_recipes(rec_b),
                               torch.as_tensor(valid_b),
                               torch.as_tensor(np.array(conf_b)))
    np.testing.assert_array_equal(p_lv.numpy(), np.asarray(j_lv))
    assert [int(x) for x in (p_b[0], p_b[1], p_b[3])] == \
        [int(x) for x in (j_b[0], j_b[1], j_b[3])]
    assert p_b[2].dtype == torch.float32
    assert float(p_b[2]) == float(j_b[2])


# ------------------------------------------------------------ the engine
@pytest.mark.parametrize("name", ["voter", "sis", "axelrod", "sirs"])
def test_wavefront_overlap_matches_reference(name):
    """Final state and stats dict against the reference's
    wavefront_overlap and oracle: full (32), partial (44) and
    single-window (10) totals at W = 16."""
    jm, pm = _pair(name)
    js0, ps0 = _states(jm, pm, 12)
    cfg_j, cfg_p = J.ProtocolConfig(window=16), P.ProtocolConfig(window=16)
    for total in (32, 44, 10):
        j_out, j_stats = J.run_engine(jm, js0, total, seed=3, config=cfg_j,
                                      engine="wavefront_overlap")
        p_out, p_stats = P.run_engine(pm, ps0, total, seed=3, config=cfg_p,
                                      engine="wavefront_overlap", device=CPU)
        j_or = J.run_oracle(jm, js0, total, seed=3, config=cfg_j)
        assert_states_equal(p_out, j_out)
        assert_states_equal(p_out, j_or)
        assert p_stats == j_stats
        assert {k: type(v) for k, v in p_stats.items()} == \
            {k: type(v) for k, v in j_stats.items()}
        assert_overlap_stats_monotone(p_stats, window=16)
    assert_states_equal(ps0, js0)  # the input state is not consumed


def test_window_drained_early_matches_reference():
    """With few conflicts (voter on a large ring, W = 16) every window
    rides completely in its predecessor's drain, so every other fused
    drain has no wave of its own left — zero waves, as in the
    reference."""
    jt, pt = JT.ring(2000, 4), PT.ring(2000, 4, device=CPU)
    jm, pm = JM.VoterModel(jt), PM.VoterModel(pt)
    js0, ps0 = _states(jm, pm, 4)
    eng = make_engine("wavefront_overlap", pm, window=16, device=CPU)
    counts = []
    pair = eng._execute_pair

    def spy(*args):
        out = pair(*args)
        counts.append(out[1])
        return out

    eng._execute_pair = spy
    for total in (100, 96):
        counts.clear()
        p_out, p_stats = eng.run(ps0, total, seed=2)
        j_out, j_stats = J.run_engine(jm, js0, total, seed=2,
                                      config=J.ProtocolConfig(window=16),
                                      engine="wavefront_overlap")
        assert 0 in counts, counts
        assert_states_equal(p_out, j_out)
        assert p_stats == j_stats
    assert_states_equal(p_out, J.run_oracle(jm, js0, 96, seed=2,
                                            config=J.ProtocolConfig(
                                                window=16)))


def test_paper_rule_overlap_matches_reference():
    """strict=False is not sequential-exact, but the port's overlapped
    schedule still equals the reference's."""
    jm, pm = _pair("voter", n=64)
    js0, ps0 = _states(jm, pm, 4)
    j_out, j_stats = J.run_engine(jm, js0, 100, seed=5,
                                  config=J.ProtocolConfig(window=32,
                                                          strict=False),
                                  engine="wavefront_overlap")
    p_out, p_stats = P.run_engine(pm, ps0, 100, seed=5, device=CPU,
                                  config=P.ProtocolConfig(window=32,
                                                          strict=False),
                                  engine="wavefront_overlap")
    assert_states_equal(p_out, j_out)
    assert p_stats == j_stats


# ------------------------------ the reference's in-process differential
def _oracle_check(pm, ps0, total, *, engine, window, seed):
    cfg = P.ProtocolConfig(window=window)
    out, stats = P.run_engine(pm, ps0, total, seed=seed, config=cfg,
                              engine=engine, device=CPU)
    oracle = P.run_oracle(pm, ps0, total, seed=seed, config=cfg, device=CPU)
    for k in oracle:
        assert torch.equal(out[k], oracle[k]), k
    return stats


def test_overlap_monotone_vs_barrier():
    """Overlap merges waves, never adds them — and does overlap on a graph
    with independence to exploit."""
    pm = PM.VoterModel(PT.watts_strogatz(64, 4, 0.2, prng.key(5, device=CPU),
                                         device=CPU))
    ps0 = pm.init_state(prng.key(1, device=CPU), device=CPU)
    _, barrier = P.run_engine(pm, ps0, 100, seed=2, device=CPU,
                              config=P.ProtocolConfig(window=32),
                              engine="wavefront")
    stats = _oracle_check(pm, ps0, 100, engine="wavefront_overlap",
                          window=32, seed=2)
    assert_overlap_stats_monotone(stats, window=32, barrier_stats=barrier)
    assert stats["mean_overlap_depth"] > 0
    assert stats["overlap_tasks_early"] > 0


def test_overlap_seeded_fuzz():
    """Random (seed, total) draws through the overlapped engine against
    the oracle — totals hit full, partial and single-window cases."""
    rng = np.random.RandomState(77)
    pm = PM.SISModel(PT.watts_strogatz(48, 4, 0.3, prng.key(0, device=CPU),
                                       device=CPU))
    ps0 = pm.init_state(prng.key(3, device=CPU), device=CPU)
    for _ in range(4):
        seed, total = int(rng.randint(1000)), int(rng.randint(1, 80))
        stats = _oracle_check(pm, ps0, total, engine="wavefront_overlap",
                              window=16, seed=seed)
        assert_overlap_stats_monotone(stats, window=16)


def test_overlap_predicate_only_model():
    """Models without footprints route the cross-window check through the
    broadcast pairwise predicate; the overlapped engine stays exact."""
    pm = _PredicateVoter(PT.ring(40, 4, device=CPU))
    ps0 = pm.init_state(prng.key(6, device=CPU), device=CPU)
    stats = _oracle_check(pm, ps0, 70, engine="wavefront_overlap",
                          window=24, seed=7)
    assert_overlap_stats_monotone(stats, window=24)


def test_overlap_knob_routes_through_config():
    """ProtocolConfig.overlap flips a windowed engine either way; the
    sequential engine ignores it."""
    pm = PM.VoterModel(PT.ring(32, 4, device=CPU))
    ps0 = pm.init_state(prng.key(0, device=CPU), device=CPU)
    cfg = P.ProtocolConfig(window=16, overlap=True)
    _, stats = P.run_engine(pm, ps0, 48, seed=1, config=cfg,
                            engine="wavefront", device=CPU)
    assert stats["overlap"] is True
    cfg_off = P.ProtocolConfig(window=16, overlap=False)
    _, stats = P.run_engine(pm, ps0, 48, seed=1, config=cfg_off,
                            engine="wavefront_overlap", device=CPU)
    assert stats["overlap"] is False
    _, stats = P.run_engine(pm, ps0, 48, seed=1, config=cfg,
                            engine="sequential", device=CPU)
    assert stats["mean_parallelism"] == 1.0
