"""The port's Axelrod and SIRS models against the JAX package, bit for bit
on the CPU.

Axelrod with complete-graph and network-restricted mixing, SIRS on the
default ring and on a rewired graph: init_state, per-window recipes,
footprints against the hand-written ``conflicts`` under both rules,
execute_window with recipes injected from the reference through the
bridge, both engines' states and stats, and SIRS's ``reference_step``
against protocol steps."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402

from repro import core as J  # noqa: E402
from repro import mabs as JM  # noqa: E402
from repro import topology as JT  # noqa: E402
from repro_torch import core as P  # noqa: E402
from repro_torch import mabs as PM  # noqa: E402
from repro_torch import topology as PT  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    recipes_from_numpy,
    state_from_numpy,
    state_to_numpy,
    topology_from_numpy,
)
from repro_torch.utils import prng  # noqa: E402

CPU = "cpu"


def assert_states_equal(port_state, ref_state):
    assert set(port_state) == set(ref_state)
    for k, v in ref_state.items():
        got = state_to_numpy(port_state)[k]
        assert got.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


def _carry(jt):
    return topology_from_numpy(np.asarray(jt.neighbors),
                               np.asarray(jt.degrees), CPU)


def _ws(n):
    return JT.connect_isolated(
        JT.watts_strogatz(n, 4, 0.2, jax.random.key(31)), jax.random.key(32))


def _models(name):
    """(reference model, port model) for each case of this file."""
    if name == "axelrod_complete":
        cfg = dict(n_agents=60, n_features=3, q=3, omega=0.95)
        return (JM.AxelrodModel(JM.AxelrodConfig(**cfg)),
                PM.AxelrodModel(PM.AxelrodConfig(**cfg), device=CPU))
    if name == "axelrod_network":
        cfg = dict(n_agents=60, n_features=4, q=2, omega=0.7)
        jt = _ws(60)
        return (JM.AxelrodModel(JM.AxelrodConfig(**cfg), topology=jt),
                PM.AxelrodModel(PM.AxelrodConfig(**cfg), topology=_carry(jt)))
    if name == "sirs_ring":
        cfg = dict(n_agents=120, k=6, subset_size=10, i0=0.3)
        return (JM.SIRModel(JM.SIRConfig(**cfg)),
                PM.SIRModel(PM.SIRConfig(**cfg), device=CPU))
    if name == "sirs_ws":
        cfg = dict(n_agents=60, k=4, subset_size=6)
        jt = _ws(60)
        return (JM.SIRModel(JM.SIRConfig(**cfg), topology=jt),
                PM.SIRModel(PM.SIRConfig(**cfg), topology=_carry(jt)))
    raise ValueError(name)


CASES = ["axelrod_complete", "axelrod_network", "sirs_ring", "sirs_ws"]


def _key_data(rec):
    return {k: (jax.random.key_data(v) if k == "key" else np.asarray(v))
            for k, v in rec.items()}


@pytest.mark.parametrize("name", CASES)
def test_state_recipes_and_footprints_match_reference(name):
    jm, pm = _models(name)
    assert_states_equal(pm.init_state(prng.key(7, device=CPU), device=CPU),
                        jm.init_state(jax.random.key(7)))
    if name.startswith("sirs"):
        np.testing.assert_array_equal(pm.block_topo.neighbors.numpy(),
                                      np.asarray(jm.block_topo.neighbors))
    w, total = 32, 80
    jkey, pkey = jax.random.key(3), prng.key(3, device=CPU)
    for start in range(0, total, w):
        jrec, prec = jm.create_tasks(jkey, start, w), \
            pm.create_tasks(pkey, start, w)
        jdata = _key_data(jrec)
        assert set(prec) == set(jdata)
        for k, v in jdata.items():
            np.testing.assert_array_equal(prec[k].numpy(), v, err_msg=k)
        jfp, pfp = jm.task_footprint(jrec), pm.task_footprint(prec)
        for a, b in zip(pfp, jfp):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        valid = np.arange(w) < min(w, total - start)
        for strict in (True, False):
            pconf = P.window_conflicts(pm, prec, torch.as_tensor(valid),
                                       strict=strict)
            np.testing.assert_array_equal(
                pconf.numpy(),
                np.asarray(J.window_conflicts(jm, jrec, valid,
                                              strict=strict)))
            # the hand-written predicate builds the same matrix
            np.testing.assert_array_equal(
                P.prefix_conflicts(pm.conflicts, prec,
                                   torch.as_tensor(valid),
                                   strict=strict).numpy(),
                pconf.numpy())


@pytest.mark.parametrize("name", CASES)
def test_execute_window_with_injected_recipes(name):
    """Recipes made by the reference, handed over through the bridge: the
    port's schedule and waves alone reproduce the reference's windows."""
    jm, pm = _models(name)
    state = jm.init_state(jax.random.key(8))
    pstate = state_from_numpy({k: np.asarray(v) for k, v in state.items()},
                              CPU)
    for start, count in ((0, 40), (40, 40), (80, 25)):
        jrec = jm.create_tasks(jax.random.key(9), start, 40)
        valid = np.arange(40) < count
        state, j_waves = J.execute_window(jm, state, jrec, valid)
        pstate, p_waves = P.execute_window(
            pm, pstate, recipes_from_numpy(_key_data(jrec), CPU),
            torch.as_tensor(valid))
        assert p_waves == int(j_waves)
        assert_states_equal(pstate, state)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("engine", ["wavefront", "wavefront_overlap"])
def test_engines_match_reference(name, engine):
    jm, pm = _models(name)
    js0 = jm.init_state(jax.random.key(12))
    ps0 = pm.init_state(prng.key(12, device=CPU), device=CPU)
    cfg_j, cfg_p = J.ProtocolConfig(window=32), P.ProtocolConfig(window=32)
    for total in (64, 90):
        j_out, j_stats = J.run_engine(jm, js0, total, seed=4, config=cfg_j,
                                      engine=engine)
        p_out, p_stats = P.run_engine(pm, ps0, total, seed=4, config=cfg_p,
                                      engine=engine, device=CPU)
        assert_states_equal(p_out, j_out)
        assert p_stats == j_stats
    assert_states_equal(
        P.run_oracle(pm, ps0, 90, seed=4, config=cfg_p, device=CPU),
        J.run_oracle(jm, js0, 90, seed=4, config=cfg_j))


def test_sir_reference_step_matches_protocol():
    """The whole-system stepper equals protocol steps (2M tasks each)
    through the port's engines, and the reference's stepper."""
    cfg = dict(n_agents=100, k=6, subset_size=10, i0=0.3)
    jm = JM.SIRModel(JM.SIRConfig(**cfg))
    pm = PM.SIRModel(PM.SIRConfig(**cfg), device=CPU)
    js = jm.init_state(jax.random.key(2))
    ps0 = ps = pm.init_state(prng.key(2, device=CPU), device=CPU)
    pkey = prng.key(5, device=CPU)
    for step in range(3):
        js = jm.reference_step(js, jax.random.key(5), step)
        ps = pm.reference_step(ps, pkey, step)
        assert_states_equal(ps, js)
    for engine in ("wavefront", "wavefront_overlap"):
        out, _ = P.run_engine(pm, ps0, pm.cfg.tasks_per_step() * 3, seed=5,
                              config=P.ProtocolConfig(window=40),
                              engine=engine, device=CPU)
        assert_states_equal(out, js)


def test_model_guards():
    with pytest.raises(ValueError, match="n_agents"):
        PM.AxelrodModel(PM.AxelrodConfig(n_agents=10),
                        topology=PT.ring(12, 2, device=CPU))
    lonely = PT.from_edges(4, [[0, 1]], device=CPU)
    with pytest.raises(ValueError, match="neighbor"):
        PM.AxelrodModel(PM.AxelrodConfig(n_agents=4), topology=lonely)
    with pytest.raises(ValueError, match="divide"):
        PM.SIRModel(PM.SIRConfig(n_agents=50, subset_size=7), device=CPU)
