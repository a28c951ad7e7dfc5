"""The port's differential harness: the matrix of
tests/test_engine_differential.py on the port's single-device engines.

Voter, SIS, Axelrod and SIRS over ring, 2D lattice, Watts-Strogatz,
Erdos-Renyi and Barabasi-Albert at n ~ 50 (the last two built by the
port's own generators from the reference's keys, and held equal to the
reference's graphs carried across), each
through ``sequential``, ``wavefront``, ``wavefront_overlap`` and the four
sharded engines at world size 1 (``sharded``, ``sharded_window_halo``,
``sharded_replicated``, ``sharded_overlap``) at W = 16, bit for bit
against the reference's oracle, with the overlap runs never executing
more waves than the barrier run, and each sharded engine's schedule that
of its single-device counterpart."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402

from repro import core as J  # noqa: E402
from repro import mabs as JM  # noqa: E402
from repro import topology as JT  # noqa: E402
from repro_torch import mabs as PM  # noqa: E402
from repro_torch import topology as PT  # noqa: E402
from repro_torch.bridge import state_to_numpy, topology_from_numpy  # noqa: E402
from repro_torch.engine import make_engine  # noqa: E402
from repro_torch.utils import prng  # noqa: E402

CPU = "cpu"
FAMILIES = ["barabasi_albert", "erdos_renyi", "lattice2d", "ring",
            "watts_strogatz"]


def assert_states_equal(port_state, ref_state):
    assert set(port_state) == set(ref_state)
    for k, v in ref_state.items():
        got = state_to_numpy(port_state)[k]
        assert got.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


def _reference_topology(name):
    k1, k2, k3, k4, k5 = jax.random.split(jax.random.key(11), 5)
    if name == "ring":
        return JT.ring(50, 4)
    if name == "lattice2d":
        return JT.lattice2d(7, 7, neighborhood="von_neumann")
    if name == "watts_strogatz":
        return JT.connect_isolated(JT.watts_strogatz(50, 4, 0.2, k1), k2)
    if name == "erdos_renyi":
        return JT.connect_isolated(JT.erdos_renyi(50, 0.1, k3), k4)
    return JT.barabasi_albert(50, 2, k5)


@functools.lru_cache(maxsize=None)
def _topology(name):
    """The reference harness's five families at n ~ 50, as (reference,
    port) graphs, made when a test first asks (not at import: every
    worker imports every test file). Erdos-Renyi and Barabasi-Albert are
    built by the port's generators from the same keys and must equal the
    reference's graphs; the others are carried across."""
    jt = _reference_topology(name)
    carried = topology_from_numpy(np.asarray(jt.neighbors),
                                  np.asarray(jt.degrees), CPU)
    if name not in ("erdos_renyi", "barabasi_albert"):
        return jt, carried
    k1, k2, k3, k4, k5 = prng.split(prng.key(11, device=CPU), 5).unbind(0)
    if name == "erdos_renyi":
        pt = PT.connect_isolated(PT.erdos_renyi(50, 0.1, k3, device=CPU), k4)
    else:
        pt = PT.barabasi_albert(50, 2, k5, device=CPU)
    assert torch.equal(pt.neighbors, carried.neighbors), name
    assert torch.equal(pt.degrees, carried.degrees), name
    return jt, pt


def _harness_models(name, topologies):
    jt, pt = topologies
    n = jt.n_nodes
    if name == "voter":
        return JM.VoterModel(jt), PM.VoterModel(pt)
    if name == "sis":
        return JM.SISModel(jt), PM.SISModel(pt)
    if name == "axelrod":
        return (JM.AxelrodModel(JM.AxelrodConfig(n_agents=n), topology=jt),
                PM.AxelrodModel(PM.AxelrodConfig(n_agents=n), topology=pt))
    s = 7 if n % 7 == 0 else 10
    return (JM.SIRModel(JM.SIRConfig(n_agents=n, k=4, subset_size=s),
                        topology=jt),
            PM.SIRModel(PM.SIRConfig(n_agents=n, k=4, subset_size=s),
                        topology=pt))


@pytest.mark.parametrize("topo", FAMILIES)
@pytest.mark.parametrize("model", ["voter", "sis", "axelrod", "sirs"])
def test_differential_harness(model, topo):
    """Every port engine against the reference's oracle at W = 16: two
    full windows, and on the ring also a padded partial third (44)."""
    jm, pm = _harness_models(model, _topology(topo))
    js0 = jm.init_state(jax.random.key(1))
    ps0 = pm.init_state(prng.key(1, device=CPU), device=CPU)
    engines = {e: make_engine(e, pm, window=16, device=CPU)
               for e in ("sequential", "wavefront", "wavefront_overlap",
                         "sharded", "sharded_window_halo",
                         "sharded_replicated", "sharded_overlap")}
    for total in ((32, 44) if topo == "ring" else (44,)):
        oracle = J.run_oracle(jm, js0, total, seed=2,
                              config=J.ProtocolConfig(window=16))
        stats = {}
        for ename, eng in engines.items():
            out, stats[ename] = eng.run(ps0, total, seed=2)
            assert_states_equal(out, oracle)
        barrier = stats["wavefront"]["total_waves"]
        for ename in ("wavefront_overlap", "sharded_overlap"):
            ov = stats[ename]
            assert ov["overlap"] is True
            assert ov["n_boundaries"] == ov["n_windows"] - 1
            assert ov["total_waves"] <= barrier
        assert (stats["sharded_overlap"]["total_waves"]
                == stats["wavefront_overlap"]["total_waves"])
        for ename in ("sharded", "sharded_window_halo",
                      "sharded_replicated"):
            assert stats[ename]["total_waves"] == barrier
            assert stats[ename]["n_devices"] == 1
