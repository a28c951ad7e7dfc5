"""The port's engines against the JAX package, bit for bit on the CPU.

Voter and SIS on Watts-Strogatz, ring and 2D-lattice topologies, with
totals that are not a multiple of the window: the port's wavefront final
state equals the reference's wavefront and oracle, the port's oracle
equals the reference's, init_state, per-window recipes and wave levels
and the stats dicts are identical; under the paper's rule (strict=False)
the port equals the reference's wavefront; with recipes injected from
the reference, execute_window agrees (so a PRNG fault and a schedule
fault show apart); and ProtocolConfig.overlap routes as in the
reference."""
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
)
from repro_torch.utils import prng  # noqa: E402

CPU = "cpu"
MODELS = {"voter": (JM.VoterModel, PM.VoterModel),
          "sis": (JM.SISModel, PM.SISModel)}


def _topologies(name):
    if name == "ws":
        return (JT.watts_strogatz(256, 4, 0.2, jax.random.key(11)),
                PT.watts_strogatz(256, 4, 0.2, prng.key(11, device=CPU),
                                  device=CPU))
    if name == "ring":
        return JT.ring(256, 4), PT.ring(256, 4, device=CPU)
    if name == "lattice":
        return (JT.lattice2d(16, 16, neighborhood="moore"),
                PT.lattice2d(16, 16, neighborhood="moore", device=CPU))
    raise ValueError(name)


def _build(model, topo):
    jcls, pcls = MODELS[model]
    jt, pt = _topologies(topo)
    jm, pm = jcls(jt), pcls(pt)
    return jm, pm, jm.init_state(jax.random.key(12)), \
        pm.init_state(prng.key(12, device=CPU), device=CPU)


def assert_states_equal(port_state, ref_state):
    assert set(port_state) == set(ref_state)
    for k, v in ref_state.items():
        got = state_to_numpy(port_state)[k]
        assert got.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got, np.asarray(v))


CASES = [("ws", 1000, 64), ("ws", 300, 128), ("ring", 300, 128),
         ("lattice", 1000, 64), ("lattice", 300, 128)]


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("topo,total,window", CASES)
def test_engines_match_reference(model, topo, total, window):
    jm, pm, js0, ps0 = _build(model, topo)
    assert_states_equal(ps0, js0)
    cfg_j = J.ProtocolConfig(window=window)
    cfg_p = P.ProtocolConfig(window=window)

    j_wf, j_stats = J.run_engine(jm, js0, total, seed=3, config=cfg_j)
    j_or = J.run_oracle(jm, js0, total, seed=3, config=cfg_j)
    p_wf, p_stats = P.run_engine(pm, ps0, total, seed=3, config=cfg_p,
                                 device=CPU)
    p_or = P.run_oracle(pm, ps0, total, seed=3, config=cfg_p, device=CPU)

    for k in j_or:
        np.testing.assert_array_equal(np.asarray(j_wf[k]), np.asarray(j_or[k]))
    assert_states_equal(p_wf, j_wf)
    assert_states_equal(p_or, j_or)
    assert p_stats == j_stats
    assert {k: type(v) for k, v in p_stats.items()} == \
        {k: type(v) for k, v in j_stats.items()}
    assert p_stats["n_windows"] == -(-total // window)
    # the input state is not consumed
    assert_states_equal(ps0, js0)

    if total > 300:  # the registry's oracle once per model and topology
        return
    j_seq, j_seq_stats = J.run_engine(jm, js0, total, seed=3, config=cfg_j,
                                      engine="sequential")
    p_seq, p_seq_stats = P.run_engine(pm, ps0, total, seed=3, config=cfg_p,
                                      engine="sequential", device=CPU)
    assert p_seq_stats == j_seq_stats
    assert_states_equal(p_seq, j_seq)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("topo", ["ws", "lattice"])
def test_window_schedules_match_reference(model, topo):
    """Recipes, conflict matrices, wave levels and the schedule stats of
    each window of a partial-tail chain (300 tasks at W = 128)."""
    jm, pm, _, _ = _build(model, topo)
    w, total = 128, 300
    jkey, pkey = jax.random.key(3), prng.key(3, device=CPU)
    for start in range(0, total, w):
        count = min(w, total - start)
        jrec = jm.create_tasks(jkey, start, w)
        prec = pm.create_tasks(pkey, start, w)
        for k, v in jrec.items():
            v = (jax.random.key_data(v) if k == "key" else v)
            np.testing.assert_array_equal(prec[k].numpy(), np.asarray(v))
        jvalid = np.arange(w) < count
        pvalid = torch.as_tensor(jvalid)
        jconf = J.window_conflicts(jm, jrec, jvalid)
        pconf = P.window_conflicts(pm, prec, pvalid)
        np.testing.assert_array_equal(pconf.numpy(), np.asarray(jconf))
        np.testing.assert_array_equal(
            P.wave_levels(pconf, pvalid).numpy(),
            np.asarray(J.wave_levels(jconf, jvalid)))
        # the predicate-only path builds the same matrix
        np.testing.assert_array_equal(
            P.prefix_conflicts(pm.conflicts, prec, pvalid).numpy(),
            pconf.numpy())
        from repro.core.wavefront import window_schedule_stats as jstats
        from repro_torch.core.wavefront import window_schedule_stats
        js = jstats(jm, jrec, jvalid)
        ps = window_schedule_stats(pm, prec, pvalid)
        np.testing.assert_array_equal(ps.pop("wave_sizes"),
                                      js.pop("wave_sizes"))
        assert ps == js


@pytest.mark.parametrize("model", sorted(MODELS))
def test_paper_rule_matches_reference_wavefront(model):
    """strict=False (flow hazards only) is not sequential-exact, but the
    port's wavefront still equals the reference's."""
    jm, pm, js0, ps0 = _build(model, "ws")
    j_out, j_stats = J.run_engine(jm, js0, 1000, seed=5,
                                  config=J.ProtocolConfig(window=64,
                                                          strict=False))
    p_out, p_stats = P.run_engine(pm, ps0, 1000, seed=5, device=CPU,
                                  config=P.ProtocolConfig(window=64,
                                                          strict=False))
    assert_states_equal(p_out, j_out)
    assert p_stats == j_stats


@pytest.mark.parametrize("model", sorted(MODELS))
def test_execute_window_with_injected_recipes(model):
    """Recipes made by the reference, handed over through the bridge:
    the port's schedule and wave execution alone must reproduce the
    reference's window."""
    jm, pm, js0, _ = _build(model, "ring")
    state = js0
    pstate = state_from_numpy({k: np.asarray(v) for k, v in js0.items()},
                              CPU)
    for start in (0, 128):
        jrec = jm.create_tasks(jax.random.key(8), start, 128)
        jvalid = np.arange(128) < (128 if start == 0 else 100)
        state, j_waves = J.execute_window(jm, state, jrec, jvalid)
        prec = recipes_from_numpy(
            {k: (jax.random.key_data(v) if k == "key" else v)
             for k, v in jrec.items()}, CPU)
        pstate, p_waves = P.execute_window(pm, pstate, prec,
                                           torch.as_tensor(jvalid))
        assert p_waves == int(j_waves)
        assert_states_equal(pstate, state)


def test_overlap_and_unknown_engine_raise():
    """An engine without the overlap hooks refuses overlap=True; an
    unregistered name raises."""
    from repro_torch.engine import WindowedEngine

    class BarrierOnly(WindowedEngine):
        name = "barrier_only"

    _, pm, _, ps0 = _build("voter", "ring")
    with pytest.raises(ValueError, match="overlap"):
        BarrierOnly(pm, window=64, overlap=True, device=CPU).run(ps0, 100)
    with pytest.raises(ValueError, match="unknown engine"):
        P.run_engine(pm, ps0, 100, device=CPU, engine="no_such_engine")


@pytest.mark.parametrize("model", sorted(MODELS))
def test_overlap_routes_through_config(model):
    """ProtocolConfig(overlap=True) turns the wavefront engine into the
    reference's overlapped loop: the same state and stats as the
    reference's run under the same config."""
    jm, pm, js0, ps0 = _build(model, "ws")
    j_out, j_stats = J.run_engine(jm, js0, 300, seed=3,
                                  config=J.ProtocolConfig(window=64,
                                                          overlap=True))
    p_out, p_stats = P.run_engine(pm, ps0, 300, seed=3, device=CPU,
                                  config=P.ProtocolConfig(window=64,
                                                          overlap=True))
    assert p_stats["overlap"] is True and p_stats["n_boundaries"] == 4
    assert_states_equal(p_out, j_out)
    assert p_stats == j_stats


def test_stats_registry_rejects_undeclared_and_non_finite():
    from repro_torch.obs.stats import finalize_stats

    assert finalize_stats({"total_waves": np.int64(3)}) == {"total_waves": 3}
    # every key of the reference's registry is declared now (``halo``
    # among them), so an undeclared key is one neither registry knows
    assert finalize_stats({"halo": np.bool_(True)}) == {"halo": True}
    with pytest.raises(ValueError, match="undeclared"):
        finalize_stats({"no_such_stat": True})
    with pytest.raises(ValueError, match="non-finite"):
        finalize_stats({"mean_parallelism": float("nan")})
