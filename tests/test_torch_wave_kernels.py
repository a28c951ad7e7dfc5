"""The port's Axelrod and SIRS wave kernels against the JAX package, bit
for bit on the CPU.

The plain versions of ``kernels/axelrod`` and ``kernels/sir`` (what a CPU
tensor takes) against the reference's Pallas kernels in interpret mode
and its jnp oracles, from seeded numpy inputs with ties forced; then the
port's Axelrod and SIRS ``execute_wave`` — which now go through these
kernels — against the reference's ``execute_wave`` wave by wave, under
both hazard rules, on the ring and on a rewired graph. The tolerance is
exact equality throughout."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as J  # noqa: E402
from repro import mabs as JM  # noqa: E402
from repro import topology as JT  # noqa: E402
from repro.kernels.axelrod.ops import axelrod_wave as j_axelrod_wave  # noqa: E402
from repro.kernels.axelrod.ref import axelrod_wave_ref as j_axelrod_ref  # noqa: E402
from repro.kernels.sir.ops import sir_wave as j_sir_wave  # noqa: E402
from repro.kernels.sir.ref import sir_wave_ref as j_sir_ref  # noqa: E402
from repro_torch import mabs as PM  # noqa: E402
from repro_torch import topology as PT  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    recipes_from_numpy,
    state_from_numpy,
    state_to_numpy,
    topology_from_numpy,
)
from repro_torch.kernels.axelrod import axelrod as axelrod_kernel  # noqa: E402
from repro_torch.kernels.axelrod import axelrod_wave  # noqa: E402
from repro_torch.kernels.sir import sir as sir_kernel  # noqa: E402
from repro_torch.kernels.sir import sir_wave  # noqa: E402
from repro_torch.kernels.sir.ref import sir_wave_ref  # noqa: E402
from repro_torch.mabs import axelrod as axelrod_mod  # noqa: E402
from repro_torch.mabs import sir as sir_mod  # noqa: E402

CPU = "cpu"
RATES = dict(p_si=.8, p_ir=.1, p_rs=.3)


def _axelrod_inputs(seed, w, f):
    """Traits over 3 values (many equal features), one row with every
    feature equal, uniforms on a grid of quarters (ties in the pick and
    the gate), masks of the row's density."""
    rng = np.random.RandomState(seed)
    s = rng.randint(0, 3, (w, f)).astype(np.int32)
    t = rng.randint(0, 3, (w, f)).astype(np.int32)
    t[0] = s[0]
    u = (rng.randint(0, 4, w) / 4).astype(np.float32)
    g = (rng.randint(0, 4, (w, f)) / 4).astype(np.float32)
    m = rng.rand(w) < (0.2, 0.7, 1.0)[seed % 3]
    return s, t, u, g, m


def _port_axelrod(s, t, u, g, m, omega):
    new_t, inter = axelrod_wave(*(torch.as_tensor(x) for x in (s, t, u, g, m)),
                                omega=omega)
    assert new_t.dtype == torch.int32 and inter.dtype == torch.bool
    return new_t.numpy(), inter.numpy()


@pytest.mark.parametrize("w,f", [(128, 3), (128, 100), (128, 128)])
def test_axelrod_plain_matches_pallas(w, f):
    s, t, u, g, m = _axelrod_inputs(w + f, w, f)
    jt, ji = j_axelrod_wave(*(jnp.asarray(x) for x in (s, t, u, g, m)),
                            omega=0.95)
    pt, pi = _port_axelrod(s, t, u, g, m, 0.95)
    np.testing.assert_array_equal(pt, np.asarray(jt))
    np.testing.assert_array_equal(pi, np.asarray(ji))
    assert pi.any() and not pi.all()


@pytest.mark.parametrize("w,f,omega", [(256, 500, 0.95), (1, 3, 0.95),
                                       (37, 3, 0.5), (37, 17, 0.2),
                                       (64, 1, 0.95)])
def test_axelrod_plain_matches_ref(w, f, omega):
    s, t, u, g, m = _axelrod_inputs(w * f, w, f)
    jt, ji = j_axelrod_ref(*(jnp.asarray(x) for x in (s, t, u, g, m)),
                           omega=omega, n_features=f)
    pt, pi = _port_axelrod(s, t, u, g, m, omega)
    np.testing.assert_array_equal(pt, np.asarray(jt))
    np.testing.assert_array_equal(pi, np.asarray(ji))


def _sir_inputs(seed, n, w, s_sz):
    rng = np.random.RandomState(seed)
    states = rng.randint(0, 3, n).astype(np.int8)
    subsets = rng.randint(0, n // s_sz, w).astype(np.int32)
    subsets[0], subsets[-1] = 0, n // s_sz - 1  # both ends wrap
    u = rng.rand(w, s_sz).astype(np.float32)
    return states, subsets, u


@pytest.mark.parametrize("w,s_sz,k", [(8, 50, 14), (16, 10, 6), (8, 400, 14),
                                      (32, 25, 2)])
def test_sir_plain_matches_pallas(w, s_sz, k):
    n = 4000
    states, subsets, u = _sir_inputs(w + s_sz + k, n, w, s_sz)
    want = j_sir_wave(jnp.asarray(states.astype(np.int32)),
                      jnp.asarray(subsets), jnp.asarray(u), n_agents=n, k=k,
                      subset_size=s_sz, **RATES)
    got = sir_wave(torch.as_tensor(states), torch.as_tensor(subsets),
                   torch.as_tensor(u), n_agents=n, k=k, subset_size=s_sz,
                   **RATES)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy().astype(np.int32),
                                  np.asarray(want))


@pytest.mark.parametrize("w,s_sz,k,n", [(1, 10, 6, 40), (37, 50, 14, 1000),
                                        (9, 20, 2, 20 * 7)])
def test_sir_plain_matches_ref(w, s_sz, k, n):
    """The ops-level plain version (ring halo + transition) and the halo-
    row transition against the reference's oracle, wrap included."""
    states, subsets, u = _sir_inputs(n + w, n, w, s_sz)
    half = k // 2
    idx = (subsets[:, None] * s_sz - half
           + np.arange(s_sz + 2 * half)[None, :]) % n
    want = np.asarray(j_sir_ref(jnp.asarray(states[idx].astype(np.int32)),
                                jnp.asarray(u), k=k, subset_size=s_sz,
                                **RATES))
    got = sir_wave(torch.as_tensor(states), torch.as_tensor(subsets),
                   torch.as_tensor(u), n_agents=n, k=k, subset_size=s_sz,
                   **RATES)
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)
    halo = sir_wave_ref(torch.as_tensor(states[idx]), torch.as_tensor(u),
                        k=k, subset_size=s_sz, **RATES)
    assert halo.dtype == torch.int32
    np.testing.assert_array_equal(halo.numpy(), want)


def test_wrappers_on_cpu_take_plain_versions():
    """A CPU tensor takes the plain version and launches nothing; asking
    for the kernel with CPU tensors raises, it never falls back."""
    s, t, u, g, m = (torch.as_tensor(x) for x in _axelrod_inputs(1, 8, 3))
    states, subsets, uu = (torch.as_tensor(x)
                           for x in _sir_inputs(2, 100, 4, 10))
    before = axelrod_kernel.launches, sir_kernel.launches
    axelrod_wave(s, t, u, g, m, omega=0.95)
    sir_wave(states, subsets, uu, n_agents=100, k=4, subset_size=10,
             **RATES)
    assert (axelrod_kernel.launches, sir_kernel.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        axelrod_wave(s, t, u, g, m, omega=0.95, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        sir_wave(states, subsets, uu, n_agents=100, k=4, subset_size=10,
                 backend="cuda", **RATES)
    with pytest.raises(ValueError, match="backend"):
        axelrod_wave(s, t, u, g, m, omega=0.95, backend="pallas")
    with pytest.raises(ValueError, match="do not match"):
        sir_wave(states, subsets, uu, n_agents=101, k=4, subset_size=10,
                 **RATES)


# ----------------------------------------------------------- model waves
def _carry(jt):
    return topology_from_numpy(np.asarray(jt.neighbors),
                               np.asarray(jt.degrees), CPU)


def _ws(n):
    return JT.connect_isolated(
        JT.watts_strogatz(n, 4, 0.2, jax.random.key(31)), jax.random.key(32))


def _models(name):
    if name == "axelrod_complete":
        cfg = dict(n_agents=24, n_features=5, q=2, omega=0.9)
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
        cfg = dict(n_agents=60, k=4, subset_size=6, i0=0.3)
        jt = _ws(60)
        return (JM.SIRModel(JM.SIRConfig(**cfg), topology=jt),
                PM.SIRModel(PM.SIRConfig(**cfg), topology=_carry(jt)))
    raise ValueError(name)


def _key_data(rec):
    return {k: (jax.random.key_data(v) if k == "key" else np.asarray(v))
            for k, v in rec.items()}


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("name", ["axelrod_complete", "axelrod_network",
                                  "sirs_ring", "sirs_ws"])
def test_execute_wave_matches_reference(name, strict, monkeypatch):
    """Wave by wave over the reference's schedule under each hazard rule:
    the port's execute_wave, through the wave kernel's plain version
    where the model takes it, equals the reference's execute_wave."""
    jm, pm = _models(name)
    calls = []
    if name.startswith("axelrod"):
        monkeypatch.setattr(axelrod_mod, "axelrod_wave",
                            lambda *a, **k: calls.append(1)
                            or axelrod_wave(*a, **k))
    else:
        monkeypatch.setattr(sir_mod, "sir_wave",
                            lambda *a, **k: calls.append(1)
                            or sir_wave(*a, **k))
    jstate = jm.init_state(jax.random.key(4))
    pstate = state_from_numpy({k: np.asarray(v) for k, v in jstate.items()},
                              CPU)
    w, n_waves, interacted = 40, 0, 0
    for start in (0, w):
        jrec = jm.create_tasks(jax.random.key(6), start, w)
        prec = recipes_from_numpy(_key_data(jrec), CPU)
        valid = np.ones(w, bool)
        conf = J.window_conflicts(jm, jrec, valid, strict=strict)
        levels = np.asarray(J.wave_levels(conf, valid))
        for lvl in range(levels.max() + 1):
            mask = levels == lvl
            before = state_to_numpy(pstate)
            jstate = jm.execute_wave(jstate, jrec, jnp.asarray(mask))
            pstate = pm.execute_wave(pstate, prec, torch.as_tensor(mask))
            after = state_to_numpy(pstate)
            for k, v in jstate.items():
                np.testing.assert_array_equal(after[k], np.asarray(v),
                                              err_msg=f"{k} level {lvl}")
            interacted += sum(int((after[k] != before[k]).any())
                              for k in after)
            n_waves += 1
    assert interacted > 0  # the waves changed the state
    routed = name != "sirs_ws"  # the rewired graph keeps the table route
    assert len(calls) == (n_waves if routed else 0)


def test_sirs_route_follows_the_topology():
    """The ring route is decided from the topology itself, so a model
    rebuilt on a moved ring takes it too; other graphs, and rings too
    small for a subset's halo, take the neighbour table."""
    cfg = PM.SIRConfig(n_agents=120, k=6, subset_size=10)
    ring = PM.SIRModel(cfg, device=CPU)
    assert ring.topology.ring_k == 6 and ring._ring_k == 6
    moved = PM.SIRModel(cfg, topology=ring.topology.to(CPU))
    assert moved.topology.ring_k == 6 and moved._ring_k == 6
    other = PM.SIRModel(cfg, topology=PT.ring(120, 4, device=CPU))
    assert other._ring_k == 4  # the topology's degree, not cfg.k
    assert ring.topology.block_graph(10).ring_k is None
    ws = PM.SIRModel(PM.SIRConfig(n_agents=60, k=4, subset_size=6),
                     topology=_carry(_ws(60)))
    assert ws.topology.ring_k is None and ws._ring_k is None
    whole = PM.SIRModel(PM.SIRConfig(n_agents=12, k=4, subset_size=12),
                        device=CPU)
    assert whole.topology.ring_k == 4 and whole._ring_k is None
