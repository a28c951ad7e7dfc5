"""The port's discrete-event protocol simulator against the JAX
package's, field for field (the makespan compared exactly): the port's
``des_model`` adapters of Axelrod (complete mixing and a Watts–Strogatz
topology) and SIRS, both hazard rules, n_workers in {1, 3, 4},
tasks_per_cycle in {1, 6}, custom ``DESCosts`` and custom cost functions.
Then the invariants of tests/test_workersim.py, run on the port."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402

from repro import core as J  # noqa: E402
from repro import mabs as JM  # noqa: E402
from repro import topology as JT  # noqa: E402
from repro_torch import topology as PT  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DESCosts,
    DESModel,
    DESResult,
    ProtocolConfig,
    ProtocolSimulator,
    simulate_protocol,
)
from repro_torch.mabs import (  # noqa: E402
    AxelrodConfig,
    AxelrodModel,
    SIRConfig,
    SIRModel,
)
from repro_torch.utils import prng  # noqa: E402

CPU = "cpu"
COSTS = dict(visit=3e-7, create=5e-7, erase=3e-7, enter=3e-7)


def assert_same_result(port, ref):
    assert isinstance(port, DESResult)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def _pair(name):
    """(reference, port) models of one family, built when a test first
    asks (not at import: every worker imports every test file)."""
    if name == "axelrod":
        return (JM.AxelrodModel(JM.AxelrodConfig(n_agents=200, n_features=20)),
                AxelrodModel(AxelrodConfig(n_agents=200, n_features=20),
                             device=CPU))
    if name == "axelrod_topology":
        jt = JT.connect_isolated(
            JT.watts_strogatz(300, 4, 0.2, jax.random.key(1)),
            jax.random.key(2))
        pt = PT.connect_isolated(
            PT.watts_strogatz(300, 4, 0.2, prng.key(1, device=CPU),
                              device=CPU), prng.key(2, device=CPU))
        cfg = dict(n_agents=300, n_features=5)
        return (JM.AxelrodModel(JM.AxelrodConfig(**cfg), topology=jt),
                AxelrodModel(AxelrodConfig(**cfg), topology=pt))
    cfg = dict(n_agents=400, k=6, subset_size=20)
    return (JM.SIRModel(JM.SIRConfig(**cfg)),
            SIRModel(SIRConfig(**cfg), device=CPU))


_models = functools.lru_cache(maxsize=None)(_pair)


@pytest.mark.parametrize("tasks_per_cycle", [1, 6])
@pytest.mark.parametrize("n_workers", [1, 3, 4])
@pytest.mark.parametrize("name", ["axelrod", "axelrod_topology", "sirs"])
def test_simulate_protocol_equals_reference(name, n_workers,
                                            tasks_per_cycle):
    jm, pm = _models(name)
    kw = {"seed": 3} if name.startswith("axelrod") else {}
    ref = J.simulate_protocol(
        jm.des_model(**kw), 400,
        config=J.ProtocolConfig(n_workers=n_workers,
                                tasks_per_cycle=tasks_per_cycle))
    port = simulate_protocol(
        pm.des_model(**kw), 400,
        config=ProtocolConfig(n_workers=n_workers,
                              tasks_per_cycle=tasks_per_cycle))
    assert_same_result(port, ref)


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("name", ["axelrod", "axelrod_topology", "sirs"])
def test_hazard_rules_and_costs_equal_reference(name, strict):
    """Both hazard rules, custom DESCosts and custom cost functions (the
    costs vary with the recipe, so the event order depends on them)."""
    jm, pm = _models(name)

    def exec_cost(recipe):
        return 2e-7 * (1 + recipe[0] % 7) + 1e-7 * recipe[1]

    kw = dict(strict=strict, exec_cost=exec_cost,
              create_cost=lambda: 4e-7)
    ref = J.simulate_protocol(jm.des_model(**kw), 300,
                              config=J.ProtocolConfig(n_workers=3),
                              costs=J.DESCosts(**COSTS))
    port = simulate_protocol(pm.des_model(**kw), 300,
                             config=ProtocolConfig(n_workers=3),
                             costs=DESCosts(**COSTS))
    assert_same_result(port, ref)


def test_protocol_config_fields_in_reference_order():
    """Positional construction agrees with the reference's dataclass."""
    names = [f.name for f in dataclasses.fields(ProtocolConfig)]
    assert names == [f.name for f in dataclasses.fields(J.ProtocolConfig)]
    assert ProtocolConfig(128, 2, 3) == ProtocolConfig(
        window=128, n_workers=2, tasks_per_cycle=3)


def test_model_cost_hooks():
    _, pm = _models("axelrod")
    assert pm.task_cost(None, 0) == 1.0
    assert pm.creation_cost() == 0.05


def test_simulator_direct_and_deadlock_free():
    """ProtocolSimulator as the reference builds it; a chain of
    dependent tasks (every task depends on every record) still drains."""
    des = DESModel(recipes_fn=lambda i: i, exec_cost_fn=lambda r: 1e-6,
                   create_cost_fn=lambda: 1e-7, record_new=list,
                   record_add=lambda rec, r: rec + [r],
                   depends=lambda rec, r: bool(rec))
    r = ProtocolSimulator(des, n_workers=3, total_tasks=50).run()
    assert r.n_tasks == 50 and sum(r.executed_per_worker) == 50


# --------------------------------- tests/test_workersim.py's invariants
def _axelrod_des(**kw):
    return AxelrodModel(AxelrodConfig(n_agents=200, n_features=20),
                        device=CPU).des_model(**kw)


def test_all_tasks_execute():
    r = simulate_protocol(_axelrod_des(), 500,
                          config=ProtocolConfig(n_workers=3))
    assert r.n_tasks == 500
    assert sum(r.executed_per_worker) == 500


def test_single_worker_is_sequential():
    """n=1: exactly one task in flight, chain length stays at C-bound."""
    r = simulate_protocol(_axelrod_des(), 300,
                          config=ProtocolConfig(n_workers=1,
                                                tasks_per_cycle=6))
    assert r.executed_per_worker == [300]
    assert r.max_chain_len <= 6 + 1


def test_more_workers_not_slower_at_large_tasks():
    """Paper Fig. 2 claim (i): T decreases with n when tasks are large."""
    model = AxelrodModel(AxelrodConfig(n_agents=500, n_features=300),
                         device=CPU)
    t1 = simulate_protocol(model.des_model(), 400,
                           config=ProtocolConfig(n_workers=1)).makespan
    t4 = simulate_protocol(model.des_model(), 400,
                           config=ProtocolConfig(n_workers=4)).makespan
    assert t4 < t1
    assert t4 > t1 / 4.5  # no super-linear nonsense


def test_makespan_bounded_below_by_work():
    """makespan >= total model work / n (work conservation)."""
    cfg = AxelrodConfig(n_agents=500, n_features=100)
    des = AxelrodModel(cfg, device=CPU).des_model()
    n = 3
    r = simulate_protocol(des, 300, config=ProtocolConfig(n_workers=n))
    per_task = 1e-7 * cfg.n_features + 5e-7
    assert r.makespan >= 300 * per_task / n


def test_sir_des_runs_and_balances():
    m = SIRModel(SIRConfig(n_agents=400, k=6, subset_size=20), device=CPU)
    r = simulate_protocol(m.des_model(), 400,
                          config=ProtocolConfig(n_workers=4))
    assert r.n_tasks == 400
    # all workers participate for a conflict-sparse chain
    assert min(r.executed_per_worker) > 0


def test_protocol_overhead_dominates_small_tasks():
    """Paper Fig. 3 claim: speedup from extra workers degrades as task
    size shrinks (protocol overhead per task is constant)."""
    def ratio(subset_size):
        m = SIRModel(SIRConfig(n_agents=4000, k=6, subset_size=subset_size),
                     device=CPU)
        tasks = m.cfg.tasks_per_step()
        costs = DESCosts(**COSTS)
        t1 = simulate_protocol(m.des_model(), tasks,
                               config=ProtocolConfig(n_workers=1),
                               costs=costs).makespan
        t5 = simulate_protocol(m.des_model(), tasks,
                               config=ProtocolConfig(n_workers=5),
                               costs=costs).makespan
        return t5 / t1

    r_small, r_mid, r_big = ratio(4), ratio(50), ratio(200)
    assert r_big < r_mid < r_small


def test_tasks_per_cycle_limit_respected():
    # C=1 forces a creation pattern where chain can't run ahead; still
    # completes and stays shorter than with large C
    r1 = simulate_protocol(_axelrod_des(), 200,
                           config=ProtocolConfig(n_workers=2,
                                                 tasks_per_cycle=1))
    r6 = simulate_protocol(_axelrod_des(), 200,
                           config=ProtocolConfig(n_workers=2,
                                                 tasks_per_cycle=6))
    assert r1.n_tasks == r6.n_tasks == 200
    assert r1.max_chain_len <= r6.max_chain_len + 1
