"""The port's agent-axis helpers and the models' row contracts against
the JAX package's, on the CPU.

``window_halo``, ``pair_halo``, ``halo_scatter``, ``wave_slab_counts``
and ``wave_halo_split`` against the reference's on the cases of
tests/test_halo_split.py and on seeded inputs with -1 rows, invalid
tasks, empty waves, rows past ``n_waves_max`` and a full
``n_chunks_max``; ``halo_gather`` and ``wave_halo_gather`` at world size
1 against the reference's inside a one-device ``shard_map``, the port's
chunk range against the reference's chunks one by one; an empty range
issuing no collective; the same gathers and an engine run through a real
one-rank ``gloo`` group; the agent group's layout; and the four models'
``task_read_agents`` / ``task_write_agents`` equal to the reference's on
the same recipes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from repro import mabs as JM  # noqa: E402
from repro import topology as JT  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.utils.compat import shard_map  # noqa: E402
from repro_torch import distributed as PD  # noqa: E402
from repro_torch import mabs as PM  # noqa: E402
from repro_torch import topology as PT  # noqa: E402
from repro_torch.core.model import MABSModel  # noqa: E402
from repro_torch.engine import make_engine  # noqa: E402
from repro_torch.utils import prng  # noqa: E402

CPU = "cpu"


def _t(x):
    return torch.tensor(np.asarray(x))


def _eq(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _world_one(n):
    return PD.agent_group(device=CPU).for_agents(n)


# ------------------------------------------------------------ the layouts
SPLIT_CASES = {
    # tests/test_halo_split.py's
    "partitions": ([[3, 7], [1, -1], [5, 6], [2, 7], [-1, -1]],
                   [0, 1, 0, 2, 1], 5, 3, None),
    "drops_invalid": ([[4, 4], [9, 2], [8, -1]], [-1, 7, 1], 2, 2, None),
    "empty_wave": ([[0, 1], [2, 3]], [0, 2], 4, 8, None),
    # the layout outgrows n_chunks_max: the rows past it are dropped
    "full_n_chunks_max": ([[1, 2, 3], [4, 5, 6], [7, 8, 9], [1, -1, 2]],
                          [0, 0, 1, 2], 3, 2, 3),
}


def _random_split_case(seed):
    rng = np.random.RandomState(seed)
    w, slots = rng.randint(1, 40), rng.randint(1, 6)
    rows = rng.randint(-1, 60, (w, slots))
    levels = rng.randint(-1, 12, w)          # invalid tasks and gaps
    n_waves_max = rng.randint(1, 14)         # levels past it are dropped
    chunk = rng.randint(1, 9)
    n_chunks_max = None if seed % 3 else rng.randint(1, 6)
    return rows.tolist(), levels.tolist(), n_waves_max, chunk, n_chunks_max


for _s in range(12):
    SPLIT_CASES[f"random{_s}"] = _random_split_case(_s)


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_wave_halo_split_equals_reference(case):
    rows, levels, n_waves_max, chunk, n_chunks_max = SPLIT_CASES[case]
    jr = jnp.asarray(rows, jnp.int32)
    jl = jnp.asarray(levels, jnp.int32)
    pr, pl = _t(jr), _t(jl)
    _eq(PD.wave_slab_counts(pr, pl, n_waves_max=n_waves_max),
        JS.wave_slab_counts(jr, jl, n_waves_max=n_waves_max))
    slabs, cs = PD.wave_halo_split(pr, pl, n_waves_max=n_waves_max,
                                   chunk=chunk, n_chunks_max=n_chunks_max)
    j_slabs, j_cs = JS.wave_halo_split(jr, jl, n_waves_max=n_waves_max,
                                       chunk=chunk,
                                       n_chunks_max=n_chunks_max)
    _eq(slabs, j_slabs)
    _eq(cs, j_cs)


def test_window_and_pair_halo_equal_reference():
    rng = np.random.RandomState(0)
    reads = rng.randint(-1, 50, (16, 5)).astype(np.int32)
    writes = rng.randint(-1, 50, (16, 2)).astype(np.int32)
    halo = PD.window_halo(_t(reads), _t(writes))
    j_halo = JS.window_halo(jnp.asarray(reads), jnp.asarray(writes))
    _eq(halo, j_halo)
    _eq(PD.pair_halo(halo, halo.flip(0)),
        JS.pair_halo(j_halo, j_halo[::-1]))


@pytest.mark.parametrize("dtype,trailing", [("int8", ()), ("int32", (3,)),
                                            ("float32", (2,))])
def test_halo_scatter_equals_reference(dtype, trailing):
    rng = np.random.RandomState(1)
    full = rng.randint(0, 3, (20,) + trailing).astype(dtype)
    halo = np.array([3, -1, 17, 3, 0, -1, 19], np.int32)
    vals = rng.randint(0, 3, (7,) + trailing).astype(dtype)
    vals[3] = vals[0]  # a duplicate slot writes what the first does
    got = PD.halo_scatter(_t(full), _t(halo), _t(vals))
    _eq(got, JS.halo_scatter(jnp.asarray(full), jnp.asarray(halo),
                             jnp.asarray(vals)))


# ------------------------------------------------------------- the gathers
def _one_device(f, *args):
    mesh = Mesh(np.asarray(jax.devices()[:1]), (JS.AGENT_AXIS,))
    return jax.jit(shard_map(f, mesh=mesh,
                             in_specs=tuple(P(JS.AGENT_AXIS) for _ in args),
                             out_specs=P(), check_vma=False))(*args)


@pytest.mark.parametrize("dtype,trailing", [("int8", ()), ("int32", (3,)),
                                            ("float32", (2,))])
def test_halo_gather_at_world_one_equals_reference(dtype, trailing):
    rng = np.random.RandomState(2)
    local = rng.randint(-5, 5, (20,) + trailing).astype(dtype)
    halo = np.array([3, -1, 17, 3, 0, 19, -1], np.int32)
    want = _one_device(lambda x: JS.halo_gather(
        x, jnp.asarray(halo), shard_n=20), jnp.asarray(local))
    ag = _world_one(20)
    got = PD.halo_gather(_t(local), _t(halo), ag)
    _eq(got, want)
    assert ag.collectives == 1
    assert ag.comm_bytes == 7 * local[0].nbytes
    # a dict of leaves travels in one collective
    both = PD.halo_gather({"a": _t(local), "b": _t(local[:, None] * 2)},
                          _t(halo), ag)
    _eq(both["a"], want)
    _eq(both["b"], np.asarray(want)[:, None] * 2)
    assert ag.collectives == 2


def test_wave_halo_gather_range_equals_reference_chunks():
    """One wave's chunk range in one collective delivers the rows the
    reference's per-chunk gathers do, chunk after chunk."""
    state = np.arange(20, dtype=np.float32)
    rows = np.array([[3, 17], [5, -1], [11, 3], [7, 8]], np.int32)
    levels = np.array([0, 1, 0, 0], np.int32)
    j_slabs, j_cs = JS.wave_halo_split(jnp.asarray(rows),
                                       jnp.asarray(levels), n_waves_max=3,
                                       chunk=2)
    c0, c1 = int(j_cs[0]), int(j_cs[1])
    assert c1 - c0 == 3

    def chunks(loc):
        return jnp.concatenate([
            JS.wave_halo_gather(loc, j_slabs, jnp.int32(c), shard_n=20)[0]
            for c in range(c0, c1)])
    want = _one_device(chunks, jnp.asarray(state))
    slabs, cs = PD.wave_halo_split(_t(rows), _t(levels), n_waves_max=3,
                                   chunk=2)
    ag = _world_one(20)
    got, slab = PD.wave_halo_gather(_t(state), slabs, c0, c1, agents=ag)
    _eq(got, want)
    _eq(slab, np.asarray(j_slabs)[c0:c1].reshape(-1))
    assert ag.collectives == 1
    # one chunk, as the reference gathers it
    one, _ = PD.wave_halo_gather(_t(state), slabs, c0, c0 + 1, agents=ag)
    _eq(one, np.asarray(want)[:2])


def test_empty_range_issues_no_collective():
    ag = _world_one(6)
    local = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    slabs = torch.full((3, 4), -1, dtype=torch.int32)
    g = PD.halo_gather(local, torch.zeros(0, dtype=torch.int32), ag)
    gc, slab = PD.wave_halo_gather(local, slabs, 1, 1, agents=ag)
    g0, _ = PD.wave_halo_gather(local, torch.zeros(3, 0, dtype=torch.int32),
                                1, 2, agents=ag)
    assert g.shape == gc.shape == g0.shape == (0, 2)
    assert slab.shape == (0,)
    assert ag.collectives == ag.comm_bytes == 0


# ----------------------------------------------------------- the agent axis
def test_agent_group_layout():
    ag = PD.agent_group(device=CPU)
    assert (ag.group, ag.rank, ag.world_size) == (None, 0, 1)
    two = PD.AgentGroup(None, 1, 4, torch.device(CPU)).for_agents(102)
    assert (two.shard_n, two.lo, two.n_pad) == (26, 26, 104)
    assert two.collectives == two.comm_bytes == 0


def test_agent_group_needs_a_card_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PD.agent_group()


def test_one_rank_gloo_group(tmp_path, monkeypatch):
    """A real one-rank process group: the gathers issue their
    collectives, the engine finds the default group, and a backend that
    cannot carry the device's tensors is refused."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        ag = PD.agent_group(device=CPU).for_agents(5)
        assert ag.group is dist.group.WORLD and ag.world_size == 1
        local = {"x": torch.arange(5, dtype=torch.int32),
                 "y": torch.arange(10, dtype=torch.int8).reshape(5, 2)}
        g = PD.halo_gather(local, torch.tensor([4, -1, 1], dtype=torch.int32),
                           ag)
        assert g["x"].tolist() == [4, 0, 1]
        assert g["y"].tolist() == [[8, 9], [0, 0], [2, 3]]
        full = PD.all_gather_rows(local, ag)
        assert all(torch.equal(full[k], local[k]) for k in local)
        assert ag.collectives == 2 and ag.comm_bytes == 3 * 6 + 5 * 6

        pm = PM.SISModel(PT.ring(50, 4, device=CPU))
        ps0 = pm.init_state(prng.key(1, device=CPU), device=CPU)
        want, w_stats = make_engine("sharded", pm, window=16,
                                    device=CPU).run(ps0, 80, seed=2)
        eng = make_engine("sharded_overlap", pm, window=16, device=CPU)
        assert eng.agents.group is dist.group.WORLD
        out, stats = eng.run(ps0, 80, seed=2)
        ov = make_engine("wavefront_overlap", pm, window=16, device=CPU)
        ov_out, _ = ov.run(ps0, 80, seed=2)
        assert torch.equal(out["states"], ov_out["states"])
        assert torch.equal(want["states"], ov_out["states"])
        assert eng.agents.comm_bytes == stats["comm_bytes_total"]

        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        with pytest.raises(ValueError, match="cannot carry cpu"):
            PD.agent_group(device=CPU)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ row contracts
def _contract_models():
    jring, pring = JT.ring(60, 4), PT.ring(60, 4, device=CPU)
    jws = JT.watts_strogatz(60, 4, 0.3, jax.random.key(5))
    pws = PT.watts_strogatz(60, 4, 0.3, prng.key(5, device=CPU), device=CPU)
    sir = dict(n_agents=60, k=4, subset_size=6)
    return {
        "voter": (JM.VoterModel(jws), PM.VoterModel(pws)),
        "sis": (JM.SISModel(jws), PM.SISModel(pws)),
        "axelrod": (JM.AxelrodModel(JM.AxelrodConfig(n_agents=60)),
                    PM.AxelrodModel(PM.AxelrodConfig(n_agents=60),
                                    device=CPU)),
        "sirs_ring": (JM.SIRModel(JM.SIRConfig(**sir), topology=jring),
                      PM.SIRModel(PM.SIRConfig(**sir), topology=pring)),
        "sirs_ws": (JM.SIRModel(JM.SIRConfig(**sir), topology=jws),
                    PM.SIRModel(PM.SIRConfig(**sir), topology=pws)),
    }


@pytest.mark.parametrize("model", ["voter", "sis", "axelrod", "sirs_ring",
                                   "sirs_ws"])
def test_row_contracts_equal_reference(model):
    jm, pm = _contract_models()[model]
    jrec = jm.create_tasks(jax.random.key(3), 5, 40)
    prec = pm.create_tasks(prng.key(3, device=CPU), 5, 40)
    _eq(pm.task_read_agents(prec), jm.task_read_agents(jrec))
    _eq(pm.task_write_agents(prec), jm.task_write_agents(jrec))


def test_model_defaults_declare_no_contracts():
    class Bare(MABSModel):
        def init_state(self, rng, *, device=None):
            return {}

        def create_tasks(self, base_key, start_index, count):
            return {}

        def execute_wave(self, state, recipes, mask):
            return state

    assert Bare().task_read_agents({}) is None
    assert Bare().task_write_agents({}) is None
