"""The port's sharded engines against the JAX package's, on the CPU.

(a) World size 1, in this process: ``sharded``, ``sharded_window_halo``,
``sharded_replicated`` and ``sharded_overlap`` on voter, SIS, Axelrod
(n = 41, F = 3, q = 3) and SIRS (n = 400, k = 6, s = 25) against the
reference's engines on this process's one device — states bit for bit,
stats dicts equal — with the collective call sites' byte count equal to
``comm_bytes_total``, and no more host reads per window than
``wavefront``.

(b) World size 4, two launches for the whole module
(``torch_sharded_cases.py``): the port on four ``gloo`` ranks
(``torch.multiprocessing``, a ``FileStore`` under the test's temporary
directory; a failed or late rank fails the tests) and the reference on
four virtual XLA devices. Every case's final state equals the
reference's and the port's oracle on every rank, its stats equal the
reference's key for key, and each rank's byte count equals
``comm_bytes_total``; every rung of the comm ladder runs in some case.
The launches start before the world-1 tests, which run meanwhile.
"""
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import torch_sharded_cases as C  # noqa: E402
from repro import mabs as JM  # noqa: E402
from repro import topology as JT  # noqa: E402
from repro.engine import make_engine as j_make_engine  # noqa: E402
from repro_torch import mabs as PM  # noqa: E402
from repro_torch import topology as PT  # noqa: E402
from repro_torch.engine import make_engine  # noqa: E402
from repro_torch.utils import prng  # noqa: E402

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PARTS = 2       # reference processes (its compiles dominate)
DEADLINE_S = 600    # for both launches, from their start


def assert_states_equal(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype, (what, k)
        np.testing.assert_array_equal(got[k], v, err_msg=f"{what} {k}")


# ------------------------------------------------- the four-rank launches
class Launches:
    """The reference's processes and the port's ranks, started at once;
    ``results()`` waits for all of them (``DEADLINE_S``), fails on a
    non-zero exit or a timeout, and loads what they wrote."""

    def __init__(self, tmp):
        self.tmp = str(tmp)
        self.t0 = time.monotonic()
        env = dict(os.environ,
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(REPO, "src"),
                        os.path.join(REPO, "tests")]))
        self.jax = []
        for part in range(JAX_PARTS):
            log = open(os.path.join(self.tmp, f"jax{part}.log"), "w")
            self.jax.append((subprocess.Popen(
                [sys.executable, C.__file__,
                 os.path.join(self.tmp, f"jax{part}.pkl"), str(part),
                 str(JAX_PARTS)], env=env, stdout=log,
                stderr=subprocess.STDOUT), log))
        ctx = mp.get_context("spawn")
        self.ranks = [ctx.Process(target=C.torch_rank,
                                  args=(r, os.path.join(self.tmp, "store"),
                                        self.tmp))
                      for r in range(C.WORLD)]
        for p in self.ranks:
            p.start()
        self._results = None

    def _left(self):
        return max(DEADLINE_S - (time.monotonic() - self.t0), 1)

    def results(self):
        if self._results is not None:
            return self._results
        for r, p in enumerate(self.ranks):
            p.join(self._left())
            if p.is_alive():
                pytest.fail(f"torch rank {r} did not finish in "
                            f"{DEADLINE_S} s")
            if p.exitcode != 0:
                err = os.path.join(self.tmp, f"torch_rank{r}.err")
                text = open(err).read() if os.path.exists(err) else ""
                pytest.fail(f"torch rank {r} exited {p.exitcode}:\n{text}")
        ref = {}
        for part, (proc, log) in enumerate(self.jax):
            try:
                rc = proc.wait(self._left())
            except subprocess.TimeoutExpired:
                pytest.fail(f"reference process {part} did not finish in "
                            f"{DEADLINE_S} s")
            log.close()
            if rc != 0:
                text = open(os.path.join(self.tmp, f"jax{part}.log")).read()
                pytest.fail(f"reference process {part} exited {rc}:\n"
                            f"{text[-4000:]}")
            with open(os.path.join(self.tmp, f"jax{part}.pkl"), "rb") as f:
                ref.update(pickle.load(f))
        ranks = []
        for r in range(C.WORLD):
            with open(os.path.join(self.tmp, f"torch_rank{r}.pkl"),
                      "rb") as f:
                ranks.append(pickle.load(f))
        self._results = ref, ranks
        return self._results

    def close(self):
        for p in self.ranks:
            if p.is_alive():
                p.kill()
            p.join(10)
        for proc, log in self.jax:
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
            log.close()


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    la = Launches(tmp_path_factory.mktemp("sharded4"))
    yield la
    la.close()


# --------------------------------------------------------- (a) world size 1
MODELS = ("voter", "sis", "axelrod", "sirs")


def _models(name):
    if name in ("voter", "sis"):
        j_cls, p_cls = ((JM.VoterModel, PM.VoterModel) if name == "voter"
                        else (JM.SISModel, PM.SISModel))
        return j_cls(JT.ring(102, 4)), p_cls(PT.ring(102, 4, device=CPU))
    if name == "axelrod":
        cfg = dict(n_agents=41, n_features=3, q=3)
        return (JM.AxelrodModel(JM.AxelrodConfig(**cfg)),
                PM.AxelrodModel(PM.AxelrodConfig(**cfg), device=CPU))
    cfg = dict(n_agents=400, k=6, subset_size=25)
    return (JM.SIRModel(JM.SIRConfig(**cfg)),
            PM.SIRModel(PM.SIRConfig(**cfg), device=CPU))


@pytest.mark.parametrize("ename", C.ENGINES)
@pytest.mark.parametrize("model", MODELS)
def test_world_one_equals_reference(launches, model, ename):
    jm, pm = _models(model)
    assert len(jax.devices()) == 1
    js0 = jm.init_state(jax.random.key(7))
    ps0 = pm.init_state(prng.key(7, device=CPU), device=CPU)
    j_eng = j_make_engine(ename, jm, window=64)
    p_eng = make_engine(ename, pm, window=64, device=CPU)
    wf = make_engine("wavefront_overlap" if ename.endswith("_overlap")
                     else "wavefront", pm, window=64, device=CPU)
    j_out, j_stats = j_eng.run(js0, 150, seed=3)
    p_out, p_stats = p_eng.run(ps0, 150, seed=3)
    assert_states_equal({k: v.numpy() for k, v in p_out.items()}, j_out,
                        f"{model} {ename}")
    assert p_stats == j_stats
    assert (p_eng.comm_iteration_counts(p_stats)
            == j_eng.comm_iteration_counts(j_stats))
    assert p_stats["n_devices"] == p_eng.agents.world_size == 1
    assert p_eng.agents.comm_bytes == p_stats["comm_bytes_total"]
    assert p_eng.agents.collectives <= p_stats["total_waves"]
    w_out, w_stats = wf.run(ps0, 150, seed=3)
    for k, v in w_out.items():
        assert torch.equal(p_out[k], v)
    assert p_stats["total_waves"] == w_stats["total_waves"]


def test_world_one_reads_the_host_no_more_than_wavefront(monkeypatch):
    """Per window the sharded engines read the device no more often than
    the wavefront engines: the split rung's chunk offsets come back in
    the wave count's copy. On the card each such read is a host sync."""
    reads = [0]
    for name in ("item", "tolist", "cpu", "numpy", "__int__", "__float__",
                 "__bool__", "__index__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *args, _orig=orig, **kwargs):
            reads[0] += 1
            return _orig(self, *args, **kwargs)
        monkeypatch.setattr(torch.Tensor, name, counted)
    _, pm = _models("sis")
    ps0 = pm.init_state(prng.key(7, device=CPU), device=CPU)
    per = {}
    for ename in ("wavefront", "sharded", "sharded_window_halo",
                  "sharded_replicated", "wavefront_overlap",
                  "sharded_overlap"):
        eng = make_engine(ename, pm, window=64, device=CPU)
        reads[0] = 0
        eng.run(ps0, 640, seed=3)
        per[ename] = reads[0]
    assert per["wavefront"] >= 10  # the wave count, once per window
    for ename in ("sharded", "sharded_window_halo", "sharded_replicated"):
        assert per[ename] <= per["wavefront"], per
    assert per["sharded_overlap"] <= per["wavefront_overlap"], per


@pytest.mark.parametrize("cls", ["no_contracts", "write_only"])
def test_halo_true_rejects_models_without_both_contracts(cls):
    pm = C._torch_model(f"voter_{cls}", ("ring", 100, 4))
    with pytest.raises(ValueError, match="task_read_agents"):
        make_engine("sharded", pm, window=32, halo=True, device=CPU)
    eng = make_engine("sharded", pm, window=32, device=CPU)
    assert eng.halo is False


def test_engine_refuses_bad_arguments():
    _, pm = _models("voter")
    with pytest.raises(ValueError, match="chunk"):
        make_engine("sharded", pm, window=32, chunk=0, device=CPU)
    eng = make_engine("sharded", pm, window=32, device=CPU)
    with pytest.raises(ValueError, match="agent axis"):
        eng.run({"opinions": torch.zeros(102, dtype=torch.int32),
                 "other": torch.zeros(5)}, 10)


# -------------------------------------------------------- (b) world size 4
RUNS = [(c["id"], t) for c in C.CASES for t in c["totals"]]


@pytest.mark.parametrize("cid,total", RUNS,
                         ids=[f"{c}-{t}" for c, t in RUNS])
def test_four_ranks_equal_reference(launches, cid, total):
    ref, ranks = launches.results()
    want = ref[cid, total]
    oracle = ranks[0][cid, total]["oracle"]
    for r, res in enumerate(ranks):
        got = res[cid, total]
        what = f"{cid} total={total} rank {r}"
        assert_states_equal(got["state"], want["state"], what)
        assert_states_equal(got["state"], oracle, what + " (oracle)")
        assert got["stats"] == want["stats"], what
        assert got["world_size"] == got["stats"]["n_devices"] == C.WORLD
        assert got["comm_bytes"] == got["stats"]["comm_bytes_total"], what
        assert got["collectives"] <= got["stats"]["total_waves"], what


def _stats(launches, cid, total):
    return launches.results()[1][0][cid, total]["stats"]


def test_four_ranks_run_every_rung(launches):
    ref, ranks = launches.results()
    for side in [ref] + ranks:
        rungs = set()
        for res in side.values():
            rungs |= set(res["stats"]["comm_modes"])
        assert rungs == {"split", "halo", "pair", "full"}


@pytest.mark.parametrize("model,n_reads", [("voter", 1), ("sis", None)])
def test_four_ranks_comm_ladder_is_monotone(launches, model, n_reads):
    """tests/test_engine_sharded.py::test_halo_comm_volume_monotone_ladder
    on the port's four ranks: split <= window halo <= full state, per
    wave and in total, over one schedule."""
    sp, mono, rep = (_stats(launches, f"ladder-{model}-{e}", 256)
                     for e in ("sharded", "sharded_window_halo",
                               "sharded_replicated"))
    if n_reads is None:
        n_reads = C._torch_model("sis", C.WS4096).topology.max_degree + 1
    assert sp["halo"] and sp["halo_split"]
    assert sp["window_halo_rows"] == 128 * (n_reads + 1)
    assert mono["halo"] and not mono["halo_split"]
    assert mono["per_wave_gather_rows"] == 128 * (n_reads + 1)
    assert mono["comm_bytes_total"] == (mono["per_wave_comm_bytes"]
                                        * mono["total_waves"])
    assert not rep["halo"]
    assert rep["per_wave_comm_bytes"] == rep["full_state_bytes"]
    assert sp["total_waves"] == mono["total_waves"] == rep["total_waves"]
    assert (sp["per_wave_comm_bytes"] < mono["per_wave_comm_bytes"]
            < rep["per_wave_comm_bytes"])
    assert (sp["comm_bytes_total"] <= mono["comm_bytes_total"]
            <= rep["comm_bytes_total"])


@pytest.mark.parametrize("cid,total", [
    ("ladder-voter-sharded", 256), ("regression-voter-w256", 512),
    ("ladder-sis-sharded", 256), ("regression-sis-w256", 512)])
def test_four_ranks_comm_regression_equals_live_reference(launches, cid,
                                                          total):
    """The comm-regression configuration, held to a live reference run
    (whose reduction the committed BENCH_engine.json no longer gives)."""
    ref, _ = launches.results()
    got = _stats(launches, cid, total)
    assert got["halo_split"]
    assert got["per_wave_comm_bytes"] < got["window_halo_bytes"]
    assert (got["comm_reduction_vs_window_halo"]
            == ref[cid, total]["stats"]["comm_reduction_vs_window_halo"])
    assert got["comm_reduction_vs_window_halo"] > 1.0


def test_four_ranks_degenerate_width(launches):
    """test_engine_sharded.py::test_halo_degenerate_width_falls_back_to_
    replication on the port's four ranks."""
    s = _stats(launches, "degenerate-ring48-sharded_window_halo", 70)
    assert not s["halo"]
    assert s["per_wave_gather_rows"] == 48   # padded N, full state
    assert s["per_wave_comm_bytes"] == s["full_state_bytes"]
    s = _stats(launches, "degenerate-ring48-sharded", 70)
    assert s["halo"] and s["halo_split"]
    s = _stats(launches, "degenerate-ring100-sharded_window_halo", 150)
    assert s["halo"] and s["per_wave_gather_rows"] == 64
    s = _stats(launches, "degenerate-ring100-window_halo_overlap", 150)
    assert s["comm_modes"].get("pair", 0) == 0
    assert s["comm_modes"].get("full", 0) == s["n_boundaries"]
    s = _stats(launches, "degenerate-ring100-sharded_overlap", 150)
    assert s["halo"] and s["halo_split"]
    s = _stats(launches, "degenerate-ws4096-window_halo_overlap", 128)
    assert s["halo"] and s["per_wave_gather_rows"] == 128


@pytest.mark.parametrize("cid", C.COST_CASES)
def test_four_ranks_costs_equal_reference(launches, cid):
    """``compiled_costs`` at world size 4 on the split, window-halo and
    replicated rungs: on every rank the collectives recorded at the call
    sites, by loop depth and resolved against ``comm_iteration_counts``,
    equal the reference's, parsed from its compiled HLO on four devices,
    and the resolved total equals ``comm_bytes_total`` (the reference's
    cross-check identity, exact)."""
    ref, ranks = launches.results()
    want = ref[cid, 256]
    for r, res in enumerate(ranks):
        got = res[cid, 256]
        assert got["iters"] == want["iters"], r
        assert set(got["costs"]) == set(want["costs"]), r
        for name, c in got["costs"].items():
            assert c == want["costs"][name], (r, name)
            assert c["total"] == got["stats"]["comm_bytes_total"], (r, name)
        assert sum(c["total"] for c in got["costs"].values()) > 0


@pytest.mark.parametrize("cid,total", [("no_contracts-sharded", 150),
                                       ("write_only-sharded", 100)])
def test_four_ranks_without_contracts_replicate(launches, cid, total):
    s = _stats(launches, cid, total)
    assert not s["halo"] and s["comm_modes"] == {"full": s["n_windows"]}
