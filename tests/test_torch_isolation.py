"""The port stands alone and never lands on the CPU by default.

An AST scan shows that nothing under src/repro_torch/, and not
chip_smoke.py, imports jax or the JAX package; and with CUDA unavailable,
every entry point called without ``device`` raises before doing any work
instead of running on the CPU. Every public name of the reference's core,
topology, engine, train and distributed packages has a counterpart in the
port."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

from repro_torch import bridge  # noqa: E402
from repro_torch import topology as PT  # noqa: E402
from repro_torch.core import ProtocolConfig, run_engine, run_oracle  # noqa: E402
from repro_torch.engine import make_engine  # noqa: E402
from repro_torch.mabs import (  # noqa: E402
    AxelrodConfig,
    AxelrodModel,
    SIRConfig,
    SIRModel,
    SISModel,
    VoterModel,
)
from repro_torch.utils import prng  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"prng.py", "graph.py", "voter.py", "sis.py", "axelrod.py",
            "sir.py", "base.py", "chip_smoke.py", "bridge.py", "trace.py",
            "profiler.py", "provenance.py", "stats.py", "timing.py",
            "chain.py", "workersim.py", "generators.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for kernel in ("conflict", "levels", "axelrod", "sir", "flash", "wkv6",
                   "attach"):
        for part in ("ops", "ref", kernel):
            assert f"src/repro_torch/kernels/{kernel}/{part}.py" in rel
    for module in ("models/api.py", "models/attention.py",
                   "models/transformer.py", "models/layers.py",
                   "models/rwkv6.py",
                   "serving/engine.py", "configs/base.py",
                   "configs/registry.py", "launch/serve.py",
                   "train/__init__.py", "train/optim.py",
                   "train/schedule.py", "train/step.py", "train/data.py",
                   "train/checkpoint.py", "train/loop.py",
                   "launch/train.py", "utils/pytree.py",
                   "distributed/compress.py", "distributed/context.py",
                   "distributed/elastic.py", "distributed/spmd.py",
                   "distributed/collectives.py", "launch/mesh.py",
                   "launch/dryrun.py", "models/block_sharded.py",
                   "models/moe_sharded.py"):
        assert f"src/repro_torch/{module}" in rel


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


class _Spy(VoterModel):
    """Counts task creation, to show a refused run did no work."""
    created = 0

    def create_tasks(self, *args, **kwargs):
        _Spy.created += 1
        return super().create_tasks(*args, **kwargs)


@pytest.fixture
def cpu_model():
    topo = PT.ring(32, 2, device="cpu")
    model = _Spy(topo)
    return model, model.init_state(prng.key(0, device="cpu"), device="cpu")


@pytest.mark.parametrize("call", [
    lambda: prng.key(0),
    lambda: PT.ring(16, 2),
    lambda: PT.lattice2d(4, 4),
    lambda: PT.watts_strogatz(16, 2, 0.1, prng.key(0, device="cpu")),
    lambda: PT.erdos_renyi(16, 0.2, prng.key(0, device="cpu")),
    lambda: PT.barabasi_albert(16, 2, prng.key(0, device="cpu")),
    lambda: PT.from_edges(4, [[0, 1], [1, 2]]),
    lambda: bridge.key_from_data(__import__("numpy").zeros(2, "uint32")),
    lambda: bridge.state_from_numpy({"x": __import__("numpy").zeros(3)}),
    lambda: bridge.topology_from_numpy([[1], [0]], [1, 1]),
    lambda: PT.complete(4),
    lambda: PT.from_adjacency(torch.ones((3, 3), dtype=torch.bool)),
    lambda: AxelrodModel(AxelrodConfig(n_agents=8)),
    lambda: SIRModel(SIRConfig(n_agents=20, k=4, subset_size=5)),
], ids=["key", "ring", "lattice2d", "watts_strogatz", "erdos_renyi",
        "barabasi_albert", "from_edges",
        "key_from_data", "state_from_numpy", "topology_from_numpy",
        "complete", "from_adjacency", "axelrod", "sirs"])
def test_constructors_without_device_raise(no_cuda, call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("package", ["core", "topology", "engine",
                                     "train", "distributed", "obs"])
def test_reference_public_names_have_counterparts(package):
    """Every name in the reference's ``__all__`` resolves in the port's
    package of the same name (and is listed in its ``__all__``)."""
    import importlib

    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    missing = [n for n in ref.__all__
               if n not in port.__all__ or not hasattr(port, n)]
    assert not missing, f"repro_torch.{package} lacks {missing}"


def test_models_and_engines_without_device_raise(no_cuda, cpu_model):
    model, state = cpu_model
    _Spy.created = 0
    for m in (model, SISModel(model.topology)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            m.init_state(prng.key(0, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_engine(model, state, 64, config=ProtocolConfig(window=16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_oracle(model, state, 64, config=ProtocolConfig(window=16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine("sequential", model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_engine(model, state, 64, config=ProtocolConfig(window=16),
                   engine="wavefront_overlap")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_engine(model, state, 64,
                   config=ProtocolConfig(window=16, overlap=True))
    axelrod = AxelrodModel(AxelrodConfig(n_agents=8), device="cpu")
    sirs = SIRModel(SIRConfig(n_agents=20, k=4, subset_size=5), device="cpu")
    for m in (axelrod, sirs):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            m.init_state(prng.key(0, device="cpu"))
    # a topology on the CPU carries its own device: no card needed
    assert model.topology.block_graph(4).device.type == "cpu"
    assert _Spy.created == 0


def test_device_mismatch_raises(cpu_model):
    """An engine refuses state or a topology on another device than its
    own instead of moving it."""
    model, state = cpu_model
    eng = make_engine("wavefront", model, window=16, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        eng.run({"opinions": state["opinions"].to("meta")}, 32)
    with pytest.raises(ValueError, match="topology"):
        make_engine("wavefront", model, window=16, device="meta")


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    """Without a compiler the kernel build raises; nothing falls back."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    src, lib = _build.library_path("conflict")
    assert src.is_file() and lib.parent == tmp_path / "kernels"
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("conflict")
    assert not (tmp_path / "kernels").exists()


def test_lm_entry_points_without_device_raise(no_cuda):
    """The LM path's entry points, called without a device, raise before
    placing anything: building a model, drawing its parameters, the
    serving engine and the serve launcher."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Model, build_model
    from repro_torch.serving import ServingEngine

    cfg = get_config("smollm-360m").reduced()
    for call in (lambda: build_model(cfg), lambda: Model(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = build_model(cfg, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, params, n_slots=2, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "smollm-360m", "--reduced"])


def test_train_entry_points_without_device_raise(no_cuda, tmp_path):
    """The training path's entry points, called without a device, raise
    before placing anything: the train state and the train launcher (which
    writes no checkpoint)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.train.step import init_train_state

    model = build_model(get_config("smollm-360m").reduced(), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(model, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "smollm-360m", "--reduced", "--steps", "1",
                    "--ckpt-dir", str(tmp_path / "ckpt")])
    assert not (tmp_path / "ckpt").exists()
