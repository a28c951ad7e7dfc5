"""CPU tests of the benchmark's harness at small sizes: the cells load,
the port's final state equals the plain reference on every cell, the
check fails under the bfloat16 control and under planted faults, the
result line's keys, the refusal without a card, the imports, and the
work formulas against hand counts."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from bench import harness  # noqa: E402
from bench.work import axelrod as ax_work  # noqa: E402
from bench.work import conflict, device, levels  # noqa: E402
from bench.work import sirs as sirs_work  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SMALL = {
    "axelrod": {"config": {"n_agents": 1000},
                "traffic": {"task_size": 20, "window": 64,
                            "tasks_per_call": 448}},
    "sirs": {"config": {"n_agents": 1000},
             "traffic": {"task_size": 50, "window": 64,
                         "tasks_per_call": 500}},
}


def small(cell: str) -> dict:
    return SMALL[harness.Cell(cell).config["family"]]


def run_small(cell: str, trace: bool = False, seed: int = 3000000019):
    return harness.run_cell(cell, seed, 0.05, trace, device="cpu",
                            overrides=small(cell))


def test_every_cell_resolves_to_its_files():
    for name in CELLS:
        cell = harness.Cell(name)
        fam = cell.family
        for attr in ("KERNELS", "LAUNCH_COUNTERS", "build", "initial_state",
                     "reference_run", "call_work", "wave_kernel_work",
                     "ids_per_task"):
            assert hasattr(fam, attr), (name, attr)
        for key in ("engine", "window", "strict", "task_size",
                    "tasks_per_call", "warmup_calls"):
            assert key in cell.traffic, (name, key)
        for m in cell.end_to_end + cell.per_layer:
            assert harness.reader_path(m["name"]).exists(), m["name"]
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and any(n.startswith("tasks_per_s")
                                        for n in e2e)
        assert cell.per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_port_equals_reference(cell):
    result, lines = run_small(cell)
    assert result["correct"], result["check"]
    assert result["check"]["state_mismatch"]["value"] == 0
    assert result["attempted"] % small(cell)["traffic"]["tasks_per_call"] == 0
    assert lines[0].startswith("set-up: imports ")
    assert lines[1:] == ["check state_mismatch: 0 (limit 0)",
                         "check tasks_gap: 0 (limit 0)"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    result, _ = run_small(CELLS[0], trace)
    keys = list(result)
    assert set(keys) - {"breakdown"} == {"correct", "attempted", "failed",
                                         "metrics", "device", "check"}
    assert keys[-1] == "check"
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    names = {m["name"] for m in (SPEC["per_layer"] if trace
                                 else SPEC["end_to_end"])}
    assert set(result["metrics"]) <= names
    assert json.loads(json.dumps(result)) == result


def _event(name, dev, start, end, annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, is_user_annotation=annotation,
        device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end))


def test_profile_summary_reads_busy_gaps_and_launches():
    events = [_event("bench.run_engine", False, 0, 100, True),
              _event("protocol.wave", False, 40, 60, True),
              _event("axelrod_wave_kernel(...)", True, 10, 30),
              _event("conflict_join_kernel(Args)", True, 20, 35),
              _event("protocol.wave", True, 10, 35, True),
              _event("axelrod_wave_kernel(...)", True, 50, 70)]
    got = harness._profile_summary(
        events, {"axelrod_wave_kernel": 2, "conflict_join_kernel": 1})
    assert got["busy_s"] == pytest.approx(45e-6)
    assert got["kernel_s"]["axelrod_wave_kernel"] == pytest.approx(40e-6)
    assert got["gaps"] == {"protocol.wave": pytest.approx(15e-6)}
    with pytest.raises(harness.IncompleteTrace, match="recorded 2 launches"):
        harness._profile_summary(events, {"axelrod_wave_kernel": 3})
    fam = harness.Cell(CELLS[0]).family
    counters = harness._counters(fam)
    assert set(counters) == {"conflict.launches", "conflict.block_launches",
                             "levels.launches", "axelrod.launches"}
    assert harness._per_kernel(fam, dict.fromkeys(counters, 1)) == {
        "conflict_join_kernel": 2, "wave_levels_kernel": 1,
        "axelrod_wave_kernel": 1}


@pytest.mark.parametrize("family", ["axelrod", "sirs"])
def test_bfloat16_control_fails_the_check(family):
    from bench.control import control_reading

    cell = next(c for c in CELLS
                if harness.Cell(c).config["family"] == family)
    cell = harness.Cell(cell, overrides=SMALL[family])
    # SIRS at this size flips a comparison once in ~10^4 tasks
    calls = 3 if family == "axelrod" else 20
    for seed in (11, 12, 13):
        got = control_reading(cell, seed, calls, torch.device("cpu"))
        assert got["state_mismatch"] > 0, got


def _unchanged(model, state, recipes, mask):
    return state


def _half(model_cls):
    def execute_wave(self, state, recipes, mask):
        keep = torch.arange(mask.shape[0], device=mask.device) % 2 == 0
        return model_cls._apply(self, state, recipes, self._draws(recipes),
                                mask & keep)
    return execute_wave


def _altered_axelrod(*args, **kwargs):
    from repro_torch.kernels.axelrod import axelrod_wave

    new_t, interact = axelrod_wave(*args, **kwargs)
    return torch.where(interact[:, None], (new_t + 1) % 3, new_t), interact


def _altered_sir(*args, **kwargs):
    from repro_torch.kernels.sir import sir_wave

    nxt = sir_wave(*args, **kwargs)
    nxt[:, 0] = (nxt[:, 0] + 1) % 3
    return nxt


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_fails_the_check(cell, fault, monkeypatch):
    """A wave that returns the state unchanged, a wave that runs half of
    its tasks, and a wave kernel whose answer is altered where it is
    made: each must turn ``correct`` false. (One card: no exchange
    between chips to leave out.)"""
    import repro_torch.mabs.axelrod as ax_mod
    import repro_torch.mabs.sir as sir_mod

    axelrod = harness.Cell(cell).config["family"] == "axelrod"
    cls = ax_mod.AxelrodModel if axelrod else sir_mod.SIRModel
    if fault == "unchanged":
        monkeypatch.setattr(cls, "execute_wave", _unchanged)
    elif fault == "half":
        monkeypatch.setattr(cls, "execute_wave", _half(cls))
    elif axelrod:
        monkeypatch.setattr(ax_mod, "axelrod_wave", _altered_axelrod)
    else:
        monkeypatch.setattr(sir_mod, "sir_wave", _altered_sir)
    result, _ = run_small(cell)
    assert not result["correct"]
    assert result["check"]["state_mismatch"]["value"] > 0
    assert result["failed"] == result["attempted"]


def test_run_exits_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "5", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_jax_and_a_reference_free_of_the_port():
    files = sorted((ROOT / "bench").rglob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)
            if path.parent.name in ("reference", "work", "metrics"):
                assert name.split(".")[0] != "repro_torch", (path, name)
    code = ("import sys; sys.path[:0] = ['.', 'src']; from bench import "
            f"harness; harness.run_cell({CELLS[0]!r}, 7, 0.01, False, "
            f"device='cpu', overrides={SMALL['axelrod']!r}); "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_work_formulas_against_hand_counts():
    assert device.THREEFRY_OPS == 117
    assert device.UNIFORM_OPS == 121
    assert device.RANDINT_OPS == 2 * 117 + 2 * 118 + 5
    # 4 tasks of 3 ids: 4 * (12 + 1) bytes in, 6 pairs = 0.75 bytes out
    assert conflict.prefix(4, 3) == (52.75, 12)
    # 4 + 2 tasks of 3 ids in, 8 pairs = 1 byte out
    assert conflict.block(4, 2, 3) == (79.0, 18)
    # 6 pairs = 0.75 bytes, 4 validity bytes, 4 levels (+ 4 floors)
    assert levels.sweep(4) == (20.75, 4.0)
    assert levels.sweep(4, floored=True) == (36.75, 4.0)
    # F = 2: rows 2 * 8 read, 8 written; draws 6 hashes, 2 integers,
    # 3 uniforms; 6 update ops + 6
    assert ax_work.task(2) == (24, 6 * 117 + 2 * device.RANDINT_OPS
                               + 3 * 121 + 12)
    assert ax_work.wave_kernel(3, 2, 4, 2) == (8 + 3 * 37, 18.0)
    # m = 2 subsets: a step is 2 computes then 2 commits
    assert sirs_work.counts(7, 2) == (4, 3)
    assert sirs_work.counts(5, 2) == (3, 2)
    assert sirs_work.compute_task(4, 2) == (10, 117 + 4 * 121 + 4 * 10)
    assert sirs_work.commit_task(4) == (8, 0.0)
    assert sirs_work.wave_kernel(2, 4, 2) == (2 * 30, 2 * 4 * 10.0)
    assert sirs_work.ids_per_task(1000) == 3.0
    assert device.least_seconds(3.35e12, 1.0) == pytest.approx(1.0)
    assert device.least_seconds(1.0, 67e12) == pytest.approx(1.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA "
                    "kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    result, _ = harness.run_cell(cell, 3000000021, 1.0, False)
    assert result["correct"], result["check"]
    assert result["device"]["platform"] == "gpu"
