#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--tasks N]

Run from the root of a checkout. Phases, each of which exits non-zero on
failure:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the port's CUDA kernels from src/repro_torch/csrc (one nvcc
     per source, in parallel) and prints the build seconds;
  3. holds each kernel bit for bit against its plain PyTorch version on
     the card: conflict at W in {1, 37, 128, 129, 1000, 4096}, nr in
     {1, 21}, nw in {1, 2}, both hazard rules; levels at the same W on
     random lower-triangular matrices of three densities, with and
     without a base floor, plus one matrix with entries above the
     diagonal;
  4. drives the main path — ``run_engine(engine="wavefront")`` on voter
     and SIS over ``watts_strogatz(n=1_000_000, k=10, beta=0.1)`` built
     on the card, W = 4096, 2^22 tasks each (``--tasks`` cuts the task
     count, never n or W) — with the kernel launch counters set to 0
     just before each model's run and read just after; each kernel must
     have launched once per window. Then, on the first 8 windows, the
     final state must equal the port's sequential oracle bit for bit,
     and state and stats must equal a CPU run of the port;
  5. splits 16 windows of each model into creation, record check,
     levels and waves (host clock, each step fenced by a synchronize),
     and profiles 16 more (torch.profiler) for the device's busy share;
  6. times each kernel at W = 4096 on a real window of each model (CUDA
     events, median of 25) beside its plain version and its bound; the
     summary line holds SIS's, the wider footprint.

The line before the last is the ``kernels`` JSON summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_NODES = 1_000_000
DEGREE = 10
REWIRE = 0.1
WINDOW = 4096
TOTAL_TASKS = 1 << 22
CHECK_WINDOWS = 8
SEED = 0

PARITY_WINDOWS = (1, 37, 128, 129, 1000, 4096)
LEVEL_DENSITIES = (0.001, 0.02, 0.3)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the CUDA-core
# (non-tensor) float32 rate, taken as the rate of the kernels' integer
# compares and maxes
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------- timing
def device_ms(torch, fn, reps: int = 25) -> float:
    """Median device time of one ``fn()`` in ms (CUDA events). A sleep
    kernel keeps the card busy while the launches are enqueued, so the
    events measure the kernels and not the host's launch gaps (for a
    host-bound function such as the plain levels loop, the gaps are its
    real cost and stay in)."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(20_000_000)
    events[0].record()
    for i in range(reps):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(reps))


# ------------------------------------------------------------- parity
def random_footprint(torch, gen, w, nr, nw, device):
    ids = max(4, w)
    reads = torch.randint(0, ids, (w, nr), generator=gen, dtype=torch.int32)
    writes = torch.randint(0, ids, (w, nw), generator=gen, dtype=torch.int32)
    reads[torch.rand((w, nr), generator=gen) < 0.2] = -1
    writes[torch.rand((w, nw), generator=gen) < 0.2] = -1
    valid = torch.arange(w) < w - w // 7  # an invalid tail
    return reads.to(device), writes.to(device), valid.to(device)


def check_conflict_parity(torch, conflict_matrix) -> int:
    gen = torch.Generator().manual_seed(1)
    worst, cases = 0, 0
    for w in PARITY_WINDOWS:
        for nr in (1, 21):
            for nw in (1, 2):
                for strict in (True, False):
                    reads, writes, valid = random_footprint(
                        torch, gen, w, nr, nw, "cuda")
                    got = conflict_matrix(reads, writes, valid,
                                          strict=strict, backend="cuda")
                    want = conflict_matrix(reads, writes, valid,
                                           strict=strict, backend="torch")
                    torch.cuda.synchronize()
                    err = int((got.int() - want.int()).abs().max())
                    worst = max(worst, err)
                    cases += 1
                    if err:
                        fail(f"conflict kernel != plain version at W={w} "
                             f"nr={nr} nw={nw} strict={strict}")
    log(f"parity conflict: {cases} cases bit-exact")
    return worst


def check_levels_parity(torch, wave_levels) -> int:
    gen = torch.Generator().manual_seed(2)
    worst, cases = 0, 0

    def one(conf, valid, base, what):
        nonlocal worst, cases
        got = wave_levels(conf, valid, base=base, backend="cuda")
        want = wave_levels(conf, valid, base=base, backend="torch")
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        worst = max(worst, err)
        cases += 1
        if err:
            fail(f"levels kernel != plain version: {what}")

    for w in PARITY_WINDOWS:
        valid = (torch.arange(w) < w - w // 7).cuda()
        for density in LEVEL_DENSITIES:
            conf = torch.rand((w, w), generator=gen) < density
            conf = conf.tril(diagonal=-1).cuda()
            base = torch.randint(0, 5, (w,), generator=gen,
                                 dtype=torch.int32).cuda()
            one(conf, valid, None, f"W={w} density={density}")
            one(conf, valid, base, f"W={w} density={density} base")
    w = 1000
    conf = (torch.rand((w, w), generator=gen) < 0.05).cuda()  # not triangular
    one(conf, torch.ones(w, dtype=torch.bool, device="cuda"), None,
        "entries above the diagonal")
    log(f"parity levels: {cases} cases bit-exact")
    return worst


# ------------------------------------------------------------ main path
def check_state(model_name, state, n):
    x = next(iter(state.values()))
    if x.shape != (n,):
        fail(f"{model_name}: final state has shape {tuple(x.shape)}")
    lo, hi = int(x.min()), int(x.max())
    if lo < 0 or hi > 1:  # two opinions / S,I
        fail(f"{model_name}: final state holds values outside [0, 1]: "
             f"[{lo}, {hi}]")


def states_equal(a: dict, b: dict) -> bool:
    return all(bool((a[k].cpu() == b[k].cpu()).all()) for k in a)


def drive_main_path(torch, total_tasks):
    """Voter and SIS through run_engine(engine="wavefront") at full size;
    returns (per-model results, summed launches, the models)."""
    from repro_torch.core import ProtocolConfig, run_engine, run_oracle
    from repro_torch.kernels.conflict import conflict as conflict_kernel
    from repro_torch.kernels.levels import levels as levels_kernel
    from repro_torch.mabs import SISModel, VoterModel
    from repro_torch.topology import watts_strogatz
    from repro_torch.utils import prng

    cfg = ProtocolConfig(window=WINDOW)
    results, launches, models = {}, {"conflict": 0, "levels": 0}, {}
    t0 = time.perf_counter()
    topo = watts_strogatz(N_NODES, DEGREE, REWIRE, prng.key(SEED))
    torch.cuda.synchronize()
    topo_s = time.perf_counter() - t0
    for name, cls in (("voter", VoterModel), ("sis", SISModel)):
        model = cls(topo)
        state0 = model.init_state(prng.key(SEED + 1))

        conflict_kernel.launches = 0
        levels_kernel.launches = 0
        t0 = time.perf_counter()
        out, stats = run_engine(model, state0, total_tasks, seed=SEED,
                                config=cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_conf, n_lev = conflict_kernel.launches, levels_kernel.launches
        launches["conflict"] += n_conf
        launches["levels"] += n_lev
        if not (n_conf == n_lev == stats["n_windows"]):
            fail(f"{name}: kernel launches conflict={n_conf} levels={n_lev}"
                 f" != n_windows={stats['n_windows']}")
        check_state(name, out, N_NODES)

        # the first CHECK_WINDOWS windows: oracle and a CPU run of the port
        prefix = min(CHECK_WINDOWS * WINDOW, total_tasks)
        t1 = time.perf_counter()
        wf, wf_stats = run_engine(model, state0, prefix, seed=SEED,
                                  config=cfg)
        oracle = run_oracle(model, state0, prefix, seed=SEED, config=cfg)
        if not states_equal(wf, oracle):
            fail(f"{name}: wavefront != sequential oracle on the first "
                 f"{prefix} tasks")
        cpu_model = cls(topo.to("cpu"))
        cpu_state0 = {k: v.cpu() for k, v in state0.items()}
        cpu_out, cpu_stats = run_engine(cpu_model, cpu_state0, prefix,
                                        seed=SEED, config=cfg, device="cpu")
        if cpu_stats != wf_stats or not states_equal(cpu_out, wf):
            fail(f"{name}: GPU run != CPU run of the port on the first "
                 f"{prefix} tasks: {wf_stats} vs {cpu_stats}")
        check_s = time.perf_counter() - t1
        results[name] = {
            "n_nodes": N_NODES, "max_degree": topo.max_degree,
            "window": WINDOW, "total_tasks": total_tasks,
            "n_windows": stats["n_windows"],
            "total_waves": stats["total_waves"],
            "mean_parallelism": stats["mean_parallelism"],
            "seconds": secs, "tasks_per_s": total_tasks / secs,
            "topology_seconds": topo_s, "check_seconds": check_s,
            "checked_tasks": prefix,
        }
        log(f"main path {name}: " + json.dumps(results[name]))
        models[name] = model
    return results, launches, models


def window_breakdown(torch, models, n_windows: int = 16):
    """Host-clock split of one window of the main path into its steps,
    each fenced by a synchronize (so the sum exceeds an unfenced
    window): creation, record check, levels, waves."""
    from repro_torch.core.records import wave_levels, window_conflicts
    from repro_torch.core.wavefront import execute_window
    from repro_torch.utils import prng

    def fenced(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for name, model in models.items():
        base_key = prng.key(SEED)
        state = model.init_state(prng.key(SEED + 1))
        valid = torch.ones(WINDOW, dtype=torch.bool, device="cuda")
        split = {"create": 0.0, "conflict": 0.0, "levels": 0.0,
                 "waves": 0.0}
        waves = 0
        for k in range(n_windows):
            rec, t = fenced(lambda: model.create_tasks(base_key, k * WINDOW,
                                                       WINDOW))
            split["create"] += t
            conf, t = fenced(lambda: window_conflicts(model, rec, valid))
            split["conflict"] += t
            lv, t = fenced(lambda: wave_levels(conf, valid))
            split["levels"] += t
            (state, n), t = fenced(lambda: execute_window(
                model, state, rec, valid, levels=lv))
            split["waves"] += t
            waves += n
        row = {f"{k}_ms": v / n_windows * 1e3 for k, v in split.items()}
        row["waves_per_window"] = waves / n_windows
        log(f"window breakdown {name} W={WINDOW}: " + json.dumps(row))


def device_busy(torch, models, results, n_windows: int = 16):
    """Device time per window of the main path (torch.profiler: the
    durations of the kernels the card ran) against the unprofiled main
    path's wall time per window: the device's busy and idle shares, and
    the kernels that take the most device time. The profiler's host
    overhead stretches the profiled wall clock, so the wall time comes
    from the main path."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ProtocolConfig, run_engine
    from repro_torch.utils import prng

    cfg = ProtocolConfig(window=WINDOW)
    for name, model in models.items():
        state0 = model.init_state(prng.key(SEED + 1))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_engine(model, state0, n_windows * WINDOW, seed=SEED,
                       config=cfg)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if str(e.device_type).endswith("CUDA")]
        if not kernels:
            fail(f"{name}: the profiler saw no device time")
        us, calls = Counter(), Counter()
        for e in kernels:
            us[e.name] += e.device_time
            calls[e.name] += 1
        busy = sum(us.values()) / 1e3 / n_windows
        wall_ms = results[name]["seconds"] / results[name]["n_windows"] * 1e3
        row = {"device_ms_per_window": busy,
               "wall_ms_per_window": wall_ms,
               "busy_share": busy / wall_ms,
               "idle_share": 1.0 - busy / wall_ms,
               "kernels_per_window": len(kernels) / n_windows,
               "top": [[k[:60], t / 1e3 / n_windows, calls[k] / n_windows]
                       for k, t in us.most_common(4)]}
        log(f"device time {name} W={WINDOW}: " + json.dumps(row))


# ----------------------------------------------------------- kernel times
def kernel_rows(torch, models, launches, errs):
    from repro_torch.kernels.conflict.ops import conflict_matrix
    from repro_torch.kernels.levels.ops import wave_levels
    from repro_torch.utils import prng

    rows, info = [], {}
    for name, model in models.items():
        recipes = model.create_tasks(prng.key(SEED), 0, WINDOW)
        reads, writes = model.task_footprint(recipes)
        reads, writes = reads.contiguous(), writes.contiguous()
        valid = torch.ones(WINDOW, dtype=torch.bool, device="cuda")
        conf = conflict_matrix(reads, writes, valid)

        c_ms = device_ms(torch, lambda: conflict_matrix(
            reads, writes, valid, backend="cuda"))
        c_plain = device_ms(torch, lambda: conflict_matrix(
            reads, writes, valid, backend="torch"), reps=5)
        nr, nw = reads.shape[1], writes.shape[1]
        c_bytes = 4 * WINDOW * (nr + nw) + WINDOW + WINDOW * WINDOW
        # compares between used slots over the valid pairs j < i
        ur = (reads >= 0).sum(1).double()
        uw = (writes >= 0).sum(1).double()
        before_w = torch.cumsum(uw, 0) - uw   # sum over j < i
        before_r = torch.cumsum(ur, 0) - ur
        c_ops = float((ur * before_w + uw * before_w + uw * before_r).sum())
        c_bound = max(c_bytes / HBM_BYTES_PER_S,
                      c_ops / CUDA_CORE_OPS_PER_S) * 1e3

        l_ms = device_ms(torch, lambda: wave_levels(conf, valid,
                                                    backend="cuda"))
        l_plain = device_ms(torch, lambda: wave_levels(
            conf, valid, backend="torch"), reps=3)
        l_bytes = WINDOW * (WINDOW - 1) // 2 + WINDOW + 4 * WINDOW
        l_bound = l_bytes / HBM_BYTES_PER_S * 1e3
        info[name] = {
            "nr": nr, "nw": nw,
            "conflict_ms": c_ms, "conflict_plain_ms": c_plain,
            "conflict_bound_ms": c_bound, "conflict_ops": c_ops,
            "conflict_density": float(conf.sum())
            / (WINDOW * (WINDOW - 1) / 2),
            "levels_ms": l_ms, "levels_plain_ms": l_plain,
            "levels_bound_ms": l_bound,
            "waves": int(wave_levels(conf, valid).max()) + 1,
        }
        log(f"kernel times {name} W={WINDOW}: " + json.dumps(info[name]))
        if name == "sis":  # the summary line holds the wider footprint
            rows = [
                {"name": "conflict_matrix", "route": "cuda",
                 "source": "src/repro_torch/csrc/conflict.cu",
                 "replaces": "src/repro/kernels/conflict/conflict.py:150",
                 "launches": launches["conflict"],
                 "max_abs_err": errs["conflict"], "ms": c_ms,
                 "plain_ms": c_plain, "bound_ms": c_bound,
                 "bound_by": ("bytes" if c_bytes / HBM_BYTES_PER_S
                              >= c_ops / CUDA_CORE_OPS_PER_S
                              else "operations"),
                 "library_ms": None},
                {"name": "wave_levels", "route": "cuda",
                 "source": "src/repro_torch/csrc/levels.cu",
                 "replaces": "src/repro/kernels/levels/levels.py:109",
                 "launches": launches["levels"],
                 "max_abs_err": errs["levels"], "ms": l_ms,
                 "plain_ms": l_plain, "bound_ms": l_bound,
                 "bound_by": "bytes", "library_ms": None},
            ]
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tasks", type=int, default=TOTAL_TASKS,
                        help="tasks per model on the main path "
                             f"(default 2^22 = {TOTAL_TASKS})")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.conflict.ops import conflict_matrix
    from repro_torch.kernels.levels.ops import wave_levels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    build_logs = _build.build(["conflict", "levels"])
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(build_logs) or 'cached'})")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    errs = {"conflict": check_conflict_parity(torch, conflict_matrix),
            "levels": check_levels_parity(torch, wave_levels)}
    log(f"parity: {time.perf_counter() - t0:.1f} s")

    results, launches, models = drive_main_path(torch, args.tasks)
    window_breakdown(torch, models)
    device_busy(torch, models, results)
    rows = kernel_rows(torch, models, launches, errs)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
