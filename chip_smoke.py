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
     diagonal; the cross-window block at (Wi, Wj) in {(1, 1), (37, 129),
     (128, 128), (4096, 4096), (1000, 37)} with each side's (nr, nw) in
     {(1, 1), (21, 2)}, both rules, invalid tails on both sides;
  4. drives the barrier path — ``run_engine(engine="wavefront")`` on voter
     and SIS over ``watts_strogatz(n=1_000_000, k=10, beta=0.1)`` built
     on the card, W = 4096, 2^22 tasks each (``--tasks`` cuts the task
     count of both paths, never n or W) — with the kernel launch
     counters set to 0 just before each model's run and read just
     after; each kernel must have launched once per window. Then, on
     the first 8 windows, the final state must equal the port's
     sequential oracle bit for bit, and state and stats must equal a
     CPU run of the port;
  5. splits 16 windows of each model into creation, record check,
     levels and waves (host clock, each step fenced by a synchronize),
     and profiles 16 more (torch.profiler) for the device's busy share;
  6. drives the overlap path — ``run_engine(engine="wavefront_overlap")``
     at W = 4096 and 2^22 tasks on four models built on the
     card: voter and SIS on the graph above, Axelrod (n = 10^6, F = 3,
     q = 3, omega = 0.95, complete mixing) and SIRS (n = 10^6 on the ring
     of degree 14, subsets of 50). The counters are set to 0 before each
     run and read after: conflict and levels once per window, the block
     kernel once per boundary. On the first 8 windows the result must
     equal the oracle, the barrier run and a CPU run of the port (state
     and stats), and the overlap stats must keep the monotone envelope
     (no more waves than the barrier run). Then the same split and
     profile as phase 5 for the overlap path;
  7. counts the host syncs per window of each path over 16 windows
     (``torch.cuda.set_sync_debug_mode("warn")``); more than 2 per window
     on the overlap path fails;
  8. times each kernel at W = 4096 on real windows (CUDA events, median
     of 25) beside its plain version and its bound; the summary line
     holds SIS's, the widest footprint of the graph models.

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
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_NODES = 1_000_000
DEGREE = 10
REWIRE = 0.1
WINDOW = 4096
TOTAL_TASKS = 1 << 22
CHECK_WINDOWS = 8
SEED = 0
DEVICE = "cuda"

PARITY_WINDOWS = (1, 37, 128, 129, 1000, 4096)
BLOCK_SHAPES = ((1, 1), (37, 129), (128, 128), (4096, 4096), (1000, 37))
SLOTS = ((1, 1), (21, 2))
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


def check_block_parity(torch, conflict_block) -> int:
    gen = torch.Generator().manual_seed(3)
    worst, cases = 0, 0
    for wi, wj in BLOCK_SHAPES:
        for nr_i, nw_i in SLOTS:
            for nr_j, nw_j in SLOTS:
                for strict in (True, False):
                    # ids drawn over one range, so the two sides collide
                    ri, wri, vi = random_footprint(torch, gen, wi, nr_i,
                                                   nw_i, "cuda")
                    rj, wrj, vj = random_footprint(torch, gen, wj, nr_j,
                                                   nw_j, "cuda")
                    args = (ri, wri, rj, wrj, vi, vj)
                    got = conflict_block(*args, strict=strict,
                                         backend="cuda")
                    want = conflict_block(*args, strict=strict,
                                          backend="torch")
                    torch.cuda.synchronize()
                    err = int((got.int() - want.int()).abs().max())
                    worst = max(worst, err)
                    cases += 1
                    if err:
                        fail(f"conflict_block kernel != plain version at "
                             f"Wi={wi} Wj={wj} (nr, nw)_i=({nr_i}, {nw_i}) "
                             f"(nr, nw)_j=({nr_j}, {nw_j}) strict={strict}")
    log(f"parity conflict_block: {cases} cases bit-exact")
    return worst


# ------------------------------------------------------------ main path
#: inclusive value range of every state leaf, per model
STATE_RANGE = {"voter": (0, 1), "sis": (0, 1), "axelrod": (0, 2),
               "sirs": (0, 2)}


def check_state(model_name, state, shapes):
    lo_ok, hi_ok = STATE_RANGE[model_name]
    for key, x in state.items():
        if tuple(x.shape) != shapes[key]:
            fail(f"{model_name}: final {key} has shape {tuple(x.shape)}, "
                 f"expected {shapes[key]}")
        lo, hi = int(x.min()), int(x.max())
        if lo < lo_ok or hi > hi_ok:
            fail(f"{model_name}: final {key} holds values outside "
                 f"[{lo_ok}, {hi_ok}]: [{lo}, {hi}]")


def states_equal(a: dict, b: dict) -> bool:
    return all(bool((a[k].cpu() == b[k].cpu()).all()) for k in a)


def drive_main_path(torch, total_tasks):
    """Voter and SIS through run_engine(engine="wavefront") at full size;
    returns (per-model results, summed launches, the models, the
    topology)."""
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
        check_state(name, out, {k: (N_NODES,) for k in out})

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
    return results, launches, models, topo


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
        valid = torch.ones(WINDOW, dtype=torch.bool, device=DEVICE)
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


def device_busy(torch, models, results, engine="wavefront",
                n_windows: int = 16):
    """Device time per window of a path (torch.profiler: the
    durations of the kernels the card ran) against the unprofiled main
    path's wall time per window: the device's busy and idle shares, and
    the kernels that take the most device time. The profiler's host
    overhead stretches the profiled wall clock, so the wall time comes
    from the path's unprofiled run."""
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
                       config=cfg, engine=engine)
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
        log(f"device time {engine} {name} W={WINDOW}: " + json.dumps(row))


# --------------------------------------------------------- overlap path
def build_overlap_models(torch, topo):
    """The overlap path's four models on the card, with a function that
    rebuilds each on the CPU (for the CPU run of the port)."""
    from repro_torch.mabs import (
        AxelrodConfig,
        AxelrodModel,
        SIRConfig,
        SIRModel,
        SISModel,
        VoterModel,
    )

    ax_cfg = AxelrodConfig(n_agents=N_NODES, n_features=3, q=3, omega=0.95)
    sir_cfg = SIRConfig(n_agents=N_NODES, k=14, subset_size=50)
    t0 = time.perf_counter()
    models = {"voter": VoterModel(topo), "sis": SISModel(topo),
              "axelrod": AxelrodModel(ax_cfg),
              "sirs": SIRModel(sir_cfg)}
    torch.cuda.synchronize()
    log(f"overlap models built: {time.perf_counter() - t0:.2f} s (SIRS "
        f"block graph: {models['sirs'].block_topo.n_nodes} blocks, "
        f"max degree {models['sirs'].block_topo.max_degree})")
    cpu = {"voter": lambda m: VoterModel(m.topology.to("cpu")),
           "sis": lambda m: SISModel(m.topology.to("cpu")),
           "axelrod": lambda m: AxelrodModel(m.cfg, device="cpu"),
           "sirs": lambda m: SIRModel(m.cfg,
                                      topology=m.topology.to("cpu"))}
    return models, cpu


def check_overlap_envelope(name, stats, barrier):
    """The reference's monotone envelope of the overlap stats
    (tests/conftest.py::assert_overlap_stats_monotone)."""
    ok = (stats["overlap"] is True
          and stats["n_boundaries"] == max(stats["n_windows"] - 1, 0)
          and 0 <= stats["mean_overlap_depth"] <= WINDOW
          and 0 <= stats["max_overlap_depth"] <= WINDOW
          and (stats["mean_overlap_depth"] <= stats["max_overlap_depth"]
               or stats["n_boundaries"] == 0)
          and 0 <= stats["overlap_tasks_early"] <= stats["total_tasks"]
          and (0 <= stats["carry_frontier_mean"]
               <= stats["carry_frontier_max"]
               or stats["n_boundaries"] == 0)
          and stats["carry_frontier_max"] <= WINDOW
          and (stats["max_overlap_depth"] > 0
               or stats["overlap_tasks_early"] == 0)
          and stats["total_waves"] <= barrier["total_waves"]
          and stats["total_tasks"] == barrier["total_tasks"])
    if not ok:
        fail(f"{name}: overlap stats outside the monotone envelope: "
             f"{stats} vs barrier {barrier}")


def drive_overlap_path(torch, total_tasks, models, cpu_twin, barrier):
    """The four models through run_engine(engine="wavefront_overlap") at
    full size; returns (per-model results, summed launches)."""
    from repro_torch.core import ProtocolConfig, run_engine, run_oracle
    from repro_torch.kernels.conflict import conflict as conflict_kernel
    from repro_torch.kernels.levels import levels as levels_kernel
    from repro_torch.utils import prng

    cfg = ProtocolConfig(window=WINDOW)
    results = {}
    launches = {"conflict": 0, "levels": 0, "conflict_block": 0}
    for name, model in models.items():
        state0 = model.init_state(prng.key(SEED + 1))
        torch.cuda.synchronize()

        conflict_kernel.launches = 0
        conflict_kernel.block_launches = 0
        levels_kernel.launches = 0
        t0 = time.perf_counter()
        out, stats = run_engine(model, state0, total_tasks, seed=SEED,
                                config=cfg, engine="wavefront_overlap")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = {"conflict": conflict_kernel.launches,
             "levels": levels_kernel.launches,
             "conflict_block": conflict_kernel.block_launches}
        for k, v in n.items():
            launches[k] += v
        nw = stats["n_windows"]
        if n != {"conflict": nw, "levels": nw,
                 "conflict_block": max(nw - 1, 0)}:
            fail(f"{name}: overlap launches {n}, expected conflict = levels"
                 f" = n_windows = {nw} and conflict_block = {nw - 1}")
        check_state(name, out, {k: tuple(v.shape)
                                for k, v in state0.items()})
        if name in barrier:  # the barrier path ran the same chain
            check_overlap_envelope(name, stats, barrier[name])

        # the first CHECK_WINDOWS windows: oracle, barrier run, CPU run
        prefix = min(CHECK_WINDOWS * WINDOW, total_tasks)
        t1 = time.perf_counter()
        ov, ov_stats = run_engine(model, state0, prefix, seed=SEED,
                                  config=cfg, engine="wavefront_overlap")
        wf, wf_stats = run_engine(model, state0, prefix, seed=SEED,
                                  config=cfg, engine="wavefront")
        if not states_equal(ov, wf):
            fail(f"{name}: wavefront_overlap != wavefront on the first "
                 f"{prefix} tasks")
        check_overlap_envelope(name, ov_stats, wf_stats)
        oracle = run_oracle(model, state0, prefix, seed=SEED, config=cfg)
        if not states_equal(ov, oracle):
            fail(f"{name}: wavefront_overlap != sequential oracle on the "
                 f"first {prefix} tasks")
        cpu_out, cpu_stats = run_engine(
            cpu_twin[name](model), {k: v.cpu() for k, v in state0.items()},
            prefix, seed=SEED, config=cfg, engine="wavefront_overlap",
            device="cpu")
        if cpu_stats != ov_stats or not states_equal(cpu_out, ov):
            fail(f"{name}: GPU overlap run != CPU run of the port on the "
                 f"first {prefix} tasks: {ov_stats} vs {cpu_stats}")
        check_s = time.perf_counter() - t1
        results[name] = {
            "window": WINDOW, "total_tasks": total_tasks,
            "n_windows": nw, "total_waves": stats["total_waves"],
            "mean_parallelism": stats["mean_parallelism"],
            "seconds": secs, "tasks_per_s": total_tasks / secs,
            "barrier_total_waves": barrier.get(name, {}).get("total_waves"),
            "checked_tasks": prefix,
            "checked_barrier_waves": wf_stats["total_waves"],
            "checked_overlap_waves": ov_stats["total_waves"],
            "check_seconds": check_s,
            **{k: stats[k] for k in (
                "n_boundaries", "mean_overlap_depth", "max_overlap_depth",
                "overlap_tasks_early", "carry_frontier_mean",
                "carry_frontier_max")},
        }
        log(f"main path overlap {name}: " + json.dumps(results[name]))
    return results, launches


def overlap_breakdown(torch, models, n_windows: int = 16):
    """Host-clock split of the overlap path's windows, each step fenced
    by a synchronize: the next window's schedule (creation + record
    check), the boundary step (block kernel, carry frontier, floored
    levels) and the fused drain."""
    from repro_torch.core.records import wave_levels
    from repro_torch.engine import make_engine
    from repro_torch.utils import prng

    def fenced(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for name, model in models.items():
        eng = make_engine("wavefront_overlap", model, window=WINDOW)
        base_key = prng.key(SEED)
        state = model.init_state(prng.key(SEED + 1))
        cur = eng._schedule_ov(base_key, 0, WINDOW)
        lv = wave_levels(cur[2], cur[1])
        split = {"schedule": 0.0, "boundary": 0.0, "drain": 0.0}
        waves = 0
        for k in range(1, n_windows + 1):
            nxt, t = fenced(lambda: eng._schedule_ov(base_key, k * WINDOW,
                                                     WINDOW))
            split["schedule"] += t
            (lv_nxt, _), t = fenced(lambda: eng._boundary(
                cur[0], lv, nxt[0], nxt[1], nxt[2]))
            split["boundary"] += t
            (state, n, lv_nxt), t = fenced(lambda: eng._execute_pair(
                state, cur, lv, nxt, lv_nxt))
            split["drain"] += t
            waves += n
            cur, lv = nxt, lv_nxt
        row = {f"{k}_ms": v / n_windows * 1e3 for k, v in split.items()}
        row["fused_waves_per_window"] = waves / n_windows
        log(f"window breakdown overlap {name} W={WINDOW}: "
            + json.dumps(row))


def count_syncs(torch, models, engine, n_windows: int = 16) -> dict:
    """Host syncs per window of one path over n_windows windows, as
    torch.cuda's sync debug mode reports them. The known one per window
    (the wave count) must show, or the count is not to be trusted."""
    from repro_torch.core import ProtocolConfig, run_engine
    from repro_torch.utils import prng

    cfg = ProtocolConfig(window=WINDOW)
    per_window = {}
    for name, model in models.items():
        state0 = model.init_state(prng.key(SEED + 1))
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_engine(model, state0, n_windows * WINDOW, seed=SEED,
                           config=cfg, engine=engine)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        if syncs < n_windows:
            fail(f"{engine} {name}: sync debug mode saw {syncs} syncs in "
                 f"{n_windows} windows, fewer than the wave counts read")
        per_window[name] = syncs / n_windows
    log(f"host syncs per window {engine} ({n_windows} windows): "
        + json.dumps(per_window))
    return per_window


# ----------------------------------------------------------- kernel times
def kernel_row(name, source, replaces, launches, err, ms, plain_ms, nbytes,
               ops):
    """One entry of the kernels line: bound = max(bytes / HBM rate,
    ops / CUDA-core rate), in ms."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def kernel_rows(torch, models, overlap_models, launches, errs):
    from repro_torch.kernels.conflict.ops import (
        conflict_block,
        conflict_matrix,
    )
    from repro_torch.kernels.levels.ops import wave_levels
    from repro_torch.utils import prng

    rows = {}
    for name, model in models.items():
        recipes = model.create_tasks(prng.key(SEED), 0, WINDOW)
        reads, writes = model.task_footprint(recipes)
        reads, writes = reads.contiguous(), writes.contiguous()
        valid = torch.ones(WINDOW, dtype=torch.bool, device=DEVICE)
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

        l_ms = device_ms(torch, lambda: wave_levels(conf, valid,
                                                    backend="cuda"))
        l_plain = device_ms(torch, lambda: wave_levels(
            conf, valid, backend="torch"), reps=3)
        l_bytes = WINDOW * (WINDOW - 1) // 2 + WINDOW + 4 * WINDOW
        info = {
            "nr": nr, "nw": nw,
            "conflict_ms": c_ms, "conflict_plain_ms": c_plain,
            "conflict_bytes": c_bytes, "conflict_ops": c_ops,
            "conflict_density": float(conf.sum())
            / (WINDOW * (WINDOW - 1) / 2),
            "levels_ms": l_ms, "levels_plain_ms": l_plain,
            "levels_bytes": l_bytes,
            "waves": int(wave_levels(conf, valid).max()) + 1,
        }
        log(f"kernel times {name} W={WINDOW}: " + json.dumps(info))
        if name == "sis":  # the summary line holds the wider footprint
            rows["conflict"] = kernel_row(
                "conflict_matrix", "src/repro_torch/csrc/conflict.cu",
                "src/repro/kernels/conflict/conflict.py:150",
                launches["conflict"], errs["conflict"], c_ms, c_plain,
                c_bytes, c_ops)
            rows["levels"] = kernel_row(
                "wave_levels", "src/repro_torch/csrc/levels.cu",
                "src/repro/kernels/levels/levels.py:109",
                launches["levels"], errs["levels"], l_ms, l_plain, l_bytes,
                0.0)

    # the cross-window block on a real boundary: window 1's tasks against
    # window 0's, all alive (window 0 has not drained yet)
    for name, model in overlap_models.items():
        key = prng.key(SEED)
        rec_a = model.create_tasks(key, 0, WINDOW)
        rec_b = model.create_tasks(key, WINDOW, WINDOW)
        reads_j, writes_j = (x.contiguous()
                             for x in model.task_footprint(rec_a))
        reads_i, writes_i = (x.contiguous()
                             for x in model.task_footprint(rec_b))
        valid = torch.ones(WINDOW, dtype=torch.bool, device=DEVICE)
        lv_a = wave_levels(conflict_matrix(reads_j, writes_j, valid), valid)
        alive = lv_a >= 0
        args = (reads_i, writes_i, reads_j, writes_j, valid, alive)
        cross = conflict_block(*args)
        b_ms = device_ms(torch, lambda: conflict_block(*args,
                                                       backend="cuda"))
        b_plain = device_ms(torch, lambda: conflict_block(
            *args, backend="torch"), reps=5)
        nr_i, nw_i = reads_i.shape[1], writes_i.shape[1]
        nr_j, nw_j = reads_j.shape[1], writes_j.shape[1]
        b_bytes = (WINDOW * WINDOW + 4 * (WINDOW * (nr_i + nw_i)
                                          + WINDOW * (nr_j + nw_j))
                   + 2 * WINDOW)
        # compares between used slots over the valid (i, alive j) pairs
        ur_i = float((reads_i >= 0)[valid].sum())
        uw_i = float((writes_i >= 0)[valid].sum())
        ur_j = float((reads_j >= 0)[alive].sum())
        uw_j = float((writes_j >= 0)[alive].sum())
        b_ops = ur_i * uw_j + uw_i * uw_j + uw_i * ur_j
        info = {"nr_i": nr_i, "nw_i": nw_i, "nr_j": nr_j, "nw_j": nw_j,
                "block_ms": b_ms, "block_plain_ms": b_plain,
                "block_bytes": b_bytes, "block_ops": b_ops,
                "block_density": float(cross.sum()) / (WINDOW * WINDOW)}
        log(f"kernel times block {name} W={WINDOW}: " + json.dumps(info))
        if name == "sis":
            rows["conflict_block"] = kernel_row(
                "conflict_block", "src/repro_torch/csrc/conflict.cu",
                "src/repro/kernels/conflict/conflict.py:219",
                launches["conflict_block"], errs["conflict_block"], b_ms,
                b_plain, b_bytes, b_ops)
    return [rows["conflict"], rows["levels"], rows["conflict_block"]]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tasks", type=int, default=TOTAL_TASKS,
                        help="tasks per model on both paths "
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
    from repro_torch.kernels.conflict.ops import (
        conflict_block,
        conflict_matrix,
    )
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
            "levels": check_levels_parity(torch, wave_levels),
            "conflict_block": check_block_parity(torch, conflict_block)}
    log(f"parity: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    results, launches, models, topo = drive_main_path(torch, args.tasks)
    window_breakdown(torch, models)
    device_busy(torch, models, results)
    log(f"barrier path: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ov_models, cpu_twin = build_overlap_models(torch, topo)
    ov_results, ov_launches = drive_overlap_path(
        torch, args.tasks, ov_models, cpu_twin, results)
    overlap_breakdown(torch, ov_models)
    device_busy(torch, ov_models, ov_results, engine="wavefront_overlap")
    log(f"overlap path: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    count_syncs(torch, models, "wavefront")
    syncs = count_syncs(torch, ov_models, "wavefront_overlap")
    worst = max(syncs.values())
    if worst > 2:
        fail(f"the overlap path syncs the host {worst} times per window")
    log(f"sync count: {time.perf_counter() - t0:.1f} s")

    log("launches barrier path: " + json.dumps(launches)
        + "; overlap path: " + json.dumps(ov_launches))
    total = {k: launches.get(k, 0) + v for k, v in ov_launches.items()}
    rows = kernel_rows(torch, models, ov_models, total, errs)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
