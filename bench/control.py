"""The control of the check: the plain reference put in the program's
place, computed in bfloat16 (the precision below the models' float32),
must fail the check the runs pass.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 \
        --calls <n> [--device cuda]

For each seed, the cell's initial state and ``n`` calls' seeds are made
as a run makes them; the bfloat16 reference's final state is compared
with the float32 reference's, and the number of state elements that
differ (the check's ``state_mismatch``, limit 0) is printed, one JSON
line a seed. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_reading(cell, seed: int, calls: int, device) -> dict:
    import torch

    from bench import harness

    cfg, tr, fam = cell.config, cell.traffic, cell.family
    seeds = [harness.call_seed(seed, i) for i in range(calls)]
    t0 = time.perf_counter()
    want, ran = fam.reference_run(
        cfg, tr, fam.initial_state(cfg, tr, seed, device), seeds)
    t1 = time.perf_counter()
    got, _ = fam.reference_run(
        cfg, tr, fam.initial_state(cfg, tr, seed, device), seeds,
        dtype=torch.bfloat16)
    return {"seed": seed, "calls": calls, "tasks": ran,
            "state_mismatch": harness.state_mismatch(got, want),
            "reference_s": t1 - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench import harness

    cell = harness.Cell(args.workload)
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload,
                          **control_reading(cell, seed, args.calls, dev)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
