"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as one JSON object, the last line of standard output,
and the numbers its check compared, each beside its limit, as the last
lines of standard error. Needs the cards the cell asks for; exits with
another code than 0, printing no result, without them, or if a module
of JAX or of the JAX package is loaded once the run is done.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the port's kernel libraries are built into the checkout, at a
    # fixed path, so that only a checkout's first run builds them
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench import harness

    cell = harness.Cell(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()})", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), t_start=T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print("error: modules of JAX or of the JAX package are loaded: "
              + ", ".join(loaded), file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
