"""The readings that a cell's limits are set from, many seeds in one process.

    python3 benchmark/limits.py --workload <name> --seeds 11 12 13 --seconds 3
        [--control] [--sweep serve.nprobe=8,16,32,64]

runs the cell as ``run.py`` does, once a seed, at the cell's own sizes and
load with a short window, and prints one JSON line a seed: the compared
numbers (``checks``), ``correct`` under the cell's current limits, and the
end-to-end metrics.  ``--control`` runs each of the cell's ``controls`` in
the program's place instead (the port's own lower-precision path, or the
reference at a lower precision).  ``--sweep`` runs every seed at each of a
list of values of one key of the cell file (how the IVF cell's nprobe was
chosen); nothing is written.  The benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def set_value(cell: dict, assignment: str) -> None:
    key, value = assignment.split("=", 1)
    *path, last = key.split(".")
    node = cell
    for part in path:
        node = node[part]
    node[last] = json.loads(value)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--sweep", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    import torch

    from harness import runner, spec

    if not torch.cuda.is_available():
        print("limits: no CUDA card", file=sys.stderr)
        return 2
    sweep = [None]
    if args.sweep:
        key, values = args.sweep.split("=", 1)
        sweep = [f"{key}={v}" for v in values.split(",")]
    t0 = T0
    controls = spec.load_spec(args.workload, ROOT).cell["controls"] if args.control else [None]
    for seed, point, control in ((s, p, c) for p in sweep for s in args.seeds for c in controls):
        s = spec.load_spec(args.workload, ROOT)
        if point:
            set_value(s.cell, point)
        r = runner.run_cell(s, seed, args.seconds, False, t0=t0, control=control)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": control, "sweep": point,
                          "correct": r["correct"], "checks": r["checks"],
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "memory_peak_bytes": r["device"]["memory_peak_bytes"], "kind": r["device"]["kind"],
                          "power_limit": r["device"]["power_limit"]}), flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
