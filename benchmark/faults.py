"""The planted faults' readings at a cell's own size, on the card.

    python3 benchmark/faults.py --workload <name> --seeds 11 12 13 [--seconds 3]

runs the cell as ``run.py`` does, once a seed and fault, with the port's
``search_batch`` broken as ``tests/test_harness_faults.py`` breaks it (the
first call's answers returned unchanged, half a call's queries answered
for the whole, one id altered), and prints one JSON line each: the
compared numbers and ``correct``, which has to read false.  The benchmark's
own runs never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT), str(BENCH_DIR / "tests")]
    import torch
    from _pytest.monkeypatch import MonkeyPatch
    from harness import runner, spec

    import test_harness_faults

    if not torch.cuda.is_available():
        print("faults: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for fault in ("stale", "half", "altered"):
            mp = MonkeyPatch()
            test_harness_faults.serving_fault(mp, args.workload, fault)
            try:
                r = runner.run_cell(spec.load_spec(args.workload), seed, args.seconds, False, t0=time.perf_counter())
            finally:
                mp.undo()
            print(json.dumps({"workload": args.workload, "seed": seed, "fault": fault, "correct": r["correct"],
                              "checks": {k: v["value"] for k, v in r["checks"].items()}}), flush=True)
            del r
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
