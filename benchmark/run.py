"""Run one cell of the benchmark of granne_tpu_torch once, on this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``granne_tpu_torch/``.  Prints one
JSON object as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each compared number beside its limit (also the last lines
of standard error).  Exits non-zero, printing no result, without enough CUDA
cards, without the port beside this folder, or where JAX or the JAX package
is loaded once the window has closed.  The port builds its CUDA kernels at
first use into ``build/granne_tpu_torch/`` inside the checkout.
"""

import time

T0 = time.perf_counter()  # set-up runs from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    if not (ROOT / "granne_tpu_torch" / "__init__.py").is_file():
        fail(f"no granne_tpu_torch/ beside {BENCH_DIR.name}/: nothing to measure")
    import torch

    from harness import runner, spec

    s = spec.load_spec(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < s.chips:
        fail(f"{args.workload} needs {s.chips} CUDA card(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    import granne_tpu_torch

    if Path(granne_tpu_torch.__file__).resolve().parents[1] != ROOT:
        fail(f"granne_tpu_torch was imported from {granne_tpu_torch.__file__}, not from this checkout")
    result = runner.run_cell(s, args.seed, args.seconds, bool(args.trace), t0=T0)
    loaded = runner.jax_modules()
    if loaded:
        fail(f"JAX or the JAX package is loaded in this process: {loaded}", 3)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
