"""The harness's CPU tests: ``harness`` and the port are imported from this
checkout, and each test process keeps to two threads, so parallel workers
do not oversubscribe the cores."""

import sys
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]
torch.set_num_threads(2)
