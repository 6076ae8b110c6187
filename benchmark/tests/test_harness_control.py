"""Each cell's control, put in the program's place, comes out not correct.

A cell's ``controls`` are the precisions below the bf16 it serves: the
port's own int8 path, and the reference computed in fp8 in the program's
place.  The cells' limits were set from readings of the program and of the
controls at the cells' own sizes on the card (``limits.py``; PERF.md gives
them); here they run at sizes a test run holds, on the CPU (the port's
plain kernels) and on the card.
"""

import time

import pytest
import torch
from harness import runner
from test_harness_faults import SERVING, cell_spec, tiny


def run(s, device, control=None):
    return runner.run_cell(s, 2**31 + 99, 0.3, False, t0=time.perf_counter(), device=device, control=control)


def cases(workloads):
    return [(w, i) for w in workloads for i in range(len(cell_spec(w).cell["controls"]))]


@pytest.mark.parametrize("workload,i", cases(SERVING))
def test_control_fails_on_the_cpu(workload, i):
    s = tiny(workload)
    sound, control = run(s, "cpu"), run(s, "cpu", s.cell["controls"][i])
    assert sound["correct"], sound["checks"]
    assert not control["correct"], control["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload,i", cases(SERVING))
def test_control_fails_on_the_card(card, workload, i):
    s = tiny(workload)
    s.config["data"]["n"] = 100_000
    s.cell["traffic"].update(queries_per_call=2_000)
    sound, control = run(s, card), run(s, card, s.cell["controls"][i])
    assert sound["correct"], sound["checks"]
    assert not control["correct"], control["checks"]
