"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the port; run.py refuses to run where it cannot measure."""

import ast
import shutil
import subprocess
import sys

import pytest
from harness import runner, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "granne_tpu"}
SOURCES = sorted(p for p in spec.BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def imported_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(spec.BENCH_DIR).as_posix())
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in imported_names(path)}
    assert not tops & FORBIDDEN, f"{path.name} imports {tops & FORBIDDEN}"


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "data.py", "checks.py"):
        tops = {n.split(".")[0] for n in imported_names(spec.BENCH_DIR / "harness" / name)}
        assert tops <= {"__future__", "contextlib", "dataclasses", "torch", "numpy"}, (name, tops)


def loaded_after(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = [{str(spec.BENCH_DIR)!r}, {str(spec.ROOT)!r}]\n{code}\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True, timeout=300, check=True)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_by_whole_top_level_name():
    code = ("import json, run\nfrom harness import runner, spec\n"
            "bench = json.loads((spec.ROOT / 'BENCHMARK.json').read_text())\n"
            "for s in (spec.load_spec(w['name']) for w in bench['workloads']):\n"
            "    spec.load_module('traffic', s.cell['traffic']['kind']); spec.load_module('systems', s.config['system'])\n"
            "    [spec.load_metric(m['name']) for m in s.per_layer]\n"
            "spec.load_module('systems', 'hnsw')")
    tops = loaded_after(code)
    assert "granne_tpu_torch" in tops  # the port is loaded, and its name only begins with the JAX package's
    assert not tops & FORBIDDEN


def test_the_reference_alone_loads_no_port():
    tops = loaded_after("from harness import reference, checks, data")
    assert "granne_tpu_torch" not in tops and not tops & FORBIDDEN


def test_runtime_check_compares_whole_names(monkeypatch):
    for name in ("granne_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert runner.jax_modules() == []
    monkeypatch.setitem(sys.modules, "granne_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert runner.jax_modules() == ["granne_tpu.ops", "jax"]


ARGS = ["--workload", "glove100-ivf.batch10k", "--seed", "1", "--seconds", "1", "--trace", "0"]


def test_run_refuses_without_a_card_or_without_the_port(tmp_path):
    here = subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=spec.ROOT, capture_output=True,
                          text=True, timeout=300)
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bare = subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    for proc in (here, bare):
        assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "granne_tpu_torch" in bare.stderr
