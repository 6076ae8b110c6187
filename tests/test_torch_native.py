"""The port's own adjacency codec, and the rule that the port reaches into
no file of the JAX package and imports no jax, in its modules and in the
ranks that its launcher spawns.

No jax import: the codec is plain C++ built with g++ at first use.  That a
compressed index written by the port equals the JAX package's byte for
byte is checked in tests/test_torch_api.py.
"""

import ast
import re
from pathlib import Path

import numpy as np

import granne_tpu_torch
from granne_tpu_torch import run_ranks
from granne_tpu_torch.native import codec, codec_source

REPO = Path(__file__).resolve().parents[1]
PORT = Path(granne_tpu_torch.__file__).resolve().parent


def _code_lines(path: Path) -> list[str]:
    """The C++ source without comments or blank lines."""
    text = re.sub(r"//[^\n]*", "", path.read_text())
    return [line.rstrip() for line in text.splitlines() if line.strip()]


def test_codec_source_lies_in_the_port():
    src = codec_source().resolve()
    assert src.is_file()
    assert src.is_relative_to(PORT)


def test_codec_copy_has_the_jax_packages_code():
    """The two copies define one format: only their comments may differ."""
    assert _code_lines(codec_source()) == _code_lines(REPO / "granne_tpu" / "native" / "codec.cpp")


def test_codec_round_trips_a_ragged_adjacency():
    rng = np.random.default_rng(0)
    rows, width = 300, 24
    adj = rng.integers(0, 1 << 31, (rows, width), dtype=np.int64).astype(np.int32)
    adj[:100] = rng.integers(0, 5000, (100, width))  # small gaps: StreamVByte rows
    fill = rng.integers(0, width + 1, rows)  # 0..width valid slots a row, -1 behind them
    fill[:3] = [0, 1, width]
    for r, k in enumerate(fill):
        adj[r, k:] = -1
        rng.shuffle(adj[r])  # -1 anywhere in the row
    got = codec.decode_adjacency(codec.encode_adjacency(adj), rows, width)
    for r in range(rows):
        ids = np.sort(adj[r][adj[r] >= 0])
        assert np.array_equal(got[r, : len(ids)], ids)
        assert (got[r, len(ids):] == -1).all()


FORBIDDEN = ("granne_tpu", "jax", "jaxlib")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith((f + ".", f + "/")) for f in FORBIDDEN)


def _reaches_jax_package(node: ast.AST) -> bool:
    """An import of the JAX package or of jax, by statement or by call."""
    if isinstance(node, ast.Import):
        return any(_forbidden(a.name) for a in node.names)
    if isinstance(node, ast.ImportFrom):
        return node.level == 0 and _forbidden(node.module or "")
    if isinstance(node, ast.Call):  # find_spec("granne_tpu"), import_module("jax..."), __import__
        args = [a.value for a in node.args if isinstance(a, ast.Constant) and isinstance(a.value, str)]
        return any(_forbidden(a) for a in args)
    return False


def test_no_port_module_reaches_into_the_jax_package():
    paths = sorted(PORT.rglob("*.py"))
    scanned = {str(p.relative_to(PORT)) for p in paths}
    assert {f"parallel/{m}.py" for m in ("mesh", "sharded", "sharded_ivf", "tiering", "dryrun", "dp_build")} <= scanned
    assert {"utils/__init__.py", "utils/trace.py", "utils/progress.py"} <= scanned
    found = [
        f"{path.relative_to(PORT)}:{node.lineno}"
        for path in paths
        for node in ast.walk(ast.parse(path.read_text()))
        if _reaches_jax_package(node)
    ]
    assert found == []
    assert not any("find_spec" in p.read_text() for p in paths)


def test_the_scan_finds_jax_imports():
    for code in ("import jax", "import jax.numpy as jnp", "from jax import lax", "import granne_tpu.api",
                 "from granne_tpu import api", "importlib.import_module('jax')"):
        assert any(_reaches_jax_package(n) for n in ast.walk(ast.parse(code))), code
    for code in ("import granne_tpu_torch", "from . import jax_like", "import jaxtyping"):
        assert not any(_reaches_jax_package(n) for n in ast.walk(ast.parse(code))), code


def test_a_spawned_rank_loads_neither_jax_nor_the_jax_package():
    """``run_ranks`` starts each rank from a fresh interpreter: the rank
    imports the port and its job's module, and nothing of jax."""
    import torch_rank_jobs as jobs

    assert run_ranks(jobs.modules_job, 2, backend="gloo", device="cpu", timeout=120) == [[], []]
