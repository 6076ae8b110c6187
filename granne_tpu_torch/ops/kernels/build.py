"""Build and load the native libraries of ``granne_tpu_torch``.

Each CUDA kernel ``csrc/<name>.cu`` has a plain C interface.  At first use
it is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/granne_tpu_torch/lib<name>.so`` beside the package (a directory
that git ignores) and loaded with ctypes; the shared adjacency codec
(``native/``) goes the same way with g++.  A library is rebuilt when its
source is newer.  A failed build raises with the compiler's output: no
caller falls back to another path.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "granne_tpu_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_loaded: dict[Path, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """The nvcc binary: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "of granne_tpu_torch are built from csrc/ at first use"
    )


def compile_library(cmd: list[str], src: Path, out: Path) -> None:
    """Run ``cmd -o <tmp> src`` and move the library to ``out`` atomically."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    full = [*cmd, "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(full, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {cmd[0]} to build {src.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cmd[0]} failed to build {src.name} (exit {proc.returncode}):\n"
            f"{' '.join(full)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)


def load_library(src: Path, out: Path, compile_cmd, signatures: dict) -> ctypes.CDLL:
    """Load ``out``, first building it from ``src`` if it is missing or older.

    ``compile_cmd()`` gives the compiler command (asked only when building);
    ``signatures`` maps each C function to ``(restype, argtypes)``, set once
    when the library is first loaded in this process.
    """
    with _lock:
        lib = _loaded.get(out)
        if lib is not None:
            return lib
        if not out.exists() or out.stat().st_mtime < src.stat().st_mtime:
            compile_library(compile_cmd(), src, out)
        lib = ctypes.CDLL(str(out))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[out] = lib
        return lib


def load_cuda_library(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) with nvcc and load ``csrc/<name>.cu``."""
    return load_library(
        CSRC_DIR / f"{name}.cu", BUILD_DIR / f"lib{name}.so", lambda: [find_nvcc(), *NVCC_FLAGS], signatures
    )
