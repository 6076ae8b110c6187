"""Repository-wide pytest hook: free JAX's compiled executables between test modules.

XLA:CPU keeps the JIT code of every compiled executable mapped for as long
as JAX's caches hold it, at three memory mappings each.  A test process that
runs many JAX test modules in a row (as an xdist worker under ``--dist load``
does) reaches the kernel's limit on mappings per process (``vm.max_map_count``,
65530 by default), and the next compilation crashes the process with a
segmentation fault or an abort.  Clearing JAX's caches when the run leaves a
module bounds the count by what one module compiles.  JAX is not imported
here: a process that never imported it is left alone.
"""

import sys

import pytest


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item, nextitem):
    yield
    if nextitem is not None and getattr(nextitem, "module", None) is getattr(item, "module", None):
        return
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
