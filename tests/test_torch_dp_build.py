"""granne_tpu_torch's data-parallel HNSW build (``build_layers(...,
group=...)``, ``parallel/dp_build.py``) over 4 gloo ranks on the CPU against
granne_tpu's ``build_layers(..., mesh=make_mesh(4))``.

``tests/test_dp_build.py``'s data and config (n 700, d 16, M 10, ef 25,
wave 64).  JAX builds its mesh graphs uncached and with the levers of
``test_dp_build_honors_levers`` (flat neighbor cache, ``build_max_iters``
10, ``gather_budget`` 24), and its one-device graph at ``reverse_cap`` 4,
``merge_chunk`` 256; one spawn of 4 ranks (``torch_rank_jobs.dp_build_job``)
builds all three configs one after the other, a build resumed from 400
elements, and the one-device build.  Bars: JAX's mesh counts and edge
Jaccard > 0.95 on every layer against JAX's mesh build; the one-device
builds by JAX's own bar, the edge Jaccard over all layers > 0.95 (the
group's warm-up waves are S elements, the one-device build's 8, and the
smallest layer differs the most: 0.86 at 47 elements, as between JAX's own
mesh and one-device builds); byte-equal layers on every rank; self-recall@1
> 0.95.
"""

import jax
import numpy as np
import pytest
import torch

import granne_tpu as J
import torch_rank_jobs as jobs
from granne_tpu.parallel.mesh import make_mesh
from granne_tpu_torch import AngularVectors, BuildConfig, Group, run_ranks
from granne_tpu_torch.index.graph import empty_layer
from granne_tpu_torch.parallel import dp_build


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_jax():
    """Drop every compiled JAX program before and after this module: each
    XLA:CPU executable holds memory maps, and one test process that runs
    many JAX-heavy files can reach vm.max_map_count and crash."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's torch ops on one thread, then restore the count:
    the test suite runs several workers at once, and torch's intra-op
    threads on top of them oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S, N, D, RESUME_AT, RECALL_ROWS = 4, 700, 16, 400, 200
BASE = dict(num_neighbors=10, max_search=25, wave_size=64)
CASES = {
    "uncached": BASE,
    "levers": dict(BASE, neighbor_cache=True, build_max_iters=10, gather_budget=24),
    "reverse_cap": dict(BASE, reverse_cap=4, merge_chunk=256),
}


def _jaccard(a, b):
    agree = total = 0
    for ra, rb in zip(a, b):
        sa = frozenset(int(x) for x in ra if x >= 0)
        sb = frozenset(int(x) for x in rb if x >= 0)
        union = len(sa | sb)
        agree += len(sa & sb) if union else 1
        total += union if union else 1
    return agree / total


def _stack_jaccard(a, b):
    return _jaccard([r for layer in a for r in layer], [r for layer in b for r in layer])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's graphs and the 4 ranks' results (computed once a run)."""
    return jobs.once_per_run(tmp_path_factory, "dp_build", _run)


def _run():
    vecs = np.random.default_rng(0).standard_normal((N, D)).astype(np.float32)
    elements = J.AngularVectors.from_raw(vecs)
    jax_out = {
        name: J.build_layers(elements, J.BuildConfig(**CASES[name]), mesh=make_mesh(S)).as_numpy()
        for name in ("uncached", "levers")
    }
    jax_out["reverse_cap_single"] = J.build_layers(elements, J.BuildConfig(**CASES["reverse_cap"])).as_numpy()
    ranks = run_ranks(jobs.dp_build_job, S, vecs, CASES, RESUME_AT, RECALL_ROWS,
                      backend="gloo", device="cpu", timeout=300)
    return jax_out, ranks


@pytest.mark.parametrize("name", ["uncached", "levers"])
def test_group_build_matches_jax_mesh_build(run, name):
    """JAX's mesh counts, and edge Jaccard > 0.95 on every layer against
    JAX's ``build_layers(mesh=make_mesh(4))`` (uncached, and with the flat
    cache and the beam levers)."""
    jax_out, ranks = run
    mine, want = ranks[0]["layers"][name], jax_out[name]
    assert [a.shape for a in mine] == [a.shape for a in want]
    for i, (a, b) in enumerate(zip(mine, want)):
        assert _jaccard(a, b) > 0.95, (name, i)


def test_group_build_matches_the_one_device_build(run):
    """The one-device build has the same layer schedule, and edge Jaccard
    over all layers > 0.95 (``tests/test_dp_build.py``'s bar); searchable
    with self-recall@1 > 0.95."""
    _, ranks = run
    mine, single = ranks[0]["layers"]["uncached"], ranks[0]["single"]
    assert [a.shape for a in mine] == [a.shape for a in single]
    assert _stack_jaccard(mine, single) > 0.95
    assert ranks[0]["self_recall"] > 0.95


def test_every_rank_holds_the_same_layers_and_no_jax(run):
    _, ranks = run
    for out in ranks:
        assert out["modules"] == []
        for name, layers in out["layers"].items():
            assert len(layers) == len(ranks[0]["layers"][name])
            assert all(np.array_equal(a, b) for a, b in zip(layers, ranks[0]["layers"][name])), name


def test_resumed_group_build(run):
    """A build of 400 elements resumed to 700 from its state: the counts of
    the build of 700 at once, and edge Jaccard > 0.95 against the one-device
    build resumed the same way.  (Against the build of 700 at once the
    Jaccard is lower on one device too, 0.87: the resumed bottom layer was
    pruned at 400 before it grew.)"""
    _, ranks = run
    out = ranks[0]
    assert out["partial_counts"][-1] == RESUME_AT
    resumed = out["layers"]["resumed"]
    assert [a.shape for a in resumed] == [a.shape for a in out["layers"]["uncached"]]
    assert _stack_jaccard(resumed, out["single_resumed"]) > 0.95


def test_reverse_cap_and_merge_chunk_take_effect(run):
    """``reverse_cap=4, merge_chunk=256`` built after the default config in
    the same rank processes: held to JAX's one-device build at those values
    (Jaccard > 0.95), and nearer to it than to the default config's graph.
    JAX's mesh build keys its compiled programs without these two fields,
    so there a second config in one process reuses the first's; the port
    compiles nothing per key."""
    jax_out, ranks = run
    mine = ranks[0]["layers"]["reverse_cap"]
    assert not all(np.array_equal(a, b) for a, b in zip(mine, ranks[0]["layers"]["uncached"]))
    to_ref = _stack_jaccard(mine, jax_out["reverse_cap_single"])
    assert to_ref > 0.95
    assert to_ref > _stack_jaccard(mine, ranks[0]["single"])


def test_ranks_refuse_different_elements(run):
    """Rank 0 holds 700 elements and the others 699: every rank raises
    ``ValueError`` before the first wave, and none hangs."""
    _, ranks = run
    for out in ranks:
        assert out["mismatch"] is not None and "different inputs" in out["mismatch"]


def test_wave_must_split_over_the_ranks():
    """A wave size that is no multiple of the world size is refused before
    any collective, by the segment loop and by the wave step."""
    group = Group(rank=0, world=S, backend="gloo", device=torch.device("cpu"), pg=None)
    elements = AngularVectors.from_raw(np.ones((8, D), np.float32), device="cpu")
    adj = empty_layer(8, 4, "cpu")
    kw = dict(m_eff=4, max_search=8, expand=1, reinsert=False, reverse_cap=8, merge_chunk=64)
    with pytest.raises(ValueError, match="multiple of the world size"):
        dp_build.dp_waves(group, (), adj, elements, 0, 8, wave_size=6, **kw)
    with pytest.raises(ValueError, match="does not split over"):
        dp_build.dp_wave_step(group, (), adj, elements, torch.arange(6, dtype=torch.int32),
                              torch.ones(6, dtype=torch.bool), **kw)
