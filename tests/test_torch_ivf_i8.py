"""granne_tpu_torch's chunked int8 IVF (``index/ivf_big.py::
build_ivf_i8_chunked``, then ``IvfIndex.search_batch`` over its int8 blocks)
against the plain reference of ``tests/plain_ivf_i8.py``, which imports
nothing of the port, at d 96 and blocks of L 64 on the CPU.

The codes are the reference's own (max-abs, half to even); the port gets
them as a host int8 array, as a deployment that keeps its data as codes
does.  The deployment states its distances with the codes exact and the
query rounded to bf16, the products summed in f32: the port's plain
scoring (and K4 on the card) sums the same exact products in another order,
so the distances agree to f32 summation-order rounding.  Over 96 products
of a score below 1 in magnitude that is a few f32 ulps, well under 1e-6
(``TOL``), while codes of 6 bits move a distance by ~1e-2.
"""

import numpy as np
import pytest
import torch

import plain_ivf_i8 as plain
from granne_tpu_torch.index import ivf_big

TOL = 1e-6  # f32 summation-order rounding of 96 exact products, a score of magnitude <= 1
N, D, K = 3000, 96, 10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's torch ops on one thread, then restore the count:
    the test suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def deployment():
    """(codes int8[N, D] on the host, queries f32[64, D], the index built
    in three chunks)."""
    gen = torch.Generator().manual_seed(19)
    centres = torch.randn((40, D), generator=gen)
    x = centres[torch.randint(0, 40, (N + 64,), generator=gen)] + 0.35 * torch.randn((N + 64, D), generator=gen)
    codes, queries = plain.quantize(x[:N]), x[N:]
    index = ivf_big.build_ivf_i8_chunked(
        codes.numpy(), n_clusters=24, cluster_cap=64, kmeans_iters=4, kmeans_sample=2048, chunk=1100, seed=3,
        log=lambda m: None, device="cpu",
    )
    return codes, queries, index


def test_every_code_is_placed_once_with_its_inverse_norm(deployment):
    codes, _, index = deployment
    assert index.blocks.dtype == torch.int8 and index.blocks.shape[1:] == (64, D) and index.n_total == N
    ids = index.block_ids
    assert sorted(ids[ids >= 0].tolist()) == list(range(N))
    live = ids >= 0
    assert torch.equal(index.blocks[live], codes[ids[live].long()])
    norms = torch.sqrt(torch.sum(codes.to(torch.float64) ** 2, dim=1))
    assert torch.allclose(index.block_scales[live].double(), 1.0 / norms[ids[live].long()], rtol=1e-7, atol=0)


def test_full_probe_returns_the_reference_ids_and_distances(deployment):
    """At nprobe = every block the search is exact over the codes: the
    reference's top-10 at the stated precision, ids differing only between
    exactly equal reference scores, each distance within ``TOL`` of the
    reference's for the same id."""
    codes, queries, index = deployment
    ids, dists = index.search_batch(queries, K, nprobe=index.k)
    want, _ = plain.exact_topk(codes, queries, K, query_bf16=True)
    got_ref = plain.id_dists(codes, queries, ids)
    want_ref = plain.id_dists(codes, queries, want)
    differ = ids.long() != want
    assert torch.equal(got_ref[differ], want_ref[differ]), int(differ.sum())
    err = float((dists - got_ref).abs().max())
    assert err <= TOL, err
    # the exact f32 top-10 (query unrounded) mostly agrees: bf16 rounding of the query reorders near ties
    exact, _ = plain.exact_topk(codes, queries, K)
    hits = np.mean([len(set(a) & set(b)) / K for a, b in zip(ids.tolist(), exact.tolist())])
    assert hits >= 0.97


def test_the_tolerance_catches_six_bit_codes(deployment):
    """The same comparison against the reference given the codes requantized
    to 6 bits fails by far more than ``TOL``: the check sees a precision
    below the stated one."""
    codes, queries, index = deployment
    ids, dists = index.search_batch(queries, K, nprobe=index.k)
    coarse = plain.id_dists(plain.quantize(codes, bits=6), queries, ids)
    assert float((dists - coarse).abs().max()) > 100 * TOL
    # the unrounded query misses by more than TOL as well: the program scores the bf16 query
    unrounded = plain.id_dists(codes, queries, ids, query_bf16=False)
    assert float((dists - unrounded).abs().max()) > TOL


def test_grouped_route_equals_the_ungrouped_bit_for_bit(deployment):
    codes, queries, index = deployment
    grouped = index.search_batch(queries, K, nprobe=4)
    ungrouped = index.search_batch(queries, K, nprobe=4, grouped=False, query_chunk=16)
    assert torch.equal(grouped[0], ungrouped[0]) and torch.equal(grouped[1], ungrouped[1])
    assert bool((grouped[0] >= 0).all())


@pytest.mark.parametrize("kind", ["i8", "f32"])
def test_chunked_builds_open_their_three_spans(kind):
    """Each chunked build times its k-means, its streamed assignment (all
    chunks in one span) and its layout, once each, on the host clock."""
    from granne_tpu_torch.utils import trace

    gen = torch.Generator().manual_seed(5)
    x = torch.randn((600, D), generator=gen)
    kw = dict(n_clusters=8, cluster_cap=64, kmeans_iters=2, kmeans_sample=300, chunk=250, log=lambda m: None,
              device="cpu")
    trace.reset()
    if kind == "i8":
        ivf_big.build_ivf_i8_chunked(plain.quantize(x).numpy(), **kw)
    else:
        ivf_big.build_ivf_f32_chunked(x.numpy(), **kw)
    got = trace.summary()
    assert sorted(got) == ["ivf_big/assign", "ivf_big/layout", "ivf_big/train"]
    assert all(v["count"] == 1 and v["total_s"] >= 0 for v in got.values())
    trace.reset()
