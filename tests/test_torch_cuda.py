"""The CUDA kernels on the card (K1, K2, K3, K4, K5) against their plain
PyTorch versions, the searches and builds that launch them, and the int8
elements on the card (exact integer dots, K1 on int8-provenance tables,
the cache-fed int8 build, the element file), reorder on the card, the
online builder's threads on one card, a world of one rank through NCCL,
the data-parallel build of four gloo ranks on one card, and trace spans
that wait for the card or time the IVF search's stages on it.

Needs an NVIDIA GPU and nvcc; every test skips elsewhere.  This file imports
no jax, so it runs on a machine that has only the port's dependencies:

    python -m pytest -p no:xdist -p no:cacheprovider --noconftest -o addopts="" tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import granne_tpu_torch as g
from composed_epilogue import composed_pair_rows
from granne_tpu_torch.index.granne import Granne
from granne_tpu_torch.ops import distance
from granne_tpu_torch.ops.kernels import ivf_score as K
from granne_tpu_torch.ops.kernels.row_topk import K_MAX, row_top_k
from granne_tpu_torch.ops.topk import top_k
from granne_tpu_torch.ops.kernels.nbr_score import (
    gather_score,
    gather_score_flat,
    gather_score_flat_reference,
    gather_score_reference,
)
from granne_tpu_torch.ops.nbr_cache import make_neighbor_cache, pack_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    distance.full_f32()
    return torch.device("cuda")


@pytest.mark.parametrize(
    "n,M,d,B,E",
    [
        (200_000, 20, 100, 1024, 1),  # the serve shape
        (200_000, 20, 100, 1024, 4),  # the build's expand
        (400, 8, 121, 32, 2),
        (300, 5, 33, 17, 3),  # M*d odd: the id lanes start off a 4-byte boundary
        (500, 7, 50, 20, 3),  # d even, vectors 4 bytes apart mod 8: scored lane by lane
        (32, 64, 512, 9, 2),  # one row needs more than 48 KB of shared memory
        (200_000, 20, 100, 4096, 4),  # 16,384 rows: every warp's ring of slots wraps
    ],
)
def test_k1_kernel_matches_plain(cuda, n, M, d, B, E):
    gen = torch.Generator(device=cuda).manual_seed(0)
    vecs = distance.normalize(torch.randn((n, M, d), generator=gen, device=cuda)).to(torch.bfloat16)
    adj = torch.randint(0, n, (n, M), generator=gen, device=cuda, dtype=torch.int32)
    adj[::2, M // 2 :] = -1
    tab = pack_rows(vecs, "flat", ids=adj)
    sel = torch.randint(-3, n, (B, E), generator=gen, device=cuda, dtype=torch.int32)
    q = distance.normalize(torch.randn((B, d), generator=gen, device=cuda)).to(torch.bfloat16)
    before = gather_score_flat.launches
    dots, nbrs = gather_score_flat(tab, sel, q, M=M, d=d)
    torch.cuda.synchronize()
    assert gather_score_flat.launches == before + 1
    ref_d, ref_n = gather_score_flat_reference(tab, sel, q, M=M, d=d)
    assert torch.equal(nbrs, ref_n)
    assert torch.isfinite(dots).all()
    # both sum exact bf16 products in f32; only the summation order differs
    assert float((dots - ref_d).abs().max()) <= 1e-4


def test_cached_search_runs_k1_and_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((3000, 48)).astype(np.float32)
    b = g.GranneBuilder("angular", num_neighbors=12, max_search=40, device=cuda)
    b.append(vecs)
    b.build()
    idx = b.get_index()
    serve = Granne(layers=idx.layers, elements=idx.elements.as_bf16()).with_neighbor_cache()
    before = gather_score_flat.launches
    ids, d = serve.search_batch(vecs[:256], max_search=32, num_neighbors=5)
    assert gather_score_flat.launches > before
    assert float(np.mean(ids[:, 0].cpu().numpy() == np.arange(256))) >= 0.95

    cpu_layers = g.LayerStack.from_numpy(idx.layers.as_numpy(), device="cpu")
    cpu = Granne(layers=cpu_layers, elements=g.AngularVectors(serve.elements.vectors.cpu())).with_neighbor_cache()
    cids, cd = cpu.search_batch(vecs[:256], max_search=32, num_neighbors=5)
    overlap = np.mean([len(set(a) & set(c)) / 5 for a, c in zip(ids.cpu().numpy(), cids.numpy())])
    assert overlap > 0.99
    np.testing.assert_allclose(np.sort(d.cpu().numpy()), np.sort(cd.numpy()), atol=1e-5)


@pytest.mark.parametrize(
    "n,M,d,B,E",
    [
        (200_000, 20, 100, 1024, 1),  # the serve shape
        (200_000, 20, 100, 1024, 4),  # the build's expand
        (400, 6, 20, 32, 3),
        (300, 9, 128, 17, 2),  # d = 128: every lane live; M odd: a lone vector in the last pair
        (50, 3, 7, 5, 1),  # d not a multiple of 8
        (200_000, 20, 100, 4096, 4),  # 16,384 rows: every warp's ring of slots wraps
    ],
)
def test_k2_kernel_matches_plain(cuda, n, M, d, B, E):
    """K2 on a table built by make_neighbor_cache from half-unfilled rows
    (-1 slots cache row 0's vector): within 1e-4 of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    el = g.AngularVectors(distance.normalize(torch.randn((n, d), generator=gen, device=cuda)))
    adj = torch.randint(0, n, (n, M), generator=gen, device=cuda, dtype=torch.int32)
    adj[::2, M // 2 :] = -1
    tab = make_neighbor_cache(adj, el, layout="tiled")
    sel = torch.randint(-3, n, (B, E), generator=gen, device=cuda, dtype=torch.int32)
    q = distance.normalize(torch.randn((B, d), generator=gen, device=cuda)).to(torch.bfloat16)
    before = gather_score.launches
    dots = gather_score(tab, sel, q, M=M)
    torch.cuda.synchronize()
    assert gather_score.launches == before + 1
    ref = gather_score_reference(tab, sel, q, M=M)
    assert dots.shape == (B, E * M) and torch.isfinite(dots).all()
    # both sum exact bf16 products in f32; only the summation order differs
    assert float((dots - ref).abs().max()) <= 1e-4


def _tensors(out):
    return out if isinstance(out, tuple) else (out,)


def _graph_replays_eager(kernel, tab, sels, q):
    """Three launches of ``kernel`` captured in one CUDA graph give the
    eager launches' outputs exactly, and follow new ids written into the
    captured ``sel_ids``."""
    eager = [kernel(tab, s, q) for s in sels]  # also loads the library before the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [kernel(tab, s, q) for s in sels]
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(captured, eager):
        assert all(torch.equal(a, b) for a, b in zip(_tensors(got), _tensors(want)))
    gen = torch.Generator(device=tab.device).manual_seed(5)
    for s in sels:
        s.copy_(torch.randint(-3, tab.shape[0] + 3, s.shape, generator=gen, device=tab.device, dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    for got, s in zip(captured, sels):
        assert all(torch.equal(a, b) for a, b in zip(_tensors(got), _tensors(kernel(tab, s, q))))


def test_k1_launches_capture_in_a_cuda_graph(cuda):
    n, M, d, B, E = 20_000, 20, 100, 256, 4
    gen = torch.Generator(device=cuda).manual_seed(3)
    vecs = distance.normalize(torch.randn((n, M, d), generator=gen, device=cuda)).to(torch.bfloat16)
    adj = torch.randint(0, n, (n, M), generator=gen, device=cuda, dtype=torch.int32)
    adj[::2, M // 2 :] = -1
    tab = pack_rows(vecs, "flat", ids=adj)
    sels = [torch.randint(-3, n, (B, E), generator=gen, device=cuda, dtype=torch.int32) for _ in range(3)]
    q = distance.normalize(torch.randn((B, d), generator=gen, device=cuda)).to(torch.bfloat16)
    before = gather_score_flat.launches
    _graph_replays_eager(lambda t, s, qq: gather_score_flat(t, s, qq, M=M, d=d), tab, sels, q)
    assert gather_score_flat.launches == before + 3 + 3 + 3  # eager, captured, eager again


def test_k2_launches_capture_in_a_cuda_graph(cuda):
    n, M, d, B, E = 20_000, 20, 100, 256, 4
    gen = torch.Generator(device=cuda).manual_seed(4)
    tab = pack_rows(distance.normalize(torch.randn((n, M, d), generator=gen, device=cuda)).to(torch.bfloat16), "tiled")
    sels = [torch.randint(-3, n, (B, E), generator=gen, device=cuda, dtype=torch.int32) for _ in range(3)]
    q = distance.normalize(torch.randn((B, d), generator=gen, device=cuda)).to(torch.bfloat16)
    before = gather_score.launches
    _graph_replays_eager(lambda t, s, qq: gather_score(t, s, qq, M=M), tab, sels, q)
    assert gather_score.launches == before + 3 + 3 + 3


def _jaccard(a, b):
    agree = total = 0
    for ra, rb in zip(a, b):
        sa, sb = {int(x) for x in ra if x >= 0}, {int(x) for x in rb if x >= 0}
        union = len(sa | sb)
        agree += len(sa & sb) if union else 1
        total += union if union else 1
    return agree / total


def test_tiled_cache_build_on_card_matches_cpu(cuda):
    """A tiled cache-fed build on the card launches K2 and gives the CPU
    build's graph (per-layer edge Jaccard >= 0.99); tiled serving on the
    card overlaps the CPU's >= 0.99."""
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((2000, 48)).astype(np.float32)
    cfg = g.BuildConfig(num_neighbors=12, max_search=32, neighbor_cache=True, neighbor_cache_layout="tiled")
    card_el = g.AngularVectors.from_raw(vecs, device=cuda)
    cpu_el = g.AngularVectors(card_el.vectors.cpu())
    before = gather_score.launches
    card = g.build_layers(card_el, cfg)
    torch.cuda.synchronize()
    assert gather_score.launches > before
    cpu = g.build_layers(cpu_el, cfg)
    assert card.counts == cpu.counts
    for a, b in zip(card.as_numpy(), cpu.as_numpy()):
        assert _jaccard(a, b) >= 0.99
    serve = Granne(layers=card, elements=card_el.as_bf16()).with_neighbor_cache("tiled")
    before = gather_score.launches
    ids, d = serve.search_batch(vecs[:256], max_search=32, num_neighbors=5)
    assert gather_score.launches > before and torch.isfinite(d).all()
    cids, _ = Granne(layers=cpu, elements=cpu_el.as_bf16()).with_neighbor_cache("tiled").search_batch(
        vecs[:256], max_search=32, num_neighbors=5
    )
    overlap = np.mean([len(set(a) & set(c)) / 5 for a, c in zip(ids.cpu().numpy(), cids.numpy())])
    assert overlap >= 0.99


def _ivf_case(dev, dtype, k, L, d, S, cap, seed=0, runs=False):
    """Unit-norm blocks (int8: their max-abs codes and inverse norms), bf16
    queries, a padded tail of -1 ids in every block, random slot keys
    (``runs``: sorted, so equal keys come in runs, as ``group_pairs`` gives
    them)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = distance.normalize(torch.randn((k, L, d), generator=gen, device=dev))
    scales = torch.ones((k, L), dtype=torch.float32, device=dev)
    if dtype == torch.int8:
        blocks = distance.quantize_i8(rows)
        scales = distance.inv_norms_i8(blocks)
    else:
        blocks = rows.to(dtype)
    ids = torch.arange(k * L, dtype=torch.int32, device=dev).reshape(k, L)
    ids[:, L - max(1, L // 5) :] = -1
    keys = torch.randint(0, k, (S,), generator=gen, device=dev, dtype=torch.int32)
    if runs:
        keys = keys.sort().values
    qg = distance.normalize(torch.randn((S, cap, d), generator=gen, device=dev)).to(torch.bfloat16)
    return blocks, ids, scales, keys, qg


IVF_CASES = [
    # k, L, d, S, cap, group, k_out, runs of equal keys
    (1000, 256, 100, 1520, 32, 8, 10, False),  # the serve shape (200k x 100 in 1,000 blocks, nprobe 4, 4,096 queries)
    (64, 64, 48, 37, 16, 8, 10, False),  # S % G != 0: a shorter tail group
    (6, 512, 300, 9, 32, 4, 10, False),  # one block is 307 KB (bf16) / 614 KB (f32): row tiles
    (8, 8, 24, 5, 8, 2, 12, False),  # k_out > L: (-inf, -1) padding
    (20, 40, 33, 11, 5, 3, 7, False),  # odd d, cap not a multiple of 8
    (50, 64, 128, 40, 17, 8, 10, False),  # d = 128: whole k steps, rows a multiple of 16 bytes; cap 17
    (30, 37, 100, 25, 1, 8, 10, False),  # ragged L (odd: scalar stores), cap 1
    (6, 256, 100, 45, 40, 8, 10, True),  # runs of equal keys; cap 40: two query tiles
    (40, 256, 100, 30, 32, 8, 64, False),  # k_out 64: K5's list in its output row, across row tiles
    (12, 100, 64, 20, 9, 8, 16, False),  # k_out 16: the longest lists K5 keeps in registers
    (12, 100, 64, 20, 9, 8, 17, False),  # k_out 17: the shortest list K5 keeps in its output row
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8], ids=["bf16", "f32", "i8"])
@pytest.mark.parametrize(
    "case", IVF_CASES, ids=[f"k{c[0]}-L{c[1]}-d{c[2]}-S{c[3]}-cap{c[4]}{'-runs' if c[7] else ''}" for c in IVF_CASES]
)
def test_ivf_kernels_match_plain(cuda, dtype, case):
    """K3/K4 within 1e-4 of plain on the cosine scale (raw dots times the
    row's scale: int8 dots run to ~400); K5 values within 1e-4 and ids
    equal wherever the plain values are not within 1e-4 of a neighbour
    (the value just past the last column counts as one).
    Both sum exact bf16 products in f32; only the summation order differs."""
    k, L, d, S, cap, group, k_out, runs = case
    blocks, ids, scales, keys, qg = _ivf_case(cuda, dtype, k, L, d, S, cap, runs=runs)
    ref = K.ivf_score_slots_reference(blocks, keys, qg)
    row_scale = scales[keys.long()][:, None, :]
    before = (K.ivf_score_slots.launches, K.ivf_score_slots_grouped.launches, K.ivf_score_topk.launches)
    k3 = K.ivf_score_slots(blocks, keys, qg)
    k4 = K.ivf_score_slots_grouped(blocks, keys, qg, group=group)
    v, i = K.ivf_score_topk(blocks, ids, scales, keys, qg, k_out=k_out)
    torch.cuda.synchronize()
    after = (K.ivf_score_slots.launches, K.ivf_score_slots_grouped.launches, K.ivf_score_topk.launches)
    assert after == tuple(b + 1 for b in before)
    for got in (k3, k4):
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert float(((got - ref) * row_scale).abs().max()) <= 1e-4
    assert torch.equal(k3, k4)  # the same per-output summation order
    rv, ri = K.ivf_score_topk_reference(blocks, ids, scales, keys, qg, k_out=k_out)
    assert v.shape == rv.shape == (S, cap, k_out) and i.dtype == torch.int32
    fin = torch.isfinite(rv)
    assert torch.equal(torch.isfinite(v), fin) and torch.equal(i[~fin], ri[~fin])
    assert bool((i[~fin] == -1).all())
    assert float((v[fin] - rv[fin]).abs().max()) <= 1e-4
    # neighbours in plain's ranking, the first value past the last column included
    rv1 = K.ivf_score_topk_reference(blocks, ids, scales, keys, qg, k_out=k_out + 1)[0]
    gaps = (rv1[..., 1:] - rv1[..., :-1]).abs()
    near = torch.zeros_like(rv1, dtype=torch.bool)
    near[..., 1:] |= gaps <= 1e-4
    near[..., :-1] |= gaps <= 1e-4
    near = near[..., :k_out]
    assert torch.equal(i[~near], ri[~near])


@pytest.mark.parametrize("group", [1, 8], ids=["k3", "k4"])
def test_ivf_launches_capture_in_a_cuda_graph(cuda, group):
    """K3 / K4 launches captured in one CUDA graph replay to the eager
    scores exactly and follow new keys (some out of range, so clamped)
    written into the captured key tensors."""
    blocks, _, _, keys, qg = _ivf_case(cuda, torch.bfloat16, 200, 256, 100, 300, 32, seed=6)
    fn = K.ivf_score_slots if group == 1 else K.ivf_score_slots_grouped
    kernel = K.ivf_score_slots if group == 1 else (lambda b, kk, q: K.ivf_score_slots_grouped(b, kk, q, group=group))
    before = fn.launches
    _graph_replays_eager(kernel, blocks, [keys.clone() for _ in range(3)], qg)
    assert fn.launches == before + 3 + 3 + 3


def test_ivf_topk_ties_take_the_lower_column(cuda):
    """Exactly duplicated block rows score equal in any order: K5 and its
    plain version both rank the lower column first."""
    blocks, ids, scales, keys, qg = _ivf_case(cuda, torch.bfloat16, 4, 64, 40, 6, 8)
    blocks[2, 10] = blocks[2, 3]
    blocks[2, 30] = blocks[2, 3]
    keys[:] = 2
    qg[:, 0] = blocks[2, 3]
    v, i = K.ivf_score_topk(blocks, ids, scales, keys, qg, k_out=5)
    rv, ri = K.ivf_score_topk_reference(blocks, ids, scales, keys, qg, k_out=5)
    torch.cuda.synchronize()
    want = ids[2, [3, 10, 30]]
    assert torch.equal(i[:, 0, :3], want.expand(6, 3)) and torch.equal(ri[:, 0, :3], want.expand(6, 3))
    assert bool((v[:, 0, 0] == v[:, 0, 2]).all())


def test_ivf_topk_ties_across_row_tiles(cuda):
    """Exact duplicates of one row far apart in a 512-row block (scored in
    many row tiles) tie in any summation order: K5 ranks them by column, as
    its plain version does, with the list in registers (k_out 10) and in the
    output row (k_out 64), for bf16 and f32 blocks (other row tiles)."""
    for dtype in (torch.bfloat16, torch.float32):
        blocks, ids, scales, keys, qg = _ivf_case(cuda, dtype, 6, 512, 300, 9, 32, seed=8)
        cols = [5, 95, 96, 300, 401]  # far apart, and two neighbours
        for c in cols[1:]:
            blocks[3, c] = blocks[3, 5]
        keys[:] = 3
        qg[:, 0] = blocks[3, 5].to(torch.bfloat16)
        for k_out in (10, 64):
            v, i = K.ivf_score_topk(blocks, ids, scales, keys, qg, k_out=k_out)
            rv, ri = K.ivf_score_topk_reference(blocks, ids, scales, keys, qg, k_out=k_out)
            torch.cuda.synchronize()
            want = ids[3, cols].expand(9, len(cols))
            assert torch.equal(i[:, 0, : len(cols)], want) and torch.equal(ri[:, 0, : len(cols)], want)
            assert bool((v[:, 0, : len(cols)] == v[:, 0, :1]).all())


def test_ivf_topk_launches_capture_in_a_cuda_graph(cuda):
    """K5 launches captured in one CUDA graph replay to the eager values and
    ids exactly and follow new keys (some out of range, so clamped) written
    into the captured key tensors."""
    blocks, ids, scales, keys, qg = _ivf_case(cuda, torch.bfloat16, 200, 256, 100, 300, 32, seed=9)
    before = K.ivf_score_topk.launches
    _graph_replays_eager(
        lambda b, kk, q: K.ivf_score_topk(b, ids, scales, kk, q, k_out=10), blocks, [keys.clone() for _ in range(3)], qg
    )
    assert K.ivf_score_topk.launches == before + 3 + 3 + 3


def test_ivf_search_on_card_matches_cpu(cuda):
    """The same index searched on the card (the pair store at G 8 and 1, K5)
    and on the CPU (plain versions): ids overlap >= 0.99, and each route
    launched its kernel once (op by op, ``graph=False``: a graph's replay is
    not counted)."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((40, 48)).astype(np.float32)
    x = (centers[rng.integers(0, 40, 4000)] + 0.35 * rng.standard_normal((4000, 48))).astype(np.float32)
    cpu = g.IvfIndex.build(x, n_clusters=32, kmeans_iters=5, cluster_cap=64, device="cpu")
    card = g.IvfIndex(
        centroids=cpu.centroids.to(cuda), blocks=cpu.blocks.to(cuda), block_ids=cpu.block_ids.to(cuda),
        block_scales=cpu.block_scales.to(cuda), n_total=cpu.n_total,
    )
    q = x[:300]
    want = cpu.search_batch(q, 10, nprobe=6)[0].numpy()
    routes = [
        (dict(), K.ivf_score_pairs),
        (dict(slot_group=1), K.ivf_score_pairs),
        (dict(fused_topk=True), K.ivf_score_topk),
    ]
    for kw, kernel in routes:
        before = kernel.launches
        ids, dists = card.search_batch(q, 10, nprobe=6, graph=False, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.isfinite(dists).all()
        got = ids.cpu().numpy()
        overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got, want)])
        assert overlap >= 0.99, (kw, overlap)


def test_k4_over_int8_deployment_blocks_matches_plain(cuda):
    """K4 over int8 blocks of the deep-image-96 deployment's shape (L 512 in
    row tiles, d 96, runs of equal keys, the real inverse norms as scales)
    equals its plain version to f32 summation-order rounding on the cosine
    scale: both sum the same exact products of int8 codes and bf16 queries."""
    blocks, ids, scales, keys, qg = _ivf_case(cuda, torch.int8, 300, 512, 96, 900, 32, seed=19, runs=True)
    assert float(scales.min()) < float(scales.max()) < 1.0  # codes' norms, not unit rows
    ref = K.ivf_score_slots_reference(blocks, keys, qg)
    before = K.ivf_score_slots_grouped.launches
    got = K.ivf_score_slots_grouped(blocks, keys, qg, group=8)
    torch.cuda.synchronize()
    assert K.ivf_score_slots_grouped.launches == before + 1
    row_scale = scales[keys.long()][:, None, :]
    assert float(((got - ref) * row_scale).abs().max()) <= 1e-6


def _pair_case(dev, dtype, k, L, d, B, nprobe, cap, num_slots=None, seed=0):
    """A grouped search's slots over ``_ivf_case``'s blocks: ``B`` unit
    queries each probing ``nprobe`` distinct blocks, a quarter of them
    block 0 (a hot block, spilled over several slots), grouped by
    ``index/ivf.py::slot_groups`` into ``num_slots`` (``slot_count``'s by
    default) slots of ``cap`` places.  Returns (blocks, ids, scales, P,
    (keys, qg, slot_pairs, item_slot, item_pos, sorted_pairs))."""
    from granne_tpu_torch.index import ivf

    blocks, ids, scales, _, _ = _ivf_case(dev, dtype, k, L, d, 1, 1, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    q = distance.normalize(torch.randn((B, d), generator=gen, device=dev))
    probes = torch.rand((B, k), generator=gen, device=dev).argsort(dim=1)[:, :nprobe]
    hot = (probes == 0).any(dim=1)
    probes[::4, 0] = torch.where(hot[::4], probes[::4, 0], 0)
    S = num_slots or ivf.slot_count(k, B, nprobe, cap)
    return blocks, ids, scales, B * nprobe, ivf.slot_groups(q, probes, blocks, group_cap=cap, num_slots=S)


PAIR_CASES = [
    # dtype, k, L, d, B, nprobe, cap, group, num_slots
    (torch.bfloat16, 1000, 256, 100, 4000, 8, 32, 8, None),  # glove's shape (bf16 blocks, L 256, d 100, nprobe 8)
    (torch.bfloat16, 1000, 256, 100, 4000, 8, 32, 1, None),  # the same at G 1 (K3's route)
    (torch.int8, 600, 512, 96, 2000, 32, 32, 8, None),  # deep96's (int8, real scales, L 512 in row tiles, nprobe 32)
    (torch.int8, 600, 512, 96, 2000, 32, 32, 8, 1203),  # too few slots: dropped pairs; S % 8 != 0
    (torch.float32, 30, 40, 33, 100, 4, 5, 3, None),  # odd d, cap 5, S % 3 != 0
    (torch.bfloat16, 30, 37, 100, 200, 3, 40, 8, None),  # ragged L (scalar stores); cap 40: two query tiles
]


@pytest.mark.parametrize(
    "case", PAIR_CASES,
    ids=[f"{str(c[0])[6:]}-L{c[2]}-d{c[3]}-G{c[7]}{'-S' + str(c[8]) if c[8] else ''}" for c in PAIR_CASES],
)
def test_pair_store_equals_k4_and_its_epilogue(cuda, case):
    """The pair store (one launch) gives, bit for bit, K4's scores (K3's at
    G 1) followed by the search's former epilogue (scale, mask, row gather,
    scatter to the pairs); rows of pairs that no slot holds keep the
    buffer's fill; and it is within 1e-4 of its plain version (only the
    summation order differs), with the same -inf rows."""
    dtype, k, L, d, B, nprobe, cap, group, num_slots = case
    blocks, ids, scales, P, slots = _pair_case(cuda, dtype, k, L, d, B, nprobe, cap, num_slots)
    keys, qg, slot_pairs, item_slot = slots[:4]
    assert bool((slot_pairs < 0).any()) and int((keys == 0).sum()) >= 2  # empty places, a spilled block
    assert bool((item_slot < 0).any()) == (num_slots is not None)
    k4 = K.ivf_score_slots(blocks, keys, qg) if group == 1 else K.ivf_score_slots_grouped(blocks, keys, qg, group=group)
    want = composed_pair_rows(k4, ids, scales, slots, P)
    before = K.ivf_score_pairs.launches
    got = K.ivf_score_pairs(blocks, ids, scales, keys, qg, slot_pairs,
                            torch.full((P, L), -torch.inf, device=cuda), group=group)
    torch.cuda.synchronize()
    assert K.ivf_score_pairs.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    kept = K.ivf_score_pairs(blocks, ids, scales, keys, qg, slot_pairs, torch.full((P, L), 7.0, device=cuda),
                             group=group)
    held = torch.zeros(P, dtype=torch.bool, device=cuda)
    held[slot_pairs[slot_pairs >= 0].long()] = True
    assert torch.equal(kept[held], want[held]) and bool((kept[~held] == 7.0).all())
    plain = K.ivf_score_pairs_reference(blocks, ids, scales, keys, qg, slot_pairs,
                                        torch.full((P, L), -torch.inf, device=cuda))
    fin = torch.isfinite(plain)
    assert torch.equal(torch.isfinite(got), fin)
    assert float((got[fin] - plain[fin]).abs().max()) <= 1e-4


def test_pair_store_launches_capture_in_a_cuda_graph(cuda):
    """Pair-store launches captured in one CUDA graph replay to the eager
    rows exactly and follow new slots copied into the captured inputs; an
    ``out`` off an 8-byte boundary is refused before any launch."""
    blocks, ids, scales, P, (keys, qg, pairs, *_) = _pair_case(cuda, torch.bfloat16, 300, 256, 100, 1000, 8, 32)
    _, _, _, _, (keys2, qg2, pairs2, *_) = _pair_case(cuda, torch.bfloat16, 300, 256, 100, 1000, 8, 32, seed=4)
    n = min(keys.shape[0], keys2.shape[0])
    ins = [t[:n].clone() for t in (keys, qg, pairs)]

    def run():
        out = torch.full((P, 256), -torch.inf, device=cuda)
        return K.ivf_score_pairs(blocks, ids, scales, *ins, out)

    eager = run()
    before = K.ivf_score_pairs.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    for t, new in zip(ins, (keys2, qg2, pairs2)):
        t.copy_(new[:n])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, run())
    assert not torch.equal(captured, eager)
    assert K.ivf_score_pairs.launches == before + 2
    misaligned = torch.full((P * 256 + 1,), -torch.inf, device=cuda)[1:].view(P, 256)
    with pytest.raises(ValueError, match="8-byte boundary"):
        K.ivf_score_pairs(blocks, ids, scales, *ins, misaligned)
    assert K.ivf_score_pairs.launches == before + 2


def _searched_with_k4_epilogue(index, x, k_out, nprobe, group, cap=32):
    """The grouped search as it ran before the pair store, assembled from
    the port's parts: probe, grouping, K4 (K3 at ``group`` 1), the torch
    epilogue, the merge's top-k over [B, nprobe * L] and the id gather."""
    from granne_tpu_torch.index import ivf

    q = distance.normalize(x)
    B, L = q.shape[0], index.cluster_cap
    probes = ivf._probe(q, index.centroids, nprobe)
    slots = ivf.slot_groups(q, probes, index.blocks, group_cap=cap,
                            num_slots=ivf.slot_count(index.k, B, nprobe, cap))
    keys, qg = slots[:2]
    scores = (K.ivf_score_slots(index.blocks, keys, qg) if group == 1
              else K.ivf_score_slots_grouped(index.blocks, keys, qg, group=group))
    rows = composed_pair_rows(scores, index.block_ids, index.block_scales, slots, B * nprobe)
    ids_g = index.block_ids[keys.long()]
    id_rows = torch.full((B * nprobe, L), -1, dtype=torch.int32, device=q.device)
    item_slot, sorted_pairs = slots[3], slots[5]
    id_rows[sorted_pairs.long()] = torch.where((item_slot < 0)[:, None], -1, ids_g[item_slot.clamp_min(0).long()])
    v, pos = ivf.ranked(rows.reshape(B, nprobe * L), k_out)
    return torch.gather(id_rows.reshape(B, nprobe * L), 1, pos), torch.clamp_min(1.0 - v, 0.0)


def test_pair_store_search_equals_k4_with_its_epilogue(cuda):
    """A whole grouped search through the pair store, op by op and replayed
    from its CUDA graph, gives the ids and distances of the same search
    assembled from K4 (K3 at ``slot_group`` 1) and the torch epilogue it
    replaces, bit for bit, over bf16 blocks and int8 blocks with real
    scales; each op-by-op call launches the pair store once."""
    rng = np.random.default_rng(13)
    centers = rng.standard_normal((40, 96)).astype(np.float32)
    x = (centers[rng.integers(0, 40, 30_000)] + 0.35 * rng.standard_normal((30_000, 96))).astype(np.float32)
    q = torch.as_tensor(x[:3000], device=cuda)
    for dtype, nprobe in (("bfloat16", 8), ("int8", 32)):
        index = g.IvfIndex.build(x, n_clusters=80, kmeans_iters=4, cluster_cap=256, dtype=dtype, device=cuda)
        for group in (8, 1):
            want = _searched_with_k4_epilogue(index, q, 10, nprobe, group)
            before = K.ivf_score_pairs.launches
            eager = index.search_batch(q, 10, nprobe=nprobe, slot_group=group, graph=False)
            torch.cuda.synchronize()
            assert K.ivf_score_pairs.launches == before + 1
            replayed = index.search_batch(q, 10, nprobe=nprobe, slot_group=group)  # captured, then replayed
            for got in (eager, replayed):
                assert torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


def _i8_deployment(n, d=96, queries=300, seed=19):
    """Blob vectors as the plain reference's max-abs codes (host int8), and
    held-out queries."""
    import plain_ivf_i8 as plain

    gen = torch.Generator().manual_seed(seed)
    centres = torch.randn((60, d), generator=gen)
    x = centres[torch.randint(0, 60, (n + queries,), generator=gen)] + 0.35 * torch.randn((n + queries, d), generator=gen)
    return plain, plain.quantize(x[:n]), x[n:]


def _equal_but_near_ties(ids, want_ids, want_d, tol=1e-6):
    """Ids equal wherever ``want_d`` has no neighbour within ``tol`` (the
    value just past the last column not known, so the last column counts
    as tied)."""
    gaps = (want_d[:, 1:] - want_d[:, :-1]).abs() <= tol
    near = torch.zeros_like(want_d, dtype=torch.bool)
    near[:, 1:] |= gaps
    near[:, :-1] |= gaps
    near[:, -1] = True
    return torch.equal(ids[~near], want_ids[~near])


def test_int8_chunked_index_searches_alike_on_card_and_cpu(cuda):
    """An int8 index from ``build_ivf_i8_chunked`` (three chunks, L 512,
    d 96) searched on the card (the grouped route op by op: the pair store
    and ``row_top_k`` at the probe's k 32) and on the CPU (plain versions), and
    on the card through the route's CUDA graph: the same ids but at
    near ties, distances within 1e-6.  Built on the card as well, at full
    probe it returns the plain reference's top-10 at the stated precision
    (codes exact, the query in bf16)."""
    from granne_tpu_torch.index import ivf_big

    plain, codes, q = _i8_deployment(20_000)
    kw = dict(n_clusters=32, cluster_cap=512, kmeans_iters=4, kmeans_sample=8192, chunk=7000, log=lambda m: None)
    cpu = ivf_big.build_ivf_i8_chunked(codes.numpy(), device="cpu", **kw)
    card = g.IvfIndex(
        centroids=cpu.centroids.to(cuda), blocks=cpu.blocks.to(cuda), block_ids=cpu.block_ids.to(cuda),
        block_scales=cpu.block_scales.to(cuda), n_total=cpu.n_total,
    )
    want_ids, want_d = cpu.search_batch(q, 10, nprobe=32)
    before = (K.ivf_score_pairs.launches, row_top_k.launches)
    ids, dists = card.search_batch(q.to(cuda), 10, nprobe=32, graph=False)
    torch.cuda.synchronize()
    assert (K.ivf_score_pairs.launches, row_top_k.launches) == (before[0] + 1, before[1] + 2)
    assert _equal_but_near_ties(ids.cpu(), want_ids, want_d)
    assert float((dists.cpu() - want_d).abs().max()) <= 1e-6
    replayed = card.search_batch(q.to(cuda), 10, nprobe=32)
    assert torch.equal(replayed[0], ids) and torch.equal(replayed[1], dists)

    built = ivf_big.build_ivf_i8_chunked(codes.numpy(), device="cuda", **kw)
    assert built.blocks.is_cuda and built.blocks.dtype == torch.int8
    assert sorted(built.block_ids[built.block_ids >= 0].tolist()) == list(range(codes.shape[0]))
    ids, dists = built.search_batch(q.to(cuda), 10, nprobe=built.k)
    ids = ids.cpu().long()
    ref_d = plain.id_dists(codes, q, ids)
    ref_ids, ref_top = plain.exact_topk(codes, q, 10, query_bf16=True)
    assert _equal_but_near_ties(ids, ref_ids, ref_top)
    assert float((dists.cpu() - ref_d).abs().max()) <= 1e-6


# -- the row top-k ----------------------------------------------------------


def _topk_rows(kind, R, C, seed):
    """f32 [R, C] CPU rows of one ``kind``: scores on a coarse grid (many
    exact ties), runs of one column repeated the way a split cluster repeats
    its centroid row, -inf with fewer finite values than 32, NaN beside
    -inf, and signed zeros."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.round(torch.randn((R, C), generator=gen) * 2) / 2 + 0.25
    if kind == "split":
        x = torch.randn((R, C // 3 + 1), generator=gen).repeat_interleave(3, dim=1)[:, :C].contiguous()
    elif kind == "few_finite":
        x[:] = -torch.inf
        for r in range(R):
            n = min(r % 5, C)
            x[r, torch.randperm(C, generator=gen)[:n]] = torch.randint(-2, 3, (n,), generator=gen).float()
    elif kind == "nan":
        x[torch.rand((R, C), generator=gen) < 0.3] = torch.nan
        x[torch.rand((R, C), generator=gen) < 0.3] = -torch.inf
        x[: R // 2, : C - 3] = torch.nan
    elif kind == "signed_zeros":
        x[:, ::3] = -0.0
        x[:, 1::4] = 0.0
    return x


@pytest.mark.parametrize("kind", ["ties", "split", "few_finite", "nan", "signed_zeros"])
def test_row_top_k_matches_plain(cuda, kind):
    """The kernel's values and columns equal the plain version's on a CPU
    copy bit for bit, at k in {1, 8, 10, 16, 32} over widths k, 33, 2,048,
    6,467 (the probe's, not a multiple of 4) and 8,193."""
    for C in (33, 2048, 6467, 8193, None):
        for k in (1, 8, 10, 16, K_MAX):
            width = C or k
            x = _topk_rows(kind, 48, width, seed=width * 64 + k)
            v, i = row_top_k(x.to(cuda), k)
            want_v, want_i = top_k(x, k)
            assert torch.equal(v.cpu().view(torch.int32), want_v.view(torch.int32)), (kind, width, k)
            assert torch.equal(i.cpu(), want_i), (kind, width, k)


def test_row_top_k_at_the_serve_shapes(cuda):
    """The probe's [10,000 x 6,467] at k 8 and the merge's [10,000 x 2,048]
    at k 10, random scores: positions equal to the sort's on every row."""
    for R, C, k in ((10_000, 6467, 8), (10_000, 2048, 10)):
        x = torch.randn((R, C), generator=torch.Generator().manual_seed(C))
        v, i = row_top_k(x.to(cuda), k)
        want_v, want_i = top_k(x, k)
        assert torch.equal(i.cpu(), want_i) and torch.equal(v.cpu(), want_v)


def test_row_top_k_launches_capture_in_a_cuda_graph(cuda):
    """One launch a call; three launches captured in one CUDA graph replay
    to the eager outputs and follow new scores copied into the captured
    inputs."""
    xs = [_topk_rows("ties", 300, 6467, seed=s).to(cuda) for s in range(3)]
    before = row_top_k.launches
    eager = [row_top_k(x, 8) for x in xs]
    assert row_top_k.launches == before + 3
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [row_top_k(x, 8) for x in xs]
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(captured, eager):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for s, x in enumerate(xs):
        x.copy_(_topk_rows("split", 300, 6467, seed=10 + s).to(cuda))
    graph.replay()
    torch.cuda.synchronize()
    for got, x in zip(captured, xs):
        want = top_k(x.cpu(), 8)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert row_top_k.launches == before + 6


def test_ivf_search_on_card_launches_row_top_k_over_split_clusters(cuda, monkeypatch):
    """``IvfIndex.search_batch`` on the card, over clusters larger than L
    (each block of a split cluster carries the cluster's centroid row, so
    probe scores tie exactly): the probe and the merge launch ``row_top_k``,
    and the ids and distances equal those of the whole-row sort's route
    (both op by op, ``graph=False``, so each call runs the route it names)."""
    from granne_tpu_torch.index import ivf

    rng = np.random.default_rng(3)
    centers = rng.standard_normal((20, 64)).astype(np.float32)
    x = (centers[rng.integers(0, 20, 20_000)] + 0.35 * rng.standard_normal((20_000, 64))).astype(np.float32)
    index = g.IvfIndex.build(x, n_clusters=40, kmeans_iters=4, cluster_cap=128, device="cuda")
    assert index.k > 80  # ~500 members a cluster: every cluster split
    q = torch.as_tensor(x[:3000], device=cuda)
    for kw in (dict(graph=False), dict(fused_topk=True, graph=False), dict(grouped=False)):
        before = row_top_k.launches
        ids, dists = index.search_batch(q, 10, nprobe=12, **kw)
        torch.cuda.synchronize()
        launched = row_top_k.launches - before
        assert launched == (2 if "grouped" not in kw else -(-3000 // 256) * 2), (kw, launched)
        with monkeypatch.context() as m:
            m.setattr(ivf, "row_top_k", top_k)
            want_ids, want_d = index.search_batch(q, 10, nprobe=12, **kw)
        assert row_top_k.launches == before + launched
        assert torch.equal(ids, want_ids) and torch.equal(dists, want_d), kw


def test_ivf_search_replays_a_cuda_graph_equal_to_op_by_op(cuda):
    """``IvfIndex.search_batch`` off the profiler replays a CUDA graph of the
    grouped search (the pair store at G 8 and 1, K5): over two different batches of one
    shape its ids and distances equal the op-by-op search's bit for bit, an
    answer already returned is not overwritten by the next replay, a graph
    is captured once a key (a replay launches no kernel from Python), and
    the index keeps ``GRAPHS_KEPT`` graphs, the most recently used."""
    from granne_tpu_torch.index import ivf

    rng = np.random.default_rng(11)
    centers = rng.standard_normal((40, 96)).astype(np.float32)
    x = (centers[rng.integers(0, 40, 20_000)] + 0.35 * rng.standard_normal((20_000, 96))).astype(np.float32)
    index = g.IvfIndex.build(x, n_clusters=60, kmeans_iters=4, cluster_cap=256, device="cuda")
    qa, qb = (torch.as_tensor(x[lo : lo + 2000], device=cuda) for lo in (0, 5000))
    routes = [(dict(), K.ivf_score_pairs), (dict(slot_group=1), K.ivf_score_pairs),
              (dict(fused_topk=True), K.ivf_score_topk)]
    for kw, kernel in routes:
        want_a = index.search_batch(qa, 10, nprobe=8, graph=False, **kw)
        want_b = index.search_batch(qb, 10, nprobe=8, graph=False, **kw)
        got_a = index.search_batch(qa, 10, nprobe=8, **kw)  # captured here
        before = (kernel.launches, row_top_k.launches)
        got_b = index.search_batch(qb, 10, nprobe=8, **kw)  # a replay
        torch.cuda.synchronize()
        assert (kernel.launches, row_top_k.launches) == before, kw
        for got, want in ((got_a, want_a), (got_b, want_b)):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), kw
        assert not torch.equal(got_a[0], got_b[0])
    assert len(index._graphs) == ivf.GRAPHS_KEPT
    assert list(index._graphs)[-1] == ((2000, 96), 10, 8, 32, True, 8)


# -- int8 elements ----------------------------------------------------------


@pytest.mark.parametrize("d", [24, 100, distance.I8_EXACT_LANES, distance.I8_EXACT_LANES + 1, 2300])
def test_i8_distances_on_card_are_the_exact_integer_dots(cuda, d):
    """PyTorch has no int32 matrix product on CUDA: the int8 dots run as f32
    products of upcast codes (chunked past I8_EXACT_LANES) and must be the
    exact integers, equal to the CPU's and to numpy's int64 dots; the
    distances agree with the CPU's within 2e-7."""
    rng = np.random.default_rng(d)
    vecs = rng.choice(np.array([-127, 127, 126, -3, 0], np.int8), (4, 6, d))
    vecs[0, 0] = 127  # |dot| = d * 127^2: past 2^24 for d > 1040
    q = vecs[:, 0].copy()
    vecs[1, 2] = 0  # a zero row: distance 1
    want = np.einsum("bcd,bd->bc", vecs.astype(np.int64), q.astype(np.int64)).astype(np.float32)
    card = [torch.from_numpy(a).to(cuda) for a in (vecs, q)]
    got = distance.i8_dots(card[0], card[1][:, None, :])[..., 0]
    assert np.array_equal(got.cpu().numpy(), want)
    cpu_inv, card_inv = distance.inv_norms_i8(torch.from_numpy(vecs)), distance.inv_norms_i8(card[0])
    q_inv = distance.inv_norms_i8(torch.from_numpy(q))
    assert torch.equal(card_inv.cpu(), cpu_inv)
    pairs = (
        (distance.i8_dist_gathered(card[0], card_inv, card[1], q_inv.to(cuda)),
         distance.i8_dist_gathered(torch.from_numpy(vecs), cpu_inv, torch.from_numpy(q), q_inv)),
        (distance.i8_pairwise_gathered(card[0], card_inv), distance.i8_pairwise_gathered(torch.from_numpy(vecs), cpu_inv)),
        (distance.i8_dist_matrix(card[0][0], card[0][1]), distance.i8_dist_matrix(torch.from_numpy(vecs[0]), torch.from_numpy(vecs[1]))),
    )
    for on_card, on_cpu in pairs:
        assert float((on_card.cpu() - on_cpu).abs().max()) <= 2e-7
    assert bool((pairs[0][0][1, 2] == 1.0).all())


def _int8_table(dev, n, M, d, seed):
    """An int8 container and its flat bf16 cache table over half-unfilled rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    el = g.AngularIntVectors.from_raw(torch.randn((n, d), generator=gen, device=dev), device=dev)
    adj = torch.randint(0, n, (n, M), generator=gen, device=dev, dtype=torch.int32)
    adj[::2, M // 2 :] = -1
    return el, make_neighbor_cache(adj, el), gen


@pytest.mark.parametrize("n,M,d,B,E", [(200_000, 20, 100, 1024, 1), (200_000, 20, 100, 1024, 4), (400, 8, 121, 32, 2)])
def test_k1_int8_table_matches_plain(cuda, n, M, d, B, E):
    """K1 on a table of int8-provenance rows with both lane forms of the
    int8 queries: the exact unit query in bf16 (within 1e-4), and the int8
    codes as bf16 (up to 127; within 1e-4 times each query's lane norm)."""
    el, tab, gen = _int8_table(cuda, n, M, d, 0)
    sel = torch.randint(-3, n, (B, E), generator=gen, device=cuda, dtype=torch.int32)
    q = el.prepare_queries(torch.randn((B, d), generator=gen, device=cuda))
    for queries in (q, type(q)(q.vecs, q.inv_norms)):
        lanes = el.query_lanes(queries)
        before = gather_score_flat.launches
        dots, nbrs = gather_score_flat(tab, sel, lanes, M=M, d=d)
        torch.cuda.synchronize()
        assert gather_score_flat.launches == before + 1
        ref_d, ref_n = gather_score_flat_reference(tab, sel, lanes, M=M, d=d)
        assert torch.equal(nbrs, ref_n) and torch.isfinite(dots).all()
        scale = lanes.float().norm(dim=1, keepdim=True)
        assert float(((dots - ref_d).abs() / scale).max()) <= 1e-4
    assert float(el.query_lanes(type(q)(q.vecs, q.inv_norms)).abs().max()) == 127.0


def test_k1_int8_launches_capture_in_a_cuda_graph(cuda):
    n, M, d, B, E = 20_000, 20, 100, 256, 4
    el, tab, gen = _int8_table(cuda, n, M, d, 6)
    sels = [torch.randint(-3, n, (B, E), generator=gen, device=cuda, dtype=torch.int32) for _ in range(3)]
    q = el.prepare_queries(torch.randn((B, d), generator=gen, device=cuda))
    lanes = el.query_lanes(type(q)(q.vecs, q.inv_norms))  # code lanes, up to 127
    before = gather_score_flat.launches
    _graph_replays_eager(lambda t, s, qq: gather_score_flat(t, s, qq, M=M, d=d), tab, sels, lanes)
    assert gather_score_flat.launches == before + 3 + 3 + 3


def test_int8_cache_fed_build_on_card_matches_cpu(cuda):
    """A flat cache-fed int8 build on the card launches K1 and gives the CPU
    build's graph (per-layer edge Jaccard >= 0.99) and self-recall@1 >=
    0.95; int8 flat-cache serving on the card overlaps the CPU's >= 0.99;
    int8 + the tiled layout raises ValueError on the card too."""
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((2000, 48)).astype(np.float32)
    cfg = g.BuildConfig(num_neighbors=12, max_search=32, neighbor_cache=True)
    card_el = g.AngularIntVectors.from_raw(vecs, device=cuda)
    cpu_el = g.AngularIntVectors.from_raw(vecs, device="cpu")
    before = gather_score_flat.launches
    card = g.build_layers(card_el, cfg)
    torch.cuda.synchronize()
    assert gather_score_flat.launches > before
    cpu = g.build_layers(cpu_el, cfg)
    assert card.counts == cpu.counts
    for a, b in zip(card.as_numpy(), cpu.as_numpy()):
        assert _jaccard(a, b) >= 0.99
    serve = Granne(layers=card, elements=card_el).with_neighbor_cache()
    before = gather_score_flat.launches
    ids, d = serve.search_batch(vecs[:256], max_search=32, num_neighbors=5)
    assert gather_score_flat.launches > before and torch.isfinite(d).all()
    assert float(np.mean(ids[:, 0].cpu().numpy() == np.arange(256))) >= 0.95
    cids, _ = Granne(layers=cpu, elements=cpu_el).with_neighbor_cache().search_batch(vecs[:256], max_search=32, num_neighbors=5)
    overlap = np.mean([len(set(a) & set(c)) / 5 for a, c in zip(ids.cpu().numpy(), cids.numpy())])
    assert overlap >= 0.99
    with pytest.raises(ValueError, match="tiled"):
        Granne(layers=card, elements=card_el).with_neighbor_cache("tiled")


def test_int8_element_file_round_trip_on_card(cuda, tmp_path):
    """An "angular_int" element file written from the card loads on the card
    and on the CPU with equal codes and norms, and its bytes equal the file
    written from the CPU copy."""
    vecs = np.random.default_rng(3).standard_normal((5000, 100)).astype(np.float32)
    card_el = g.AngularIntVectors.from_raw(vecs, device=cuda)
    cpu_el = g.AngularIntVectors.from_raw(vecs, device="cpu")
    assert torch.equal(card_el.vectors.cpu(), cpu_el.vectors) and torch.equal(card_el.inv_norms.cpu(), cpu_el.inv_norms)
    from granne_tpu_torch.index import io

    card_path, cpu_path = str(tmp_path / "card.gt"), str(tmp_path / "cpu.gt")
    io.save_elements(card_el, card_path)
    io.save_elements(cpu_el, cpu_path)
    assert open(card_path, "rb").read() == open(cpu_path, "rb").read()
    loaded = io.load_elements(card_path, device=cuda)
    assert loaded.vectors.is_cuda and torch.equal(loaded.vectors, card_el.vectors)
    assert torch.equal(loaded.inv_norms, card_el.inv_norms)
    assert torch.equal(io.load_elements(card_path, device="cpu").vectors, cpu_el.vectors)


@pytest.mark.parametrize("kind", ["angular", "angular_int"])
def test_reorder_on_card_matches_cpu(cuda, kind):
    """Granne.reorder on the card: trails as on the CPU (>= 99% of elements;
    a near-tie of an ef=1 step may go either way), the order their banded
    sort gives, and with one order the same layers and elements to the bit.
    A cached index loses its cache; a fresh one serves through K1."""
    from granne_tpu_torch.index import reorder

    vecs = np.random.default_rng(8).standard_normal((4000, 48)).astype(np.float32)
    b = g.GranneBuilder(kind, num_neighbors=12, max_search=32, device="cpu")
    b.append(vecs)
    b.build()
    cpu = b.get_index()
    card_el = (g.AngularVectors.from_normalized(cpu.elements.vectors.numpy(), device=cuda) if kind == "angular"
               else g.AngularIntVectors.from_quantized(cpu.elements.vectors.numpy(), device=cuda))
    card = Granne(layers=g.LayerStack.from_numpy(cpu.layers.as_numpy(), device=cuda), elements=card_el)
    cpu_trails = reorder._entrypoint_trails(cpu.layers, cpu.elements)
    card_trails = reorder._entrypoint_trails(card.layers, card.elements)
    assert card_trails.shape == cpu_trails.shape and card_trails.shape[1] >= 1
    assert np.mean(np.all(card_trails == cpu_trails, axis=1)) >= 0.99
    cpu_new, cpu_order = cpu.reorder()
    card_new, card_order = card.with_neighbor_cache("flat").reorder()
    assert card_new.nbr_vecs is None and card_new.layers.layers[0].is_cuda
    assert np.array_equal(card_order, reorder.banded_order(card.layers.counts, card_trails))
    if np.array_equal(card_trails, cpu_trails):
        assert np.array_equal(card_order, cpu_order)
    card_given, _ = card.reorder(cpu_order)
    assert all(np.array_equal(a, c) for a, c in zip(card_given.layers.as_numpy(), cpu_new.layers.as_numpy()))
    assert torch.equal(card_given.elements.vectors.cpu(), cpu_new.elements.vectors)
    served = card_new.elements.as_bf16() if kind == "angular" else card_new.elements
    serve = Granne(layers=card_new.layers, elements=served).with_neighbor_cache("flat")
    before = gather_score_flat.launches
    ids, _ = serve.search_batch(vecs[:512], max_search=32, num_neighbors=1)
    assert gather_score_flat.launches > before
    assert float(np.mean(card_order[ids[:, 0].cpu().numpy()] == np.arange(512))) >= 0.98


@pytest.mark.parametrize("cls", [g.AngularVectors, g.AngularIntVectors], ids=["angular", "angular_int"])
def test_rw_builder_on_card_keeps_inserts_visible(cuda, cls):
    """RwGranneBuilder on the card, two threads inserting and one searching:
    each thread finds its rows (self top-1 >= 0.98) as soon as each
    insert_batch returns, flushes included, and nothing is lost."""
    import threading

    vecs = np.random.default_rng(9).standard_normal((3024, 32)).astype(np.float32)
    rw = g.RwGranneBuilder(cls.from_raw(vecs[:2000], device=cuda),
                           g.BuildConfig(num_neighbors=12, max_search=40, wave_size=256))
    errors, hits, searches, done = [], [], [0], threading.Event()

    def inserter(lo):
        try:
            for a in range(lo, lo + 512, 128):
                rw.insert_batch(vecs[a : a + 128])
                _, d = rw.search_batch(vecs[a : a + 128], max_search=32, num_neighbors=1)
                hits.append(float((d[:, 0] < 1e-4).float().mean()))
        except Exception as e:  # re-raised below
            errors.append(e)

    def searcher():
        try:
            while not done.is_set():
                ids, _ = rw.search_batch(vecs[:256], max_search=32, num_neighbors=5)
                assert tuple(ids.shape) == (256, 5) and ids.is_cuda
                searches[0] += 1
        except Exception as e:  # re-raised below
            errors.append(e)

    workers = [threading.Thread(target=inserter, args=(lo,)) for lo in (2000, 2512)]
    reader = threading.Thread(target=searcher)
    reader.start()
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    done.set()
    reader.join()
    if errors:
        raise errors[0]
    assert len(hits) == 8 and min(hits) >= 0.98 and searches[0] > 0
    rw.flush()
    assert rw.indexed_elements == 3024
    _, d = rw.search_batch(vecs, max_search=32, num_neighbors=1)  # the threads' order decides the ids
    assert float((d[:, 0] < 1e-4).float().mean()) >= 0.98


# -- bag-of-embeddings elements and host-tiered IVF ---------------------------


def _sum_embeddings(dev, V, d, n, T, seed=0):
    """A SumEmbeddings container: V words of width d with norms in [0.5, 2],
    n bags of 1..T distinct words, one empty bag."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((V, d)).astype(np.float32)
    emb *= (rng.uniform(0.5, 2.0, V) / np.linalg.norm(emb, axis=1))[:, None]
    lists = [list(rng.choice(V, size=rng.integers(1, T + 1), replace=False)) for _ in range(n)]
    lists[3] = []
    return g.SumEmbeddings.from_parts(emb, lists, device=dev)


@pytest.mark.parametrize("V,d,n,T", [(300, 24, 2000, 6), (5000, 100, 20_000, 8)])
def test_sum_embeddings_get_on_card_matches_cpu(cuda, V, d, n, T):
    """get, self_dist and the distances of SumEmbeddings on the card within
    1e-6 of the same container on the CPU (the T columns summed in order on
    both); the empty bag is the zero vector at self-distance 1."""
    card = _sum_embeddings(cuda, V, d, n, T)
    cpu = g.SumEmbeddings(card.embeddings.cpu(), card.terms.cpu())
    ids = torch.randint(0, n, (64, 33), generator=torch.Generator().manual_seed(1))
    ids[0, 0] = 3
    got, want = card.get(ids.to(cuda)).cpu(), cpu.get(ids)
    assert float((got - want).abs().max()) <= 1e-6
    assert float(card.self_dist(torch.tensor([3], device=cuda))[0]) == 1.0
    q = torch.randn((64, d), generator=torch.Generator().manual_seed(2))
    d_card = card.dist_ids_to_queries(ids.to(cuda), card.prepare_queries(q)).cpu()
    assert float((d_card - cpu.dist_ids_to_queries(ids, cpu.prepare_queries(q))).abs().max()) <= 1e-6


@pytest.mark.parametrize("V,d,n,T", [(300, 24, 2000, 6), (5000, 100, 20_000, 8)])
def test_precomputed_codes_on_card_equal_cpu(cuda, tmp_path, V, d, n, T):
    """precompute_quantized_vectors gives the same int8 codes and norms on the
    card and the CPU, bit for bit, and compute_embeddings_and_save_to_disk
    the same i1 file."""
    from granne_tpu_torch.elements.embeddings_etl import precompute_quantized_vectors

    card = _sum_embeddings(cuda, V, d, n, T)
    cpu = g.SumEmbeddings(card.embeddings.cpu(), card.terms.cpu())
    a, b = precompute_quantized_vectors(card), precompute_quantized_vectors(cpu, chunk=1000)
    assert a.vectors.device.type == "cuda"
    assert torch.equal(a.vectors.cpu(), b.vectors) and torch.equal(a.inv_norms.cpu(), b.inv_norms)
    np.savez(tmp_path / "el", terms=cpu.terms.numpy())
    for dev in (cuda, "cpu"):
        g.compute_embeddings_and_save_to_disk(str(tmp_path / "el.npz"), cpu.embeddings.numpy(),
                                              str(tmp_path / f"{torch.device(dev).type}.i1"), device=dev)
    assert (tmp_path / "cuda.i1").read_bytes() == (tmp_path / "cpu.i1").read_bytes()


def test_k1_k2_on_sum_embeddings_cache_match_plain(cuda):
    """K1 (flat) and K2 (tiled) on neighbor caches of SumEmbeddings rows at
    the serve width (d 100, M 20) against their plain versions (within
    1e-4; ids equal); each launched once."""
    el = _sum_embeddings(cuda, 5000, 100, 20_000, 8)
    M, B = 20, 512
    gen = torch.Generator(device=cuda).manual_seed(3)
    adj = torch.randint(0, len(el), (len(el), M), generator=gen, device=cuda, dtype=torch.int32)
    adj[::2, M // 2 :] = -1
    sel = torch.randint(-3, len(el), (B, 4), generator=gen, device=cuda, dtype=torch.int32)
    q = el.query_lanes(el.prepare_queries(torch.randn((B, 100), generator=gen, device=cuda)))
    flat = make_neighbor_cache(adj, el, layout="flat")
    before = gather_score_flat.launches
    dots, nbrs = gather_score_flat(flat, sel, q, M=M, d=100)
    torch.cuda.synchronize()
    assert gather_score_flat.launches == before + 1
    ref_d, ref_n = gather_score_flat_reference(flat, sel, q, M=M, d=100)
    assert torch.equal(nbrs, ref_n) and float((dots - ref_d).abs().max()) <= 1e-4
    tiled = make_neighbor_cache(adj, el, layout="tiled")
    before = gather_score.launches
    dots = gather_score(tiled, sel, q, M=M)
    torch.cuda.synchronize()
    assert gather_score.launches == before + 1
    assert float((dots - gather_score_reference(tiled, sel, q, M=M)).abs().max()) <= 1e-4


def test_sum_embeddings_cache_fed_build_on_card_matches_cpu(cuda):
    """A flat cache-fed build over SumEmbeddings on the card launches K1 and
    gives the CPU build's graph (per-layer edge Jaccard >= 0.99); serving
    it through the tiled cache launches K2 and finds each element's own
    vector (self top-1 by vector >= 0.95)."""
    el = _sum_embeddings(cuda, 300, 24, 2000, 6)
    cfg = g.BuildConfig(num_neighbors=12, max_search=32, neighbor_cache=True, neighbor_cache_layout="flat")
    before = gather_score_flat.launches
    card = g.build_layers(el, cfg)
    torch.cuda.synchronize()
    assert gather_score_flat.launches > before
    cpu = g.build_layers(g.SumEmbeddings(el.embeddings.cpu(), el.terms.cpu()), cfg)
    assert card.counts == cpu.counts
    for a, b in zip(card.as_numpy(), cpu.as_numpy()):
        assert _jaccard(a, b) >= 0.99
    own = el.get(torch.arange(256, device=cuda))
    before = gather_score.launches
    ids, _ = Granne(layers=card, elements=el).with_neighbor_cache("tiled").search_batch(own, 32, 1)
    assert gather_score.launches > before
    assert float(((el.get(ids[:, 0]) * own).sum(1) > 1 - 1e-5).float().mean()) >= 0.95


def test_tiered_ivf_on_card_matches_resident(cuda, tmp_path):
    """TieredIvf on the card (blocks in host memory, fetched blocks on the
    card, scored by the pair store) gives the device-resident IvfIndex's ids and
    distances bit for bit, pipelined and sequential, from from_ivf and from
    a memory-mapped load, with bf16 and int8 blocks."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((40, 48)).astype(np.float32)
    x = (centers[rng.integers(0, 40, 6000)] + 0.35 * rng.standard_normal((6000, 48))).astype(np.float32)
    batches = [x[lo : lo + 500] for lo in range(0, 2000, 500)]
    for dtype in ("bfloat16", "int8"):
        index = g.IvfIndex.build(x, n_clusters=40, kmeans_iters=5, cluster_cap=64, dtype=dtype, device=cuda)
        path = str(tmp_path / f"{dtype}.ivf")
        index.save(path)
        want = [tuple(t.cpu().numpy() for t in index.search_batch(b, 10, nprobe=8)) for b in batches]
        for t in (g.TieredIvf.from_ivf(index), g.TieredIvf.load(path)):
            assert isinstance(t.host_blocks, np.ndarray) and t.centroids.device.type == "cuda"
            stream, slots = t._streams()
            (q, blocks, ids, scales, inv), done = t._prepare(x[:8], 2, slots[0], stream)
            done.synchronize()
            assert blocks.device.type == "cuda" and blocks.dtype == index.blocks.dtype
            assert blocks.shape[0] == len(np.unique(inv.cpu().numpy())) < index.k
            before = K.ivf_score_pairs.launches
            for run in (t.search_batches, t.search_batches_sequential):
                got = list(run(batches, 10, nprobe=8))
                for (gi, gd), (wi, wd) in zip(got, want):
                    assert np.array_equal(gi, wi) and np.array_equal(gd, wd)
            assert K.ivf_score_pairs.launches == before + 2 * len(batches)


def test_trace_span_blocks_on_k1_calls(cuda):
    """``trace.span(block=True)`` around K1 calls synchronises the card before
    its clock stops: one count, a nonzero time."""
    from granne_tpu_torch.utils import trace

    n, M, d, B, E = 200_000, 20, 100, 1024, 4
    gen = torch.Generator(device=cuda).manual_seed(3)
    vecs = distance.normalize(torch.randn((n, M, d), generator=gen, device=cuda)).to(torch.bfloat16)
    tab = pack_rows(vecs, "flat", ids=torch.randint(0, n, (n, M), generator=gen, device=cuda, dtype=torch.int32))
    sel = torch.randint(0, n, (B, E), generator=gen, device=cuda, dtype=torch.int32)
    q = distance.normalize(torch.randn((B, d), generator=gen, device=cuda)).to(torch.bfloat16)
    gather_score_flat(tab, sel, q, M=M, d=d)
    torch.cuda.synchronize()
    trace.reset()
    before = gather_score_flat.launches
    with trace.span("test/k1", block=True):
        for _ in range(20):
            gather_score_flat(tab, sel, q, M=M, d=d)
    assert gather_score_flat.launches == before + 20
    got = trace.summary()["test/k1"]
    assert got["count"] == 1 and got["total_s"] > 0
    trace.reset()


def test_ivf_spans_time_the_device(cuda, monkeypatch):
    """Under a profiler every ``ivf/*`` span of a K4 search gets a device
    time: the four stages' sum within ``ivf/search``'s, ``ivf/score``'s at
    least ``slot_score_kernel``'s own in the same profile and above
    ``ivf/epilogue``'s (the -inf fill of the pair rows before the pair
    store), which runs inside it; no pair is dropped.  Pairs still
    pending when ``summary()`` is called are resolved there, and pairs
    resolved early (past the drain mark) are not lost; ``count`` adds a
    device tensor without a sync."""
    from granne_tpu_torch.utils import trace

    rng = np.random.default_rng(5)
    centers = rng.standard_normal((64, 100)).astype(np.float32)
    x = (centers[rng.integers(0, 64, 60_000)] + 0.35 * rng.standard_normal((60_000, 100))).astype(np.float32)
    index = g.IvfIndex.build(x, n_clusters=200, kmeans_iters=4, cluster_cap=256, device="cuda")
    q = torch.as_tensor(x[:4000], device=cuda)
    index.search_batch(q, 10, nprobe=8)
    torch.cuda.synchronize()
    stages = ["ivf/probe", "ivf/group", "ivf/score", "ivf/merge"]

    trace.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        index.search_batch(q, 10, nprobe=8)
    pending = len(trace._pending)
    got = trace.summary()
    assert pending == 6 and not trace._pending and sum(map(len, trace._free.values())) >= 2 * pending
    assert all(got[name]["device_s"] > 0 and got[name]["count"] == 1
               for name in ["ivf/search", "ivf/epilogue", *stages])
    assert sum(got[name]["device_s"] for name in stages) <= got["ivf/search"]["device_s"]
    kernel_s = sum(e.end_ns() - e.start_ns() for e in prof.profiler.kineto_results.events()
                   if e.device_type() != torch.autograd.DeviceType.CPU and "slot_score_kernel" in e.name()) / 1e9
    assert 0 < kernel_s <= got["ivf/score"]["device_s"]
    assert got["ivf/epilogue"]["device_s"] < got["ivf/score"]["device_s"]
    assert got["ivf/slots"]["total"] > got["ivf/blocks"]["total"] > 0
    assert got["ivf/slot_rows"]["total"] >= got["ivf/pairs"]["total"] == 4000 * 8
    assert got["ivf/dropped_pairs"]["total"] == 0

    trace.reset()
    monkeypatch.setattr(trace, "_DRAIN_AT", 0)
    with torch.profiler.profile(activities=acts):
        for _ in range(3):
            index.search_batch(q, 10, nprobe=8)
            torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            trace.count("test/on_card", (q[:, 0] > 0).sum())
        finally:
            torch.cuda.set_sync_debug_mode("default")
    got = trace.summary()
    assert all(got[name]["count"] == 3 and got[name]["device_s"] > 0 for name in ["ivf/search", *stages])
    assert got["test/on_card"]["total"] == int((q[:, 0] > 0).sum())
    trace.reset()


def test_tiled_cache_fed_group_build_on_card(cuda):
    """Four gloo ranks on cuda:0 build one graph with the tiled cache (K2 in
    every rank's beam): byte-equal layers on every rank, the one-device
    tiled cache-fed build's layer counts and edge Jaccard > 0.95 over all
    layers against it (clustered data, as ``bench.py``'s: on unclustered
    Gaussian data the two warm-up schedules alone give 0.74 on the CPU)."""
    import torch_rank_jobs as jobs
    from granne_tpu_torch.ops.kernels import nbr_score

    nbr_score.load_kernel()  # built here, before the ranks start
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((60, 48)).astype(np.float32)
    vecs = (centers[rng.integers(0, 60, 3000)] + 0.35 * rng.standard_normal((3000, 48))).astype(np.float32)
    cfg = dict(num_neighbors=16, max_search=64, wave_size=128, neighbor_cache=True, neighbor_cache_layout="tiled")
    ranks = g.run_ranks(jobs.dp_card_build_job, 4, vecs, cfg, backend="gloo", device="cuda", timeout=600)
    for out in ranks:
        assert out["k2"] > 0
        assert all(np.array_equal(a, b) for a, b in zip(out["layers"], ranks[0]["layers"]))
    one = g.build_layers(g.AngularVectors.from_raw(vecs, device=cuda), g.BuildConfig(**cfg)).as_numpy()
    mine = ranks[0]["layers"]
    assert [a.shape for a in mine] == [a.shape for a in one]
    jaccard = _jaccard([r for a in mine for r in a], [r for a in one for r in a])
    print(f"tiled cache-fed build, 4 gloo ranks on one card vs one device: edge Jaccard {jaccard}")
    assert jaccard > 0.95


# -- multi-device serving ----------------------------------------------------


def test_sharded_ivf_world_of_one_nccl_matches_resident(cuda, tmp_path):
    """A world of one rank through NCCL on cuda:0 (a spawned rank,
    ``torch_rank_jobs.world_of_one_job``): ``ShardedIvf.load`` gives the
    resident ``IvfIndex.search_batch``'s ids and distances bit for bit
    (no padding, the same K4 route, a merge of one sorted list)."""
    import torch_rank_jobs as jobs

    rng = np.random.default_rng(1)
    centers = rng.standard_normal((40, 48)).astype(np.float32)
    x = (centers[rng.integers(0, 40, 6000)] + 0.35 * rng.standard_normal((6000, 48))).astype(np.float32)
    path = str(tmp_path / "bf16.ivf")
    g.IvfIndex.build(x, n_clusters=40, kmeans_iters=5, cluster_cap=64, device=cuda).save(path)
    out = g.run_ranks(jobs.world_of_one_job, 1, path, x[:512], (4, 16, 64), backend="nccl", device="cuda",
                      timeout=300)[0]
    for nprobe, ((si, sd), (ri, rd)) in out.items():
        assert np.array_equal(si, ri) and np.array_equal(sd, rd), nprobe


def test_dryrun_nccl_world_a_gpu_a_rank(cuda):
    """The port's dry run through NCCL over every card of the host, rank r
    on ``cuda:r`` (the launcher's placement): each engine at least as good
    as the single-device search.  Needs two cards or more."""
    from granne_tpu_torch.parallel.dryrun import dryrun_multichip

    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two CUDA devices or more")
    K.load_kernel()  # built here, before the ranks start
    recalls = dryrun_multichip(world, timeout=600)
    print(f"dryrun_multichip({world}) over NCCL: {recalls}")
    jaccard = recalls.pop("dp_build_jaccard")
    assert min(recalls.values()) == recalls["single_device"] > 0.9
    assert 0.95 < jaccard <= 1.0
