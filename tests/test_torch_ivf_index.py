"""granne_tpu_torch's IVF index construction (index/ivf.py) against
granne_tpu's: the block layout, the files and ``append``.

The same numpy inputs (fixed seeds) go to both packages on the CPU.  Given
one k-means result, the layout is bit-identical, and so are the files
(in both directions) and the appended index.
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import granne_tpu.index.ivf as jivf
import granne_tpu.ops.kmeans as jkmeans
from composed_epilogue import composed_pair_rows
from granne_tpu_torch import IvfIndex, convert
from granne_tpu_torch.index import ivf
from granne_tpu_torch.ops import kmeans
from granne_tpu_torch.ops.kernels import ivf_score


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_jax():
    """Drop every compiled JAX program before and after this module: each
    XLA:CPU executable holds memory maps, and one test process that runs
    many JAX-heavy files can reach vm.max_map_count and crash."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _t(x):
    return torch.as_tensor(np.array(x))


def _clustered(rng, n, d, c=30, sigma=0.3):
    centers = rng.standard_normal((c, d)).astype(np.float32)
    return (centers[rng.integers(0, c, n)] + sigma * rng.standard_normal((n, d))).astype(np.float32)


def _exactly_normalizable(rng, n, d=32):
    """Rows of 16 entries of +-1 (norm exactly 4) times a power of two, so
    both packages normalize them to the same bits (+-0.25)."""
    x = np.zeros((n, d), np.float32)
    for i in range(n):
        x[i, rng.choice(d, 16, replace=False)] = rng.choice([-1.0, 1.0], 16)
    return x * (2.0 ** rng.integers(-3, 4, (n, 1))).astype(np.float32)


def _jax_to_port(j) -> IvfIndex:
    return convert.ivf_from_numpy(
        np.asarray(j.centroids), np.asarray(j.blocks), np.asarray(j.block_ids), np.asarray(j.block_scales),
        j.n_total, device="cpu",
    )


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_build_layout_bit_identical_given_the_same_kmeans(rng, monkeypatch, dtype):
    """With one (centroids, assignment) handed to both, blocks, ids,
    centroids and scales are bit-identical; a cluster larger than L spans
    several blocks with duplicated centroid rows."""
    x = _exactly_normalizable(rng, 700)
    cent = rng.standard_normal((9, 32)).astype(np.float32)
    assign = rng.integers(0, 9, 700).astype(np.int32)
    assign[:150] = 3  # one cluster of >= 150 members: at least 3 blocks of 56
    assign[assign == 7] = 0  # one empty cluster: still one block
    monkeypatch.setattr(jkmeans, "train_kmeans", lambda *a, **k: (jnp.asarray(cent), jnp.asarray(assign)))
    monkeypatch.setattr(kmeans, "train_kmeans", lambda *a, **k: (_t(cent), _t(assign)))
    j = jivf.IvfIndex.build(x, n_clusters=9, cluster_cap=52, dtype=dtype)
    t = IvfIndex.build(x, n_clusters=9, cluster_cap=52, dtype=dtype, device="cpu")
    assert t.cluster_cap == 56 and t.k == j.k
    assert np.array_equal(t.centroids.numpy(), np.asarray(j.centroids))
    assert np.array_equal(t.block_ids.numpy(), np.asarray(j.block_ids))
    assert np.array_equal(t.block_scales.numpy(), np.asarray(j.block_scales))
    jb = np.asarray(j.blocks)
    if dtype == "bfloat16":
        jb, tb = jb.view(np.int16), t.blocks.view(torch.int16).numpy()
    else:
        tb = t.blocks.numpy()
    assert t.blocks.dtype == ivf._DTYPES[dtype] and np.array_equal(tb, jb)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_save_load_byte_identical_both_ways(rng, tmp_path, dtype):
    j = jivf.IvfIndex.build(_clustered(rng, 600, 16), n_clusters=8, kmeans_iters=2, cluster_cap=48, dtype=dtype)
    jpath, tpath, back = (str(tmp_path / f) for f in ("j.ivf", "t.ivf", "back.ivf"))
    j.save(jpath)
    t = IvfIndex.load(jpath, device="cpu")  # JAX file -> port
    assert t.blocks.dtype == ivf._DTYPES[dtype] and t.n_total == 600
    t.save(tpath)
    assert filecmp.cmp(jpath, tpath, shallow=False)
    jt = jivf.IvfIndex.load(tpath)  # port file -> JAX
    jt.save(back)
    assert filecmp.cmp(jpath, back, shallow=False)
    conv = _jax_to_port(j)
    for a, b in ((t.blocks, conv.blocks), (t.block_ids, conv.block_ids), (t.block_scales, conv.block_scales)):
        assert torch.equal(a, b)


def test_append_matches_jax(rng):
    """Appending the same vectors to the same index: bit-identical
    centroids, blocks, ids and scales (fill-before-spill and the new
    spill blocks alike), for bf16 and int8 storage."""
    base = _exactly_normalizable(rng, 500)
    new = _exactly_normalizable(rng, 260)
    new[:120] = base[:120] * 2.0  # near an existing cluster: fills, then spills
    for dtype in ("bfloat16", "int8"):
        j = jivf.IvfIndex.build(base, n_clusters=8, kmeans_iters=3, cluster_cap=40, dtype=dtype)
        ja = j.append(new)
        ta = _jax_to_port(j).append(new)
        assert ta.n_total == ja.n_total == 760
        want = _jax_to_port(ja)
        assert ta.k > j.k  # some run spilled into fresh blocks
        for name in ("centroids", "block_ids", "block_scales"):
            assert torch.equal(getattr(ta, name), getattr(want, name)), name
        assert torch.equal(ta.blocks.view(torch.int16) if dtype == "bfloat16" else ta.blocks,
                           want.blocks.view(torch.int16) if dtype == "bfloat16" else want.blocks)
    with pytest.raises(ValueError, match="dimension mismatch"):
        ta.append(np.ones((2, 5), np.float32))


# -- the top-k route -----------------------------------------------------------


@pytest.mark.parametrize("k,cols,route", [(1, 40, "kernel"), (32, 40, "kernel"), (33, 40, "sort"), (8, 5, "sort")])
def test_ranked_sends_narrow_k_to_the_row_kernel_and_wide_k_to_the_sort(rng, monkeypatch, k, cols, route):
    """``ranked`` takes ``row_top_k`` for k <= min(C, K_MAX) and the whole-row
    sort past that, with the same answers, and while a profiler records
    counts the rows of each route."""
    from granne_tpu_torch.ops.kernels import row_topk
    from granne_tpu_torch.ops.topk import top_k
    from granne_tpu_torch.utils import trace

    calls = []
    monkeypatch.setattr(ivf, "row_top_k", lambda s, kk: (calls.append("kernel"), row_topk.row_top_k(s, kk))[1])
    monkeypatch.setattr(ivf, "top_k", lambda s, kk: (calls.append("sort"), top_k(s, kk))[1])
    x = torch.as_tensor(np.round(rng.standard_normal((6, cols)) * 2).astype(np.float32))
    trace.reset()
    got = ivf.ranked(x, k)
    assert calls == [route] and trace.summary() == {}
    want = top_k(x, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with _cpu_profile():
        ivf.ranked(x, k)
    assert trace.summary() == {f"topk/{route}_rows": {"total": 6}}
    trace.reset()


def _exact_unit_rows(rng, n):
    """Rows of 16 entries of +-1 times a power of two: unit rows of +-0.25
    in either package, whose dots (bf16 or f32) are exact multiples of
    1/16, so both packages score them bit for bit and tie often."""
    return rng.choice([-1.0, 1.0], (n, 16)).astype(np.float32) * (2.0 ** rng.integers(-3, 4, (n, 1))).astype(np.float32)


@pytest.mark.parametrize("route", ["k4", "k5", "ungrouped"])
def test_search_over_split_clusters_equals_jax_probes_and_ids(rng, route):
    """Clusters larger than L span several blocks, each with a copy of the
    cluster's centroid row, so a query's centroid scores tie exactly (and
    its element scores, all multiples of 1/16, tie often): the port probes
    the same blocks as ``lax.top_k`` and returns JAX's ids and distances
    exactly, on the grouped (K4 and K5 plain versions) and ungrouped routes."""
    x = _exact_unit_rows(rng, 1500)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    cent = xn[rng.choice(1500, 6, replace=False)]
    blocks, ids, pcent = ivf.layout_blocks(xn, cent, np.argmax(xn @ cent.T, axis=1), 6, 64)
    assert len(pcent) >= 24  # ~250 members a cluster: every cluster split
    t = IvfIndex._from_f32_blocks(blocks, ids, pcent, 1500, "bfloat16", torch.device("cpu"))
    jargs = (jnp.asarray(pcent), jnp.asarray(blocks, jnp.bfloat16), jnp.asarray(ids), jnp.ones(ids.shape, jnp.float32))
    q = _exact_unit_rows(np.random.default_rng(7), 96)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    nprobe, k_out = 8, 10

    probes = ivf._probe(torch.as_tensor(qn), t.centroids, nprobe)
    jprobes = jax.lax.top_k(jnp.asarray(qn) @ jnp.asarray(pcent).T, nprobe)[1]
    assert np.array_equal(probes.numpy(), np.asarray(jprobes))
    cs = qn @ pcent.T
    assert (cs[:, :, None] == cs[:, None, :]).sum() > 2 * cs.size  # ties beyond the diagonal

    targs = (t.centroids, t.blocks, t.block_ids, t.block_scales, torch.as_tensor(qn))
    if route == "ungrouped":
        got = ivf._ivf_search(*targs, nprobe=nprobe, k_out=k_out, query_chunk=40)
        want = jivf._ivf_search(*jargs, jnp.asarray(qn), nprobe=nprobe, k_out=k_out, query_chunk=40)
    else:
        S = ivf.slot_count(t.k, len(q), nprobe, 16)
        kw = dict(nprobe=nprobe, k_out=k_out, group_cap=16, num_slots=S)
        got = ivf._ivf_search_grouped(*targs, use_pallas_topk=route == "k5", **kw)
        want = jivf._ivf_search_grouped(*jargs, jnp.asarray(qn), use_pallas_topk=route == "k5", **kw)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("route", ["k4", "k3", "k5"])
def test_search_with_too_few_slots_equals_jax(rng, route):
    """With ``num_slots`` below ``slot_count``'s, some pairs are held by no
    slot: their rows stay -inf in the merge, so queries whose probes are
    mostly dropped return (-1, inf) past their last candidate.  Ids and
    distances equal JAX's grouped search with the same slots, on the pair
    store's routes (K4 and K3) and K5's."""
    x = _exact_unit_rows(rng, 1500)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    cent = xn[rng.choice(1500, 6, replace=False)]
    blocks, ids, pcent = ivf.layout_blocks(xn, cent, np.argmax(xn @ cent.T, axis=1), 6, 64)
    t = IvfIndex._from_f32_blocks(blocks, ids, pcent, 1500, "int8", torch.device("cpu"))
    jargs = (jnp.asarray(pcent), jnp.asarray(t.blocks.numpy()), jnp.asarray(ids), jnp.asarray(t.block_scales.numpy()))
    q = _exact_unit_rows(np.random.default_rng(9), 64)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    nprobe, k_out, cap, S = 6, 10, 8, 12
    assert S < ivf.slot_count(t.k, len(q), nprobe, cap)
    kw = dict(nprobe=nprobe, k_out=k_out, group_cap=cap, num_slots=S)
    targs = (t.centroids, t.blocks, t.block_ids, t.block_scales, torch.as_tensor(qn))
    got = ivf._ivf_search_grouped(*targs, use_pallas_topk=route == "k5", slot_group=1 if route == "k3" else 8, **kw)
    want = jivf._ivf_search_grouped(*jargs, jnp.asarray(qn), use_pallas_topk=route == "k5", **kw)
    assert (got[0] == -1).any() and torch.isinf(got[1]).any()  # some queries lost most of their pairs
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


def _pair_store_case(rng, dtype, num_slots=None, cap=4):
    """A grouped search's slot inputs over blocks with padding rows (ids -1)
    and, for int8, real row scales: 60 queries probing 5 of the blocks, a
    third of them block 0 (hot: spilled into several slots at ``cap`` 4),
    so some slot places are empty; ``num_slots`` below ``slot_count``'s
    drops pairs."""
    x = rng.standard_normal((12 * 40, 24)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    assign = np.repeat(np.arange(12), 40)
    assign[::7] = 3
    blocks, ids, cent = ivf.layout_blocks(x, x[:12], assign, 12, 48)
    t = IvfIndex._from_f32_blocks(blocks, ids, cent, len(x), dtype, torch.device("cpu"))
    q = torch.as_tensor(rng.standard_normal((60, 24)).astype(np.float32))
    q = q / q.norm(dim=1, keepdim=True)
    probes = torch.as_tensor(np.stack([
        np.r_[0, 1 + rng.choice(t.k - 1, 4, replace=False)] if i % 3 == 0 else rng.choice(t.k, 5, replace=False)
        for i in range(60)
    ]))
    S = num_slots or ivf.slot_count(t.k, 60, 5, cap)
    return t, probes, ivf.slot_groups(q, probes, t.blocks, group_cap=cap, num_slots=S)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("slots", ["slot_count", "too_few"])
def test_pair_store_plain_equals_the_composed_epilogue(rng, dtype, slots):
    """``ivf_score_pairs``'s plain version (the wrapper on CPU tensors)
    equals, bit for bit, the plain K4 scores followed by the scale, the
    mask, the row gather and the scatter to the pairs, over padding rows,
    empty places, spilled hot blocks (group cap 4) and, with too few slots,
    dropped pairs; rows of pairs that no slot holds keep the buffer's fill."""
    t, probes, slot_inputs = _pair_store_case(rng, dtype, num_slots=10 if slots == "too_few" else None)
    safe_keys, qg, slot_pairs, item_slot = slot_inputs[:4]
    P, L = probes.numel(), t.cluster_cap
    assert int((safe_keys == 0).sum()) >= 2  # a spilled hot block
    assert (slot_pairs < 0).any()  # empty places
    assert bool((t.block_ids < 0).any())
    assert ((item_slot < 0).any()) == (slots == "too_few")
    want = composed_pair_rows(ivf_score.ivf_score_slots_reference(t.blocks, safe_keys, qg), t.block_ids,
                              t.block_scales, slot_inputs, P)
    for group in (1, 3, 8):
        got = ivf_score.ivf_score_pairs(t.blocks, t.block_ids, t.block_scales, safe_keys, qg, slot_pairs,
                                        torch.full((P, L), -torch.inf), group=group)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    kept = ivf_score.ivf_score_pairs(t.blocks, t.block_ids, t.block_scales, safe_keys, qg, slot_pairs,
                                     torch.full((P, L), 7.0))
    held = torch.zeros(P, dtype=torch.bool)
    held[slot_pairs[slot_pairs >= 0].long()] = True
    assert torch.equal(kept[held], want[held]) and bool((kept[~held] == 7.0).all())
    assert int((~held).sum()) == int((item_slot < 0).sum())


# -- spans and counters -----------------------------------------------------

STAGES = ["ivf/probe", "ivf/group", "ivf/score", "ivf/merge"]
ROUTES = {"k4": {}, "k3": {"slot_group": 1}, "k5": {"fused_topk": True}}


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("route", list(ROUTES))
def test_search_spans_nest_in_order_and_count_slots_and_blocks(rng, route):
    """Under a profiler one grouped search opens each ``ivf/*`` span once, as
    user annotations, the four stages inside ``ivf/search`` in the order
    probe, group, score, merge, and ``ivf/epilogue`` inside ``ivf/score``;
    ``ivf/slots`` is ``slot_count``'s and ``ivf/blocks`` the distinct
    probed blocks (some hot blocks spill into further slots at a group cap
    of 4), ``ivf/pairs`` the queries times nprobe, ``ivf/slot_rows`` the
    slots times the cap and ``ivf/dropped_pairs`` the pairs that no slot
    holds (none at ``slot_count``'s sizing).  The answers are bit-identical
    with and without the profiler, and off it nothing is counted."""
    from granne_tpu_torch.ops import distance
    from granne_tpu_torch.utils import trace

    x = _clustered(rng, 3000, 16, c=12)
    index = IvfIndex.build(x, n_clusters=48, kmeans_iters=3, cluster_cap=64, device="cpu")
    q, nprobe, cap = x[:40], 3, 4
    kw = dict(nprobe=nprobe, group_cap=cap, **ROUTES[route])
    trace.reset()
    plain = index.search_batch(q, 10, **kw)
    assert all("device_s" not in v and "total" not in v for v in trace.summary().values())
    trace.reset()
    with _cpu_profile() as prof:
        assert trace.recording()
        traced = index.search_batch(q, 10, **kw)
    assert not trace.recording()
    assert torch.equal(plain[0], traced[0]) and torch.equal(plain[1], traced[1])

    got = trace.summary()
    probes = ivf._probe(distance.normalize(torch.as_tensor(q)), index.centroids, nprobe)
    blocks = torch.unique(probes).numel()
    slots = ivf.slot_count(index.k, len(q), nprobe, cap)
    assert got.pop("ivf/slots") == {"total": slots} and got.pop("ivf/blocks") == {"total": blocks}
    assert got.pop("ivf/pairs") == {"total": len(q) * nprobe}
    assert got.pop("ivf/slot_rows") == {"total": slots * cap}
    held = int((ivf.slot_groups(distance.normalize(torch.as_tensor(q)), probes, index.blocks, group_cap=cap,
                                num_slots=slots)[2] >= 0).sum())
    assert got.pop("ivf/dropped_pairs") == {"total": len(q) * nprobe - held} == {"total": 0}
    assert got.pop("topk/kernel_rows") == {"total": 2 * len(q)}  # the probe's rows and the merge's
    assert blocks < index.k and slots > blocks
    assert sorted(got) == sorted(["ivf/search", "ivf/epilogue", *STAGES])
    assert all(v["count"] == 1 and "device_s" not in v for v in got.values())

    spans = {e.name(): (e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.name().startswith("ivf/") and e.is_user_annotation()}
    assert sorted(spans) == sorted(got)
    lo, hi = spans["ivf/search"]
    edges = [lo] + [t for name in STAGES for t in spans[name]] + [hi]
    assert edges == sorted(edges)
    (s0, s1), (e0, e1) = spans["ivf/score"], spans["ivf/epilogue"]
    assert s0 <= e0 <= e1 <= s1
    trace.reset()


@pytest.mark.parametrize("route", list(ROUTES))
def test_search_of_cpu_queries_captures_no_graph(rng, route):
    """``graph`` (the default) takes CUDA queries only: on the CPU each
    route answers op by op, bit for bit as with ``graph=False``, and the
    index holds no graph."""
    x = _clustered(rng, 3000, 16, c=12)
    index = IvfIndex.build(x, n_clusters=48, kmeans_iters=3, cluster_cap=64, device="cpu")
    kw = dict(nprobe=3, group_cap=4, **ROUTES[route])
    ids, dists = index.search_batch(x[:40], 10, **kw)
    want_ids, want_d = index.search_batch(x[:40], 10, graph=False, **kw)
    assert torch.equal(ids, want_ids) and torch.equal(dists, want_d)
    assert not index._graphs


def test_replay_captures_a_key_once_and_keeps_the_most_recently_used(monkeypatch):
    """``_replay``'s bookkeeping, with a stand-in for the CUDA capture: a
    key's graph is captured once and replayed after; each input is copied
    into the graph's buffer before its replay; the answers are copies, so
    the next replay leaves them as they were; and only the ``GRAPHS_KEPT``
    most recently used keys keep a graph."""
    from collections import OrderedDict

    captures = []

    class StandIn:  # replays by running ``run`` on its buffer into its outputs
        def __init__(self, run, x_in):
            self.run, self.x_in, self.outs = run, x_in, run(x_in)

        def replay(self):
            for out, new in zip(self.outs, self.run(self.x_in)):
                out.copy_(new)

    def capture(run, x):
        captures.append(x.clone())
        graph = StandIn(run, x.clone())
        return graph, graph.x_in, graph.outs

    monkeypatch.setattr(ivf, "_capture", capture)
    monkeypatch.setattr(ivf, "GRAPHS_KEPT", 2)
    graphs = OrderedDict()
    run = lambda x: (x * 2, x + 1)  # noqa: E731
    a, b, c = (torch.full((3,), float(v)) for v in (1, 2, 3))
    first = ivf._replay(graphs, "a", run, a)
    second = ivf._replay(graphs, "a", run, b)
    assert len(captures) == 1
    assert torch.equal(first[0], a * 2) and torch.equal(first[1], a + 1)
    assert torch.equal(second[0], b * 2) and torch.equal(second[1], b + 1)
    ivf._replay(graphs, "b", run, c)
    ivf._replay(graphs, "a", run, c)
    ivf._replay(graphs, "c", run, a)
    assert list(graphs) == ["a", "c"] and len(captures) == 3
    assert torch.equal(ivf._replay(graphs, "a", run, c)[0], c * 2) and len(captures) == 3


def _reader(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_benchmark_readers_of_the_ivf_spans():
    """The six readers of the ``ivf/*`` spans and counters: milliseconds a
    1,000 queries from ``device_s``, slots over blocks, and the window's
    share outside the search calls; nothing from a summary without them
    (a program without the spans, or a run off the card)."""
    from types import SimpleNamespace

    spans = {name: {"total_s": 1.0, "count": 3, "device_s": s}
             for name, s in zip(STAGES + ["ivf/search"], [0.5, 0.1, 0.2, 0.3, 1.5])}
    spans.update({"ivf/slots": {"total": 900}, "ivf/blocks": {"total": 600}})
    m = SimpleNamespace(trace=SimpleNamespace(window_s=2.0), spans=spans, counts={"queries": 20_000})
    for name, want in zip(STAGES, [25.0, 5.0, 10.0, 15.0]):
        assert _reader(f"{name[4:]}_ms_per_kq.ivf_serve")(m) == pytest.approx(want)
    assert _reader("slot_reads_per_block.ivf_serve")(m) == pytest.approx(1.5)
    assert _reader("between_calls_idle_pct.serve")(m) == pytest.approx(25.0)
    host_only = {name: {"total_s": 1.0, "count": 3} for name in STAGES + ["ivf/search"]}
    for spans in ({}, host_only):
        bare = SimpleNamespace(trace=SimpleNamespace(window_s=2.0), spans=spans, counts={"queries": 20_000})
        for name in ["probe", "group", "score", "merge"]:
            assert _reader(f"{name}_ms_per_kq.ivf_serve")(bare) is None
        assert _reader("slot_reads_per_block.ivf_serve")(bare) is None
        assert _reader("between_calls_idle_pct.serve")(bare) is None
