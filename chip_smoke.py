#!/usr/bin/env python3
"""On-card smoke run of granne_tpu_torch: the quickest proof that the port
starts and is right on an NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

1. Builds every CUDA kernel of the main path from ``granne_tpu_torch/csrc``
   (and the shared adjacency codec with g++).
2. K1 (``gather_score_flat``) against its plain PyTorch version on the card
   at the serve shape n=200,000, M=20, d=100, B=1024, E in {1, 4}: ids
   exactly equal, dots within 1e-4 (both sum exact bf16 products in f32 and
   differ only in summation order), finite dots on half-unfilled rows, and
   both times from CUDA events.
3. The main path through the public API: ``GranneBuilder.append`` ->
   ``build`` -> ``save_index`` (compressed) / ``save_elements`` ->
   ``load_granne`` -> bf16 copy + flat neighbor cache -> ``search_batch``,
   on the synthetic data of ``bench.py`` (1000 Gaussian centres, sigma 0.35,
   seed 42; 200,000 x 100 with 4,096 held-out queries), M=20, build ef=100.
   Recall@10 against exact f32 ground truth must reach 0.95 at some
   ef <= 120, and the search must have launched K1.

Any failed phase exits non-zero.  The last two lines of stdout are the
kernel table and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

N, D, N_QUERIES, K = 200_000, 100, 4096, 10
M, BUILD_EF, WAVE, EXPAND = 20, 100, 1024, 4
SERVE_B = 1024
EFS = (32, 40, 60, 80, 120)
TARGET_RECALL = 0.95
K1_ATOL = 1e-4
TIMED_LAUNCHES = 50


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, args_list, torch) -> float:
    """Mean device milliseconds per call of ``fn`` over ``args_list``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for args in args_list:
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(args_list)


def k1_phase(torch):
    """K1 vs its plain version at the serve shape.  Returns the kernel record."""
    from granne_tpu_torch.ops import distance
    from granne_tpu_torch.ops.kernels.nbr_score import gather_score_flat, gather_score_flat_reference
    from granne_tpu_torch.ops.nbr_cache import pack_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    vecs = distance.normalize(torch.randn((N, M, D), generator=gen, device=dev)).to(torch.bfloat16)
    adj = torch.randint(0, N, (N, M), generator=gen, device=dev, dtype=torch.int32)
    adj[::2, M // 2 :] = -1  # every other row half-unfilled: -1 embeds as bf16 NaN lanes
    adj[1, :3] = torch.tensor([0x7F85, 0xFF90, 0x1FF85], dtype=torch.int32)  # NaN-pattern halves
    tab = pack_rows(vecs, "flat", ids=adj)
    del vecs
    rec = {"max_abs_err": 0.0}
    for E in (1, 4):
        sels = [
            torch.randint(-2, N, (SERVE_B, E), generator=gen, device=dev, dtype=torch.int32)
            for _ in range(TIMED_LAUNCHES)
        ]
        q = distance.normalize(torch.randn((SERVE_B, D), generator=gen, device=dev)).to(torch.bfloat16)
        ref_d, ref_n = gather_score_flat_reference(tab, sels[0], q, M=M, d=D)
        ker_d, ker_n = gather_score_flat(tab, sels[0], q, M=M, d=D)
        torch.cuda.synchronize()
        if not torch.equal(ker_n, ref_n):
            fail(f"K1 ids differ from the plain version at E={E}")
        if not bool(torch.isfinite(ker_d).all()):
            fail(f"K1 gave non-finite dots at E={E} (NaN id lanes leaked)")
        err = float((ker_d - ref_d).abs().max())
        if err > K1_ATOL:
            fail(f"K1 dots differ from the plain version by {err} > {K1_ATOL} at E={E}")
        args = [(tab, s, q) for s in sels]
        kernel = lambda t, s, qq: gather_score_flat(t, s, qq, M=M, d=D)  # noqa: E731
        plain = lambda t, s, qq: gather_score_flat_reference(t, s, qq, M=M, d=D)  # noqa: E731
        cuda_ms(kernel, args[:3], torch)
        cuda_ms(plain, args[:3], torch)
        # plain, kernel, kernel, plain: both sides see the same drift
        p1, k1, k2, p2 = (cuda_ms(f, args, torch) for f in (plain, kernel, kernel, plain))
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"K1 B={SERVE_B} E={E}: max_abs_err={err} kernel_ms={ms} plain_ms={plain_ms}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if E == 1:  # the main path serves with expand=1
            rec.update(ms=ms, plain_ms=plain_ms)
    del tab
    torch.cuda.empty_cache()
    return rec


def bench_data():
    """bench.py's synthetic generator, verbatim (seed 42)."""
    rng = np.random.default_rng(42)
    n_clusters = 1000
    centers = rng.standard_normal((n_clusters, D)).astype(np.float32)
    assign = rng.integers(0, n_clusters, N)
    vecs = (centers[assign] + 0.35 * rng.standard_normal((N, D))).astype(np.float32)
    queries = (
        centers[rng.integers(0, n_clusters, N_QUERIES)]
        + 0.35 * rng.standard_normal((N_QUERIES, D))
    ).astype(np.float32)
    return vecs, queries


def exact_topk(torch, elements, queries):
    """Exact f32 top-K ids by cosine: a check, computed on the card."""
    from granne_tpu_torch.ops import distance

    qn = distance.normalize(torch.as_tensor(queries, device="cuda"))
    out = []
    for lo in range(0, qn.shape[0], SERVE_B):
        dots = qn[lo : lo + SERVE_B] @ elements.vectors.T
        out.append(dots.topk(K, dim=1).indices)
    return torch.cat(out).cpu().numpy()


def search_all(torch, index, queries, ef):
    """Search every query in batches of SERVE_B; (ids, dists) on the card."""
    out = [
        index.search_batch(queries[lo : lo + SERVE_B], max_search=ef, num_neighbors=K)
        for lo in range(0, len(queries), SERVE_B)
    ]
    ids, dists = torch.cat([i for i, _ in out]), torch.cat([d for _, d in out])
    torch.cuda.synchronize()
    return ids, dists


def main_path(torch, g):
    from granne_tpu_torch.index.granne import Granne
    from granne_tpu_torch.ops.kernels.nbr_score import gather_score_flat

    vecs, queries = bench_data()
    gather_score_flat.launches = 0  # count the main path's launches only

    builder = g.GranneBuilder(
        "angular", num_neighbors=M, max_search=BUILD_EF, wave_size=WAVE, expand=EXPAND,
        show_progress=True, device="cuda",
    )
    for lo in range(0, N, 50_000):
        builder.append(vecs[lo : lo + 50_000])
    t = time.perf_counter()
    builder.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    counts = [builder.layer_len(i) for i in range(builder.num_layers)]
    log(f"build: n={N} d={D} M={M} ef={BUILD_EF} wave={WAVE} expand={EXPAND} "
        f"seconds={build_s} vectors_per_s={N / build_s} layer_counts={counts}")
    if counts[-1] != N:
        fail(f"bottom layer holds {counts[-1]} of {N} elements")

    out_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    ipath, epath = os.path.join(out_dir, "index.gtz"), os.path.join(out_dir, "elements.gt")
    builder.save_index(ipath, compressed=True)
    builder.save_elements(epath)
    loaded = g.load_granne(ipath, epath, device="cuda")
    built = builder.get_index()
    for a, b in zip(built.layers.as_numpy(), loaded.layers.as_numpy()):
        if not np.array_equal(np.sort(a, axis=1), np.sort(b, axis=1)):  # the codec sorts rows
            fail("the loaded index differs from the built one")
    if not torch.equal(built.elements.vectors, loaded.elements.vectors):
        fail("the loaded elements differ from the built ones")
    log(f"save/load: index {os.path.getsize(ipath)} bytes (compressed), "
        f"elements {os.path.getsize(epath)} bytes; round trip equal")

    gt = exact_topk(torch, loaded.elements, queries)
    serve = Granne(layers=loaded.layers, elements=loaded.elements.as_bf16()).with_neighbor_cache("flat")
    del built, builder
    chosen = None
    for ef in EFS:
        ids, dists = search_all(torch, serve, queries, ef)
        if not bool(torch.isfinite(dists[ids >= 0]).all()):
            fail(f"non-finite distances at ef={ef}")
        ids = ids.cpu().numpy()
        if ids.shape != (N_QUERIES, K) or ids.min() < -1 or ids.max() >= N:
            fail(f"malformed search result at ef={ef}: shape {ids.shape}")
        recall = float(np.mean([len(set(ids[i]) & set(gt[i])) / K for i in range(N_QUERIES)]))
        log(f"search ef={ef}: recall@{K}={recall}")
        if chosen is None and recall >= TARGET_RECALL:
            search_all(torch, serve, queries, ef)  # warm
            t = time.perf_counter()
            search_all(torch, serve, queries, ef)
            qps = N_QUERIES / (time.perf_counter() - t)
            chosen = dict(ef=ef, recall=recall, qps=qps)
            log(f"serve bf16+flat cache: ef={ef} recall@{K}={recall} qps={qps} (batch {SERVE_B})")
    if chosen is None:
        fail(f"recall@{K} stayed below {TARGET_RECALL} for every ef in {EFS}")
    launches = gather_score_flat.launches
    if launches <= 0:
        fail("the main path never launched gather_score_flat")
    log(f"gather_score_flat launches in the main path: {launches}")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs on the card only")
    try:
        import granne_tpu_torch as g
    except ImportError as e:
        fail(f"granne_tpu_torch not importable next to this script: {e}")
    if not os.path.abspath(g.__file__).startswith(REPO + os.sep):
        fail(f"granne_tpu_torch comes from {g.__file__}, not from this checkout")
    from granne_tpu_torch.native import get_lib as load_codec
    from granne_tpu_torch.ops import distance
    from granne_tpu_torch.ops.kernels.nbr_score import load_kernel

    distance.full_f32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    load_kernel()
    k1_build = time.perf_counter() - t
    t = time.perf_counter()
    load_codec()
    log(f"build: nbr_score.cu (nvcc) {k1_build} s, codec.cpp (g++) {time.perf_counter() - t} s")

    rec = k1_phase(torch)
    launches = main_path(torch, g)
    if "jax" in sys.modules or "granne_tpu" in sys.modules:
        fail("the port pulled in jax or the JAX package")

    kernels = [{
        "name": "gather_score_flat",
        "route": "cuda",
        "source": "granne_tpu_torch/csrc/nbr_score.cu",
        "replaces": "granne_tpu/ops/pallas/nbr_score.py:342",
        "launches": launches,
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
