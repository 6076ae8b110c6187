"""K1 on the card: the CUDA kernel against its plain PyTorch version.

Needs an NVIDIA GPU and nvcc; every test skips elsewhere.  This file imports
no jax, so it runs on a machine that has only the port's dependencies:

    python -m pytest -p no:xdist -p no:cacheprovider --noconftest -o addopts="" tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import granne_tpu_torch as g
from granne_tpu_torch.index.granne import Granne
from granne_tpu_torch.ops import distance
from granne_tpu_torch.ops.kernels.nbr_score import gather_score_flat, gather_score_flat_reference
from granne_tpu_torch.ops.nbr_cache import pack_rows

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
        (32, 64, 512, 9, 2),  # one row needs more than 48 KB of shared memory
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
