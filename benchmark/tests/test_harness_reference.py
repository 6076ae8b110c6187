"""The generator's determinism, and the reference against a NumPy brute force."""

import numpy as np
import pytest
import torch
from harness import data, reference

DATA = {"d": 16, "centres": 20, "centres_seed": 0, "sigma": 0.35}


def test_same_seed_same_inputs():
    a = data.make(DATA, 2**31 + 5, 500, 40, "cpu")
    b = data.make(DATA, 2**31 + 5, 500, 40, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = data.make(DATA, 2**31 + 6, 500, 40, "cpu")
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[1], c[1])
    d = data.make({**DATA, "centres_seed": 1}, 2**31 + 5, 500, 40, "cpu")
    assert not torch.equal(a[0], d[0])


def test_queries_do_not_depend_on_the_corpus_size():
    assert torch.equal(data.make(DATA, 7, 300, 40, "cpu")[1], data.make(DATA, 7, 900, 40, "cpu")[1])


def test_shapes_and_blobs():
    corpus, queries = data.make(DATA, 11, 2000, 64, "cpu")
    assert corpus.shape == (2000, 16) and queries.shape == (64, 16) and corpus.dtype == torch.float32
    # every vector lies near a centre: sigma * sqrt(d) from its nearest of 20
    centres = torch.randn((20, 16), generator=data.generator(DATA["centres_seed"], "cpu"))
    nearest = torch.cdist(corpus, centres).min(dim=1).values
    assert float(nearest.mean()) == pytest.approx(0.35 * np.sqrt(16), rel=0.1)


def test_large_and_negative_seeds():
    data.make(DATA, 2**40 + 3, 10, 2, "cpu")
    data.make(DATA, -1, 10, 2, "cpu")


@pytest.mark.parametrize("k", [1, 10])
def test_exact_topk_against_numpy(k):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((700, 24)).astype(np.float32)
    q = rng.standard_normal((37, 24)).astype(np.float32)
    xn = reference.normalize(torch.from_numpy(x))
    qn = reference.normalize(torch.from_numpy(q))
    ids, dists = reference.exact_topk(xn, qn, k)
    xu = x / np.linalg.norm(x, axis=1, keepdims=True)
    qu = q / np.linalg.norm(q, axis=1, keepdims=True)
    d = np.maximum(1.0 - qu.astype(np.float64) @ xu.T.astype(np.float64), 0.0)
    want = np.argsort(d, axis=1, kind="stable")[:, :k]
    assert np.array_equal(ids.numpy(), want)
    assert np.allclose(dists.numpy(), np.take_along_axis(d, want, axis=1), atol=1e-6)


def test_exact_topk_in_blocks(monkeypatch):
    monkeypatch.setattr(reference, "_BLOCK_ELEMS", 700 * 5)  # 5 queries a block
    xn = reference.normalize(torch.randn(700, 8, generator=torch.Generator().manual_seed(1)))
    qn = reference.normalize(torch.randn(23, 8, generator=torch.Generator().manual_seed(2)))
    ids, _ = reference.exact_topk(xn, qn, 4)
    assert torch.equal(ids, torch.topk(qn @ xn.T, 4, dim=1).indices)


def test_id_dists_and_zero_rows():
    x = torch.tensor([[3.0, 4.0], [0.0, 0.0], [0.0, 2.0]])
    xn = reference.normalize(x)
    assert torch.equal(xn[1], torch.zeros(2))
    qn = reference.normalize(torch.tensor([[0.0, 1.0]]))
    d = reference.id_dists(xn, qn, torch.tensor([[0, 1, 2]]))
    assert torch.allclose(d, torch.tensor([[1.0 - 0.8, 1.0, 0.0]]))


def test_full_f32_turns_tf32_off_and_restores(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with reference.full_f32():
        assert torch.backends.cuda.matmul.allow_tf32 is False and torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is True
