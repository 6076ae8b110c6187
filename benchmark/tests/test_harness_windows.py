"""The measured window on a fake clock: every call counted, the pool sent in turn."""

import pytest
import torch
from harness.runner import Ctx
from harness.traffic import closed_batch


class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(closed_batch.time, "perf_counter", c)
    return c


def test_closed_batch_counts_every_call(clock):
    class Server:
        def __init__(self):
            self.seen = []

        def search(self, q):
            clock.now += 0.3
            self.seen.append(int(q[0, 0]))
            return torch.zeros(q.shape[0], 2, dtype=torch.int32), torch.zeros(q.shape[0], 2)

    t = {"queries_per_call": 4, "pool_calls": 3}
    queries = torch.arange(3).repeat_interleave(4)[:, None].float().expand(12, 2).contiguous()
    like = torch.zeros(4, 2, dtype=torch.int32), torch.zeros(4, 2)
    store = closed_batch.AnswerStore(*like, calls=2)  # made in set-up for 2 calls: the window outruns it
    st = closed_batch.State(torch.zeros(5, 2), queries, Server(), store)
    ctx = Ctx({}, {"traffic": t}, 1, 2.0, "cpu")
    out = closed_batch.window(ctx, st)
    assert len(st.answers) == 7  # 7 * 0.3 = 2.1 >= 2.0
    assert st.server.seen == [0, 1, 2, 0, 1, 2, 0]  # the pool in turn: no two calls in a row repeat a batch
    assert [b for b, _, _ in st.answers] == st.server.seen
    assert out["qps"] == pytest.approx(7 * 4 / 2.1)
    assert len(store.chunks) == 4 and all(ids.shape == (4, 2) for _, ids, _ in st.answers)


def test_answer_store_keeps_each_call():
    store = closed_batch.AnswerStore(torch.zeros(3, 2, dtype=torch.int32), torch.zeros(3, 2), calls=2)
    views = [store.put(i, torch.full((3, 2), i, dtype=torch.int32), torch.full((3, 2), i / 2)) for i in range(5)]
    for i, (ids, dists) in enumerate(views):
        assert int(ids[0, 0]) == i and float(dists[2, 1]) == i / 2


def test_a_shorter_pass_counts_its_own_calls(clock):
    """The gap-naming pass of a traced run: its own calls and seconds, its
    answers kept with the window's for the check."""

    class Server:
        def search(self, q):
            clock.now += 0.5
            return torch.zeros(q.shape[0], 2, dtype=torch.int32), torch.zeros(q.shape[0], 2)

    t = {"queries_per_call": 4, "pool_calls": 2}
    like = torch.zeros(4, 2, dtype=torch.int32), torch.zeros(4, 2)
    st = closed_batch.State(torch.zeros(5, 2), torch.zeros(8, 2), Server(), closed_batch.AnswerStore(*like, calls=4))
    ctx = Ctx({}, {"traffic": t}, 1, 2.0, "cpu")
    assert closed_batch.window(ctx, st)["qps"] == pytest.approx(4 * 4 / 2.0)
    assert closed_batch.window(ctx, st, 1.0)["qps"] == pytest.approx(2 * 4 / 1.0)
    assert len(st.answers) == 6 and [b for b, _, _ in st.answers] == [0, 1, 0, 1, 0, 1]
