"""The loop's prefetch and eval cache on the CPU (``train/loop.py``:
``device_prefetch``, ``DeviceCacheLoader``, the JAX package's
kpgnn_tpu/train/loop.py:150 and :166): the eval cache fills on its first
pass and replays after it, or streams every pass past its cap (the JAX
package's tests/test_train.py:243); the prefetch yields the loader's
batches in order and equal, and abandoning it stops its thread; the
byte count of every backend's batch; and a CPU ``Trainer.fit`` gives
the history it gave with the uncapped list of eval batches, bit for
bit."""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.prep.khop import KHopConfig, extract_graphs
from kpgnn_tpu_torch.train import loop
from kpgnn_tpu_torch.train.config import TrainConfig
from kpgnn_tpu_torch.train.loader import GraphLoader
from tests.test_torch_model import FLAGSHIP_SMALL, PREP_SMALL
from tests.test_torch_prep_batch import raw_molecules

torch.set_num_threads(1)
V1, VK = 5, 11          # num_hop1_edge + 2, max_pe_num + 2 of FLAGSHIP_SMALL
MODEL = dict(FLAGSHIP_SMALL, hidden_size=12, num_layer=3)


def assert_same(a, b, what):
    """Batches (or parts of one) equal exactly, field for field; a dict
    field (a per-device cache) is left out."""
    if dataclasses.is_dataclass(a):
        assert type(a) is type(b), what
        for f in dataclasses.fields(a):
            if not isinstance(getattr(a, f.name), dict):
                assert_same(getattr(a, f.name), getattr(b, f.name),
                            f"{what}.{f.name}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.fixture(scope="module")
def graphs():
    return extract_graphs(raw_molecules(22, seed=5),
                          KHopConfig(**PREP_SMALL))


def test_device_cache_loader(graphs, monkeypatch):
    inner = GraphLoader(graphs[:20], batch_size=8)
    counting = type("L", (), {
        "passes": 0,
        "__iter__": lambda s: (setattr(s, "passes", s.passes + 1),
                               iter(inner))[1],
        "__len__": lambda s: len(inner)})()
    dl = loop.DeviceCacheLoader(counting, "cpu")
    first = [b.x for b in dl]
    second = [b.x for b in dl]
    assert counting.passes == 1          # the second pass replays
    assert len(first) == len(second) == len(dl) == 3
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    # a tiny cap streams every pass from the inner loader
    monkeypatch.setattr(loop, "EVAL_CACHE_BYTES", 8)
    small = loop.DeviceCacheLoader(counting, "cpu")
    list(small)
    list(small)
    assert counting.passes == 3


@pytest.mark.parametrize("mode", ["coo", "pallas", "dense", "banded"])
def test_device_prefetch_yields_the_batches_in_order(graphs, mode):
    kw = dict(v1=V1, vk=VK) if mode != "coo" else {}
    want = list(GraphLoader(graphs, 8, mode=mode, **kw))
    got = list(loop.device_prefetch(iter(want), "cpu"))
    assert len(got) == len(want) == 3
    for i, (a, b) in enumerate(zip(got, want)):
        assert_same(a, b, f"{mode} batch {i}")
        # the eval cache's byte count: the batch's own tensors, and its
        # adjacency's through the backend's dataclasses
        flat = loop._nbytes(b.replace(adj=None))
        assert flat == sum(t.numel() * t.element_size()
                           for t in vars(b).values()
                           if isinstance(t, torch.Tensor))
        assert loop._nbytes(b) > flat > 0


def test_abandoning_device_prefetch_stops_its_thread():
    before = threading.active_count()

    def endless():
        while True:
            yield torch.zeros(4)
    stream = loop.device_prefetch(endless(), "cpu")
    assert next(stream).shape == (4,)
    assert threading.active_count() == before + 1
    stream.close()
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


def fit(graphs):
    tl = GraphLoader(graphs, 8, shuffle=True, seed=3, mode="pallas",
                     v1=V1, vk=VK)
    vl = GraphLoader(graphs[:10], 8, mode="pallas", v1=V1, vk=VK)
    el = GraphLoader(graphs[10:], 8, mode="pallas", v1=V1, vk=VK)
    cfg = TrainConfig(lr=1e-3, num_epochs=2, batch_size=8, patience=50)
    tr = loop.Trainer(make_model(ModelConfig(**MODEL)), cfg, loss="l1",
                      device="cpu", resident="off")
    return tr.fit(tl, vl, el, seed=1)[1]["history"]


def test_trainer_history_equals_the_plain_stream(graphs, monkeypatch):
    got = fit(graphs)
    # the eval batches as the Trainer kept them before: an uncapped list
    monkeypatch.setattr(loop, "DeviceCacheLoader", lambda loader, device: [
        b.to(device) for b in loader])
    want = fit(graphs)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            if k != "seconds":
                assert (a[k] == b[k]).all() if k == "step_losses" \
                    else a[k] == b[k], k
