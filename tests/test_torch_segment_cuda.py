"""``ops.segment.segment_sum`` on the card: graph-level sums repeat.

The JAX package's graph-level segment sums are one-hot products, which
repeat bit for bit on a TPU; on the card the port takes the same form
for a float sum into at most ``ONEHOT_SEGMENTS_MAX`` segments, where
``index_add_`` would add with atomics in an order that varies from run
to run.  More segments (edge -> node) keep ``index_add_``.  Each case
sums rows into segments as pooling does (ids sorted by graph, most rows
in the last, the pad segment) and in a shuffled order, forward and
autograd backward:

- on values drawn at random, into at most ``ONEHOT_SEGMENTS_MAX``
  segments, three runs must agree bit for bit;
- on values on a grid of 1/256 with |v| < 1, where every partial sum is
  exact in f32 and so cannot depend on its order, the card must equal
  the CPU's ``index_add_`` bit for bit, on both sides of the bound.

Needs a card and skips without one.  On the card, without the JAX
package's conftest:

    python -m pytest -q -p no:cacheprovider --noconftest -o addopts= \\
        tests/test_torch_segment_cuda.py
"""
import numpy as np
import pytest
import torch

from kpgnn_tpu_torch.ops.segment import ONEHOT_SEGMENTS_MAX, segment_sum

pytestmark = pytest.mark.cuda

ROWS = 8192


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: it checks the card's summation")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def case(tail, segments, shuffled, grid, dtype):
    """(data, ids) on the CPU: ROWS rows of shape ``tail`` in
    ``segments`` segments of uneven size, the last (the pad segment)
    holding half the rows; ids sorted unless ``shuffled``."""
    rng = np.random.default_rng(11)
    ids = np.sort(np.concatenate([
        rng.integers(0, segments - 1, ROWS // 2),
        np.full(ROWS - ROWS // 2, segments - 1)]))
    if shuffled:
        ids = rng.permutation(ids)
    x = rng.uniform(-1.0, 1.0, (ROWS,) + tail)
    if grid:
        x = np.round(x * 255.0) / 256.0
    return (torch.tensor(x, dtype=torch.float32).to(dtype),
            torch.tensor(ids, dtype=torch.int64))


def run(data, ids, segments, weights):
    """segment_sum forward and the gradient of <sums, weights> in data."""
    data = data.detach().clone().requires_grad_(True)
    out = segment_sum(data, ids, segments)
    (out.float() * weights).sum().backward()
    return out.detach().cpu(), data.grad.detach().cpu()


TAILS = [(), (104,), (8, 13)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("segments", [65, ONEHOT_SEGMENTS_MAX])
@pytest.mark.parametrize("tail", TAILS)
def test_segment_sum_repeats_on_the_card(dev, tail, segments, shuffled,
                                         dtype):
    data, ids = case(tail, segments, shuffled, grid=False, dtype=dtype)
    w = torch.randn((segments,) + tail,
                    generator=torch.Generator().manual_seed(3))
    runs = [run(data.to(dev), ids.to(dev), segments, w.to(dev))
            for _ in range(3)]
    for out, grad in runs[1:]:
        assert torch.equal(out, runs[0][0])
        assert torch.equal(grad, runs[0][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("segments", [65, ONEHOT_SEGMENTS_MAX,
                                      4 * ONEHOT_SEGMENTS_MAX])
@pytest.mark.parametrize("tail", TAILS)
def test_segment_sum_on_the_card_equals_the_cpu(dev, tail, segments, dtype):
    data, ids = case(tail, segments, shuffled=True, grid=True, dtype=dtype)
    w = torch.ones((segments,) + tail)
    out_c, grad_c = run(data.to(dev), ids.to(dev), segments, w.to(dev))
    out_h, grad_h = run(data, ids, segments, w)
    assert out_c.dtype == dtype
    assert torch.equal(out_c, out_h)
    assert torch.equal(grad_c, grad_h)
