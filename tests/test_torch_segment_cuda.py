"""``ops.segment`` on the card: every float segment sum repeats.

The JAX package's segment sums repeat bit for bit on a TPU.  On the card
the port takes the JAX package's one-hot product for a float sum into
at most ``ONEHOT_SEGMENTS_MAX`` segments (graph-level), and above it,
for sorted ids (edge -> node), ``sorted_segment_sum``: the gather kernel
over the ids' CSR with identity senders, which adds each segment's rows
in index order, as the CPU's ``index_add_`` does.  ``index_add_`` on the
card adds with atomics, in an order that varies from run to run; only
``sorted=False`` keeps it.  Each ``segment_sum`` case sums rows into
segments as pooling does (ids sorted by graph, most rows in the last,
the pad segment) and in a shuffled order (``sorted=False``), forward and
autograd backward:

- on values drawn at random, into at most ``ONEHOT_SEGMENTS_MAX``
  segments, three runs must agree bit for bit;
- on values on a grid of 1/256 with |v| < 1, where every partial sum is
  exact in f32 and so cannot depend on its order, the card must equal
  the CPU's ``index_add_`` bit for bit, on both sides of the bound.

``sorted_segment_sum`` itself, at the row widths of the main paths (D =
12, 104 and the flagship COO message's K*H = 832), f32 and bf16, on ids
with a padded tail past the CSR's end, a 5,000-row hub segment and
empty segments: three runs bit for bit, and equal to its plain version
on the CPU bit for bit, on grid values and on values drawn at random
(both add every segment's rows in index order, in f32).  Then the two
sums built on it: the halo exchange's backward (a group of one gloo
rank) and the GCN plan's weighted histograms, against the CPU bit for
bit on grid values and on a repeat.  Every case runs with
``segment.CHECK_SORTED`` on; one shows what it catches: ids that are not
sorted, which give wrong sums on the card above the bound without it.

Needs a card and skips without one.  On the card, without the JAX
package's conftest:

    python -m pytest -q -p no:cacheprovider --noconftest -o addopts= \\
        tests/test_torch_segment_cuda.py
"""
import numpy as np
import pytest
import torch

from kpgnn_tpu_torch.ops import segment, spmm
from kpgnn_tpu_torch.ops.segment import (ONEHOT_SEGMENTS_MAX, segment_sum,
                                         sorted_segment_sum)

pytestmark = pytest.mark.cuda

ROWS = 8192


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: it checks the card's summation")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    # every sorted sum here checks that its ids are sorted
    monkeypatch.setattr(segment, "CHECK_SORTED", True)
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


def run(data, ids, segments, weights, sorted=True):
    """segment_sum forward and the gradient of <sums, weights> in data."""
    data = data.detach().clone().requires_grad_(True)
    out = segment_sum(data, ids, segments, sorted)
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
    runs = [run(data.to(dev), ids.to(dev), segments, w.to(dev),
                not shuffled) for _ in range(3)]
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
    out_c, grad_c = run(data.to(dev), ids.to(dev), segments, w.to(dev),
                        sorted=False)
    out_h, grad_h = run(data, ids, segments, w, sorted=False)
    assert out_c.dtype == dtype
    assert torch.equal(out_c, out_h)
    assert torch.equal(grad_c, grad_h)


def plain_launch(x, indptr, senders, n_rows, *args, **kwargs):
    """``spmm.launch_kernel``'s sum over the CSR on the CPU, for the CPU
    tests of the card's paths (no table term): rows from ``indptr``, each
    row's edges added in index order, as the kernel adds them."""
    lo, hi = int(indptr[0]), int(indptr[-1])
    rows = torch.repeat_interleave(torch.arange(n_rows),
                                   (indptr[1:] - indptr[:-1]).long())
    out = torch.zeros((n_rows, x.shape[1]), dtype=torch.float32)
    out.index_add_(0, rows, x[senders[lo:hi].long()].float())
    return out, spmm.variant_name(x.dtype, x.shape[1] * x.element_size()
                                  % 16 == 0, False)


# sorted_segment_sum at the main paths' row widths: CSL's D=12, the
# flagship's D=104, and the flagship COO message (K*H = 8*104)
WIDTHS = [12, 104, 832]
SORTED_SEGMENTS = 3000


def sorted_case(D, grid, dtype, seed=13):
    """(data, ids, indptr) on the CPU: 2,000 rows over the first 2,000
    segments, a hub segment of 5,000 rows, empty segments between, and a
    tail of 700 pad rows into the last segment that the CSR ends before
    (a COO batch's padded edges)."""
    rng = np.random.default_rng(seed)
    ids = np.sort(np.concatenate([
        rng.integers(0, 2000, 2000), np.full(5000, 2100),
        rng.integers(2101, SORTED_SEGMENTS, 300)]))
    indptr = np.searchsorted(ids, np.arange(SORTED_SEGMENTS + 1))
    ids = np.concatenate([ids, np.full(700, SORTED_SEGMENTS - 1)])
    x = rng.uniform(-1.0, 1.0, (len(ids), D))
    if grid:
        x = np.round(x * 255.0) / 256.0
    return (torch.tensor(x, dtype=torch.float32).to(dtype),
            torch.tensor(ids, dtype=torch.int32),
            torch.tensor(indptr, dtype=torch.int32))


def sorted_run(data, ids, indptr, weights):
    data = data.detach().clone().requires_grad_(True)
    out = sorted_segment_sum(data, ids, SORTED_SEGMENTS, indptr)
    (out.float() * weights).sum().backward()
    return out.detach().cpu(), data.grad.detach().cpu()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", WIDTHS)
def test_sorted_segment_sum_repeats_and_counts(dev, D, dtype):
    data, ids, indptr = sorted_case(D, grid=False, dtype=dtype)
    w = torch.randn(SORTED_SEGMENTS, D,
                    generator=torch.Generator().manual_seed(4))
    segment.reset_launch_counts()
    runs = [sorted_run(data.to(dev), ids.to(dev), indptr.to(dev), w.to(dev))
            for _ in range(3)]
    variant = spmm.variant_name(dtype, D * data.element_size() % 16 == 0,
                                False)
    assert dict(segment.sorted_segment_sum.width_launches) == {
        (variant, D): 3}
    for out, grad in runs[1:]:
        assert torch.equal(out, runs[0][0])
        assert torch.equal(grad, runs[0][1])
    # the tail past the CSR's end adds nothing and takes no gradient
    assert not runs[0][1][-700:].any()


@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", WIDTHS)
def test_sorted_segment_sum_on_the_card_equals_the_cpu(dev, D, dtype, grid):
    data, ids, indptr = sorted_case(D, grid=grid, dtype=dtype)
    w = torch.ones(SORTED_SEGMENTS, D)
    out_c, grad_c = sorted_run(data.to(dev), ids.to(dev), indptr.to(dev),
                               w.to(dev))
    out_h, grad_h = sorted_run(data, ids, indptr, w)
    assert out_c.dtype == dtype
    assert torch.equal(out_c, out_h)
    assert torch.equal(grad_c, grad_h)


def test_segment_sum_takes_the_sorted_sum_above_the_bound(dev):
    """A sorted float sum into more than ONEHOT_SEGMENTS_MAX segments
    launches the kernel once; ``sorted=False`` does not."""
    data, ids, indptr = sorted_case(104, grid=True, dtype=torch.float32)
    data, ids = data.to(dev), ids.to(dev)
    segment.reset_launch_counts()
    a = segment_sum(data, ids, SORTED_SEGMENTS, indptr=indptr.to(dev))
    assert sum(segment.sorted_segment_sum.variant_launches.values()) == 1
    b = segment_sum(data, ids, SORTED_SEGMENTS, sorted=False)
    assert sum(segment.sorted_segment_sum.variant_launches.values()) == 1
    # grid values: every order gives the same sums, the tail's included
    tail = torch.zeros_like(a).index_add_(0, ids[-700:].long(), data[-700:])
    assert torch.equal(a + tail, b)


def test_halo_backward_sum_on_the_card(dev, tmp_path):
    """The halo exchange's backward on a group of one gloo rank: a send
    plan that sends rows 0, 3 and 7 several times, the cotangents added
    back bit for bit as on the CPU (grid values) and on a repeat."""
    import torch.distributed as dist
    from types import SimpleNamespace

    from kpgnn_tpu_torch.ops.sharded_adjacency import (halo_exchange,
                                                       halo_plan)

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        rows = torch.tensor([[7, 0, 3, 7, 3, 0, 7, 1, 0, 7]],
                            dtype=torch.int32)
        rng = np.random.default_rng(2)
        x = torch.tensor(np.round(rng.uniform(-1, 1, (9, 4, 104)) * 255)
                         / 256, dtype=torch.float32)
        g = torch.tensor(np.round(rng.uniform(-1, 1, (19, 4, 104)) * 255)
                         / 256, dtype=torch.float32)

        order, indptr = halo_plan(rows.reshape(-1), 9)

        def grad(device):
            adj = SimpleNamespace(send_rows=rows.to(device), n_local=9,
                                  group=None, halo_order=order.to(device),
                                  halo_indptr=indptr.to(device))
            xx = x.to(device).requires_grad_(True)
            (halo_exchange(adj, xx) * g.to(device)).sum().backward()
            return xx.grad.cpu()
        got = [grad(dev) for _ in range(2)]
        assert torch.equal(got[0], got[1])
        assert torch.equal(got[0], grad(torch.device("cpu")))
    finally:
        dist.destroy_process_group()


def test_weighted_hists_on_the_card(dev):
    """GCN's sender-weighted code histograms on a plan with repeated
    codes per row: bit for bit as on the CPU (grid scales) and on a
    repeat."""
    rng = np.random.default_rng(8)
    n, K, E = 300, 3, 4000
    r, s = np.sort(rng.integers(0, n, E)), rng.integers(0, n, E)
    attr = rng.integers(0, 6, (E, K))
    plan = spmm.build_plan(r, s, attr, n, 6, 6)
    scale = torch.tensor(np.round(rng.uniform(0, 1, (n, K)) * 255) / 256,
                         dtype=torch.float32)
    want = spmm._weighted_hists(plan, scale, 6)
    cplan = plan.to(dev)
    got = [spmm._weighted_hists(cplan, scale.to(dev), 6).cpu()
           for _ in range(2)]
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0], want)


def test_unsorted_ids_give_wrong_sums_on_the_card_unless_checked(
        dev, monkeypatch):
    """``sorted=True`` promises sorted ids.  Above ONEHOT_SEGMENTS_MAX
    segments the card builds their CSR without looking: shuffled ids
    give wrong sums there, where the CPU's ``index_add_`` is right (grid
    values, so the right sums are exact in any order), and
    ``CHECK_SORTED`` refuses them instead."""
    data, ids = case((104,), SORTED_SEGMENTS, shuffled=True, grid=True,
                     dtype=torch.float32)
    want = segment_sum(data, ids, SORTED_SEGMENTS)
    with pytest.raises(ValueError, match="not sorted"):
        segment_sum(data.to(dev), ids.to(dev), SORTED_SEGMENTS)
    monkeypatch.setattr(segment, "CHECK_SORTED", False)
    got = segment_sum(data.to(dev), ids.to(dev), SORTED_SEGMENTS).cpu()
    assert not torch.equal(got, want)
    assert torch.equal(segment_sum(data.to(dev), ids.to(dev),
                                   SORTED_SEGMENTS, sorted=False).cpu(),
                       want)
