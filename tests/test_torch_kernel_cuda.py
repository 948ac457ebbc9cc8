"""The hand-written kernel (csrc/gather_segment_sum.cu) on the card, on
the harder cases of the JAX package's Pallas tests (tests/test_pallas.py):
a heavy row (:60), a hub row of 5,000 edges (:75; the port has no spill
list, so the hub is one heavy row), blocks whose senders span several of
the TPU plan's windows (:209), and a graph-sorted batch whose senders
stay inside each graph (:376).

Each case runs the gather form (``_GatherSegment``) and the fused form
(``_FusedKHop``: the gather plus each edge's table row), f32 and bf16,
forward and autograd backward, against the plain version
``spmm.gather_segment_sum_reference`` on the same values.  The values lie
on a grid of 1/256 with |v| < 1 (exact in bf16 too), so every partial sum
of the largest row (10,000 terms) is exact in f32 and the sums cannot
depend on their order: the forward, dx (the kernel over the transposed
CSR, on the gradient in x's dtype) and the table gradients (``counts.T @
g``, TF32 off) must equal the plain version's bit for bit, which also
rules out a narrower accumulator.  A second run must repeat the kernel's
outputs bit for bit, and each run launches the expected variants once
forward and once backward.

The last case is QM9 scoring's batch (2,048 QM9-shaped molecules on the
kernel plan, g_pad 2,049, n_pad 65,536): its graph-level sums (the
attention pooling's two and the seven virtual-node poolings of a
forward) are sorted sums, and on the batch's CSR, which ends at the real
nodes, they and the predictions equal those on the ids' CSR bit for bit.

A CUDA kernel has no CPU form, so every case needs a card and skips
without one.  On the card, without the JAX package's conftest:

    python -m pytest -q -p no:cacheprovider --noconftest -o addopts= \\
        tests/test_torch_kernel_cuda.py
"""
from collections import Counter

import numpy as np
import pytest
import torch

from kpgnn_tpu_torch.ops import spmm
from kpgnn_tpu_torch.utils.profiling import launch_counts

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU form")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def codes(rng, e, K, V1, VK, live_hop1=False):
    """Per-edge attr codes, 0 = hop absent; hop 1 all live if asked."""
    attr = rng.integers(0, VK, size=(e, K))
    attr[:, 0] = rng.integers(1 if live_hop1 else 0, V1, e)
    return attr


def heavy_row():
    """One receiver with 400 of 900 edges (test_pallas.py:60)."""
    rng = np.random.default_rng(2)
    n, e = 256, 900
    senders = rng.integers(0, n - 1, e)
    receivers = np.where(np.arange(e) < 400, 17, rng.integers(0, n, e))
    return senders, receivers, codes(rng, e, 1, 5, 7, True), n, 8


def hub():
    """A hub receiving 5,000 edges from the whole table beside sparse
    local structure (test_pallas.py:75)."""
    rng = np.random.default_rng(7)
    n, hub_e = 1024, 5000
    senders = np.concatenate([rng.integers(0, n - 1, hub_e),
                              rng.integers(0, n - 1, 800)])
    receivers = np.concatenate([np.full(hub_e, 3), rng.integers(0, n, 800)])
    return senders, receivers, codes(rng, hub_e + 800, 2, 5, 7, True), n, 16


def multi_window_blocks():
    """Random senders over a 384-row table, three hops
    (test_pallas.py:209, the JAX ``case(seed=5, n=384, e=900, D=24)``)."""
    rng = np.random.default_rng(5)
    n, e = 384, 900
    senders = rng.integers(0, n - 1, e)
    receivers = np.sort(rng.integers(0, n - 1, e))
    return senders, receivers, codes(rng, e, 3, 5, 7), n, 24


def graph_sorted():
    """32-node graphs with intra-graph edges only (test_pallas.py:376)."""
    rng = np.random.default_rng(3)
    n, gsize = 1024, 32
    senders, receivers = [], []
    for g0 in range(0, n - gsize, gsize):
        senders.append(rng.integers(g0, g0 + gsize, 40))
        receivers.append(rng.integers(g0, g0 + gsize, 40))
    senders, receivers = np.concatenate(senders), np.concatenate(receivers)
    return senders, receivers, codes(rng, len(senders), 2, 5, 7), n, 8


CASES = {"heavy_row": heavy_row, "hub": hub,
         "multi_window_blocks": multi_window_blocks,
         "graph_sorted": graph_sorted}
V1, VK = 5, 7


def run(form, plan, x, t1, tk, w):
    """One forward and autograd backward; the outputs and the launches
    per variant."""
    before = launch_counts("gather_segment_sum")
    xk = x.clone().requires_grad_(True)
    t1k, tkk = (t.clone().requires_grad_(True) for t in (t1, tk))
    if form == "gather":
        out = spmm._GatherSegment.apply(xk, plan.fwd, plan.bwd)
    else:
        out = spmm._FusedKHop.apply(xk, t1k, tkk, plan)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    launches = launch_counts("gather_segment_sum")
    launches.subtract(before)
    return dict(out=out.detach(), dx=xk.grad, dt1=t1k.grad, dtk=tkk.grad,
                launches=+launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("form", ["gather", "fused"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(case, form, dtype, dev):
    senders, receivers, attr, n, D = CASES[case]()
    plan = spmm.build_plan(receivers, senders, attr, n, V1, VK).to(dev)
    f, b = plan.fwd, plan.bwd
    K, fused = attr.shape[1], form == "fused"
    rng = np.random.default_rng(0)

    def grid(*shape):
        """Values k/256, |k| < 256: exact in f32 and bf16, and so are
        the sums here."""
        return torch.from_numpy((rng.integers(-255, 256, size=shape) / 256
                                 ).astype(np.float32)).to(dev)
    x, t1, tk, w = (grid(f.n_cols, D).to(dtype), grid(V1, D), grid(VK, D),
                    grid(f.n_rows, D))
    got = run(form, plan, x, t1, tk, w)
    again = run(form, plan, x, t1, tk, w)

    vec = D * x.element_size() % 16 == 0
    fwd_v = spmm.variant_name(dtype, vec, fused)
    bwd_v = spmm.variant_name(dtype, vec, False)
    assert got["launches"] == Counter([fwd_v, bwd_v]), got["launches"]
    for key in ("out", "dx"):
        assert torch.equal(got[key], again[key]), f"{key} not bitwise"

    # the plain version on the same values: the forward over fwd (with the
    # tables in the fused form), dx over bwd on the gradient in x's dtype,
    # the table gradients by its autograd
    t1r, tkr = (t.clone().requires_grad_(True) for t in (t1, tk))
    tabs = dict(codes=f.codes, table1=t1r, tablek=tkr if K > 1 else None,
                rows_per_hop=n) if fused else {}
    ref = spmm.gather_segment_sum_reference(
        x.float(), f.indptr, f.senders, f.n_rows, **tabs)
    if fused:
        (ref * w).sum().backward()
    wg = w.to(dtype)
    dx = b.gather(wg)
    dx_ref = spmm.gather_segment_sum_reference(
        wg.float(), b.indptr, b.senders, b.n_rows)
    assert got["out"].dtype == torch.float32 and got["dx"].dtype == dtype
    assert torch.equal(got["out"], ref.detach()), f"{case} fwd"
    assert torch.equal(got["dx"], dx.to(dtype)), f"{case} dx is not bwd's"
    assert torch.equal(dx, dx_ref), f"{case} dx"
    if not fused:
        return
    assert torch.equal(got["dt1"], t1r.grad), f"{case} d table1"
    assert bool((got["dt1"][0] == 0).all()), f"{case} d table1 row 0"
    if K > 1:
        assert torch.equal(got["dtk"], tkr.grad), f"{case} d tablek"
        assert bool((got["dtk"][0] == 0).all()), f"{case} d tablek row 0"
    else:
        assert got["dtk"] is None


QM9_SCORING = "qm9_kpginplus_k8l8h128"


def graph_sums_both_ways(dev, monkeypatch, n_molecules):
    """QM9 scoring's forward on ``n_molecules`` QM9-shaped molecules from
    the benchmark's generator, collated on the kernel plan as the loader
    pads them, with its graph-level sums recorded: ((predictions, sums,
    segment_csr counts) on the batch's CSR, the same without it)."""
    import json
    import os

    from benchmark import molecules
    from benchmark.drive import khop_config, program_model
    from kpgnn_tpu_torch.models import backbones, heads
    from kpgnn_tpu_torch.nn.inits import init_parameters
    from kpgnn_tpu_torch.ops import segment
    from kpgnn_tpu_torch.prep.runner import preprocess_graphs
    from kpgnn_tpu_torch.train.loader import GraphLoader
    from kpgnn_tpu_torch.utils.profiling import reset_launch_counts

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs",
                           QM9_SCORING + ".json")) as f:
        m = json.load(f)["model"]
    graphs = preprocess_graphs(
        molecules.generate("qm9", n_molecules, 20261), khop_config(m))
    b = next(iter(GraphLoader(graphs, n_molecules, mode="pallas",
                              v1=m["num_hop1_edge"] + 2,
                              vk=m["max_pe_num"] + 2))).to(dev)
    model = init_parameters(program_model(m, "cpu"), 7).to(dev).eval()
    sums = []

    def recording(fn):
        def call(data, ids, n, *a, **kw):
            out = fn(data, ids, n, *a, **kw)
            if n == b.g_pad:
                sums.append(out)
            return out
        return call
    for mod in (segment, heads, backbones):
        monkeypatch.setattr(mod, "segment_sum", recording(mod.segment_sum))

    def forward(batch):
        sums.clear()
        reset_launch_counts()
        with torch.no_grad():
            pred = model(batch)
        counts = {v: n for (v, shape), n in launch_counts(
            "segment_csr", by_shape=True).items() if shape == b.g_pad}
        return pred, list(sums), counts
    return b, forward(b), forward(b.replace(graph_indptr=None))


def test_graph_sums_on_the_batch_csr_repeat_the_ids_csr(dev, monkeypatch):
    b, (pred, sums, counts), (pred_ids, sums_ids, counts_ids) = \
        graph_sums_both_ways(dev, monkeypatch, 2048)
    assert b.g_pad == 2049 and b.n_pad == 65536
    tot_n = int(b.graph_indptr[-1])
    assert int(b.graph_indptr[-2]) == tot_n == int(b.node_mask.sum())
    assert counts == {"batch": 9} and counts_ids == {"ids": 9}
    assert len(sums) == len(sums_ids) == 9
    for i, (s, t) in enumerate(zip(sums, sums_ids)):
        assert torch.equal(s, t), f"graph-level sum {i}"
    assert bool(torch.isfinite(pred).all())
    assert torch.equal(pred, pred_ids)
