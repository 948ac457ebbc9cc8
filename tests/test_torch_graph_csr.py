"""The packed batches' graph CSR (``GraphBatch.graph_indptr``) and the
graph-level sums that read it, on the CPU.

``collate``, ``collate_pallas`` and ``collate_banded`` put every padded
node into the reserved last graph slot.  They carry the CSR of
``node_graph_ids`` over the real nodes, in which that slot is empty and
the padded nodes lie past the end.  Dense, resident and node-shard
batches carry none.

On the card a float sum into more than ``ONEHOT_SEGMENTS_MAX`` graph
slots is the sorted sum (the gather kernel over a CSR).  With the
batch's CSR it adds the real nodes only, the same rows in the same
order as over the ids' CSR, so every real slot's sum, the model's
predictions and a training step's gradients are equal bit for bit.  The
kernel cannot run here, so the card's routing runs with the launch
replaced by ``plain_launch``, as in tests/test_torch_sorted_sum.py.  The
models take each benchmark configuration's settings
(benchmark/configs/), cut to hidden 8 and K=2 at their 8 layers; the
batches hold 1,030 molecules (g_pad 1,031) drawn by the benchmark's
generators, padded as the loader pads them.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

from benchmark import molecules
from benchmark.drive import khop_config, program_model
from kpgnn_tpu_torch.graph.batch import (collate, collate_banded,
                                         collate_dense, collate_pallas)
from kpgnn_tpu_torch.models.heads import pool_nodes
from kpgnn_tpu_torch.nn.basic import TorchLinear
from kpgnn_tpu_torch.nn.inits import init_parameters
from kpgnn_tpu_torch.nn.norms import (GraphSizeNorm, MaskedGraphLayerNorm,
                                      MaskedInstanceNorm)
from kpgnn_tpu_torch.ops import segment, spmm
from kpgnn_tpu_torch.parallel.partition import partition_batch
from kpgnn_tpu_torch.prep.khop import KHopConfig, extract_graphs
from kpgnn_tpu_torch.train import loop
from kpgnn_tpu_torch.train.loader import GraphLoader
from kpgnn_tpu_torch.train.resident import build_dense_store, gather_batch
from kpgnn_tpu_torch.utils.profiling import launch_counts, reset_launch_counts
from tests.test_torch_prep_batch import raw_molecules
from tests.test_torch_segment_cuda import plain_launch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"zinc": "zinc_kpginplus_k8l8h104", "qm9": "qm9_kpginplus_k8l8h128"}
# graph-level sorted sums a forward: ZINC's sum pooling; QM9's 7
# virtual-node poolings and its attention pooling's 2
GRAPH_SUMS = {"zinc": 1, "qm9": 9}
N_MOLECULES = 1030
SMALL_PREP = dict(K=2, max_edge_attr_num=9)


def small_graphs(n=9, seed=4):
    """Mixed-size ZINC-shaped molecules (9-37 atoms), prepped at K=2."""
    return extract_graphs(raw_molecules(n, seed=seed),
                          KHopConfig(**SMALL_PREP))


def expected_csr(batch, n_real):
    ids = batch.node_graph_ids.numpy()[:n_real]
    return np.searchsorted(ids, np.arange(batch.g_pad + 1))


COLLATES = {
    "collate": lambda gs, **kw: collate(gs, **kw),
    "collate_pallas": lambda gs, **kw: collate_pallas(gs, v1=5, vk=11, **kw),
    "collate_banded": lambda gs, **kw: collate_banded(gs, v1=5, vk=11, **kw),
}


@pytest.mark.parametrize("extra_slots", [0, 3])
@pytest.mark.parametrize("how", sorted(COLLATES))
def test_packed_collates_carry_the_graph_csr(how, extra_slots):
    """The CSR of the real nodes' graph ids: each molecule's rows, the
    pad slot (and any unused slot before it) empty, the padded nodes past
    ``graph_indptr[-1]``."""
    gs = small_graphs()
    tot_n = sum(g.num_nodes for g in gs)
    b = COLLATES[how](gs, n_pad=1024, e_pad=8192,
                      g_pad=len(gs) + 1 + extra_slots)
    ip = b.graph_indptr
    assert ip.dtype == torch.int32 and ip.shape == (b.g_pad + 1,)
    np.testing.assert_array_equal(ip.numpy(), expected_csr(b, tot_n))
    np.testing.assert_array_equal(np.diff(ip.numpy())[:len(gs)],
                                  [g.num_nodes for g in gs])
    assert int(ip[0]) == 0
    assert int(ip[len(gs)]) == int(ip[b.g_pad - 1]) == int(ip[-1]) == tot_n
    assert b.n_pad > tot_n and not b.node_mask[tot_n:].any()


def test_unpacked_batches_carry_no_graph_csr():
    """collate_dense and the resident gather give every graph its own
    node slots (padding included); a node shard re-slices the rows: none
    carries a CSR, so their sums build the ids' CSR."""
    gs = small_graphs()
    assert collate_dense(gs, n_slot=40, v1=5, vk=11).graph_indptr is None
    store = build_dense_store(gs, n_slot=40, v1=5, vk=11, device="cpu")
    assert gather_batch(store, torch.tensor([2, 0, 5])).graph_indptr is None
    full = collate(gs, n_pad=1024, e_pad=8192)
    assert full.graph_indptr is not None
    for rank in range(2):
        assert partition_batch(full, 2, rank).graph_indptr is None


def test_batch_to_and_the_device_cache_carry_the_graph_csr():
    """``GraphBatch.to`` and ``DeviceCacheLoader``'s fill and replay keep
    the field, equal to the collated one."""
    gs = small_graphs(20, seed=6)
    inner = GraphLoader(gs, batch_size=8, mode="pallas", v1=5, vk=11)
    want = [b.graph_indptr for b in inner]
    assert all(w is not None for w in want)
    moved = next(iter(inner)).to(torch.device("cpu"))
    assert torch.equal(moved.graph_indptr, want[0])
    cache = loop.DeviceCacheLoader(inner, torch.device("cpu"))
    for _ in range(2):                  # the fill, then the replay
        got = [b.graph_indptr for b in cache]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# ---- the card's sums on the batch's CSR and on the ids' ---------------

@pytest.fixture
def card_paths(monkeypatch):
    monkeypatch.setattr(segment, "_on_card", lambda t: True)
    monkeypatch.setattr(spmm, "launch_kernel", plain_launch)
    reset_launch_counts()


def model_settings(name):
    with open(os.path.join(REPO, "benchmark", "configs",
                           CONFIGS[name] + ".json")) as f:
        m = json.load(f)["model"]
    return dict(m, hidden_size=8, K=2)


_GRAPHS = {}


def bench_graphs(name):
    """1,030 molecules from the benchmark's generator for ``name``,
    prepped with the cut model's k-hop settings (memoized)."""
    if name not in _GRAPHS:
        _GRAPHS[name] = extract_graphs(
            molecules.generate(name, N_MOLECULES, 20260),
            khop_config(model_settings(name)))
    return _GRAPHS[name]


def bench_batch(name, backend):
    """The whole library as one batch, padded as the loader pads it (the
    worst case: n_pad 32,768 for ~23k real nodes)."""
    m = model_settings(name)
    kw = {} if backend == "coo" else dict(v1=m["num_hop1_edge"] + 2,
                                          vk=m["max_pe_num"] + 2)
    loader = GraphLoader(bench_graphs(name), N_MOLECULES, mode=backend,
                         **kw)
    b = next(iter(loader))
    assert b.g_pad > segment.ONEHOT_SEGMENTS_MAX
    assert b.n_pad - int(b.graph_indptr[-1]) > 5000     # a padding hub
    return b


def bench_model(name):
    return init_parameters(program_model(model_settings(name), "cpu"), 7)


def graph_csr_counts(batch):
    """``segment_csr``'s counts at the batch's graph slots."""
    return {v: n for (v, shape), n in
            launch_counts("segment_csr", by_shape=True).items()
            if shape == batch.g_pad}


@pytest.mark.parametrize("backend", ["pallas", "coo"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_on_the_batch_csr_equals_the_ids_csr(card_paths, name,
                                                     backend):
    """Eval-mode predictions bit for bit; every graph-level sum reads the
    batch's CSR (``batch``), or, without it, builds the ids' (``ids``)."""
    b = bench_batch(name, backend)
    model = bench_model(name).eval()
    with torch.no_grad():
        reset_launch_counts()
        got = model(b)
        counts = graph_csr_counts(b)
        reset_launch_counts()
        want = model(b.replace(graph_indptr=None))
        counts_ids = graph_csr_counts(b)
    assert counts == {"batch": GRAPH_SUMS[name]}
    assert counts_ids == {"ids": GRAPH_SUMS[name]}
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_gradients_on_the_batch_csr_equal_the_ids_csr(card_paths,
                                                           name):
    """One training step's loss, every gradient and the norms' updated
    running statistics, bit for bit, on the COO batch the training cells
    take."""
    b = bench_batch(name, "coo")
    model = bench_model(name)
    loss = "l1" if name == "zinc" else "mse"

    def step(batch):
        mdl = copy.deepcopy(model).train()
        pred = mdl(batch, train=True)
        total, _ = loop._masked_loss(pred, batch.y, batch.graph_mask, loss)
        total.backward()
        return total.detach(), mdl
    got, ours = step(b)
    want, theirs = step(b.replace(graph_indptr=None))
    assert torch.equal(got, want)
    grads = 0
    for (k, p), (_, q) in zip(ours.named_parameters(),
                              theirs.named_parameters()):
        assert (p.grad is None) == (q.grad is None), k
        if p.grad is not None:
            assert torch.equal(p.grad, q.grad), k
            grads += 1
    assert grads > 50
    for (k, s), (_, t) in zip(ours.named_buffers(), theirs.named_buffers()):
        assert torch.equal(s, t), k


POOLS = ["sum", "mean", "attention"]


@pytest.mark.parametrize("method", POOLS)
def test_pool_nodes_on_the_batch_csr_equals_the_ids_csr(card_paths, method):
    """Each pooling of ``heads.pool_nodes`` and its gradient."""
    b = bench_batch("zinc", "pallas")
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((b.n_pad, 6), generator=gen)
    gate = TorchLinear(6, 1)
    init_parameters(gate, 2)

    def pooled(batch):
        xi = x.clone().requires_grad_(True)
        out = pool_nodes(xi, batch, method, gate)
        out.backward(torch.ones_like(out))
        return out.detach(), xi.grad
    out, dx = pooled(b)
    want, want_dx = pooled(b.replace(graph_indptr=None))
    assert torch.equal(out, want) and torch.equal(dx, want_dx)
    assert graph_csr_counts(b)["batch"] >= 1


NORMS = {"Layer": lambda: MaskedGraphLayerNorm(6),
         "Instance": MaskedInstanceNorm, "GraphSize": GraphSizeNorm}


@pytest.mark.parametrize("norm", sorted(NORMS))
def test_graph_norms_on_the_batch_csr_equal_the_ids_csr(card_paths, norm):
    """The per-graph norms (nn/norms.py) as ``_apply_norm`` calls them."""
    b = bench_batch("qm9", "pallas")
    x = torch.randn((b.n_pad, 6), generator=torch.Generator().manual_seed(5))
    mod = NORMS[norm]()

    def normed(ip):
        return mod(x, b.node_graph_ids, b.g_pad, mask=b.node_mask,
                   indptr=ip)
    reset_launch_counts()
    got = normed(b.graph_indptr)
    assert set(graph_csr_counts(b)) == {"batch"}
    assert torch.equal(got, normed(None))
