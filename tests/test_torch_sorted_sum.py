"""Every edge -> node sum of the port adds in one fixed order: the sorted
segment sum (``ops.segment.sorted_segment_sum``) and its callers against
the JAX package, on the CPU.

On the card a float sum into more than ``ONEHOT_SEGMENTS_MAX`` sorted
segments is the gather kernel over the ids' CSR with identity senders;
on the CPU it is ``index_add_``.  The kernel cannot run here, so the
card's Python path runs in the ``card_paths`` cases with the launch
replaced by a plain sum over the same CSR: the routing, the CSR the
callers build (padded tails past its end), the autograd backward and
the sorts of the plans.  Each sum is held against the JAX package's on
the same seeded numpy inputs: ``segment_sum`` / ``segment_mean`` with
``sorted`` either way, the CSR builder on a padded tail, empty rows and
a 5,000-row hub, the COO ``khop_aggregate`` (add and mean, with
gradients) on per-batch and resident-gathered batches, the resident
banded spill against the per-batch one, and GCN's weighted histograms.
The loader, config and backbone arguments the port had dropped are held
to the JAX package's too.

Tolerance: f32 atol 1e-5, rtol 1e-4; the sums the port adds in the same
order in two layouts are equal bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kpgnn_tpu.graph.batch as jbatch
import kpgnn_tpu.ops.adjacency as jadjacency
import kpgnn_tpu.ops.banded as jbanded
import kpgnn_tpu.ops.pallas_spmm as jspmm
import kpgnn_tpu.train.config as jconfig
import kpgnn_tpu.train.loader as jloader
import kpgnn_tpu.train.resident as jres
from kpgnn_tpu.ops import segment as jseg
import kpgnn_tpu_torch as kt
from kpgnn_tpu_torch.graph import batch as tbatch
from kpgnn_tpu_torch.ops import segment, spmm
from kpgnn_tpu_torch.ops.adjacency import khop_aggregate_adj
from kpgnn_tpu_torch.ops.banded import banded_khop_aggregate
from kpgnn_tpu_torch.parallel.partition import partition_batch
from kpgnn_tpu_torch.train import resident as tres
from kpgnn_tpu_torch.utils.profiling import launch_counts, reset_launch_counts
from tests.test_torch_banded import chain_graphs
from tests.test_torch_prep_batch import ZINC_PREP, both_prep, raw_molecules
from tests.test_torch_segment_cuda import plain_launch

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-4)
PREP = dict(ZINC_PREP, K=3, max_edge_attr_num=6)
V1, VK = 5, 8           # num_hop1_edge + 2, max_edge_attr_num + 2


@pytest.fixture(params=["cpu", "card_paths"])
def path(request, monkeypatch):
    """"cpu": the CPU's sums; "card_paths": the card's routing (one-hot
    products, the sorted sum's autograd function) with the kernel launch
    replaced by ``plain_launch``."""
    if request.param == "card_paths":
        monkeypatch.setattr(segment, "_on_card", lambda t: True)
        monkeypatch.setattr(spmm, "launch_kernel", plain_launch)
    reset_launch_counts()
    return request.param


def launches():
    return sum(launch_counts("sorted_segment_sum").values())


def seeded_rows(segments, rows, tail, sorted_ids, seed=5):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, segments, rows))
    if not sorted_ids:
        ids = rng.permutation(ids)
    return rng.standard_normal((rows,) + tail).astype(np.float32), ids


# ---- segment_sum / segment_mean with ``sorted`` either way -------------

@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("segments", [65, 1500])
@pytest.mark.parametrize("fn", ["segment_sum", "segment_mean"])
def test_segment_reductions_match_jax(path, fn, segments, sorted_ids):
    x, ids = seeded_rows(segments, 4000, (6,), sorted_ids)
    want = np.asarray(getattr(jseg, fn)(
        jnp.asarray(x), jnp.asarray(ids, jnp.int32), segments,
        sorted=sorted_ids))
    got = getattr(segment, fn)(torch.tensor(x), torch.tensor(ids),
                               segments, sorted=sorted_ids)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the sorted kernel path exactly where the card takes it
    takes = path == "card_paths" and sorted_ids and segments > 1024
    assert (launches() > 0) == takes


# ---- the CSR builder and the sorted sum on its edge cases --------------

def csr_case(kind):
    """(ids, segments, the rows the CSR keeps) of one edge case."""
    rng = np.random.default_rng(3)
    if kind == "pad tail":              # a COO batch: pads past the end
        ids = np.concatenate([np.sort(rng.integers(0, 1200, 3000)),
                              np.full(500, 1199)])
        return ids, 1200, 3000
    if kind == "empty rows":            # only every 7th segment has rows
        ids = np.sort(rng.integers(0, 300, 2000) * 7)
        return ids, 2100, 2000
    ids = np.sort(np.concatenate([rng.integers(0, 1500, 1000),
                                  np.full(5000, 700)]))
    return ids, 1500, 6000              # a 5,000-row hub


@pytest.mark.parametrize("kind", ["pad tail", "empty rows", "hub"])
def test_sorted_segment_sum_on_its_csr_matches_jax(path, kind):
    ids, n, keep = csr_case(kind)
    indptr = segment.segment_indptr(torch.tensor(ids, dtype=torch.int32), n)
    assert indptr.dtype == torch.int32
    np.testing.assert_array_equal(indptr.numpy(), np.searchsorted(
        ids, np.arange(n + 1)))
    # a caller ends the CSR at the last real row; the tail adds nothing
    indptr = torch.tensor(np.searchsorted(ids[:keep], np.arange(n + 1)),
                          dtype=torch.int32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((len(ids), 12)).astype(np.float32)
    w = rng.standard_normal((n, 12)).astype(np.float32)

    def jsum(xx):
        return (jax.ops.segment_sum(xx[:keep], jnp.asarray(ids[:keep]),
                                    num_segments=n, indices_are_sorted=True)
                * w).sum()
    want, jgrad = jax.value_and_grad(jsum)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = segment.sorted_segment_sum(xt, torch.tensor(ids), n, indptr)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(float((out.detach() * torch.tensor(w)).sum()),
                               float(want), rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), **TOL)
    assert not xt.grad[keep:].any()
    assert launches() == (path == "card_paths")


# ---- the COO aggregation on per-batch and resident batches -------------

@pytest.fixture(scope="module")
def molecules():
    return both_prep(raw_molecules(7, seed=21), **PREP)


def coo_batches(molecules, layout):
    """(JAX batch, port batch) of the molecules in one layout, over more
    than ONEHOT_SEGMENTS_MAX nodes; e_pad leaves a padded tail (into the
    last node) in the collated batch."""
    js, ts = molecules
    if layout == "per-batch":
        # more nodes than ONEHOT_SEGMENTS_MAX: the card's sorted sum
        pads = dict(n_pad=1280, e_pad=sum(g.num_edges for g in ts) + 40,
                    g_pad=8)
        return jbatch.collate(js, **pads), tbatch.collate(ts, **pads)
    idx = [4, 0, 6, 2, 7, 5] * 6          # 36 slots, the pad slot among them
    jb = jres.gather_coo_batch(jres.build_coo_store(js), jnp.asarray(idx))
    tb = tres.gather_coo_batch(tres.build_coo_store(ts, device="cpu"),
                               torch.tensor(idx))
    return jb, tb


def assert_sorted_csr(adj):
    """The receivers are sorted and ``adj.indptr`` is their CSR up to the
    last real edge; what lies past it is padding."""
    r = adj.receivers.numpy()
    m = adj.edge_mask.numpy()
    assert (np.diff(r) >= 0).all()
    real = int(np.flatnonzero(m)[-1]) + 1 if m.any() else 0
    ip = adj.indptr.numpy()
    assert ip[-1] >= real and not m[ip[-1]:].any()
    np.testing.assert_array_equal(ip, np.searchsorted(r[:ip[-1]],
                                                      np.arange(len(ip))))


@pytest.mark.parametrize("aggr", ["add", "mean"])
@pytest.mark.parametrize("layout", ["per-batch", "resident"])
def test_coo_khop_aggregate_matches_jax(molecules, path, layout, aggr):
    jb, tb = coo_batches(molecules, layout)
    adj = tb.adj
    assert_sorted_csr(adj)
    if layout == "per-batch":           # the pads lie past the CSR's end
        assert int(adj.indptr[-1]) == int(adj.edge_mask.sum())
    n, K, D = adj.n_nodes, adj.K, 16
    rng = np.random.default_rng(9)
    x = rng.standard_normal((n, K, D)).astype(np.float32)
    t1 = rng.standard_normal((V1, D)).astype(np.float32)
    tk = rng.standard_normal((VK, D)).astype(np.float32)
    w = rng.standard_normal((n, K, D)).astype(np.float32)

    def jloss(xx, a1, ak):
        out = jadjacency.khop_aggregate_adj(jb.adj, xx, a1, ak, aggr=aggr)
        return (out * w).sum(), out
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(x), jnp.asarray(t1), jnp.asarray(tk))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, t1, tk)]
    out = khop_aggregate_adj(adj, *leaves, aggr=aggr)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for leaf, want in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   **TOL)
    # add: one sorted sum; mean: the sum and the union in-degree
    assert launches() == (0 if path == "cpu" else 1 if aggr == "add" else 2)


def test_node_shards_keep_sorted_receivers(molecules):
    """Each rank's local receivers are sorted, its CSR ends at its last
    real edge, and the send plan is sorted once at partition time."""
    js, ts = molecules
    tb = tbatch.collate(ts, n_pad=256, e_pad=sum(g.num_edges for g in ts)
                        + 40, g_pad=8)
    for rank in range(2):
        adj = partition_batch(tb, 2, rank).adj
        assert_sorted_csr(adj)
        rows = adj.send_rows.reshape(-1)[adj.halo_order].numpy()
        assert (np.diff(rows) >= 0).all()
        np.testing.assert_array_equal(adj.halo_indptr.numpy(),
                                      np.searchsorted(rows, np.arange(
                                          adj.n_local + 1)))


# ---- the banded spill, resident against per batch ----------------------

@pytest.fixture(scope="module")
def chains():
    # chords of span 300 reach beyond the capped halo and spill
    return chain_graphs(4, 12, 300, n_lo=520, n_hi=640, chords=3)


def spill_by_node(adj, x, node_ids):
    """{(hop, node): the spill's sum into it} of a plan whose hop-major
    row k*N + i is node node_ids[i]'s at hop k."""
    K, N = adj.n_hops, adj.n_nodes
    g = x.reshape(-1, x.shape[-1])[adj.spill_senders.long().clamp(
        max=K * N - 1)]
    s = segment.sorted_segment_sum(g, adj.spill_rows, K * N,
                                   adj.spill_indptr).reshape(K, N, -1)
    return {(k, node): s[k, i] for k in range(K)
            for i, node in enumerate(node_ids) if node >= 0}


@pytest.mark.parametrize("gcn_norm", [False, True])
def test_resident_banded_spill_matches_per_batch(chains, path, gcn_norm):
    """The batch gathered from the BandedStore sorts its spill list once
    and sums each node's spill in collate_banded's order: bit for bit
    the per-batch sums; and its aggregation is the JAX gathered batch's."""
    js, ts = chains
    idx = [2, 0, 3]
    store = tres.build_banded_store(ts, V1, VK, gcn_norm=gcn_norm,
                                    device="cpu")
    got = tres.gather_banded_batch(store, torch.tensor(idx)).adj
    rows = got.spill_rows
    assert got.spill_sorted and bool((rows[1:] >= rows[:-1]).all())
    want = tbatch.collate_banded([ts[i] for i in idx], v1=V1, vk=VK,
                                 g_pad=3, tile=store.tile, halo=store.halo,
                                 spill_pad=store.spill_rows.shape[1] * 3,
                                 gcn_norm=gcn_norm).adj
    K, D = got.n_hops, 8
    rng = np.random.default_rng(6)
    # graph b's node j: slot b * n_slot + j in the store, packed in order
    # in the collated batch
    slot_ids = np.full(got.n_nodes, -1)
    packed_ids = np.full(want.n_nodes, -1)
    off = 0
    for b, i in enumerate(idx):
        nn_ = ts[i].num_nodes
        slot_ids[b * store.n_slot:b * store.n_slot + nn_] = off + np.arange(
            nn_)
        packed_ids[off:off + nn_] = off + np.arange(nn_)
        off += nn_
    feats = rng.standard_normal((off, K, D)).astype(np.float32)

    def table(ids):
        t = np.zeros((K, len(ids), D), np.float32)
        t[:, ids >= 0] = feats[ids[ids >= 0]].transpose(1, 0, 2)
        return torch.tensor(t)
    a = spill_by_node(got, table(slot_ids), slot_ids)
    b = spill_by_node(want, table(packed_ids), packed_ids)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[key], b[key]) for key in a)
    # the whole aggregation against the JAX package's gathered batch
    jgot = jres.gather_banded_batch(jres.build_banded_store(
        js, V1, VK, gcn_norm=gcn_norm), jnp.asarray(idx)).adj
    xs = rng.standard_normal((K, got.n_nodes, D)).astype(np.float32)
    t1 = rng.standard_normal((V1, D)).astype(np.float32)
    tk = rng.standard_normal((VK, D)).astype(np.float32)
    ours = banded_khop_aggregate(torch.tensor(xs), torch.tensor(t1),
                                 torch.tensor(tk), got, hop_major=True)
    theirs = jbanded.banded_khop_aggregate(jnp.asarray(xs), jnp.asarray(t1),
                                           jnp.asarray(tk), jgot,
                                           hop_major=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)
    assert (launches() > 0) == (path == "card_paths")


# ---- GCN's weighted histograms -----------------------------------------

@pytest.mark.parametrize("hops", [3, 2])
def test_weighted_hists_match_jax(path, hops):
    """The sender-weighted code histograms summed over the plan's (row,
    code) bins, whole and on a hop prefix, against the JAX package's."""
    rng = np.random.default_rng(12)
    n, K, E = 256, 3, 2500
    r, s = np.sort(rng.integers(0, n, E)), rng.integers(0, n, E)
    attr = rng.integers(0, 6, (E, K))
    scale = rng.uniform(0.1, 1.0, (n, K)).astype(np.float32)
    jplan = jspmm.build_plan(r, s, attr[:, :hops], n, 6, 6,
                             for_interpret=True)
    want = jspmm._weighted_hists(jplan, jnp.asarray(scale[:, :hops]), 6)
    plan = spmm.build_plan(r, s, attr, n, 6, 6).slice_hops(hops)
    # the bins: the edges sorted by (row, code), each bin once
    h = plan.hist_bins()
    idx = (plan.edge_recv * 6 + plan.fwd.codes.long())[h.order]
    bins = h.row * 6 + h.code
    assert bool((bins[1:] > bins[:-1]).all())
    np.testing.assert_array_equal(idx.numpy(), bins[h.seg.long()].numpy())
    np.testing.assert_array_equal(h.indptr.numpy(), np.searchsorted(
        h.seg.numpy(), np.arange(len(bins) + 1)))
    got = spmm._weighted_hists(plan, torch.tensor(scale[:, :hops]), 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert launches() == (path == "card_paths")


def test_hist_bins_are_built_on_first_use_and_shared(path):
    """A plan carries no bins until a sender-scaled aggregation asks for
    them (GCN, SAGE); then they are built once for the plan, its device
    copies and its hop slices, each slice's a prefix of the whole's."""
    rng = np.random.default_rng(13)
    n, K, E = 200, 3, 1500
    r, s = np.sort(rng.integers(0, n, E)), rng.integers(0, n, E)
    attr = rng.integers(0, 6, (E, K))
    plan = spmm.build_plan(r, s, attr, n, 6, 6)
    t1 = torch.randn(6, 4)
    tk = torch.randn(6, 4)
    spmm.khop_spmm(torch.randn(n, K, 4), t1, tk, plan)
    assert plan.hist_cache == {}
    sub = plan.to("cpu").slice_hops(2)
    scale = torch.rand(n, 2)
    spmm._weighted_hists(sub, scale, 6)
    assert list(plan.hist_cache) == [torch.device("cpu")]
    whole, part = plan.hist_bins(), sub.hist_bins()
    assert whole is plan.hist_cache[torch.device("cpu")]
    e = part.order.shape[0]
    assert e == sub.fwd.senders.shape[0]
    for f in ("order", "seg", "row", "code"):
        a, b = getattr(part, f), getattr(whole, f)
        assert torch.equal(a, b[:a.shape[0]])
    assert torch.equal(part.indptr, whole.indptr[:part.row.shape[0] + 1])
    assert part.hop_edges == whole.hop_edges[:2]


# ---- what each batch keeps for its sums ---------------------------------

@pytest.mark.parametrize("layout", ["per-batch", "resident", "node shard"])
def test_grad_rows_kept_with_the_batch(molecules, layout):
    """Each COO adjacency keeps its sums' backward rows with its CSR:
    the receivers, and one past the last node on the padded tail outside
    it, as ``segment_grad_rows`` builds them on the device."""
    if layout == "node shard":
        _, ts = molecules
        tb = tbatch.collate(ts, n_pad=256, e_pad=sum(
            g.num_edges for g in ts) + 40, g_pad=8)
        adj = partition_batch(tb, 2, 1).adj
        n = adj.n_local
    else:
        adj = coo_batches(molecules, layout)[1].adj
        n = adj.n_nodes
    want = segment.segment_grad_rows(adj.receivers, adj.indptr, n)
    assert adj.grad_rows.dtype == adj.receivers.dtype == torch.int32
    np.testing.assert_array_equal(adj.grad_rows.numpy(), want.numpy())
    tail = adj.grad_rows.numpy() == n
    assert not adj.edge_mask.numpy()[tail].any()
    assert tail.sum() == (0 if layout == "resident"
                          else adj.receivers.shape[0] - int(adj.indptr[-1]))


def test_resident_coo_pads_spread_over_the_slot():
    """The COO store spreads each slot's pads over its nodes, after each
    node's real edges: no node's range grows by more than its share, so
    the sorted sum has no long row the per-batch batch lacks."""
    js, ts = both_prep(raw_molecules(5, seed=3), **PREP)
    store = tres.build_coo_store(ts, device="cpu")
    r, m = store.receivers.numpy(), store.edge_mask.numpy()
    n, e = store.n_slot, store.e_slot
    for i in range(r.shape[0]):
        pads = e - int(m[i].sum())
        per_node = np.bincount(r[i][~m[i]], minlength=n)
        assert per_node.max() <= -(-pads // n)
        # within a node the real edges come first
        for v in range(n):
            mv = m[i][r[i] == v]
            assert not (np.diff(mv.astype(int)) > 0).any()


def test_identity_senders_are_one_kept_tensor():
    a = segment.identity(10, "cpu")
    b = segment.identity(4, "cpu")
    assert torch.equal(a, torch.arange(10, dtype=torch.int32))
    assert torch.equal(b, torch.arange(4, dtype=torch.int32))
    assert b.data_ptr() == a.data_ptr()
    c = segment.identity(50, "cpu")
    assert torch.equal(c, torch.arange(50, dtype=torch.int32))


@pytest.mark.parametrize("check", [False, True])
def test_check_sorted_catches_unsorted_ids(path, monkeypatch, check):
    """``CHECK_SORTED`` makes the sorted sum refuse ids out of order (on
    the card they would give wrong sums); sorted ids pass either way."""
    monkeypatch.setattr(segment, "CHECK_SORTED", check)
    x, ids = seeded_rows(1500, 3000, (4,), sorted_ids=False)
    xs, ids_s = torch.tensor(x), torch.tensor(np.sort(ids))
    segment.sorted_segment_sum(xs, ids_s, 1500)
    if not check:
        segment.sorted_segment_sum(xs, torch.tensor(ids), 1500)
        return
    with pytest.raises(ValueError, match="not sorted"):
        segment.sorted_segment_sum(xs, torch.tensor(ids), 1500)
    if path == "card_paths":        # segment_sum's route to the sorted sum
        with pytest.raises(ValueError, match="not sorted"):
            segment.segment_sum(xs, torch.tensor(ids), 1500)


# ---- the loader, config and backbone arguments -------------------------

def test_graph_loader_defaults_to_coo_as_in_jax(molecules):
    js, ts = molecules
    jl, tl = jloader.GraphLoader(js, 3), kt.GraphLoader(ts, 3)
    assert tl.mode == jl.mode == "coo"
    for jb, tb in zip(jl, tl):
        for f in ("senders", "receivers", "edge_attr", "edge_mask"):
            np.testing.assert_array_equal(getattr(tb.adj, f).numpy(),
                                          np.asarray(getattr(jb.adj, f)))
        assert_sorted_csr(tb.adj)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_drop_last_matches_jax(molecules, drop_last, shuffle):
    js, ts = molecules
    kw = dict(batch_size=3, shuffle=shuffle, seed=4, drop_last=drop_last)
    jl, tl = jloader.GraphLoader(js, **kw), kt.GraphLoader(ts, **kw)
    assert len(tl) == len(jl) == (2 if drop_last else 3)
    got, want = list(tl), list(jl)
    assert len(got) == len(want) == len(tl)
    for jb, tb in zip(want, got):
        np.testing.assert_array_equal(tb.graph_mask.numpy(),
                                      np.asarray(jb.graph_mask))
        np.testing.assert_array_equal(tb.adj.senders.numpy(),
                                      np.asarray(jb.adj.senders))


def test_trainer_cuts_the_resident_order_with_drop_last(molecules):
    """A resident COO epoch takes len(loader) steps: the order is cut to
    whole batches under drop_last, as the JAX trainer cuts it."""
    _, ts = molecules
    cfg = kt.ModelConfig(model_name="KPGIN", K=PREP["K"], num_layer=2,
                         hidden_size=6, num_hop1_edge=3,
                         max_pe_num=PREP["max_edge_attr_num"],
                         input_encoder=("embedding", 21),
                         task="graph_regression")
    steps = {}
    for drop_last in (False, True):
        loader = kt.GraphLoader(ts, 3, shuffle=True, seed=1,
                                drop_last=drop_last)
        rows = []
        kt.Trainer(kt.make_model(cfg), kt.TrainConfig(num_epochs=1, seed=1),
                   loss="l1", device="cpu", resident="on").fit(
            loader, seed=1, epoch_callback=lambda e, m, r: rows.append(r))
        steps[drop_last] = len(rows[0]["step_losses"])
        assert steps[drop_last] == len(loader)
    assert steps == {False: 3, True: 2}


def test_train_config_fields_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(kt.TrainConfig)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(jconfig.TrainConfig)}
    assert ours == theirs
    for f in ("step_decay_every", "step_decay_factor", "drop_last"):
        assert f in ours
    cfg = kt.TrainConfig(step_decay_every=20, step_decay_factor=0.3,
                         drop_last=True)
    assert (cfg.step_decay_every, cfg.step_decay_factor, cfg.drop_last) == (
        20, 0.3, True)


@pytest.mark.parametrize("K", [1, 2])
def test_gnn_peripheral_full_width_matches_jax(molecules, K):
    """GNN's peripheral embedding at the full width H: at K=1 (where H
    is the hop width) the model equals the JAX one; at K=2 both
    packages refuse the KPGIN layers, which take the hop width, and the
    port's tables have width H."""
    from kpgnn_tpu.models import factory as jfactory
    from kpgnn_tpu.models.backbones import GNN as JGNN
    from kpgnn_tpu.models.heads import GraphRegression as JReg
    from kpgnn_tpu_torch.models import factory as tfactory
    from kpgnn_tpu_torch.models.backbones import GNN
    from kpgnn_tpu_torch.models.heads import GraphRegression
    from tests.test_torch_layers import carry

    js, ts = both_prep(raw_molecules(4, seed=2), **dict(PREP, K=K))
    H = 8
    cfg = dict(model_name="KPGIN", hidden_size=H, num_layer=2, K=K,
               num_hop1_edge=3, max_pe_num=PREP["max_edge_attr_num"],
               input_encoder=("embedding", 21), task="graph_regression")

    def common(f, c):
        return dict(num_layer=2, hidden_size=H, K=K, layer_fn=f.make_gnn_layer(
            "KPGIN", H, K, num_layer=2, num_hop1_edge=3,
            num_pe=c.max_pe_num, combine=c.combine, aggr="add",
            train_eps=False), init_encoder=f._make_encoder(c),
            num_hop1_edge=3, max_edge_count=c.max_edge_count,
            max_hop_num=c.max_hop_num,
            max_distance_count=c.max_distance_count,
            peripheral_full_width=True)
    jc, tc = jfactory.ModelConfig(**cfg), tfactory.ModelConfig(**cfg)
    jm = JReg(JGNN(name="embedding_model", **common(jfactory, jc)), "sum", 1)
    tm = GraphRegression(GNN(**common(tfactory, tc)), "sum", H, 1)
    assert tm.embedding_model.peripheral.width == H
    jb, tb = jbatch.collate(js), tbatch.collate(ts)
    if K > 1:
        with pytest.raises(TypeError):
            jm.init(jax.random.PRNGKey(0), jb, train=False)
        with pytest.raises(RuntimeError):
            tm.eval()(tb, train=False)
        return
    variables = jm.init(jax.random.PRNGKey(0), jb, train=False)
    carry(tm, variables).eval()
    with torch.no_grad():
        got = tm(tb, train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jm.apply(variables, jb, train=False)), **TOL)
