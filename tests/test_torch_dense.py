"""The port's dense backend against the JAX package: ``collate_dense``
field by field, the dense loader, ``khop_aggregate_adj`` on ``DenseAdj``
for every aggregation mode with values and gradients, the max oracle,
``degree`` and ``union_in_degree``, and the seven golden bundles module by
module on ``--backend dense``.

Tolerances (f32): activations atol 1e-5 / rtol 1e-4, gradients rtol 1e-4
with an atol of 1e-4 of the gradient scale (the two sides sum in
different orders); collated fields and degrees are exact.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kpgnn_tpu.graph.batch as jbatch
import kpgnn_tpu.graph.data as jdata
import kpgnn_tpu.ops.adjacency as jadjacency
import kpgnn_tpu.prep.khop as jkhop
from kpgnn_tpu.train.loader import GraphLoader as JGraphLoader
from kpgnn_tpu_torch.graph import batch as tbatch
from kpgnn_tpu_torch.graph import data as tdata
from kpgnn_tpu_torch.ops import adjacency
from kpgnn_tpu_torch.prep import khop as tkhop
from kpgnn_tpu_torch.train.loader import GraphLoader
from tests.test_torch_families import BUNDLES, FLAX_ONLY, GOLDEN_DIR, golden_setup
from tests.test_torch_layers import close

torch.set_num_threads(1)
ACT = dict(atol=1e-5, rtol=1e-4)
V1, VK = 6, 8               # num_hop1_edge + 2, max_pe_num + 2
BATCH_FIELDS = ("x", "node_mask", "node_graph_ids", "pe_attr",
                "peripheral_edge_attr", "peripheral_config_attr", "rd", "z",
                "pos", "y", "graph_mask")


def assert_dense_batches_equal(jb, tb):
    for f in BATCH_FIELDS:
        a, b = getattr(jb, f), getattr(tb, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)
    for f in ("hop_attr", "counts1", "countsk"):
        a, b = getattr(jb.adj, f), getattr(tb.adj, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)


def golden_graphs(name):
    """The bundle's raw graph through both packages' prep."""
    g = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    a = json.loads(bytes(g["meta"]).decode())
    cfg = dict(K=a["K"], kernel=a["kernel"],
               max_edge_attr_num=a["max_edge_attr_num"],
               max_hop_num=a["max_hop_num"], max_edge_type=a["max_edge_type"],
               max_edge_count=a["max_edge_count"],
               max_distance_count=a["max_distance_count"], use_rd=a["use_rd"])
    n = int(g["raw/n"][0])
    args = (n, g["raw/edge_index"], g["raw/edge_attr"])
    kw = dict(x=g["raw/x"], y=np.array([0]))
    return (jkhop.extract_khop(*args, jkhop.KHopConfig(**cfg), **kw),
            tkhop.extract_khop(*args, tkhop.KHopConfig(**cfg), **kw), a)


@pytest.mark.parametrize("name", BUNDLES)
def test_collate_dense_fields_match_on_golden_raw_graphs(name):
    jg, tg, a = golden_graphs(name)
    v1, vk = a["num_hop1_edge"] + 2, a["max_pe_num"] + 2
    n_slot = -(-jg.num_nodes // 8) * 8
    jb = jbatch.collate_dense([jg], n_slot=n_slot, v1=v1, vk=vk)
    tb = tbatch.collate_dense([tg], n_slot=n_slot, v1=v1, vk=vk)
    assert tb.n_pad == n_slot and tb.g_pad == 1
    assert_dense_batches_equal(jb, tb)


def graphs_case(K=3, seed=0, n_graphs=3, pkg=tdata):
    """Small graphs with de-duplicated (u, v) pairs (a dense tile holds one
    code per pair), hop-1 codes in [2, V1 - 1), hop-k codes in [0, VK - 2),
    and x, y, z, pos, rd and pe_attr, made from a numpy seed."""
    rng = np.random.default_rng(seed)
    gs = []
    for _ in range(n_graphs):
        n = int(rng.integers(5, 9))
        e = int(rng.integers(6, 14))
        ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
        _, keep = np.unique(ei[0] * n + ei[1], return_index=True)
        ei = ei[:, np.sort(keep)]
        e = ei.shape[1]
        ea = rng.integers(0, VK - 2, size=(e, K))
        ea[:, 0] = rng.integers(2, V1 - 1, size=e)
        gs.append(pkg.Graph(
            num_nodes=n, edge_index=ei, edge_attr=ea,
            x=rng.normal(size=(n, 12)).astype(np.float32),
            y=rng.normal(size=(1,)).astype(np.float32),
            pe_attr=rng.integers(0, VK - 2, size=(n, K - 1)).astype(np.int32),
            rd=rng.normal(size=(n, 1)).astype(np.float32),
            z=rng.integers(1, 10, size=n),
            pos=rng.normal(size=(n, 3)).astype(np.float32)))
    return gs


def test_collate_dense_partial_batch_and_clipped_codes_match():
    """Three graphs in five graph slots (graph_mask false past them), and
    a hop-k vocabulary smaller than the codes: out-of-vocabulary codes
    count in the last bin."""
    jgs, tgs = graphs_case(seed=1, pkg=jdata), graphs_case(seed=1)
    for v1, vk in ((V1, VK), (V1, 4)):
        jb = jbatch.collate_dense(jgs, n_slot=10, v1=v1, vk=vk, g_pad=5)
        tb = tbatch.collate_dense(tgs, n_slot=10, v1=v1, vk=vk, g_pad=5)
        assert tb.n_pad == 50 and tb.g_pad == 5
        assert_dense_batches_equal(jb, tb)
        assert not tb.graph_mask[3:].any()
        # padded nodes carry their own slot's graph id
        np.testing.assert_array_equal(tb.node_graph_ids.numpy(),
                                      np.repeat(np.arange(5), 10))
    with pytest.raises(ValueError, match="n_slot"):
        tbatch.collate_dense(tgs, n_slot=4, v1=V1, vk=VK)


def test_dense_loader_matches_jax():
    raws = [dict(num_nodes=g.num_nodes, edge_index=g.edge_index,
                 edge_attr=g.edge_attr[:, 0], x=g.x, y=g.y)
            for g in graphs_case(seed=2, n_graphs=11)]
    cfg = dict(K=3, kernel="spd", max_edge_attr_num=VK - 2)
    js = [jkhop.extract_khop(r["num_nodes"], r["edge_index"], r["edge_attr"],
                             jkhop.KHopConfig(**cfg), x=r["x"], y=r["y"])
          for r in raws]
    ts = tkhop.extract_graphs(raws, tkhop.KHopConfig(**cfg))
    jl = JGraphLoader(js, 4, shuffle=True, seed=3, mode="dense", v1=V1,
                      vk=VK)
    tl = GraphLoader(ts, 4, shuffle=True, seed=3, mode="dense", v1=V1, vk=VK)
    assert (tl.n_slot, tl.g_pad) == (jl.n_slot, jl.g_pad) == (8, 4)
    batches = list(zip(jl, tl))
    assert len(batches) == 3            # the last batch is partial
    for jb, tb in batches:
        assert_dense_batches_equal(jb, tb)
    with pytest.raises(ValueError, match="n_slot"):
        GraphLoader(ts, 4, mode="dense", v1=V1, vk=VK, n_slot=4)


def both_dense(K=3, seed=0, n_graphs=3):
    jb = jbatch.collate_dense(graphs_case(K, seed, n_graphs, jdata),
                              n_slot=10, v1=V1, vk=VK)
    tb = tbatch.collate_dense(graphs_case(K, seed, n_graphs), n_slot=10,
                              v1=V1, vk=VK)
    return jb, tb


@pytest.mark.parametrize("kw,hop_major", [
    ("add", False), ("add", True), ("mean", False), ("mean", True),
    ("gcn", False), ("gcn", True), ("max", False)])
def test_dense_khop_aggregate_adj_against_jax(kw, hop_major):
    """Values and gradients of x, both tables and, for GCN, the receiver
    and sender scales; table row 0 is zeroed at use."""
    K, D = 3, 5
    jb, tb = both_dense(K, seed=4)
    n = tb.n_pad
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, K, D)).astype(np.float32)
    if hop_major:
        x = x.transpose(1, 0, 2).copy()
    t1 = rng.normal(size=(V1, D)).astype(np.float32)
    tk = rng.normal(size=(VK, D)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, size=(n, K)).astype(np.float32)
    sj = rng.uniform(0.5, 2.0, size=(n, K)).astype(np.float32)
    args = [x, t1, tk] + ([s, sj] if kw == "gcn" else [])

    def split(a):
        extra = dict(aggr=kw) if kw in ("mean", "max") else {}
        if kw == "gcn":
            extra = dict(scale=a[3], sender_scale=a[4])
        return a[:3], extra

    def jf(*a):
        (xx, a1, ak), extra = split(a)
        out = jadjacency.khop_aggregate_adj(jb.adj, xx, a1, ak,
                                            hop_major=hop_major, **extra)
        return jnp.sum(out * jnp.sin(out)), out

    (_, jout), jg = jax.value_and_grad(
        jf, argnums=tuple(range(len(args))), has_aux=True)(
        *map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    (tx, ta1, tak), extra = split(ts)
    tout = adjacency.khop_aggregate_adj(tb.adj, tx, ta1, tak,
                                        hop_major=hop_major, **extra)
    close(tout, jout)
    (tout * torch.sin(tout)).sum().backward()
    for t, g in zip(ts, jg):
        close(t.grad, g, rtol=1e-4, atol=1e-4 * float(np.abs(g).max()))
    assert not ts[1].grad[0].any() and not ts[2].grad[0].any()


def test_dense_max_matches_reference_oracle():
    """Max on COO and on dense against a literal numpy oracle: union
    edges dead at hop k contribute 0.0, receivers with no union edge read
    0 (strictly negative features make those zeros the answer)."""
    K, D = 3, 5
    gs = graphs_case(K, seed=11)
    coo = tbatch.collate(gs, n_pad=64, e_pad=128, g_pad=len(gs) + 1)
    dense = tbatch.collate_dense(gs, n_slot=10, v1=V1, vk=VK)
    rng = np.random.default_rng(3)
    x = -np.abs(rng.normal(size=(coo.n_pad, K, D))).astype(np.float32) - 0.1
    t1 = rng.normal(size=(V1, D)).astype(np.float32)
    tk = rng.normal(size=(VK, D)).astype(np.float32)
    a = coo.adj
    snd, rcv = a.senders.numpy(), a.receivers.numpy()
    attr, mask = a.edge_attr.numpy(), a.edge_mask.numpy()
    want = np.zeros((coo.n_pad, K, D), np.float32)
    for i in range(coo.n_pad):
        for k in range(K):
            cands = []
            for e in np.flatnonzero(mask & (rcv == i)):
                if attr[e, k] > 0:
                    tab = t1 if k == 0 else tk
                    cands.append(x[snd[e], k] + tab[attr[e, k]])
                else:
                    cands.append(np.zeros(D, np.float32))
            if cands:
                want[i, k] = np.max(np.stack(cands), axis=0)
    tabs = (torch.from_numpy(t1), torch.from_numpy(tk))
    got = adjacency.khop_aggregate_adj(a, torch.from_numpy(x), *tabs,
                                       aggr="max").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    rows_c = np.flatnonzero(coo.node_mask.numpy())
    rows_d = np.flatnonzero(dense.node_mask.numpy())
    x_d = np.zeros((dense.n_pad, K, D), np.float32)
    x_d[rows_d] = x[rows_c]
    got = adjacency.khop_aggregate_adj(dense.adj, torch.from_numpy(x_d),
                                       *tabs, aggr="max").numpy()
    np.testing.assert_allclose(got[rows_d], want[rows_c], atol=1e-5)
    assert not got[~dense.node_mask.numpy()].any()


@pytest.mark.parametrize("k", [1, 2, 3])
def test_dense_degrees_against_jax(k):
    jb, tb = both_dense(3, seed=6)
    ja, ta = jb.adj.slice_hops(k), tb.adj.slice_hops(k)
    for self_loop in (False, True):
        np.testing.assert_array_equal(
            adjacency.degree(ta, self_loop).numpy(),
            np.asarray(jadjacency.degree(ja, self_loop)))
    np.testing.assert_array_equal(adjacency.union_in_degree(ta).numpy(),
                                  np.asarray(jadjacency.union_in_degree(ja)))
    assert not adjacency.hop_major_native(ta)


@pytest.mark.parametrize("name", BUNDLES)
def test_golden_bundle_module_by_module_on_dense(name):
    """The bundle's stored weights and activations on a dense batch of its
    one graph with n_slot = n + 1, the node layout of its COO batch.  The
    dense batch has one graph slot where the bundle has two (the graph
    and the reserved pad slot), so graph-level activations are compared
    on their first row; and its pad node belongs to graph 0 where the
    bundle's belongs to the pad slot (a virtual node reaches it), so
    node-level activations are compared on the real nodes."""
    g, model, _ = golden_setup(name, "coo")
    _, tg, a = golden_graphs(name)
    batch = tbatch.collate_dense([tg], n_slot=tg.num_nodes + 1,
                                 v1=a["num_hop1_edge"] + 2,
                                 vk=a["max_pe_num"] + 2)
    acts = {}
    for mname, mod in model.named_modules():
        mod.register_forward_hook(
            lambda m, i, o, mname=mname: acts.__setitem__(
                mname.replace(".", "/"), o))
    with torch.no_grad():
        out = model(batch, train=False)
    close(out, g["act/__output__"][:1])
    real = batch.node_mask.numpy()
    compared = []
    for key in g.files:
        if not (key.startswith("act/") and key.endswith("__call__")):
            continue
        mname = key[len("act/"):-len("__call__")].rstrip("/")
        if any(f in mname for f in FLAX_ONLY):
            continue
        ours, want = acts[mname].numpy(), g[key]
        if mname.endswith("attention_lstm") and ours.shape != want.shape:
            ours = ours.transpose(1, 0, 2)
        if ours.shape != want.shape and ours.shape[0] == 1:
            want = want[:1]                 # graph slots: no pad slot here
        if ours.shape[0] == batch.n_pad:    # node rows
            ours, want = ours[real], want[real]
        np.testing.assert_allclose(ours, want, err_msg=mname, **ACT)
        compared.append(mname)
    assert {"", "classifier", "embedding_model",
            "embedding_model/peripheral", "embedding_model/norm1"
            } <= set(compared), compared
    assert len(compared) >= 17, compared
