"""The port's k-hop prep, collation and loader against the JAX package.

Inputs are made from numpy seeds and go through both packages; prep is
compared bit for bit, collated batches field by field.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

import kpgnn_tpu.graph.batch as jbatch
import kpgnn_tpu.prep.khop as jkhop
from kpgnn_tpu.data.synthetic import _random_connected
from kpgnn_tpu.train.loader import GraphLoader as JGraphLoader
from kpgnn_tpu_torch.graph import batch as tbatch
from kpgnn_tpu_torch.prep import khop as tkhop
from kpgnn_tpu_torch.train.loader import GraphLoader

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLES = sorted(glob.glob(os.path.join(
    REPO, "kpgnn_tpu", "data", "parity_golden", "*.npz")))
GRAPH_FIELDS = ("edge_index", "edge_attr", "x", "y", "pe_attr",
                "peripheral_edge_attr", "peripheral_config_attr", "rd")
ZINC_PREP = dict(K=8, kernel="spd", max_edge_attr_num=50, max_hop_num=6,
                 max_edge_type=3, max_edge_count=50, max_distance_count=50)


def raw_molecules(n, seed=0, n_min=9, n_max=37):
    """ZINC-shaped raw graphs: connected, bond codes 2..4, atom codes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        nn_ = int(rng.integers(n_min, n_max + 1))
        ei = _random_connected(nn_, rng)
        half = ei.shape[1] // 2
        t = rng.integers(2, 5, size=half)
        out.append(dict(num_nodes=nn_, edge_index=ei,
                        edge_attr=np.concatenate([t, t]),
                        x=rng.integers(0, 21, size=(nn_, 1)),
                        y=rng.normal(size=(1,)).astype(np.float32)))
    return out


def both_prep(raws, **cfg):
    """The same raw graphs through both packages' extract_khop."""
    jc, tc = jkhop.KHopConfig(**cfg), tkhop.KHopConfig(**cfg)
    js = [jkhop.extract_khop(r["num_nodes"], r["edge_index"],
                             r["edge_attr"], jc, x=r["x"], y=r["y"])
          for r in raws]
    ts = tkhop.extract_graphs(raws, tc)
    return js, ts


def assert_graphs_equal(jg, tg):
    assert jg.num_nodes == tg.num_nodes
    for f in GRAPH_FIELDS:
        a, b = getattr(jg, f), getattr(tg, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("bundle", BUNDLES,
                         ids=[os.path.basename(b) for b in BUNDLES])
def test_extract_khop_bit_equal_on_golden_raw_graphs(bundle):
    g = np.load(bundle)
    a = json.loads(bytes(g["meta"]).decode())
    raw = dict(num_nodes=int(g["raw/n"][0]), edge_index=g["raw/edge_index"],
               edge_attr=g["raw/edge_attr"], x=g["raw/x"],
               y=np.array([0], np.int64))
    cfg = dict(K=a["K"], kernel=a["kernel"],
               max_edge_attr_num=a["max_edge_attr_num"],
               max_hop_num=a["max_hop_num"],
               max_edge_type=a["max_edge_type"],
               max_edge_count=a["max_edge_count"],
               max_distance_count=a["max_distance_count"],
               use_rd=a["use_rd"])
    (jg,), (tg,) = both_prep([raw], **cfg)
    assert_graphs_equal(jg, tg)


@pytest.mark.parametrize("kernel", ["spd", "gd"])
def test_extract_khop_bit_equal_on_molecules_k8(kernel):
    js, ts = both_prep(raw_molecules(20, seed=1),
                       **dict(ZINC_PREP, kernel=kernel))
    for jg, tg in zip(js, ts):
        assert_graphs_equal(jg, tg)


def test_extract_khop_edgeless_graph():
    raw = dict(num_nodes=3, edge_index=np.zeros((2, 0), np.int64),
               edge_attr=None, x=np.zeros((3, 1), np.int64),
               y=np.zeros(1, np.float32))
    (jg,), (tg,) = both_prep([raw], **ZINC_PREP)
    assert_graphs_equal(jg, tg)


@pytest.mark.parametrize("wo_pe,wo_ef", [(True, False), (False, True),
                                         (True, True)])
def test_ablation_clamps_match(wo_pe, wo_ef):
    js, ts = both_prep(raw_molecules(4, seed=2), K=3, max_edge_attr_num=9)
    for jg, tg in zip(js, ts):
        assert_graphs_equal(jkhop.apply_ablation_clamps(jg, wo_pe, wo_ef),
                            tkhop.apply_ablation_clamps(tg, wo_pe, wo_ef))


NODE_FIELDS = ("x", "node_mask", "node_graph_ids", "pe_attr",
               "peripheral_edge_attr", "peripheral_config_attr", "y",
               "graph_mask")


def assert_batches_equal(jb, tb):
    for f in NODE_FIELDS:
        a, b = getattr(jb, f), getattr(tb, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)
    jp, tp = jb.adj, tb.adj
    for f in ("counts1", "countsk", "union_deg", "hop_deg"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                      getattr(tp, f).numpy(), err_msg=f)


def test_collate_pallas_fields_and_histograms_match():
    js, ts = both_prep(raw_molecules(12, seed=3), **ZINC_PREP)
    # n_pad a multiple of the JAX kernel tile, so both keep it as given
    jb = jbatch.collate_pallas(js, v1=5, vk=52, n_pad=512, e_pad=8192,
                               g_pad=13)
    tb = tbatch.collate_pallas(ts, v1=5, vk=52, n_pad=512, e_pad=8192,
                               g_pad=13)
    assert tb.n_pad == 512 and tb.g_pad == 13
    assert_batches_equal(jb, tb)
    # reserved pad slots: the last node slot and the last graph slot
    ids = tb.node_graph_ids.numpy()
    assert (ids[~tb.node_mask.numpy()] == 12).all()
    assert not tb.graph_mask[-1]


def test_collate_coo_edges_match():
    js, ts = both_prep(raw_molecules(5, seed=4), K=3, max_edge_attr_num=9)
    jb = jbatch.collate(js, n_pad=256, e_pad=1024, g_pad=6)
    tb = tbatch.collate(ts, n_pad=256, e_pad=1024, g_pad=6)
    for f in ("senders", "receivers", "edge_attr", "edge_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(jb.adj, f)),
                                      getattr(tb.adj, f).numpy(), err_msg=f)


def test_loader_worst_case_layout_matches():
    js, ts = both_prep(raw_molecules(40, seed=5), **ZINC_PREP)
    jl = JGraphLoader(js, 16, mode="pallas", v1=5, vk=52)
    tl = GraphLoader(ts, 16, mode="pallas", v1=5, vk=52)
    assert (tl.n_pad, tl.e_pad, tl.g_pad) == (jl.n_pad, jl.e_pad, jl.g_pad)
    for jb, tb in zip(jl, tl):
        assert_batches_equal(jb, tb)


def test_loader_shuffle_order_matches():
    js, ts = both_prep(raw_molecules(24, seed=6), K=2, max_edge_attr_num=5)
    jl = JGraphLoader(js, 8, shuffle=True, seed=3, mode="pallas", v1=5, vk=7)
    tl = GraphLoader(ts, 8, shuffle=True, seed=3, mode="pallas", v1=5, vk=7)
    for jb, tb in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(jb.y), tb.y.numpy())


def test_loader_refuses_unported_modes():
    """Every mode of the JAX loader is ported; a mode it does not know
    still raises, naming ROADMAP.md."""
    ts = tkhop.extract_graphs(raw_molecules(2), tkhop.KHopConfig(K=2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GraphLoader(ts, 2, mode="sharded", v1=4, vk=4)


def test_coo_loader_layout_and_edges_match():
    js, ts = both_prep(raw_molecules(20, seed=8), K=3, max_edge_attr_num=9)
    jl = JGraphLoader(js, 8, mode="coo")
    tl = GraphLoader(ts, 8, mode="coo")
    assert (tl.n_pad, tl.e_pad, tl.g_pad) == (jl.n_pad, jl.e_pad, jl.g_pad)
    for jb, tb in zip(jl, tl):
        for f in NODE_FIELDS:
            a, b = getattr(jb, f), getattr(tb, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                              err_msg=f)
        for f in ("senders", "receivers", "edge_attr", "edge_mask"):
            np.testing.assert_array_equal(np.asarray(getattr(jb.adj, f)),
                                          getattr(tb.adj, f).numpy(),
                                          err_msg=f)
