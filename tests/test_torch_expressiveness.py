"""The port's expressiveness slice against the JAX package: the graph6
parser against networkx, the EXP/CEXP/SR25 loaders on fixtures the
tests and chip_smoke.py write, the k-regular generator, the collision
rate and one simulation embedding on carried weights, the search
presets (the scripts themselves: test_torch_expressiveness_scripts.py).
Activations atol 1e-5 / rtol 1e-4 (f32; the two sides sum in different
orders)."""
import os
import pickle
import sys
import types

import jax
import networkx as nx
import numpy as np
import pytest
import torch

import chip_smoke
from kpgnn_tpu.data.expressiveness import load_exp_pickle as jload_pickle
from kpgnn_tpu.data.expressiveness import load_exp_txt as jload_txt
from kpgnn_tpu.data.expressiveness import load_sr25 as jload_sr25
from kpgnn_tpu.graph.batch import collate as jcollate
from kpgnn_tpu.models import make_model as jmake_model
from kpgnn_tpu.prep import KHopConfig as JKHopConfig
from kpgnn_tpu.prep import extract_khop as jextract_khop
from kpgnn_tpu.scripts import run_search as jrun_search
from kpgnn_tpu.scripts import run_simulation as jsim
from kpgnn_tpu_torch.data.expressiveness import (load_exp_pickle,
                                                 load_exp_txt, load_sr25,
                                                 parse_graph6, read_graph6)
from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.prep.khop import KHopConfig, extract_khop
from kpgnn_tpu_torch.scripts import run_search, run_simulation
from kpgnn_tpu_torch.utils.convert import params_from_flax
from tests.test_torch_layers import flat

torch.set_num_threads(1)
ACT = dict(atol=1e-5, rtol=1e-4)


def write_g6(path, graphs, header):
    with open(path, "wb") as f:
        for i, g in enumerate(graphs):
            f.write(nx.to_graph6_bytes(g, header=header and i == 0))
    return str(path)


def assert_records_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("header", [False, True])
@pytest.mark.parametrize("n", [1, 2, 7, 25, 62, 63, 100])
def test_graph6_parser_equals_networkx(tmp_path, n, header):
    """N(n) in one byte (n <= 62) and in four (n > 62), with and without
    the >>graph6<< header, against ``nx.read_graph6`` on files written by
    networkx."""
    graphs = [nx.gnp_random_graph(n, p, seed=s)
              for s, p in enumerate((0.1, 0.5, 0.9))]
    path = write_g6(tmp_path / "g.g6", graphs, header)
    ref = nx.read_graph6(path)
    ref = ref if isinstance(ref, list) else [ref]
    got = read_graph6(path)
    assert len(got) == len(ref) == 3
    for (m, edges), g in zip(got, ref):
        assert m == g.number_of_nodes() == n
        assert sorted(edges) == sorted(tuple(sorted(e)) for e in g.edges)
    line = nx.to_graph6_bytes(graphs[1], header=header)
    assert parse_graph6(line) == got[1]
    with pytest.raises(ValueError):
        parse_graph6(line.strip() + b"?")           # one byte too many
    with pytest.raises(ValueError):
        parse_graph6(b"!" + line.strip())           # a byte below 63


@pytest.mark.parametrize("header", [False, True])
def test_load_sr25_equals_jax(tmp_path, header):
    graphs = [nx.random_regular_graph(4, 25, seed=s) for s in range(15)]
    path = write_g6(tmp_path / "sr.g6", graphs, header)
    assert_records_equal(load_sr25(path), jload_sr25(path))


def test_smoke_sr25_fixture_is_strongly_regular_and_reads_in_networkx(
        tmp_path):
    """chip_smoke.py's own graph6 encoder writes what networkx writes, and
    its 15 graphs are SRG(25,12,5,6)."""
    graphs = chip_smoke.write_sr25_fixture(str(tmp_path))
    assert len(graphs) == 15
    for n, edges in graphs:
        assert chip_smoke.srg_parameters(n, edges) == (25, 12, 5, 6)
        g = nx.Graph()
        g.add_nodes_from(range(n))
        g.add_edges_from(edges)
        assert chip_smoke.to_graph6(n, edges) == nx.to_graph6_bytes(
            g, header=False)
    path = str(tmp_path / "sr25" / "raw" / "sr251256.g6")
    assert_records_equal(load_sr25(path), jload_sr25(path))
    assert chip_smoke.srg_parameters(4, [(0, 1), (1, 2)]) is None


def test_load_exp_pickle_flat_layout_equals_jax(tmp_path):
    """chip_smoke.py's EXP fixture: PyG-class objects with torch tensors,
    the flat layout; pairs of 3-regular graphs with opposite labels."""
    chip_smoke.write_exp_fixture(str(tmp_path), n_pairs=20)
    path = str(tmp_path / "EXP" / "raw" / "GRAPHSAT.pkl")
    ours = load_exp_pickle(path)
    assert_records_equal(ours, jload_pickle(path))
    assert len(ours) == 40
    for i in range(0, 40, 2):
        a, b = ours[i], ours[i + 1]
        assert a["num_nodes"] == b["num_nodes"] and a["num_nodes"] % 4 == 0
        assert {int(a["y"][0]), int(b["y"][0])} == {0, 1}
        for g in (a, b):
            deg = np.bincount(g["edge_index"][1], minlength=g["num_nodes"])
            assert (deg == 3).all()
    assert not any(m.startswith("torch_geometric") for m in sys.modules)


def test_load_exp_pickle_store_layout_equals_jax(tmp_path, monkeypatch):
    """Newer PyG keeps the fields under ``__dict__['_store']`` (numpy
    arrays here, a 1-D x, no num_nodes), both classes from
    torch_geometric modules."""
    mods = {m: types.ModuleType(m) for m in (
        "torch_geometric", "torch_geometric.data",
        "torch_geometric.data.data", "torch_geometric.data.storage")}
    Data = type("Data", (), {"__module__": "torch_geometric.data.data"})
    Storage = type("GlobalStorage", (),
                   {"__module__": "torch_geometric.data.storage"})
    mods["torch_geometric.data.data"].Data = Data
    mods["torch_geometric.data.storage"].GlobalStorage = Storage
    for m, mod in mods.items():
        monkeypatch.setitem(sys.modules, m, mod)
    rng = np.random.default_rng(0)
    objs = []
    for i in range(6):
        n = int(rng.integers(4, 9))
        st = Storage()
        ei = np.stack([np.arange(n), (np.arange(n) + 1) % n])
        st.edge_index = np.concatenate([ei, ei[::-1]], 1)
        st.x = rng.integers(0, 2, n)
        st.y = np.array([i % 2])
        d = Data()
        d._store = st
        objs.append(d)
    path = tmp_path / "GRAPHSAT.pkl"
    with open(path, "wb") as f:
        pickle.dump(objs, f)
    for m in mods:
        monkeypatch.delitem(sys.modules, m)
    ours = load_exp_pickle(str(path))
    assert_records_equal(ours, jload_pickle(str(path)))
    assert ours[0]["x"].shape == (ours[0]["num_nodes"], 1)


def test_load_exp_txt_equals_jax(tmp_path):
    chip_smoke.write_exp_fixture(str(tmp_path), n_pairs=10, txt=True)
    path = str(tmp_path / "CEXP" / "GRAPHSAT.txt")
    ours = load_exp_txt(path)
    assert_records_equal(ours, jload_txt(path))
    assert len(ours) == 20


@pytest.mark.parametrize("n,r", [(20, 3), (50, 3), (40, 4)])
def test_generate_k_regular_equals_jax(n, r):
    for seed in range(5):
        assert_records_equal(run_simulation.generate_k_regular(n, r, 3, seed),
                             jsim.generate_k_regular(n, r, 3, seed))


def test_collision_rate_equals_jax():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(30, 8)).astype(np.float32)
    emb[5] = emb[3]
    emb[17] = emb[3]
    emb[20] = emb[2] + 1e-9
    for e in (emb, np.zeros((6, 4)), rng.normal(size=(9, 3))):
        assert run_simulation.collision_rate(e) == jsim.collision_rate(e)
    assert run_simulation.collision_rate(emb) == 8 / (30 * 29)


def pair_distances(emb):
    """Distances of the distinct node pairs (i < j)."""
    d = np.linalg.norm(emb[:, None] - emb[None], axis=-1)
    return d[np.triu_indices(len(emb), 1)]


@pytest.mark.parametrize("backend", ["coo", "pallas", "dense"])
def test_simulation_embedding_equals_jax_on_carried_weights(backend):
    """The JAX main's model, initialized as there from PRNGKey(seed + i),
    carried into the port: the same node embeddings on every backend, the
    same node pairs equal within rounding (1e-5 of the largest |value|),
    and the same collision rate under the JAX 1e-8 threshold on coo and on
    the kernel plan.  That threshold is below f32 rounding: x is all
    ones, so two nodes equal in exact arithmetic sum the same values, and
    they collide only where their sums run in the same order.  The dense
    backend's batched matmul orders them otherwise, so there the rate
    differs; every pair that collides on one side only is equal within
    rounding on both."""
    args = run_simulation.parser().parse_args(["--backend", backend])
    kcfg = dict(K=args.K, kernel="spd", max_edge_attr_num=10, max_hop_num=1,
                max_edge_type=1, max_edge_count=1, max_distance_count=1)
    mcfg = dict(model_name="KPGIN", hidden_size=args.hidden_size,
                num_layer=1, K=args.K, num_hop1_edge=1, max_pe_num=10,
                JK="last", combine="geometric", virtual_node=False,
                wo_peripheral_edge=True, wo_peripheral_configuration=True,
                input_encoder=("embedding", 2), task="node_classification",
                output_size=args.hidden_size)
    tcfg = run_simulation.model_config(args.K, args.hidden_size)
    assert run_simulation.khop_config(args.K) == KHopConfig(**kcfg)
    assert tcfg == ModelConfig(**mcfg)
    lk = run_simulation.loader_kwargs(args, tcfg)
    raw = run_simulation.generate_k_regular(args.n, args.r, 2, args.seed)
    rates_j, rates_t = [], []
    for i, g in enumerate(raw):
        jg = jextract_khop(g["num_nodes"], g["edge_index"], None,
                           JKHopConfig(**kcfg), x=g["x"], y=g["y"])
        jb = jcollate([jg])
        jmodel = jmake_model(jsim.ModelConfig(**mcfg))
        v = jmodel.init(jax.random.PRNGKey(args.seed + i), jb, train=False)
        jemb = np.asarray(jmodel.apply(v, jb, train=False))[
            np.asarray(jb.node_mask)]
        model = make_model(tcfg)
        model.load_state_dict(params_from_flax(flat(v)), strict=True)
        tg = extract_khop(g["num_nodes"], g["edge_index"], None,
                          KHopConfig(**kcfg), x=g["x"], y=g["y"])
        temb = run_simulation.node_embeddings(model, tg, lk,
                                              torch.device("cpu"))
        np.testing.assert_allclose(temb, jemb, **ACT)
        rates_j.append(jsim.collision_rate(jemb))
        rates_t.append(run_simulation.collision_rate(temb))
        dt, dj = pair_distances(temb), pair_distances(jemb)
        tol = 1e-5 * float(np.abs(jemb).max())
        np.testing.assert_array_equal(dt < tol, dj < tol)
        one_side = (dt < 1e-8) != (dj < 1e-8)
        assert (dt[one_side] < tol).all() and (dj[one_side] < tol).all()
        if backend != "dense":
            assert not one_side.any()
    assert 0.0 < rates_t[0] < 1.0
    if backend != "dense":
        assert rates_t == rates_j


def test_search_presets_equal_jax():
    """Preset for preset, the JAX flag lists; the script keys name the
    same scripts in the port's package."""
    ours, theirs = run_search._presets(), jrun_search._presets()
    assert ours == theirs and len(ours) == 7
    assert run_search.SCRIPTS.keys() == jrun_search.SCRIPTS.keys()
    for k, mod in run_search.SCRIPTS.items():
        assert mod == jrun_search.SCRIPTS[k].replace("kpgnn_tpu.",
                                                     "kpgnn_tpu_torch.")
        assert os.path.isfile(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            *mod.split(".")) + ".py"), mod
