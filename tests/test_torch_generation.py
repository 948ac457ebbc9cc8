"""The port's generated datasets against the JAX package.

* the ten graph families, drawn without networkx: adjacency, node values
  and family exactly equal to the networkx-built JAX generator for every
  family, N in {15, 19, 24} and several seeds; the power-law tree, its
  failures and its Prüfer fallback against networkx itself;
* the graph oracles;
* the counting dataset (60 graphs) and the property dataset (scale 0.02),
  array by array;
* the TU parsers on the fixtures of tests/test_scripts.py and on the
  smoke run's MUTAG-scale fixture;
* StepDecay.
"""
import random

import networkx as nx
import numpy as np
import pytest

import kpgnn_tpu.data.algorithms as jalg
import kpgnn_tpu.data.generation as jgen
import kpgnn_tpu.data.tu as jtu
from chip_smoke import write_gin_fixture
from kpgnn_tpu.data.counting import TASKS as JTASKS
from kpgnn_tpu.data.counting import generate_counting_dataset as jcounting
from kpgnn_tpu.data.property import generate_property_dataset as jproperty
from kpgnn_tpu.train.lr import StepDecay as JStepDecay
from kpgnn_tpu_torch.data import algorithms as alg
from kpgnn_tpu_torch.data import generation as gen
from kpgnn_tpu_torch.data import tu
from kpgnn_tpu_torch.data.counting import TASKS, generate_counting_dataset
from kpgnn_tpu_torch.data.property import generate_property_dataset
from kpgnn_tpu_torch.train.lr import StepDecay
from tests.test_scripts import write_gin_dataset, write_standard_tu_dataset


def assert_graph_equal(ours, theirs):
    a, f, t = ours
    ja, jf, jt = theirs
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(f, jf)
    assert a.dtype == ja.dtype and f.dtype == jf.dtype
    assert t.name == jt.name and t.value == jt.value


# ---- the families ----

def test_graph_types_and_mixture_equal_jax():
    assert [(t.name, t.value) for t in gen.GraphType] == [
        (t.name, t.value) for t in jgen.GraphType]
    assert [(t.name, p) for t, p in gen.MIXTURE] == [
        (t.name, p) for t, p in jgen.MIXTURE]


@pytest.mark.parametrize("gtype", list(gen.GraphType),
                         ids=lambda t: t.name)
def test_generate_graph_equals_jax(gtype):
    for N in (15, 19, 24):
        for seed in range(8):
            assert_graph_equal(
                gen.generate_graph(N, gtype, seed=seed),
                jgen.generate_graph(N, jgen.GraphType[gtype.name],
                                    seed=seed))


@pytest.mark.parametrize("name,degree", [("ERDOS_RENYI", 3),
                                         ("ERDOS_RENYI", 19),
                                         ("ERDOS_RENYI", 40),
                                         ("BARABASI_ALBERT", 4),
                                         ("BARABASI_ALBERT", 30)])
def test_generate_graph_with_a_degree_equals_jax(name, degree):
    """The degree argument, up to p >= 1 (complete graph) and m capped at
    N - 1."""
    for seed in range(4):
        assert_graph_equal(
            gen.generate_graph(19, gen.GraphType[name], seed=seed,
                               degree=degree),
            jgen.generate_graph(19, jgen.GraphType[name], seed=seed,
                                degree=degree))


def edge_set(edges):
    return {frozenset(e) for e in edges}


@pytest.mark.parametrize("tries", [1, 3, 10])
def test_powerlaw_tree_and_its_failures_equal_networkx(tries):
    """Same tree where networkx finds one, TreeSequenceError where it
    raises NetworkXError."""
    outcomes = set()
    for n in (2, 5, 15, 24):
        for seed in range(30):
            try:
                want = edge_set(nx.random_powerlaw_tree(
                    n, seed=seed, tries=tries).edges)
            except nx.NetworkXError:
                want = None
            try:
                got = edge_set(gen.random_powerlaw_tree(
                    n, random.Random(seed), tries=tries))
            except gen.TreeSequenceError:
                got = None
            assert got == want, (n, seed)
            outcomes.add(want is None)
    assert outcomes == {True, False}    # both branches were taken


def test_random_labeled_tree_equals_networkx():
    for n in (1, 2, 3, 15, 24):
        for seed in range(10):
            assert edge_set(gen.random_labeled_tree(
                n, random.Random(seed))) == edge_set(
                nx.random_labeled_tree(n, seed=seed).edges)


def test_tree_fallback_equals_jax(monkeypatch):
    """At 3 tries the power-law sequence fails for some seeds: both
    generators then draw the Prüfer tree from the same seed."""
    powerlaw = nx.random_powerlaw_tree
    monkeypatch.setattr(jgen.nx, "random_powerlaw_tree",
                        lambda n, seed=None, tries=100: powerlaw(
                            n, seed=seed, tries=3))
    monkeypatch.setattr(gen, "TREE_TRIES", 3)
    fell_back = 0
    for N in (15, 19, 24):
        for seed in range(12):
            assert_graph_equal(
                gen.generate_graph(N, gen.GraphType.TREE, seed=seed),
                jgen.generate_graph(N, jgen.GraphType.TREE, seed=seed))
            family_seed = int(np.random.default_rng(seed).integers(1 << 30))
            try:
                gen.random_powerlaw_tree(N, random.Random(family_seed),
                                         tries=3)
            except gen.TreeSequenceError:
                fell_back += 1
    assert fell_back > 0


def test_adjacency_to_edge_index_equals_jax():
    a, _, _ = gen.generate_graph(17, gen.GraphType.LOBSTER, seed=3)
    ours, theirs = (gen.adjacency_to_edge_index(a),
                    jgen.adjacency_to_edge_index(a))
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == theirs.dtype


# ---- the oracles ----

def oracle_graphs():
    """Graphs of every family (caveman, and some ER draws, are
    disconnected), one with an isolated node, and a single node."""
    out = [gen.generate_graph(N, t, seed=s)[0]
           for t in gen.GraphType for N in (15, 24) for s in (0, 1)]
    iso = gen.generate_graph(12, gen.GraphType.LINE, seed=0)[0]
    iso[5, :] = iso[:, 5] = 0.0
    return out + [iso, np.zeros((1, 1))]


def test_oracles_equal_jax():
    rng = np.random.default_rng(0)
    for A in oracle_graphs():
        n = A.shape[0]
        for inf_sub in (np.inf, 0, -1):
            np.testing.assert_array_equal(
                alg.all_pairs_shortest_paths(A, inf_sub),
                jalg.all_pairs_shortest_paths(A, inf_sub))
        for f in ("is_connected", "diameter", "spectral_radius"):
            assert getattr(alg, f)(A) == getattr(jalg, f)(A), f
        for f in ("eccentricity", "graph_laplacian", "substructure_counts"):
            np.testing.assert_array_equal(getattr(alg, f)(A),
                                          getattr(jalg, f)(A), err_msg=f)
        src = int(rng.integers(0, n))
        np.testing.assert_array_equal(alg.sssp_dist(A, src),
                                      jalg.sssp_dist(A, src))
        F = rng.uniform(size=n)
        np.testing.assert_array_equal(alg.graph_laplacian_features(A, F),
                                      jalg.graph_laplacian_features(A, F))
    for n, k in ((5, 3), (2, 3), (3, 3), (10.0, 3)):
        assert alg._comb(n, k) == jalg._comb(n, k)


# ---- the datasets ----

def assert_splits_equal(ours, theirs):
    assert list(ours) == list(theirs)
    for split in theirs:
        assert len(ours[split]) == len(theirs[split]), split
        for a, b in zip(ours[split], theirs[split]):
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_counting_dataset_equals_jax():
    assert TASKS == JTASKS
    ours = generate_counting_dataset(60, seed=1234)
    assert [len(v) for v in ours.values()] == [18, 12, 30]
    assert_splits_equal(ours, jcounting(60, seed=1234))


def test_property_dataset_equals_jax():
    ours = generate_property_dataset(seed=1234, scale=0.02)
    assert [len(v) for v in ours.values()] == [100, 15, 25]
    assert_splits_equal(ours, jproperty(seed=1234, scale=0.02))


# ---- TU ----

def assert_tu_equal(ours, theirs):
    (og, of), (tg, tf) = ours, theirs
    assert len(og) == len(tg) and len(of) == len(tf)
    for a, b in zip(og, tg):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
    for (a_tr, a_te), (b_tr, b_te) in zip(of, tf):
        np.testing.assert_array_equal(a_tr, b_tr)
        np.testing.assert_array_equal(a_te, b_te)
    assert tu.num_tag_classes(og) == jtu.num_tag_classes(tg)


@pytest.mark.parametrize("name", ["TOY2", "IMDBTOY"])
def test_load_tu_gin_split_equals_jax(tmp_path, name):
    """The GIN text format with its fold files; IMDB* takes degrees as
    tags."""
    write_gin_dataset(tmp_path, name=name)
    root = str(tmp_path)
    assert_tu_equal(tu.load_tu_gin_split(root, name),
                    jtu.load_tu_gin_split(root, name))
    with pytest.raises(FileNotFoundError):
        tu.load_tu_gin_split(root, "NOWHERE")


def test_mutag_scale_fixture_loads_as_jax(tmp_path):
    """The smoke run's fixture: 188 graphs, 7 tags, two classes, every
    test fold holding both."""
    write_gin_fixture(str(tmp_path))
    ours = tu.load_tu_gin_split(str(tmp_path), "MUTAG")
    assert_tu_equal(ours, jtu.load_tu_gin_split(str(tmp_path), "MUTAG"))
    graphs, folds = ours
    labels = np.array([int(g["y"][0]) for g in graphs])
    assert len(graphs) == 188 and tu.num_tag_classes(graphs) == 7
    assert len(folds) == 10
    for tr, te in folds:
        assert set(labels[te]) == {0, 1}
        assert sorted(np.concatenate([tr, te])) == list(range(188))


def test_load_tu_standard_equals_jax(tmp_path):
    write_standard_tu_dataset(tmp_path)
    root = str(tmp_path)
    ours, theirs = (tu.load_tu_standard(root, "TOYSTD"),
                    jtu.load_tu_standard(root, "TOYSTD"))
    assert_tu_equal((ours, []), (theirs, []))
    with pytest.raises(FileNotFoundError):
        tu.load_tu_standard(root, "NOWHERE")


def test_step_decay_equals_jax():
    for every, factor in ((50, 0.5), (10, 0.1), (1, 0.9)):
        ours, theirs = StepDecay(every, factor), JStepDecay(every, factor)
        for epoch in range(0, 200, 7):
            assert ours.lr_at(1e-2, epoch) == theirs.lr_at(1e-2, epoch)
    assert StepDecay().lr_at(1e-2, 49) == 1e-2
    assert StepDecay().lr_at(1e-2, 50) == 5e-3
