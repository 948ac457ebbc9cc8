"""The port's native prep (``prep/native.py``, built with g++ from the
port's own copy of the C++ source) and its prep runner
(``prep/runner.py``: the pickle cache and the worker pool) against the
JAX package's prep: bit for bit on the golden raw graphs and on the
shapes of tests/test_prep.py and tests/test_native.py."""
import os
import pickle

import numpy as np
import pytest

import kpgnn_tpu.prep.khop as jkhop
from kpgnn_tpu.prep.runner import preprocess_graphs as jpreprocess
from kpgnn_tpu_torch.graph.data import Graph
from kpgnn_tpu_torch.prep import khop as tkhop
from kpgnn_tpu_torch.prep import native, runner
from tests.test_native import rand_graph
from tests.test_prep import random_graph
from tests.test_torch_prep_batch import (BUNDLES, ZINC_PREP,
                                         assert_graphs_equal, raw_molecules)

PERIPHERAL = dict(max_hop_num=3, max_edge_type=2, max_edge_count=7,
                  max_distance_count=9)


def test_native_builds_from_the_ports_own_source():
    assert native.available(), native.BUILD_ERROR
    pkg = os.path.dirname(os.path.abspath(tkhop.__file__))
    assert native.SOURCE == os.path.join(pkg, "_native", "khop_native.cpp")
    assert native._lib._name == native.lib_path()
    assert native.lib_path().startswith(os.path.join(pkg, "_native",
                                                     "build", ""))
    assert native.source_hash() in native.lib_path()


def extract_both(n, ei, ea, cfg, monkeypatch):
    """The JAX package's graph and the port's on each of its paths."""
    jg = jkhop.extract_khop(n, ei, ea, jkhop.KHopConfig(**cfg))
    assert native.available()
    tg = tkhop.extract_khop(n, ei, ea, tkhop.KHopConfig(**cfg))
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        tg_numpy = tkhop.extract_khop(n, ei, ea, tkhop.KHopConfig(**cfg))
    return jg, tg, tg_numpy


@pytest.mark.parametrize("bundle", BUNDLES,
                         ids=[os.path.basename(b) for b in BUNDLES])
def test_native_prep_bit_equal_jax_on_golden_raw_graphs(bundle,
                                                         monkeypatch):
    import json
    g = np.load(bundle)
    a = json.loads(bytes(g["meta"]).decode())
    cfg = {k: a[k] for k in ("K", "kernel", "max_edge_attr_num",
                             "max_hop_num", "max_edge_type",
                             "max_edge_count", "max_distance_count",
                             "use_rd")}
    jg, tg, tg_numpy = extract_both(int(g["raw/n"][0]), g["raw/edge_index"],
                                    g["raw/edge_attr"], cfg, monkeypatch)
    assert_graphs_equal(jg, tg)
    assert_graphs_equal(jg, tg_numpy)


@pytest.mark.parametrize("kernel,K,seeds", [("spd", 1, range(3)),
                                            ("spd", 3, range(6)),
                                            ("gd", 3, range(4))])
def test_native_prep_bit_equal_jax_on_test_prep_shapes(kernel, K, seeds,
                                                       monkeypatch):
    """tests/test_prep.py's random graphs (with peripheral attributes)
    and tests/test_native.py's full extract."""
    for seed in seeds:
        n, ei, ea = random_graph(10, 0.3, seed)
        cfg = dict(K=K, kernel=kernel, max_edge_attr_num=30, **PERIPHERAL)
        jg, tg, tgn = extract_both(n, ei, ea, cfg, monkeypatch)
        assert_graphs_equal(jg, tg)
        assert_graphs_equal(jg, tgn)
    A, attr = rand_graph(13, 0.3, 7)
    ei = np.stack(np.nonzero(A)).astype(np.int64)
    jg, tg, _ = extract_both(13, ei, attr[ei[0], ei[1]],
                             dict(K=3, kernel="spd", max_edge_attr_num=8,
                                  **PERIPHERAL), monkeypatch)
    assert_graphs_equal(jg, tg)


@pytest.mark.parametrize("seed", range(3))
def test_native_kernels_equal_jax_numpy(seed):
    """Each C++ entry point against the JAX package's numpy function."""
    assert native.available(), native.BUILD_ERROR
    A, attr = rand_graph(15, 0.3, seed)
    for k in (1, 3, 5):
        ref = jkhop.adjacency_powers(A, k)
        got = native.adjacency_powers(A, k)
        assert np.array_equal(ref, got)
        for a, b in zip(jkhop._spd_mask(ref.copy()),
                        native.spd_mask(got.copy())):
            assert np.array_equal(a, b)
        assert np.array_equal(native.gd_union(got),
                              (ref.sum(0) > 0).astype(np.int64))
    for cap in (1, 2, 6):
        assert np.array_equal(native.bfs_apsp((A > 0).astype(np.uint8), cap),
                              jkhop.bfs_apsp(A > 0, cap))
    cfg = jkhop.KHopConfig(K=2, kernel="spd", max_edge_attr_num=10,
                           **PERIPHERAL)
    hop_mats, _ = jkhop._spd_mask(jkhop.adjacency_powers(A, 2))
    for k in range(2):
        for a, b in zip(jkhop._peripheral_for_hop(attr, hop_mats[k], cfg),
                        native.peripheral_hop(attr, hop_mats[k],
                                              **PERIPHERAL)):
            assert np.array_equal(a, b)


def molecules(n, seed=0):
    return raw_molecules(n, seed=seed, n_min=5, n_max=12)


CFG = dict(ZINC_PREP, K=3)


def test_cache_hit_equals_fresh_prep_and_reattaches_labels(tmp_path):
    raws = molecules(10)
    cfg = tkhop.KHopConfig(**CFG)
    fresh = runner.preprocess_graphs(raws, cfg, str(tmp_path), "mol")
    path = runner.cache_path(str(tmp_path), "mol", cfg)
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    for i, r in enumerate(raws):              # a task switch relabels
        r["y"] = np.array([float(i)], np.float32)
    hit = runner.preprocess_graphs(raws, cfg, str(tmp_path), "mol")
    assert [float(g.y[0]) for g in hit] == list(map(float, range(10)))
    for a, b in zip(fresh, hit):
        assert_graphs_equal(a.replace(y=b.y), b)
    # the hit came from the file: a poisoned entry shows through
    with open(path, "rb") as f:
        cached = pickle.load(f)
    cached[0] = cached[0].replace(num_nodes=-1)
    with open(path, "wb") as f:
        pickle.dump(cached, f)
    assert runner.preprocess_graphs(raws, cfg, str(tmp_path),
                                    "mol")[0].num_nodes == -1
    # --reprocess rebuilds it
    assert runner.preprocess_graphs(raws, cfg, str(tmp_path), "mol",
                                    reprocess=True)[0].num_nodes != -1
    # another config is another entry
    other = runner.preprocess_graphs(raws, tkhop.KHopConfig(**dict(CFG, K=2)),
                                     str(tmp_path), "mol")
    assert other[0].K == 2 and len(os.listdir(tmp_path)) == 2


def test_stale_cache_is_rebuilt(tmp_path):
    raws = molecules(6, seed=1)
    cfg = tkhop.KHopConfig(**CFG)
    runner.preprocess_graphs(raws, cfg, str(tmp_path), "mol")
    fewer = runner.preprocess_graphs(raws[:4], cfg, str(tmp_path), "mol")
    assert len(fewer) == 4
    for a, b in zip(fewer, tkhop.extract_graphs(raws[:4], cfg)):
        assert_graphs_equal(a, b)
    with open(runner.cache_path(str(tmp_path), "mol", cfg), "rb") as f:
        assert len(pickle.load(f)) == 4


def test_pool_equals_serial_prep(tmp_path):
    """Two spawned workers above the pool's 64-graph threshold."""
    raws = molecules(runner.POOL_MIN_GRAPHS + 16, seed=2)
    cfg = tkhop.KHopConfig(**CFG)
    pooled = runner.preprocess_graphs(raws, cfg, num_workers=2)
    serial = runner.preprocess_graphs(raws, cfg)
    assert len(pooled) == len(serial) == len(raws)
    for a, b in zip(pooled, serial):
        assert type(a) is Graph
        assert_graphs_equal(a, b)


def test_jax_cache_files_are_never_read(tmp_path):
    """The JAX package pickles its own Graph into the same default
    directory; the port's file has another name, so it never unpickles
    (and imports) the JAX package's."""
    raws = molecules(5, seed=3)
    jpreprocess(raws, jkhop.KHopConfig(**CFG), cache_dir=str(tmp_path),
                name="mol")
    (jax_file,) = os.listdir(tmp_path)
    ours = runner.cache_path(str(tmp_path), "mol", tkhop.KHopConfig(**CFG))
    assert os.path.basename(ours) != jax_file
    assert ours.endswith(runner.CACHE_SUFFIX)
    assert not jax_file.endswith(runner.CACHE_SUFFIX)
    # a JAX-named file that would fail to unpickle is not opened
    with open(tmp_path / jax_file, "wb") as f:
        f.write(b"not a pickle")
    got = runner.preprocess_graphs(raws, tkhop.KHopConfig(**CFG),
                                   str(tmp_path), "mol")
    assert all(type(g) is Graph for g in got)
    got = runner.preprocess_graphs(raws, tkhop.KHopConfig(**CFG),
                                   str(tmp_path), "mol")
    assert all(type(g) is Graph for g in got)
    assert sorted(os.listdir(tmp_path)) == sorted(
        [jax_file, os.path.basename(ours)])


def test_train_zinc_prep_cache_flags(tmp_path, monkeypatch):
    """``prepare`` caches each split under the JAX script's cache name in
    ``--cache_dir`` (default ``<dataset_dir>/cache``, or
    ``KPGNN_CACHE_DIR``); a second run reads the files, ``--reprocess``
    writes them anew."""
    from kpgnn_tpu_torch.scripts import train_zinc
    from tests.test_torch_model import TINY_ARGS, write_zinc_fixture

    write_zinc_fixture(str(tmp_path), (24, 8, 8))
    monkeypatch.delenv("KPGNN_CACHE_DIR", raising=False)

    def run(*extra):
        return train_zinc.main(["--dataset_dir", str(tmp_path), "--save_dir",
                                str(tmp_path / "s"), "--device", "cpu",
                                "--num_workers", "2", *extra] + TINY_ARGS)
    first = run()
    cache = tmp_path / "cache"
    files = sorted(p.name for p in cache.iterdir())
    assert [f.split("_")[:2] for f in files] == [
        ["ZINC", "test"], ["ZINC", "train"], ["ZINC", "val"]]
    assert all(f.endswith(runner.CACHE_SUFFIX) for f in files)
    stamps = {p.name: p.stat().st_mtime_ns for p in cache.iterdir()}
    assert run() == first
    assert {p.name: p.stat().st_mtime_ns for p in cache.iterdir()} == stamps
    assert run("--reprocess") == first
    assert all(p.stat().st_mtime_ns != stamps[p.name]
               for p in cache.iterdir())
    monkeypatch.setenv("KPGNN_CACHE_DIR", str(tmp_path / "elsewhere"))
    run()
    assert len(list((tmp_path / "elsewhere").iterdir())) == 3
