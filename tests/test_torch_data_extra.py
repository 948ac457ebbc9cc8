"""The rest of the port's data/ and prep/ against the JAX package: the OGB
loader on fixtures written here (plain and gzipped, multi-task labels
with empty cells), every graph oracle of ``data/algorithms.py`` on
seeded random graphs, and the on-device k-hop prep
(``prep/device.device_khop_dense``) against the JAX function and the
port's host prep.

The oracles are numpy in both packages: values compare at rtol 1e-12
(eigen-solvers) or exactly.  Where the JAX package parts from the
reference's oracles (ADVICE.md:3-5; ``algorithms.py:223``, ``:257``,
``:316``), the port keeps the JAX value, and the tests below pin it."""
import gzip
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kpgnn_tpu.data.algorithms as jalg
import kpgnn_tpu.graph.batch as jbatch
import kpgnn_tpu.prep.khop as jkhop
from kpgnn_tpu.data.ogb import load_ogb_graphpred as jload_ogb
from kpgnn_tpu.prep.device import device_khop_dense as jdevice_khop_dense
from kpgnn_tpu_torch.data import algorithms as alg
from kpgnn_tpu_torch.data.ogb import load_ogb_graphpred
from kpgnn_tpu_torch.graph import batch as tbatch
from kpgnn_tpu_torch.prep import khop as tkhop
from kpgnn_tpu_torch.prep.device import CLIP, device_khop_dense

torch.set_num_threads(1)


# ---- the OGB loader ----

PLAIN = {
    "num-node-list.csv": "3\n2\n4\n",
    "num-edge-list.csv": "4\n2\n0\n",
    "edge.csv": "0,1\n1,0\n1,2\n2,1\n0,1\n1,0\n",
    "node-feat.csv": "1,7\n2,7\n3,8\n4,8\n5,9\n6,1\n7,1\n8,2\n9,2\n",
    "edge-feat.csv": "0,1\n0,1\n1,0\n1,0\n2,2\n2,2\n",
    "graph-label.csv": "1\n0\n1\n",
}
MULTITASK = {
    "num-node-list.csv": "2\n2\n3\n",
    "num-edge-list.csv": "2\n2\n2\n",
    "edge.csv": "0,1\n1,0\n0,1\n1,0\n1,2\n2,1\n",
    "graph-label.csv": "1,,0\n,0,\n0,1,1\n",
}


def write_ogb(root, files, gz, splits):
    raw = root / "raw"
    raw.mkdir(parents=True)

    def put(path, body):
        if gz:
            with gzip.open(str(path) + ".gz", "wt") as f:
                f.write(body)
        else:
            path.write_text(body)
    for name, body in files.items():
        put(raw / name, body)
    sp = root / "split" / "scaffold"
    sp.mkdir(parents=True)
    for part, idx in splits.items():
        put(sp / f"{part}.csv", "".join(f"{i}\n" for i in idx))


def assert_ogb_equal(a, b):
    assert a["splits"].keys() == b["splits"].keys()
    for k in a["splits"]:
        np.testing.assert_array_equal(a["splits"][k], b["splits"][k])
        assert a["splits"][k].dtype == b["splits"][k].dtype
    assert len(a["graphs"]) == len(b["graphs"])
    for ga, gb in zip(a["graphs"], b["graphs"]):
        assert ga.keys() == gb.keys()
        for k in ga:
            x, y = np.asarray(ga[k]), np.asarray(gb[k])
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("files", ["plain", "multitask"])
def test_load_ogb_graphpred_equals_jax(tmp_path, gz, files):
    body = PLAIN if files == "plain" else MULTITASK
    splits = {"train": [0, 2], "valid": [1], "test": [1]}
    write_ogb(tmp_path, body, gz, splits)
    out = load_ogb_graphpred(str(tmp_path))
    assert_ogb_equal(out, jload_ogb(str(tmp_path)))
    assert out["splits"]["train"].tolist() == [0, 2]
    if files == "plain":
        g0 = out["graphs"][0]
        assert g0["edge_attr"].tolist() == [2, 2, 3, 3]   # bond code + 2
        assert g0["x"].shape == (3, 2) and "edge_attr" not in out[
            "graphs"][2]                                  # no edges
    else:
        y0, y1 = out["graphs"][0]["y"], out["graphs"][1]["y"]
        assert y0[0] == 1.0 and np.isnan(y0[1]) and y0[2] == 0.0
        assert np.isnan(y1[0]) and y1[1] == 0.0 and np.isnan(y1[2])
        assert out["graphs"][0]["x"].tolist() == [[0], [0]]


def test_load_ogb_graphpred_without_files_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="raw"):
        load_ogb_graphpred(str(tmp_path))


# ---- the oracles ----

def random_adjacency(n, p, seed):
    """A seeded symmetric {0,1} adjacency without self-loops."""
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((n, n)) < p, 1)
    return (upper | upper.T).astype(np.float64)


GRAPHS = [random_adjacency(n, p, s) for n, p, s in
          ((7, 0.4, 0), (8, 0.3, 1), (6, 0.7, 2), (8, 0.25, 3))]
A_ONLY = ("count_edges", "first_neighbours", "second_neighbours",
          "is_eulerian_cyclable", "is_eulerian_percorrible",
          "has_hamiltonian_cycle", "max_eigenvector", "get_graph_labels",
          "tsp_length", "max_eigenvalue", "page_rank")
WITH_F = ("sssp_predecessor", "mean_neighbourhood", "max_neighbourhood",
          "identity", "min_neighbourhood", "std_neighbourhood",
          "local_maxima", "mean_graph", "max_graph", "min_graph",
          "std_graph", "get_nodes_labels")


def assert_same(ours, theirs, name):
    if isinstance(theirs, tuple):
        assert ours == theirs, name
        return
    a, b = np.asarray(ours), np.asarray(theirs)
    assert a.shape == b.shape and a.dtype == b.dtype, name
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("gi", range(len(GRAPHS)))
def test_every_oracle_equals_jax(gi):
    A = GRAPHS[gi]
    n = A.shape[0]
    rng = np.random.default_rng(10 + gi)
    F = rng.normal(size=n)
    onehot = np.eye(n)[int(rng.integers(n))]
    for name in A_ONLY:
        assert_same(getattr(alg, name)(A), getattr(jalg, name)(A), name)
    for name in WITH_F:
        f = onehot if name == "sssp_predecessor" else F
        assert_same(getattr(alg, name)(A, f), getattr(jalg, name)(A, f),
                    name)
    for k in (1, 2, 3):
        for name in ("kth_neighbours", "max_eigenvalues",
                     "max_absolute_eigenvalues",
                     "max_absolute_eigenvalues_laplacian"):
            assert_same(getattr(alg, name)(A, k), getattr(jalg, name)(A, k),
                        name)
    for kw in (dict(), dict(hops=2), dict(consider_itself=True),
               dict(f_map=np.abs, hops=2)):
        assert_same(alg.map_reduce_neighbourhood(A, F, np.median, **kw),
                    jalg.map_reduce_neighbourhood(A, F, np.median, **kw),
                    f"map_reduce_neighbourhood {kw}")
    assert_same(alg.map_reduce_graph(A, F, np.median),
                jalg.map_reduce_graph(A, F, np.median), "map_reduce_graph")
    labels = (F > 0).astype(int)
    assert_same(alg.wl_colors(A), jalg.wl_colors(A), "wl_colors")
    assert_same(alg.wl_colors(A, labels), jalg.wl_colors(A, labels),
                "wl_colors labels")
    perm = rng.permutation(n)
    B = A[np.ix_(perm, perm)]
    for other, fa, fb in ((B, None, None), (GRAPHS[(gi + 1) % 4], None, None),
                          (B, labels, labels[perm])):
        assert (alg.isomorphism(A, other, fa, fb)
                == jalg.isomorphism(A, other, fa, fb))
    assert alg.isomorphism(A, B)


def path(n):
    A = np.zeros((n, n))
    i = np.arange(n - 1)
    A[i, i + 1] = A[i + 1, i] = 1
    return A


def test_oracles_keep_the_jax_values_where_they_part_from_the_reference():
    """ADVICE.md:3-5: the reference includes the node itself in
    min/std_neighbourhood and counts ties as local maxima
    (``algorithms.py:223``), tests connectivity over every node for the
    Eulerian checks (``:257``), and measures the shortest open path over
    the F-selected nodes (``:316``).  The port keeps the JAX values."""
    A, F = path(3), np.array([0.0, 5.0, 3.0])
    # node 0's only neighbour is node 1 (5); with itself it would read 0
    assert alg.min_neighbourhood(A, F)[0] == jalg.min_neighbourhood(A, F)[0] \
        == 5.0
    assert alg.std_neighbourhood(A, F)[0] == 0.0
    ties = np.array([5.0, 5.0, 3.0])
    # a tie is no local maximum here (the reference's F == max counts it)
    assert alg.local_maxima(A, ties).tolist() == jalg.local_maxima(
        A, ties).tolist() == [0.0, 0.0, 0.0]
    # a triangle beside an isolated node: the reference says 0.0
    tri = np.zeros((4, 4))
    tri[:3, :3] = 1 - np.eye(3)
    assert alg.is_eulerian_cyclable(tri) == jalg.is_eulerian_cyclable(tri) \
        == 1.0
    assert alg.is_eulerian_percorrible(tri) == 1.0
    # the 6-cycle: the closed tour through node 0 (the reference's open
    # path over every node would be 5.0)
    cyc = path(6)
    cyc[0, 5] = cyc[5, 0] = 1
    assert alg.tsp_length(cyc) == jalg.tsp_length(cyc) == 6.0
    assert alg.tsp_length(tri) == jalg.tsp_length(tri) == math.inf


# ---- on-device k-hop prep ----

def prep_case(seed, K, kernel, vk, n_slot=12, count=5):
    """(JAX graphs, port graphs, (B, n_slot, n_slot) adjacency and
    receiver-major attr stacks) of symmetric random graphs."""
    rng = np.random.default_rng(seed)
    js, ts, adjs, attrs = [], [], [], []
    for i in range(count):
        n = int(rng.integers(6, 11))
        A = random_adjacency(n, 0.35, 100 * seed + i)
        u, v = np.nonzero(A)
        if not len(u):
            continue
        codes = rng.integers(2, 5, size=(n, n))
        codes = np.triu(codes, 1) + np.triu(codes, 1).T
        ei = np.stack([u, v])
        ea = codes[u, v]
        cfg = dict(K=K, kernel=kernel, max_edge_attr_num=vk - 2)
        js.append(jkhop.extract_khop(n, ei, ea, jkhop.KHopConfig(**cfg)))
        ts.append(tkhop.extract_khop(n, ei, ea, tkhop.KHopConfig(**cfg)))
        Ap = np.zeros((n_slot, n_slot))
        Ap[:n, :n] = A
        At = np.zeros((n_slot, n_slot), np.int32)
        At[u, v] = ea
        adjs.append(Ap)
        attrs.append(At.T)                  # receiver-major
    return js, ts, np.stack(adjs), np.stack(attrs)


@pytest.mark.parametrize("kernel", ["spd", "gd"])
@pytest.mark.parametrize("K", [1, 3])
def test_device_khop_dense_equals_jax_and_the_host_prep(kernel, K):
    v1, vk, n_slot = 6, 9, 12
    js, ts, adjs, attrs = prep_case(4, K, kernel, vk, n_slot)
    kw = dict(K=K, max_edge_attr_num=vk - 2, kernel=kernel, v1=v1, vk=vk)
    dev, pe = device_khop_dense(torch.from_numpy(adjs),
                                torch.from_numpy(attrs), **kw)
    jdev, jpe = jdevice_khop_dense(jnp.asarray(adjs), jnp.asarray(attrs),
                                   **kw)
    host = tbatch.collate_dense(ts, n_slot=n_slot, v1=v1, vk=vk,
                                g_pad=len(ts))
    jhost = jbatch.collate_dense(js, n_slot=n_slot, v1=v1, vk=vk,
                                 g_pad=len(js))
    assert dev.hop_attr.dtype == torch.int32
    for f in ("hop_attr", "counts1", "countsk"):
        a = getattr(dev, f)
        if K == 1 and f == "countsk":
            assert a is None and jdev.countsk is None
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jdev, f)),
                                      err_msg=f)
        np.testing.assert_array_equal(a.numpy(), getattr(host.adj, f).numpy(),
                                      err_msg=f)
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(getattr(jhost.adj, f)),
                                      err_msg=f)
    if K == 1:
        assert pe is None and jpe is None
    else:
        assert pe.shape == (len(ts) * n_slot, K - 1) and not pe.any()


def test_device_khop_dense_saturates_walk_counts():
    """A complete graph's walk counts overflow f32's integers by K=9; they
    saturate at CLIP and the codes stay the clipped ones."""
    n, K = 12, 9
    A = 1 - np.eye(n)
    dev, _ = device_khop_dense(torch.from_numpy(A[None]),
                               torch.from_numpy(2 * A[None].astype(np.int32)),
                               K=K, max_edge_attr_num=7, kernel="gd")
    jdev, _ = jdevice_khop_dense(jnp.asarray(A[None]),
                                 jnp.asarray(2 * A[None].astype(np.int32)),
                                 K=K, max_edge_attr_num=7, kernel="gd")
    np.testing.assert_array_equal(dev.hop_attr.numpy(),
                                  np.asarray(jdev.hop_attr))
    assert int(dev.hop_attr[:, 1:].max()) == 8 and CLIP == 1e6
