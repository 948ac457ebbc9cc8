"""The port's ``tune_pallas``: the plan it times and the rows it prints.

The tuner's batch, n_pad and union edges are the JAX tuner's on the
same graphs, and its forward CSR holds the JAX plan's live (row, sender)
pairs (the JAX plan's null alignment edges dropped).  Its rows' shape
numbers (n_pad, rows with an edge, largest row) are those of the plan
``collate_pallas`` builds for that batch size.  Here the wrapper takes
the plain version, so the rates say nothing of the kernel; chip_smoke.py
runs the tuner on the card.
"""
import json

import numpy as np
import pytest
import torch

from kpgnn_tpu_torch.data.synthetic import synthetic_molecules
from kpgnn_tpu_torch.graph import batch as tbatch
from kpgnn_tpu_torch.prep.khop import KHopConfig
from kpgnn_tpu_torch.scripts import tune_pallas

torch.set_num_threads(1)
PREP = dict(kernel="spd", max_edge_attr_num=30, max_hop_num=6,
            max_edge_type=3, max_edge_count=20, max_distance_count=30)


def live_pairs(indptr, senders, n_cols):
    """Sorted (row, sender) pairs of a CSR's live (non-null) edges."""
    indptr, senders = np.asarray(indptr), np.asarray(senders)
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    senders = senders[:len(rows)]
    live = senders < n_cols
    return sorted(zip(rows[live].tolist(), senders[live].tolist()))


@pytest.mark.parametrize("B,K", [(4, 8), (6, 2)])
def test_tuner_plan_matches_jax(B, K):
    from kpgnn_tpu.data.synthetic import synthetic_molecules as jmolecules
    from kpgnn_tpu.graph.batch import collate as jcollate
    from kpgnn_tpu.graph.batch import collate_pallas as jcollate_pallas
    from kpgnn_tpu.prep import KHopConfig as JKHopConfig

    graphs = synthetic_molecules(B, KHopConfig(K=K, **PREP), seed=0)
    jgraphs = jmolecules(B, JKHopConfig(K=K, **PREP), seed=0)
    union = int(tbatch.collate(graphs).adj.edge_mask.sum())
    assert union == int(np.asarray(jcollate(jgraphs).adj.edge_mask).sum())
    jb = jcollate_pallas(jgraphs, v1=tune_pallas.V1, vk=tune_pallas.VK)
    b = tbatch.collate_pallas(graphs, v1=tune_pallas.V1, vk=tune_pallas.VK)
    assert b.n_pad == jb.x.shape[0]
    f, jf = b.adj.fwd, jb.adj.fwd
    assert int(f.senders.shape[0]) == union
    assert live_pairs(f.indptr, f.senders, f.n_cols) == live_pairs(
        jf.indptr, np.asarray(jf.senders2d).reshape(-1),
        jf.n_cols_static or jf.n_rows)


def test_tune_pallas_prints_a_row_per_point_and_the_best(capsys):
    res = tune_pallas.main(["--device", "cpu", "--batch_size", "4,6",
                            "--iters", "2", "--chain", "1", "--K", "3",
                            "--hidden_size", "8"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    points = ["gather/4", "fused/4", "gather/6", "fused/6"]
    assert [x.get("point") for x in lines[:-1]] == points
    assert list(res) == points
    for line in lines[:-1]:
        assert line["fwd_edges_per_s"] > 0 and line["fwdbwd_edges_per_s"] > 0
        assert f"{line['variant']}/{line['batch_size']}" == line["point"]
    best = lines[-1]
    assert best["best_point"] in res
    assert best == {"best_point": best["best_point"],
                    **res[best["best_point"]]}


@pytest.mark.parametrize("bs", [3, 5])
def test_tune_pallas_shape_numbers_are_the_plans(capsys, bs):
    res = tune_pallas.main(["--device", "cpu", "--batch_size", str(bs),
                            "--iters", "1", "--chain", "1", "--K", "4",
                            "--hidden_size", "4"])
    graphs = synthetic_molecules(bs, KHopConfig(K=4, **PREP), seed=0)
    b = tbatch.collate_pallas(graphs, v1=tune_pallas.V1, vk=tune_pallas.VK)
    deg = b.adj.fwd.indptr[1:] - b.adj.fwd.indptr[:-1]
    assert list(res) == [f"gather/{bs}", f"fused/{bs}"]
    for row in res.values():
        assert (row["n_pad"], row["live_rows"], row["max_row_nnz"]) == (
            b.n_pad, int((deg > 0).sum()), int(deg.max()))

