"""The port's ``scaling_estimate``.

* The link projection (``--mode ici``): the halo, boundary, union-edge,
  communication and psum numbers of the partitioned polymer equal what
  the JAX package's ``partition_adj`` gives on the same polymer at the
  same D (the hidden width, 104: the port moves D columns, where the JAX
  script rounds D up to 128 lanes).
* The weak mode runs its multi-rank steps in spawned gloo ranks on the
  CPU and names the backend and device of every row.
"""
import numpy as np
import pytest
import torch

from kpgnn_tpu_torch.scripts import scaling_estimate as se

torch.set_num_threads(1)


@pytest.mark.parametrize("n_nodes,shards", [(2048, 2), (2000, 2)])
def test_link_mode_halo_numbers_equal_the_jax_partition(n_nodes, shards):
    from kpgnn_tpu.data.synthetic import synthetic_polymers
    from kpgnn_tpu.graph.batch import collate
    from kpgnn_tpu.parallel import partition_adj

    out = se.main(["--mode", "ici", "--n_nodes", str(n_nodes), "--shards",
                   str(shards), "--device", "cpu"])["ici_projection"]
    coo = collate(synthetic_polymers(1, n_nodes, K=3, seed=0))
    sh = partition_adj(coo.adj, shards)
    D = 104
    assert out["union_edges"] == int(np.asarray(coo.adj.edge_mask).sum())
    assert out["halo_rows"] == sh.halo
    assert out["boundary_rows"] == sh.boundary_total()
    assert out["comm_bytes_per_device_per_layer"] == (
        sh.comm_elems_per_layer(3, D) * 4)
    assert out["full_table_psum_bytes_would_be"] == (
        sh.psum_elems_per_layer(3, D) * 4)
    assert out["device"] == "cpu" and "process group" in out["backend"]
    assert set(out["efficiency_vs_ici_GBps"]) == set(se.LINK_GBPS)
    assert all(0 < e <= 1 for e in out["efficiency_vs_ici_GBps"].values())


def test_weak_mode_runs_gloo_ranks_and_names_backend_and_device(
        monkeypatch):
    monkeypatch.setitem(se.WEAK, "K", 2)
    monkeypatch.setitem(se.WEAK, "num_layer", 2)
    monkeypatch.setitem(se.WEAK, "hidden_size", 8)
    monkeypatch.setitem(se.WEAK, "per_dev", 2)
    monkeypatch.setitem(se.WEAK, "iters", 1)
    out = se.main(["--mode", "weak", "--ranks", "1,2", "--device", "cpu"])
    for mode in ("data_parallel", "node_sharded"):
        assert set(out[mode]) == {"1", "2"}
        for P, row in out[mode].items():
            assert row["backend"] == "gloo" and row["device"] == "cpu"
            assert row["ranks_per_device"] == int(P)
            assert row["overhead_factor"] > 0
            assert row["parallel_step_ms"] > 0
            assert row["single_device_same_batch_ms"] > 0
    assert "gloo" in out["weak_setup"]
