"""Whole runs of the port's ``Trainer.fit`` against the JAX package's on a
small QM9 model (``--virtual_node --use_rd``, attention combine and
pooling, MSE loss, MAE metric), on the COO backend and on the kernel
plan: the checks and tolerances of tests/test_torch_fit_twin.py.

Both cases run shuffle seed 1.  There the kernel-plan case's epoch 1
parts from the JAX run by 1.6e-4 and 2.6e-4 in its last two steps (the
epoch's train loss by 9.6e-5), and so does the JAX package from itself:
the same epoch from the same start with every weight one ulp up (the
witness the test computes), and the same epoch run op by op under
``jax.disable_jit`` (measured once, not in the test), part from the JAX
run by 1.6e-4 and 2.6e-4 at those two steps.  Those steps' tolerances
are therefore 3.2e-4 and 5.2e-4 (twice the witness), every other one
1e-5; the port's other gaps are at most 3.7e-7 on the plan and 1.0e-6 on
COO.  What turns rounding into 1e-4 there: the port's forward on the
JAX run's state before step 3 gives the JAX loss to 5e-7, and of the
leaves two steps apart, ``init_encoder.init_proj.weight`` (6.8e-5 apart,
7% of lr, after two Adam steps on gradients that rounding dominates)
alone moves that loss by 1.4e-4 when swapped into the JAX state.
"""
import numpy as np
import pytest
import torch

import kpgnn_tpu.prep.khop as jkhop
from kpgnn_tpu_torch.data import molecules as tmol
from kpgnn_tpu_torch.prep import khop as tkhop
from tests.test_torch_fit_twin import assert_twin_runs
from tests.test_torch_qm9 import QM9_PREP, QM9_SMALL, write_qm9_fixture

torch.set_num_threads(1)


def qm9_splits(tmp_path, n=24):
    """``n`` fixture molecules through both preps, task 0 standardized,
    cut 16/4/4."""
    write_qm9_fixture(tmp_path, n, seed=5)
    raws = tmol.load_qm9(str(tmp_path / "QM9"))
    y = np.array([r["y"][0] for r in raws], np.float64)
    for r, v in zip(raws, (y - y.mean()) / y.std()):
        r["y"] = np.array([v], np.float32)
    jc = jkhop.KHopConfig(**QM9_PREP)
    js = [jkhop.extract_khop(r["num_nodes"], r["edge_index"],
                             r["edge_attr"], jc, x=r["x"], y=r["y"],
                             z=r["z"], pos=r["pos"]) for r in raws]
    ts = tkhop.extract_graphs(raws, tkhop.KHopConfig(**QM9_PREP))
    cut = lambda g: (g[:16], g[16:20], g[20:])
    return cut(js), cut(ts)


@pytest.mark.parametrize("mode", ["coo", "pallas"])
def test_small_qm9_fit_equals_jax(monkeypatch, tmp_path, mode):
    js, ts = qm9_splits(tmp_path)
    jh = assert_twin_runs(monkeypatch, dict(QM9_SMALL), js, ts, mode, "mse",
                          "mae", epochs=5, bs=4, seed=1)
    assert jh[-1]["train_loss"] < jh[0]["train_loss"]
