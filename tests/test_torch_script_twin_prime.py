"""Whole runs of the port's ``train_qm9.main`` against the JAX package's
on the CPU at the QM9 sweep's second config, ``--model_name KPGINPrime
--K 16 --residual --use_rd`` (QM9_SWEEP_r05.jsonl line 2), on the COO
backend and on the kernel plan, from one JAX init carried to both sides:
the checks and tolerances of tests/test_torch_script_twin.py.  K stays
16, the kernel's hop limit (``spmm.MAX_HOPS``) and the BiLSTM kernel's
largest capacity; depth and width are cut as tests/test_torch_qm9.py's
KPGINPrime K=16 case cuts them (3 layers, width 32), on a 24-molecule
fixture, task 0, the 20 train molecules one batch (one step an epoch),
``--patience 0`` so the plateau schedule fires within 10 epochs, with
the one-ulp witnesses (``witness``).  In batches of 8 the JAX package's
own epochs from a one-ulp start flip the comparison of two validation
losses 0.6% apart, which decides the schedule: that case, without the
free run, is tests/test_torch_script_twin_prime_steps.py."""
import numpy as np
import pytest

from kpgnn_tpu_torch.scripts import common as tcommon
from kpgnn_tpu_torch.scripts import train_qm9 as tqm9
from tests.test_torch_qm9 import write_qm9_fixture
from tests.test_torch_script_twin import (RTOL, assert_script_twins,
                                          best_tests, script_args)


@pytest.mark.parametrize("backend", ["coo", "pallas"])
def test_train_qm9_kpginprime_k16_main_twin(monkeypatch, tmp_path, backend):
    write_qm9_fixture(tmp_path, 24, seed=5)
    argv = ["--dataset_dir", str(tmp_path), "--cache_dir",
            str(tmp_path / "cache"), "--model_name", "KPGINPrime", "--K",
            "16", "--num_layer", "3", "--hidden_size", "32", "--residual",
            "--use_rd", "--batch_size", "32", "--num_epochs", "10",
            "--patience", "0", "--resident", "off", "--backend", backend]
    jresult, results, runs, evaluated = assert_script_twins(
        monkeypatch, tmp_path, "qm9", argv, "mae", witness=True)
    args, _ = script_args("qm9", argv + ["--device", "cpu"])
    (train, _, _), std = tqm9.task_splits(
        tcommon.prepare(tqm9.load(args), args, "QM9"), args)
    np.testing.assert_allclose(evaluated[0] * std, jresult, rtol=RTOL)
    for result, rec in zip(results, runs):
        np.testing.assert_allclose(result, best_tests(rec, "mae")[0] * std,
                                   rtol=1e-6)
