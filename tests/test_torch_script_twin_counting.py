"""Whole runs of the port's ``train_counting.main`` against the JAX
package's on the CPU (task 1, the tailed triangle, ``--ystd train``), on
the COO backend and on the kernel plan, from one JAX init carried to
both sides: the checks and tolerances of tests/test_torch_script_twin.py
(the free run's learning rates and best epochs exactly; the run
resynchronized to the JAX run's state each epoch at rtol 1e-5 a step;
the best-val protocol; the returned std-normalized MAE at DRIFT).  The
script's model at small width (K=3 L=3 H=16, its defaults' depth) on 60
generated graphs (18 / 12 / 30), the train split one batch (one step an
epoch), with the one-ulp witnesses (``witness``).  Several steps an
epoch: tests/test_torch_script_twin_counting_steps.py."""
import numpy as np
import pytest

from tests.test_torch_script_twin import assert_script_twins, best_tests


def counting_argv(tmp_path, backend, batch_size=64):
    """The twin's flags: 60 graphs, the train split's 18 in batches of
    ``batch_size``."""
    return ["--dataset_dir", str(tmp_path), "--cache_dir",
            str(tmp_path / "cache"), "--task", "1", "--ystd", "train",
            "--n_graphs", "60", "--hidden_size", "16", "--batch_size",
            str(batch_size), "--num_epochs", "10", "--patience", "1",
            "--runs", "1", "--resident", "off", "--backend", backend]


@pytest.mark.parametrize("backend", ["coo", "pallas"])
def test_train_counting_main_twin(monkeypatch, tmp_path, backend):
    argv = counting_argv(tmp_path, backend)
    jresult, results, runs, evaluated = assert_script_twins(
        monkeypatch, tmp_path, "counting", argv, "loss", witness=True)
    np.testing.assert_allclose(evaluated[0], jresult, rtol=1e-5)
    for result, rec in zip(results, runs):
        np.testing.assert_allclose(result, best_tests(rec, "loss")[0],
                                   rtol=1e-12)
