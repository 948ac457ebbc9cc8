"""Whole runs of the port's ``train_graph_property.main`` against the JAX
package's on the CPU (task 0, is_connected), on the COO backend and on
the kernel plan, from one JAX init carried to both sides: the checks and
tolerances of tests/test_torch_script_twin.py, and the returned
log10(MSE) at DRIFT.  The script's model at small width (K=2 L=2 H=16)
on the generated splits at ``--data_scale 0.02`` (100 / 15 / 25 graphs),
which the script's batch of 128 takes in one step an epoch, with the
one-ulp witnesses (``witness``).  Several steps an epoch:
tests/test_torch_script_twin_graph_property_steps.py."""
import math

import numpy as np
import pytest

from tests.test_torch_script_twin import assert_script_twins, best_tests


def graph_property_argv(tmp_path, backend, extra=()):
    """The twin's flags (the script's batch of 128 unless ``extra`` sets
    one)."""
    return ["--dataset_dir", str(tmp_path), "--cache_dir",
            str(tmp_path / "cache"), "--task", "0", "--data_scale", "0.02",
            "--K", "2", "--num_layer", "2", "--hidden_size", "16",
            "--num_epochs", "10", "--patience", "1", "--runs", "1",
            "--resident", "off", "--backend", backend, *extra]


@pytest.mark.parametrize("backend", ["coo", "pallas"])
def test_train_graph_property_main_twin(monkeypatch, tmp_path, backend):
    argv = graph_property_argv(tmp_path, backend)
    jresult, results, runs, evaluated = assert_script_twins(
        monkeypatch, tmp_path, "graph_property", argv, "loss", witness=True)
    np.testing.assert_allclose(math.log10(evaluated[0]), jresult, rtol=1e-5)
    for result, rec in zip(results, runs):
        np.testing.assert_allclose(
            result, math.log10(best_tests(rec, "loss")[0]), rtol=1e-12)
