"""The twin of tests/test_torch_script_twin_prime.py (``train_qm9`` at
the QM9 sweep's ``--model_name KPGINPrime --K 16 --residual --use_rd``,
3 layers, width 32, a 24-molecule fixture) with several steps an epoch:
the 20 train molecules in batches of 8 (three steps) for 6 epochs, on
the COO backend, held as tests/test_torch_script_twin_counting_steps.py
holds the generated benchmarks (``assert_steps_twin``): the port's run,
resynchronized each epoch to the JAX run's state and learning rate, at
the larger of PR 13's tolerances and twice the furthest of the JAX
package's own witnesses (one-ulp moves of its weights, its float64
replay of the same epochs)."""
from tests.test_torch_qm9 import write_qm9_fixture
from tests.test_torch_script_twin import assert_steps_twin


def test_train_qm9_kpginprime_k16_main_twin_steps(monkeypatch, tmp_path):
    write_qm9_fixture(tmp_path, 24, seed=5)
    argv = ["--dataset_dir", str(tmp_path), "--cache_dir",
            str(tmp_path / "cache"), "--model_name", "KPGINPrime", "--K",
            "16", "--num_layer", "3", "--hidden_size", "32", "--residual",
            "--use_rd", "--batch_size", "8", "--num_epochs", "6",
            "--patience", "0", "--resident", "off", "--backend", "coo"]
    assert_steps_twin(monkeypatch, tmp_path, "qm9", argv, "mae")
