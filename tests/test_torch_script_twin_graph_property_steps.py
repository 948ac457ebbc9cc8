"""The twin of tests/test_torch_script_twin_graph_property.py with
several steps an epoch: the train split's 100 graphs in batches of 32
(four steps), on the COO backend, at the script's lr of 1e-2.

There Adam moves each element whose exact gradient is 0 (biases that
feed a batch norm, table rows and weight columns every node reads
alike) by about lr in the direction f32 rounding picks, so within an
epoch a step loss parts from the JAX run's by up to 3e-5 and an epoch's
validation loss by percents: as far as the JAX package's own f32 run
parts from the same epochs replayed in float64, further than a one-ulp
move of its weights carries it.  So the port's run, resynchronized each
epoch to the JAX run's state and learning rate, is held to the larger
of PR 13's tolerances and twice the furthest of those witnesses, each
measured here (``assert_steps_twin`` of tests/test_torch_script_twin.py).
The free run and the schedule's decisions are not compared: at these
gaps the JAX package's own witnesses reverse decisions whose validation
losses lie percents apart."""
from tests.test_torch_script_twin import assert_steps_twin
from tests.test_torch_script_twin_graph_property import graph_property_argv


def test_train_graph_property_main_twin_steps(monkeypatch, tmp_path):
    assert_steps_twin(monkeypatch, tmp_path, "graph_property",
                      graph_property_argv(tmp_path, "coo",
                                          ["--batch_size", "32"]),
                      "loss")
