"""The port's scripts on generated data, end to end on the CPU at a tiny
size: ``train_counting``, ``train_graph_property``,
``train_node_property`` and ``train_tu`` (on the GIN-format fixture and on
a standard-format one), on the kernel plan (its plain version here), coo
and dense; their label processing against the JAX scripts'; and the
first step of each, which must not depend on the backend (the same
weights and the same first batch; losses rtol 1e-4)."""
import math

import numpy as np
import pytest
import torch

from chip_smoke import write_gin_fixture
from kpgnn_tpu.data.counting import generate_counting_dataset as jcounting
from kpgnn_tpu.data.property import generate_property_dataset as jproperty
from kpgnn_tpu_torch.scripts import (train_counting, train_graph_property,
                                     train_node_property, train_tu)
from tests.test_scripts import write_standard_tu_dataset

torch.set_num_threads(1)
TINY = ["--device", "cpu", "--K", "2", "--num_layer", "2", "--hidden_size",
        "16", "--num_epochs", "2", "--runs", "1"]
SCRIPTS = {
    "counting": (train_counting, ["--n_graphs", "60", "--batch_size", "8"]),
    "gprop": (train_graph_property, ["--data_scale", "0.02", "--batch_size",
                                     "32", "--task", "1"]),
    "nprop": (train_node_property, ["--data_scale", "0.02", "--batch_size",
                                    "32"]),
}


def run(mod, argv):
    rows = []
    out = mod.main(argv, epoch_callback=lambda e, m, row: rows.append(row))
    assert math.isfinite(out)
    assert all(np.isfinite(r["step_losses"]).all() for r in rows)
    return out, rows


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_generated_data_scripts_on_cpu(tmp_path, name):
    """Two epochs on each backend; the first step's loss is the same on
    every backend."""
    mod, extra = SCRIPTS[name]
    firsts = []
    for backend in ("pallas", "coo", "dense"):
        _, rows = run(mod, TINY + extra + ["--backend", backend,
                                           "--save_dir", str(tmp_path),
                                           "--dataset_dir", str(tmp_path)])
        # counting: 18 train graphs in 3 batches of 8; property: 100 in 4
        assert len(rows) == 2 and all(
            len(r["step_losses"]) == (3 if name == "counting" else 4)
            for r in rows)
        assert all(math.isfinite(r["val_loss"]) for r in rows)
        assert "test_loss" in rows[0]       # the first epoch is the best
        firsts.append(rows[0]["step_losses"][0])
    np.testing.assert_allclose(firsts, firsts[0], rtol=1e-4)


@pytest.mark.parametrize("ystd", ["train", "full"])
def test_counting_labels_follow_the_jax_script(ystd, tmp_path):
    """y is the task's count over the train split's std (ddof 0) or the
    whole set's (ddof 1), as kpgnn_tpu/scripts/train_counting.py."""
    args = train_counting.parser().parse_args(
        ["--n_graphs", "60", "--task", "3", "--ystd", ystd,
         "--dataset_dir", str(tmp_path)])
    splits = train_counting.datasets(args)
    data = jcounting(60, seed=1234)
    ys = [g["y"][3] for s in data.values() for g in s]
    std = (np.std(ys, ddof=1) if ystd == "full"
           else np.std([g["y"][3] for g in data["train"]]))
    for k in data:
        got = [g.y for g in splits[k]]
        want = [np.array([g["y"][3] / std], np.float32) for g in data[k]]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_property_labels_follow_the_jax_scripts(tmp_path):
    """Graph property: y the task's graph label; node property: the
    task's column of the node labels, (N, 1)."""
    argv = ["--data_scale", "0.02", "--task", "2", "--dataset_dir",
            str(tmp_path)]
    gs = train_graph_property.datasets(
        train_graph_property.parser().parse_args(argv))
    ns = train_node_property.datasets(
        train_node_property.parser().parse_args(argv))
    data = jproperty(seed=1234, scale=0.02)
    for k in data:
        for g, n, want in zip(gs[k], ns[k], data[k]):
            np.testing.assert_array_equal(
                g.y, np.array([want["y"][2]], np.float32))
            np.testing.assert_array_equal(n.y, want["node_y"][:, 2:3])
            assert n.y.shape == (want["num_nodes"], 1)


def test_train_tu_gin_split_on_cpu(tmp_path):
    """The GIN protocol on the MUTAG-scale fixture, fold 0 of its ten,
    without dropout: every backend takes the same first step."""
    write_gin_fixture(str(tmp_path))
    firsts = []
    for backend in ("pallas", "coo", "dense"):
        acc, rows = run(train_tu, TINY + [
            "--dataset_dir", str(tmp_path), "--folds", "1", "--backend",
            backend, "--drop_prob", "0", "--save_dir", str(tmp_path / "s")])
        assert 0.0 <= acc <= 1.0
        # fold 0 trains on 169 of the 188 graphs: 6 batches of 32
        assert len(rows) == 2 and all(len(r["step_losses"]) == 6
                                      for r in rows)
        assert [r["lr"] for r in rows] == [1e-2, 1e-2]
        firsts.append(rows[0]["step_losses"][0])
    np.testing.assert_allclose(firsts, firsts[0], rtol=1e-4)


def test_train_tu_standard_format_on_cpu(tmp_path):
    """The stratified k-fold protocol (train and val merged) on a
    standard-format tree, K=3: the hidden size rounds up to 18."""
    write_standard_tu_dataset(tmp_path)
    rows = []
    acc = train_tu.main(["--device", "cpu", "--dataset_name", "TOYSTD",
                         "--dataset_dir", str(tmp_path), "--folds", "3",
                         "--K", "3", "--hidden_size", "16", "--num_layer",
                         "1", "--num_epochs", "2", "--batch_size", "8",
                         "--save_dir", str(tmp_path / "s")],
                        epoch_callback=lambda e, m, row: rows.append(row))
    assert 0.0 <= acc <= 1.0 and len(rows) == 3 * 2
    args = train_tu.parser().parse_args(["--K", "3", "--hidden_size", "16"])
    assert train_tu.config(args, 3, 2).hidden_size == 18


def test_train_tu_step_decay(tmp_path):
    """The LR times --factor every 50 epochs."""
    write_gin_fixture(str(tmp_path))
    rows = []
    train_tu.main(TINY[:-4] + ["--num_epochs", "51", "--dataset_dir",
                               str(tmp_path), "--folds", "1",
                               "--batch_size", "188", "--factor", "0.1",
                               "--save_dir", str(tmp_path / "s")],
                  epoch_callback=lambda e, m, row: rows.append(row))
    assert [r["lr"] for r in rows] == [1e-2] * 50 + [1e-3]


def test_train_tu_refuses_resident_on(tmp_path):
    """``--resident on`` was refused before resident epochs were ported
    (the name stays); it now takes the resident fold under --dense, and
    still refuses nothing."""
    write_gin_fixture(str(tmp_path))
    acc = train_tu.main(TINY + ["--dataset_dir", str(tmp_path), "--dense",
                                "--resident", "on", "--folds", "1",
                                "--save_dir", str(tmp_path / "s")])
    assert 0.0 <= acc <= 1.0
    (log,) = (tmp_path / "s" / "train").glob("*/log.txt")
    assert "fold 0: resident stores on cpu" in log.read_text()
