"""The port's expressiveness scripts end to end on the CPU, against the
JAX package: ``train_exp`` (EXP from the pickle, CEXP from the text
file) and ``train_sr`` take the JAX script's first step on carried
weights (rtol 1e-4; the two sides sum in different orders),
``run_simulation``'s main and sweep, and ``run_search`` over a preset
and a grid.  The fixtures are chip_smoke.py's."""
import json
import math

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import kpgnn_tpu.train.loop as jloop
from kpgnn_tpu.scripts import run_search as jrun_search
from kpgnn_tpu_torch.models.factory import make_model
from kpgnn_tpu_torch.scripts import run_search, run_simulation
from kpgnn_tpu_torch.scripts import train_exp, train_sr
from kpgnn_tpu_torch.scripts.common import model_config
from kpgnn_tpu_torch.train.checkpoint import save_checkpoint
from kpgnn_tpu_torch.train.state import make_optimizer
from kpgnn_tpu_torch.utils.convert import params_from_flax
from tests.test_torch_layers import flat

torch.set_num_threads(1)


def test_simulation_main_and_sweep_on_cpu(tmp_path, capsys):
    rate = run_simulation.main(["--device", "cpu", "--backend", "pallas",
                                "--n", "20", "--graphs", "2",
                                "--hidden_size", "16"])
    assert 0.0 <= rate <= 1.0 and "collision rate" in capsys.readouterr().out
    table = run_simulation.main([
        "--device", "cpu", "--sweep", "--graphs", "1", "--hidden_size", "8",
        "--plot_path", str(tmp_path / "sim" / "simulation.png")])
    with open(tmp_path / "sim" / "simulation.json") as f:
        saved = json.load(f)
    assert saved["n"] == [20, 40, 80, 160]
    assert sorted(saved["rates"]) == ["1", "2", "3", "4"]
    assert all(0.0 <= x <= 1.0 for rr in saved["rates"].values() for x in rr)
    assert table["rates"][1] == saved["rates"]["1"]
    assert table["plot"] in (None, str(tmp_path / "sim" / "simulation.png"))


def test_run_search_grid_and_preset_on_cpu(tmp_path, capsys):
    chip_smoke.write_sr25_fixture(str(tmp_path))
    base = (f"--device cpu --num_epochs 1 --hidden_size 8 --save_dir "
            f"{tmp_path / 's'} --dataset_dir {tmp_path}")
    res = run_search.main(["--preset", "sr_search", "--limit", "1",
                           "--base", base])
    assert len(res) == 1 and res[0]["script"] == "sr"
    assert res[0]["config"] == jrun_search._presets()["sr_search"][0][1]
    assert math.isfinite(res[0]["metric"])
    res = run_search.main(["sr", "--grid", '{"K": [1, 2]}', "--base",
                           base + " --num_layer 2"])
    assert [r["config"] for r in res] == [["--K", "1"], ["--K", "2"]]
    with pytest.raises(SystemExit):
        run_search.main(["--base", base])


def record_jax_first_step(monkeypatch):
    """Records the JAX Trainer's first initial state and its first step's
    loss (the jitted step wrapped inside ``train_epoch``: the scripts run
    with ``--resident off``, whose epochs go through it)."""
    seen = {}
    create, epoch = jloop.create_train_state, jloop.train_epoch

    def create_rec(*a, **kw):
        out = create(*a, **kw)
        # a host copy: the jitted step donates the state's buffers
        seen.setdefault("state", jax.device_get(out[0]))
        return out

    def epoch_rec(train_step, state, loader, rng):
        def step(s, b, r):
            s2, m = train_step(s, b, r)
            seen.setdefault("loss", float(m["loss_sum"]) / float(m["count"]))
            return s2, m
        return epoch(step, state, loader, rng)
    monkeypatch.setattr(jloop, "create_train_state", create_rec)
    monkeypatch.setattr(jloop, "train_epoch", epoch_rec)
    return seen


def carried_checkpoint(path, state, mcfg):
    """The JAX initial state as a port checkpoint (a fresh optimizer)."""
    model = make_model(mcfg)
    model.load_state_dict(params_from_flax(flat(state.variables)),
                          strict=True)
    save_checkpoint(path, model, make_optimizer(model.parameters(), 1e-3))
    return path


TINY = ["--K", "2", "--num_layer", "2", "--hidden_size", "16",
        "--resident", "off", "--num_epochs", "1"]


@pytest.mark.parametrize("name", ["EXP", "CEXP"])
def test_train_exp_first_step_equals_jax_script(tmp_path, monkeypatch,
                                                name):
    """EXP from the pickle, CEXP from the text file, 2 contiguous folds:
    the port's script, warm-started from the JAX script's initial weights,
    takes the JAX script's first step."""
    from kpgnn_tpu.scripts import train_exp as jtrain_exp

    chip_smoke.write_exp_fixture(str(tmp_path), n_pairs=40,
                                 txt=name == "CEXP")
    argv = ["--dataset_name", name, "--dataset_dir", str(tmp_path),
            "--folds", "2", "--batch_size", "16"] + TINY
    seen = record_jax_first_step(monkeypatch)
    jtrain_exp.main(argv + ["--save_dir", str(tmp_path / "j")])
    args = train_exp.parser().parse_args(argv)
    mcfg = model_config(args, ("embedding", 2), "graph_classification", 2)
    ck = carried_checkpoint(str(tmp_path / "init.pt"), seen["state"], mcfg)
    rows = []
    acc = train_exp.main(argv + ["--device", "cpu", "--backend", "pallas",
                                 "--save_dir", str(tmp_path / "t"),
                                 "--load_path", ck],
                         epoch_callback=lambda e, m, r: rows.append(r))
    assert 0.0 <= acc <= 1.0
    # 80 graphs, fold 0: test 40, val 20, train 20 in 2 batches of 16
    assert len(rows) == 2 and len(rows[0]["step_losses"]) == 2
    np.testing.assert_allclose(rows[0]["step_losses"][0], seen["loss"],
                               rtol=1e-4)
    with pytest.raises(SystemExit, match="--folds"):
        train_exp.main(["--device", "cpu", "--folds", "1"])


def test_train_exp_contiguous_folds_equal_jax(tmp_path):
    """The folds of the JAX script (kpgnn_tpu/scripts/train_exp.py:60-76),
    rebuilt here from its formula, keep every pair in one split."""
    for n, folds in ((1200, 10), (80, 2), (37, 3)):
        got = train_exp.splits(n, folds)
        idx = np.arange(n)
        per = n // folds
        assert len(got) == folds
        for fold, (tr, va, te) in enumerate(got):
            test = idx[fold * per:(fold + 1) * per]
            rest = np.concatenate([idx[:fold * per], idx[(fold + 1) * per:]])
            vn = len(rest) // folds
            np.testing.assert_array_equal(te, test)
            np.testing.assert_array_equal(va, rest[fold * vn:(fold + 1) * vn])
            np.testing.assert_array_equal(tr, np.concatenate(
                [rest[:fold * vn], rest[(fold + 1) * vn:]]))


def test_train_sr_first_step_equals_jax_script(tmp_path, monkeypatch):
    """SR25 on the smoke's fixture: x = ones, train == eval, accuracy in
    max mode without a scheduler, batch-statistics eval; the first step
    on carried weights equals the JAX script's, and the running
    statistics move only in train steps."""
    from kpgnn_tpu.scripts import train_sr as jtrain_sr

    chip_smoke.write_sr25_fixture(str(tmp_path))
    argv = ["--dataset_dir", str(tmp_path)] + TINY[:-1] + ["2"]
    seen = record_jax_first_step(monkeypatch)
    jtrain_sr.main(argv + ["--save_dir", str(tmp_path / "j")])
    args = train_sr.parser().parse_args(argv)
    mcfg = model_config(args, ("embedding", 2), "graph_classification", 15)
    ck = carried_checkpoint(str(tmp_path / "init.pt"), seen["state"], mcfg)
    rows, stats = [], []
    acc = train_sr.main(
        argv + ["--device", "cpu", "--backend", "pallas", "--save_dir",
                str(tmp_path / "t"), "--load_path", ck],
        epoch_callback=lambda e, m, r: (rows.append(r), stats.append(
            {k: v.clone() for k, v in m.named_buffers()})))
    assert acc == max(r["val_accuracy"] for r in rows)
    assert len(rows) == 2 and all(len(r["step_losses"]) == 1 for r in rows)
    assert all(r["val_loss"] == r["test_loss"] for r in rows
               if "test_loss" in r)
    assert [r["lr"] for r in rows] == [1e-3, 1e-3]
    np.testing.assert_allclose(rows[0]["step_losses"][0], seen["loss"],
                               rtol=1e-4)
    assert any(not torch.equal(stats[0][k], stats[1][k]) for k in stats[0])
