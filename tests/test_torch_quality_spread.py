"""quality_spread.py's summary: groups keyed by seed, a repeated seed
refused, d and se against the JAX CPU group, and d and se paired by
seed."""
import importlib
import importlib.util
import json
import math
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def quality_spread():
    spec = importlib.util.spec_from_file_location(
        "quality_spread", os.path.join(ROOT, "quality_spread.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_rows(path, rows):
    with open(path, "w") as f:
        for side, device, seed, mae in rows:
            f.write(json.dumps(dict(task="qm9", side=side, device=device,
                                    backend="dense", seed=seed,
                                    test_mae=mae, seconds=1.0)) + "\n")


JAX = [("jax", "cpu", 1, 0.30), ("jax", "cpu", 2, 0.50),
       ("jax", "cpu", 3, 0.40)]
PORT = [("port", "cuda", 1, 0.32), ("port", "cuda", 2, 0.51),
        ("port", "cuda", 3, 0.43)]


def test_summary_d_se_and_paired(tmp_path):
    write_rows(tmp_path / "jax.jsonl", JAX)
    write_rows(tmp_path / "card.jsonl", PORT)
    out = quality_spread().summarize([str(tmp_path)])
    row = out["qm9/d/cuda/dense"]
    sj = math.sqrt(((0.30 - 0.4) ** 2 + (0.5 - 0.4) ** 2) / 2)
    mp = (0.32 + 0.51 + 0.43) / 3
    sp = math.sqrt(sum((x - mp) ** 2 for x in (0.32, 0.51, 0.43)) / 2)
    assert row["d"] == pytest.approx(mp - 0.4)
    assert row["se"] == pytest.approx(math.sqrt(sj ** 2 / 3 + sp ** 2 / 3))
    assert row["smallest_seen"] == pytest.approx(2 * row["se"])
    diffs = [0.02, 0.01, 0.03]
    assert row["paired_n"] == 3
    assert row["paired_d"] == pytest.approx(0.02)
    assert row["paired_se"] == pytest.approx(
        math.sqrt(sum((x - 0.02) ** 2 for x in diffs) / 2) / math.sqrt(3))
    assert out["qm9/port/cuda/dense"]["seeds"] == [1, 2, 3]


def test_summary_refuses_a_repeated_seed(tmp_path):
    write_rows(tmp_path / "a.jsonl", JAX + PORT)
    write_rows(tmp_path / "b.jsonl", PORT[:1])
    with pytest.raises(SystemExit, match="seed 1 of qm9/port/cuda/dense"):
        quality_spread().summarize([str(tmp_path)])
    # one file alone reads; the same file named twice is refused
    quality_spread().summarize([str(tmp_path / "a.jsonl")])
    with pytest.raises(SystemExit):
        quality_spread().summarize([str(tmp_path / "a.jsonl")] * 2)


NEW_TASKS = ("qm9_prime", "counting", "counting_prime", "graph_property",
             "node_property")


def run_args(mod, task, side, **kw):
    a = dict(side=side, task=task, task_id=kw.pop("task_id", 1), seed=235,
             data="/data" if mod.TASKS[task][2] else None, out="/out",
             num_epochs=None, n_graphs=None, data_scale=None,
             backend="pallas", device="cpu" if side == "jax" else "cuda",
             load_path=None)
    a.update(kw)
    import argparse
    return argparse.Namespace(**a)


@pytest.mark.parametrize("task", NEW_TASKS)
def test_new_tasks_argv_differs_only_in_device(task):
    """Each task's flags are the same on both sides but --device (the
    save and cache directories name the side), cuts included, and
    --task_id reaches the script's --task."""
    mod = quality_spread()
    cut = ({"n_graphs": 500} if task.startswith("counting") else
           {"data_scale": 0.5} if task.endswith("property") else {})
    jax = mod.script_argv(run_args(mod, task, "jax", num_epochs=7, **cut))
    port = mod.script_argv(run_args(mod, task, "port", num_epochs=7, **cut))
    assert "--device" not in jax
    assert port[port.index("--device") + 1] == "cuda"
    assert mod.flag_set(jax) == mod.flag_set(port)
    strip = lambda argv: [x for i, x in enumerate(argv) if not (
        x in mod.PER_RUN or (i and argv[i - 1] in mod.PER_RUN))]
    assert strip(jax) == strip(port)
    assert port.count("--num_epochs") == 1
    module = importlib.import_module(
        f"kpgnn_tpu_torch.scripts.{mod.TASKS[task][0]}")
    args = module.parser().parse_args(port)
    assert args.task == 1 and args.num_epochs == 7 and args.seed == 235
    for k, v in cut.items():
        assert getattr(args, k) == v
    if task == "qm9_prime":
        assert (args.model_name, args.K, args.num_layer, args.residual,
                args.use_rd) == ("KPGINPrime", 16, 16, True, True)
    if task == "counting_prime":
        assert (args.model_name, args.K, args.num_layer,
                args.wo_path_encoding) == ("KPGINPrime", 4, 2, True)


def write_task_rows(path, task, task_id, rows, flags=()):
    with open(path, "w") as f:
        for side, device, seed, value in rows:
            f.write(json.dumps(dict(
                task=task, task_id=task_id, side=side, device=device,
                backend="dense" if side == "jax" else "pallas", seed=seed,
                metric=value, metric_name="log10_mse", seconds=1.0,
                argv=["--task", str(task_id), *flags, "--seed", str(seed),
                      "--backend", "x"])) + "\n")


def test_summary_groups_new_tasks(tmp_path):
    """Rows of a generated task group by (task:task_id, side, device,
    backend); d and se against its JAX CPU group, the pass rule |d| <=
    2se; no pairing by seed where the seed does not draw the split; a
    port group on other flags than its JAX group's is refused."""
    mod = quality_spread()
    jax = [("jax", "cpu", s, v) for s, v in ((1, -3.0), (2, -3.2))]
    port = [("port", "cuda", s, v) for s, v in ((1, -3.1), (2, -3.15))]
    write_task_rows(tmp_path / "a.jsonl", "graph_property", 0, jax + port)
    write_task_rows(tmp_path / "b.jsonl", "node_property", 2, port)
    out = mod.summarize([str(tmp_path)])
    row = out["graph_property:0/d/cuda/pallas"]
    assert row["d"] == pytest.approx(-3.125 - -3.1)
    se = math.sqrt(0.02 / 2 + 0.00125 / 2)
    assert row["se"] == pytest.approx(se)
    assert row["pass"] is True and "paired_d" not in row
    assert out["node_property:2/port/cuda/pallas"]["seeds"] == [1, 2]
    assert "node_property:2/d/cuda/pallas" not in out
    # a cut run is a task of its own: the same seeds, another group
    write_task_rows(tmp_path / "e.jsonl", "graph_property", 0, port,
                    flags=("--num_epochs", "9"))
    out = mod.summarize([str(tmp_path)])
    assert out["graph_property:0 num_epochs=9/port/cuda/pallas"][
        "seeds"] == [1, 2]
    assert "graph_property:0 num_epochs=9/d/cuda/pallas" not in out
    write_task_rows(tmp_path / "c.jsonl", "counting", 1, jax)
    write_task_rows(tmp_path / "d.jsonl", "counting", 1, port,
                    flags=("--K", "2"))
    with pytest.raises(SystemExit, match="counting:1/port"):
        mod.summarize([str(tmp_path)])
