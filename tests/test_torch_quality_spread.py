"""quality_spread.py's summary: groups keyed by seed, a repeated seed
refused, d and se against the JAX CPU group, and d and se paired by
seed."""
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
