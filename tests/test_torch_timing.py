"""``utils/timing.chained_throughput`` and the two entry points that time
the banded backend, ``scripts/tune_banded`` and ``profile_step --stages
banded``, at toy sizes on the CPU (the numbers are CPU times, checked
for form only; the card's come from chip_smoke.py)."""
import json

import numpy as np
import pytest
import torch

import kpgnn_tpu.graph.batch as jbatch
from kpgnn_tpu.data.synthetic import synthetic_polymers as jpolymers
from kpgnn_tpu_torch.utils import timing

torch.set_num_threads(1)


class FakeClock:
    """perf_counter that advances only when the timed op runs: each call
    of ``op`` costs ``costs[i]`` seconds, in turn."""

    def __init__(self, costs):
        self.now, self.costs, self.calls = 0.0, list(costs), 0

    def __call__(self):
        return self.now

    def op(self, x):
        self.now += self.costs[self.calls % len(self.costs)]
        self.calls += 1
        return x + 1


def test_chained_throughput_counts_chain_times_units(monkeypatch):
    """units/s of one application: reps x chain x units over a round's
    seconds, the best of 3 rounds, after one warm-up call."""
    # warm-up 1 s, then rounds of 2 calls at 2 s, 1 s and 4 s a call
    clock = FakeClock([1.0, 2.0, 2.0, 1.0, 1.0, 4.0, 4.0])
    monkeypatch.setattr(timing.time, "perf_counter", clock)
    seen = []

    def chained(x):
        seen.append(x)
        for _ in range(4):              # chain = 4 dependent applications
            x = x * 1.0
        return clock.op(x)
    rate = timing.chained_throughput(chained, torch.zeros(3), units=10,
                                     iters=8, chain=4)
    assert clock.calls == 1 + 3 * 2
    # the best round: 2 calls x chain 4 x 10 units in 2 s
    assert rate == 2 * 4 * 10 / 2.0
    assert all(torch.equal(x, torch.zeros(3)) for x in seen)


def test_chained_throughput_on_a_real_chain():
    a = torch.randn(64, 64) / 8

    def chained(x):
        for _ in range(3):
            x = a @ x
        return x
    rate = timing.chained_throughput(chained, torch.randn(64, 16), units=5,
                                     iters=6, chain=3)
    assert rate > 0 and np.isfinite(rate)


def test_tune_banded_at_toy_size(capsys):
    """One JSON row per tile with the JAX script's keys, the plan fields
    the JAX package's collate_banded gives for the same polymers, then
    the best tile by the forward + backward rate."""
    from kpgnn_tpu_torch.scripts import tune_banded

    res = tune_banded.main(["--device", "cpu", "--n_nodes", "300",
                            "--batch", "2", "--K", "2", "--hidden_size",
                            "8", "--iters", "2", "--chain", "2", "--tiles",
                            "128,256"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert len(lines) == 3 and set(res) == {"128", "256"}
    graphs = jpolymers(2, 300, K=2, seed=0)
    for row, tile in zip(lines[:2], (128, 256)):
        assert row["tile"] == tile
        assert set(row) == {"tile", "fwd_edges_per_s", "fwdbwd_edges_per_s",
                            "halo", "win", "n_pad", "spill"}
        assert row["fwd_edges_per_s"] > 0 and row["fwdbwd_edges_per_s"] > 0
        adj = jbatch.collate_banded(graphs, v1=5, vk=32, tile=tile).adj
        spill = (0 if adj.spill_senders is None
                 else int(adj.spill_senders.shape[0]))
        assert (row["halo"], row["win"], row["n_pad"], row["spill"]) == (
            adj.halo, tile + 2 * adj.halo, adj.n_nodes, spill)
    best = lines[2]
    assert best["best_tile"] in (128, 256)
    assert best["fwdbwd_edges_per_s"] == max(
        r["fwdbwd_edges_per_s"] for r in lines[:2])


def test_tune_banded_counts_union_edges_as_jax():
    """The rate's unit: the batch's real union edges, as the JAX script
    counts them (collate's edge mask)."""
    from kpgnn_tpu_torch.data.synthetic import synthetic_polymers
    from kpgnn_tpu_torch.graph.batch import collate

    graphs = synthetic_polymers(2, 300, K=2, seed=0)
    ours = int(collate(graphs).adj.edge_mask.sum())
    theirs = int(np.asarray(jbatch.collate(jpolymers(2, 300, K=2, seed=0))
                            .adj.edge_mask).sum())
    assert ours == theirs == sum(g.num_edges for g in graphs)


@pytest.fixture
def toy_profile_step(monkeypatch):
    from kpgnn_tpu_torch.scripts import profile_step as ps

    for name, value in (("LARGE_NODES", 64), ("LARGE_HIDDEN", 18),
                        ("REPEATS", 1), ("LARGE_ITERS", 2), ("TOP_N", 5)):
        monkeypatch.setattr(ps, name, value)
    return ps


def test_profile_step_banded_stage_at_toy_size(toy_profile_step, tmp_path,
                                               capsys):
    """The banded stage: the plan's tile, halo and spill, the f32 and the
    bf16 step's time, and a trace report of each."""
    res = toy_profile_step.main(["--device", "cpu", "--out_dir",
                                 str(tmp_path), "--stages", "banded"])
    out = capsys.readouterr().out
    assert set(res) == {"banded"}
    r = res["banded"]
    assert set(r) == {"collate_s", "float32", "bfloat16"}
    assert all(v > 0 for v in r.values())
    for line in ("banded plan: tile=128, halo=", "banded float32 step:",
                 "banded bfloat16 step:", "[stage banded done"):
        assert line in out, line
    assert out.count("==== trace summary:") == 2
