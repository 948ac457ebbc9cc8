"""The port's CSL slice against the JAX package: the generator, the
folds, three Adam steps of a small KPGIN-on-GNN model on CSL batches
with carried weights (dropout 0), and ``train_csl.main`` end to end on
the CPU.  Losses rtol 1e-4 (f32; the two sides sum in different
orders)."""
import math

import jax
import numpy as np
import pytest
import torch

import kpgnn_tpu.graph.batch as jbatch
import kpgnn_tpu.models as jmodels
from kpgnn_tpu.data.expressiveness import CSL_SKIPS as JCSL_SKIPS
from kpgnn_tpu.data.expressiveness import generate_csl as jgenerate_csl
from kpgnn_tpu.train.kfold import k_fold as jk_fold
from kpgnn_tpu.train.loop import train_step_body
from kpgnn_tpu.train.state import create_train_state
from kpgnn_tpu_torch.data.expressiveness import CSL_SKIPS, generate_csl
from kpgnn_tpu_torch.graph import batch as tbatch
from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.train.kfold import k_fold
from kpgnn_tpu_torch.train.loop import evaluate, train_step
from kpgnn_tpu_torch.train.state import make_optimizer
from kpgnn_tpu_torch.utils.convert import params_from_flax
from tests.test_torch_layers import flat
from tests.test_torch_prep_batch import both_prep

torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [{}, dict(n=11, copies=3, seed=5)])
def test_generate_csl_equals_jax(kw):
    assert CSL_SKIPS == JCSL_SKIPS
    ours, theirs = generate_csl(**kw), jgenerate_csl(**kw)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("folds,seed", [(10, 234), (3, 7), (5, 12345)])
def test_k_fold_equals_jax(folds, seed):
    labels = np.repeat(np.arange(10), 15)
    ours = k_fold(len(labels), labels, folds=folds, seed=seed)
    theirs = jk_fold(len(labels), labels, folds=folds, seed=seed)
    assert len(ours) == len(theirs) == folds
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="folds >= 3"):
        k_fold(len(labels), labels, folds=2)


def test_train_csl_few_folds_run_the_standard_splits():
    from kpgnn_tpu_torch.scripts.train_csl import splits

    labels = np.repeat(np.arange(10), 15)
    ten = jk_fold(len(labels), labels, folds=10, seed=234)
    for folds in (1, 2):
        got = splits(labels, folds, 234)
        assert len(got) == folds
        for a, b in zip(got, ten):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


CSL_SMALL = dict(model_name="KPGIN", hidden_size=12, num_layer=2, K=3,
                 max_pe_num=1000, max_edge_count=1000, max_hop_num=3,
                 max_distance_count=1000, virtual_node=True, drop_prob=0.0,
                 input_encoder=("linear", 1), task="graph_classification",
                 output_size=10, pooling_method="sum")
CSL_PREP = dict(K=3, kernel="spd", max_edge_attr_num=1000, max_hop_num=3,
                max_edge_type=1, max_edge_count=1000, max_distance_count=1000)


def csl_batches(n_batches=3, per_batch=5):
    raw = generate_csl()
    # graphs of every class: one per class and batch, in batch order
    picks = [raw[c * 15 + b] for b in range(n_batches)
             for c in range(per_batch)]
    for r in picks:
        r["x"] = np.ones((r["num_nodes"], 1), np.float32)
        r["edge_attr"] = None
    js, ts = both_prep(picks, **CSL_PREP)
    pads = dict(n_pad=256, e_pad=max(4096, 2 * sum(
        g.num_edges for g in ts[:per_batch])), g_pad=per_batch + 1)
    out = []
    for i in range(n_batches):
        sl = slice(i * per_batch, (i + 1) * per_batch)
        out.append((jbatch.collate(js[sl], **pads),
                    tbatch.collate(ts[sl], **pads),
                    tbatch.collate_pallas(ts[sl], v1=3, vk=1002, **pads)))
    return out


@pytest.mark.parametrize("backend", ["coo", "pallas"])
def test_csl_kpgin_three_adamw_steps_equal_jax(backend):
    """CSL's optimizer (AdamW, l2_wd 3e-6) and cross entropy; the JAX
    model on its COO backend."""
    batches = csl_batches()
    jmodel = jmodels.make_model(jmodels.ModelConfig(**CSL_SMALL))
    tmodel = make_model(ModelConfig(**CSL_SMALL))
    state, tx = create_train_state(jmodel, batches[0][0],
                                   jax.random.PRNGKey(0), lr=1e-3,
                                   l2_wd=3e-6)
    tmodel.load_state_dict(params_from_flax(flat(state.variables)),
                           strict=True)
    opt = make_optimizer(tmodel.parameters(), lr=1e-3, l2_wd=3e-6)
    assert isinstance(opt, torch.optim.AdamW)
    jstep = jax.jit(train_step_body(jmodel, tx, "cross_entropy"))
    jl, tl = [], []
    for jb, tb_coo, tb_plan in batches:
        state, m = jstep(state, jb, jax.random.PRNGKey(1))
        jl.append(float(m["loss_sum"]) / float(m["count"]))
        lsum, cnt = train_step(tmodel, opt,
                               tb_coo if backend == "coo" else tb_plan,
                               "cross_entropy")
        tl.append(float(lsum) / float(cnt))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert len(set(np.round(jl, 6))) == 3       # the steps moved weights


def test_evaluate_reports_accuracy_over_real_graphs():
    class Fixed(torch.nn.Module):
        def forward(self, batch, train=False):
            return batch.pred
    from kpgnn_tpu_torch.graph.batch import GraphBatch

    batches = []
    for pred, y, mask in (([[0.1, 0.9], [0.8, 0.2], [0.0, 5.0]], [1, 1, 1],
                           [True, True, False]),
                          ([[2.0, 1.0], [0.0, 0.0]], [0, 1], [True, False])):
        b = GraphBatch.__new__(GraphBatch)
        b.pred, b.y = torch.tensor(pred), torch.tensor(y)
        b.graph_mask = torch.tensor(mask)
        batches.append(b)
    res = evaluate(Fixed(), batches, "cross_entropy")
    assert res["count"] == 3.0 and math.isclose(res["accuracy"], 2 / 3)


def test_trainer_refuses_the_plateau_schedule_in_max_mode():
    """The plateau schedule is ported in "min" mode only: an accuracy-gated
    run must keep the LR constant, as the expressiveness scripts do."""
    from kpgnn_tpu_torch.train.config import TrainConfig
    from kpgnn_tpu_torch.train.loop import Trainer

    trainer = Trainer(torch.nn.Linear(1, 1), TrainConfig(num_epochs=1),
                      loss="cross_entropy", metric_mode="max",
                      use_scheduler=True, device="cpu")
    with pytest.raises(NotImplementedError, match="'min' mode only"):
        trainer.fit([])


TINY = ["--K", "2", "--hidden_size", "16", "--num_layer", "2",
        "--num_epochs", "2", "--batch_size", "32", "--folds", "1"]


@pytest.mark.parametrize("backend", ["coo", "pallas"])
def test_train_csl_main_on_cpu(tmp_path, backend):
    from kpgnn_tpu_torch.scripts import train_csl

    rows = []
    acc = train_csl.main(
        ["--device", "cpu", "--backend", backend, "--save_dir",
         str(tmp_path / "s")] + TINY,
        epoch_callback=lambda e, m, row: rows.append(row))
    assert 0.0 <= acc <= 1.0
    # 150 graphs, fold 0 of 10: 120 train graphs in 4 batches of 32
    assert len(rows) == 2 and all(len(r["step_losses"]) == 4 for r in rows)
    assert all(np.isfinite(r["step_losses"]).all()
               and math.isfinite(r["val_loss"])
               and 0.0 <= r["val_accuracy"] <= 1.0 for r in rows)
    assert "test_accuracy" in rows[0]       # the first epoch is the best


def test_train_csl_refuses_max_on_the_kernel_backend(tmp_path):
    """As the JAX CLI: the kernel plan is sum-only, max needs COO."""
    from kpgnn_tpu_torch.scripts import train_csl

    with pytest.raises(SystemExit, match="--aggr max"):
        train_csl.main(["--device", "cpu", "--backend", "pallas",
                        "--model_name", "KPGraphSAGE", "--aggr", "max",
                        "--save_dir", str(tmp_path / "s")] + TINY)
