"""The port's QM9 slice against the JAX package: the loaders (qm9_v3.pt
and raw gdb9 artifacts), the QM9 constants and atomrefs, the
``QM9InputEncoder``, a small QM9 model (KPGINPlus K=3 L=3 H=16, attention
combine and pooling, virtual node, rd) on coo, on the kernel plan (its
plain version) and on dense, three Adam steps with MSE losses, the
evaluation metrics, and ``train_qm9.main`` end to end on the CPU.

Tolerances (f32): activations atol 1e-5 / rtol 1e-4, losses rtol 1e-4;
loaded arrays and collated fields are exact.
"""
import math
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kpgnn_tpu.data.molecules as jmol
import kpgnn_tpu.graph.batch as jbatch
import kpgnn_tpu.models as jmodels
import kpgnn_tpu.nn.encoders as jenc
import kpgnn_tpu.prep.khop as jkhop
from kpgnn_tpu.train.loop import _masked_loss as jmasked_loss
from kpgnn_tpu.train.loop import eval_step_body, summarize_eval_sums
from kpgnn_tpu.train.loop import train_step_body
from kpgnn_tpu.train.state import create_train_state
from chip_smoke import run_tool
from kpgnn_tpu_torch.data import molecules as tmol
from kpgnn_tpu_torch.graph import batch as tbatch
from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.nn import encoders
from kpgnn_tpu_torch.prep import khop as tkhop
from kpgnn_tpu_torch.train.loop import _masked_loss, evaluate, train_step
from kpgnn_tpu_torch.train.state import make_optimizer
from tests.test_molecule_loaders import _write_qm9_raw_fixture
from kpgnn_tpu_torch.utils.convert import params_from_flax
from tests.test_torch_layers import carry, close, flat

torch.set_num_threads(1)
RAW_FIELDS = ("num_nodes", "edge_index", "edge_attr", "x", "z", "pos", "y")


def write_qm9_fixture(root, n, seed=7):
    """A qm9_v3.pt-format dump of ``n`` molecules, written by
    tools/make_qm9_fixture.py."""
    run_tool("make_qm9_fixture", "--out", root, "--n", n, "--seed", seed)


def assert_raw_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == sorted(RAW_FIELDS)
        for k in RAW_FIELDS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


# ---- loaders and constants ----

@pytest.mark.parametrize("raw_order", [False, True])
def test_load_qm9_equals_jax(tmp_path, raw_order):
    write_qm9_fixture(tmp_path, 12)
    root = str(tmp_path / "QM9")
    assert_raw_equal(tmol.load_qm9(root, targets_raw_order=raw_order),
                     jmol.load_qm9(root, targets_raw_order=raw_order))
    with pytest.raises(FileNotFoundError):
        tmol.load_qm9(str(tmp_path / "nowhere"))


def test_load_qm9_raw_equals_jax(tmp_path):
    _write_qm9_raw_fixture(tmp_path)
    root = str(tmp_path / "QM9")
    ours = tmol.load_qm9_raw(root)
    assert len(ours) == 2               # the uncharacterized one is skipped
    assert_raw_equal(ours, jmol.load_qm9_raw(root))
    with pytest.raises(FileNotFoundError):
        tmol.load_qm9_raw(str(tmp_path / "nowhere"))


def test_qm9_constants_and_atomrefs_equal_jax():
    np.testing.assert_array_equal(tmol.QM9_CONVERSION, jmol.QM9_CONVERSION)
    assert tmol.QM9_TYPES == jmol.QM9_TYPES
    assert tmol.QM9_ATOMIC_NUM == jmol.QM9_ATOMIC_NUM
    assert tmol.QM9_ATOMREFS == jmol.QM9_ATOMREFS
    for t in range(19):
        a, b = tmol.qm9_atomref(t), jmol.qm9_atomref(t)
        assert (a is None) == (b is None), t
        if a is not None:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    row = np.random.default_rng(0).normal(size=19)
    np.testing.assert_array_equal(tmol.qm9_reorder_and_convert(row),
                                  jmol.qm9_reorder_and_convert(row))


# ---- the input encoder ----

@pytest.mark.parametrize("use_pos", [False, True])
@pytest.mark.parametrize("multi_code", [False, True])
def test_qm9_input_encoder_equals_jax(use_pos, multi_code):
    """The summed z embedding (1-D z, or several codes a node), x and,
    under use_pos, pos; values and gradients with carried weights."""
    rng = np.random.default_rng(3)
    n = 30
    z = rng.choice([1, 6, 7, 8, 9], size=(n, 2) if multi_code else n)
    x = rng.normal(size=(n, 11)).astype(np.float32)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    jb, tb = types.SimpleNamespace(), types.SimpleNamespace()
    jb.z, jb.x, jb.pos = jnp.asarray(z), jnp.asarray(x), jnp.asarray(pos)
    tb.z, tb.x, tb.pos = (torch.from_numpy(z), torch.from_numpy(x),
                          torch.from_numpy(pos))
    jm = jenc.QM9InputEncoder(16, use_pos=use_pos)
    v = jm.init(jax.random.PRNGKey(2), jb)
    tm = carry(encoders.QM9InputEncoder(16, use_pos=use_pos), v)
    out = tm(tb)
    close(out, jm.apply(v, jb))
    w = rng.normal(size=(n, 16)).astype(np.float32)
    (out * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jb) * w))(
        v["params"])
    close(tm.z_embedding.weight.grad, jg["z_embedding"]["embedding"])
    close(tm.init_proj.weight.grad, jg["init_proj"]["kernel"].T)


# ---- a small QM9 model ----

QM9_SMALL = dict(model_name="KPGINPlus", hidden_size=16, num_layer=3, K=3,
                 num_hop1_edge=4, max_pe_num=50, max_edge_type=4,
                 max_edge_count=20, max_hop_num=5, max_distance_count=15,
                 combine="attention", pooling_method="attention", JK="last",
                 virtual_node=True, use_rd=True, drop_prob=0.0,
                 input_encoder=("qm9", 0), task="graph_regression",
                 output_size=1)
QM9_PREP = dict(K=3, kernel="spd", max_edge_attr_num=50, max_hop_num=5,
                max_edge_type=4, max_edge_count=20, max_distance_count=15,
                use_rd=True)
V1, VK = 6, 52
BACKENDS = ["coo", "pallas", "dense"]


def qm9_batches(tmp_path, n_batches=3, per_batch=4):
    """Fixture molecules through both packages' loader and prep, task 0
    as y; per batch the JAX (coo, dense) and the port's (coo, pallas,
    dense) collations."""
    write_qm9_fixture(tmp_path, n_batches * per_batch, seed=5)
    raws = tmol.load_qm9(str(tmp_path / "QM9"))
    for r in raws:
        r["y"] = r["y"][:1]
    jc = jkhop.KHopConfig(**QM9_PREP)
    js = [jkhop.extract_khop(r["num_nodes"], r["edge_index"],
                             r["edge_attr"], jc, x=r["x"], y=r["y"],
                             z=r["z"], pos=r["pos"]) for r in raws]
    ts = tkhop.extract_graphs(raws, tkhop.KHopConfig(**QM9_PREP))
    pads = dict(n_pad=128, e_pad=2048, g_pad=per_batch + 1)
    out = []
    for i in range(n_batches):
        sl = slice(i * per_batch, (i + 1) * per_batch)
        dense = dict(n_slot=24, v1=V1, vk=VK)
        out.append(({"coo": jbatch.collate(js[sl], **pads),
                     "dense": jbatch.collate_dense(js[sl], **dense)},
                    {"coo": tbatch.collate(ts[sl], **pads),
                     "pallas": tbatch.collate_pallas(ts[sl], v1=V1, vk=VK,
                                                     **pads),
                     "dense": tbatch.collate_dense(ts[sl], **dense)}))
    return out


def jax_side(backend):
    """The JAX backend a port backend is held against: the kernel plan
    against the JAX package's COO batch (its Pallas plan would run the
    kernel in interpret mode, the same sums)."""
    return "dense" if backend == "dense" else "coo"


@pytest.mark.parametrize("backend", BACKENDS)
def test_small_qm9_model_equals_jax(tmp_path, backend):
    (jbs, tbs), = qm9_batches(tmp_path, n_batches=1)
    jb, tb = jbs[jax_side(backend)], tbs[backend]
    jmodel = jmodels.make_model(jmodels.ModelConfig(**QM9_SMALL))
    v = jmodel.init(jax.random.PRNGKey(0), jbs["coo"], train=False)
    tmodel = carry(make_model(ModelConfig(**QM9_SMALL)), v)
    real = tb.graph_mask.numpy()
    with torch.no_grad():
        ours = tmodel(tb, train=False).numpy()[real]
    theirs = np.asarray(jmodel.apply(v, jb, train=False))[real]
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=1e-4)
    assert ours.shape == (4,) and np.isfinite(ours).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_small_qm9_three_adam_steps_equal_jax(tmp_path, backend):
    """QM9's optimizer (Adam, lr 1e-3, no weight decay) and MSE loss,
    dropout 0; the three losses differ, so the steps moved the weights."""
    batches = qm9_batches(tmp_path)
    jmodel = jmodels.make_model(jmodels.ModelConfig(**QM9_SMALL))
    tmodel = make_model(ModelConfig(**QM9_SMALL))
    state, tx = create_train_state(jmodel, batches[0][0]["coo"],
                                   jax.random.PRNGKey(0), lr=1e-3)
    carry(tmodel, state.variables)
    opt = make_optimizer(tmodel.parameters(), lr=1e-3)
    jstep = jax.jit(train_step_body(jmodel, tx, "mse"))
    jl, tl = [], []
    for jbs, tbs in batches:
        state, m = jstep(state, jbs[jax_side(backend)], jax.random.PRNGKey(1))
        jl.append(float(m["loss_sum"]) / float(m["count"]))
        lsum, cnt = train_step(tmodel, opt, tbs[backend], "mse")
        tl.append(float(lsum) / float(cnt))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert len(set(np.round(jl, 6))) == 3


def kpginprime_k16(tmp_path, backend):
    """The sweep's second config at small width (KPGINPrime K=16, the
    kernel's MAX_HOPS) on four QM9 molecules: (JAX model, its variables,
    JAX COO batch, the port's model carrying them, the port's batch on
    ``backend``)."""
    cfg = dict(QM9_SMALL, model_name="KPGINPrime", K=16, num_layer=3,
               hidden_size=32, virtual_node=False, residual=True)
    prep = dict(QM9_PREP, K=16)
    write_qm9_fixture(tmp_path, 4, seed=6)
    raws = tmol.load_qm9(str(tmp_path / "QM9"))
    for r in raws:
        r["y"] = r["y"][:1]
    jc = jkhop.KHopConfig(**prep)
    js = [jkhop.extract_khop(r["num_nodes"], r["edge_index"],
                             r["edge_attr"], jc, x=r["x"], y=r["y"],
                             z=r["z"], pos=r["pos"]) for r in raws]
    ts = tkhop.extract_graphs(raws, tkhop.KHopConfig(**prep))
    pads = dict(n_pad=96, e_pad=4096, g_pad=5)
    jb = jbatch.collate(js, **pads)
    tb = (tbatch.collate(ts, **pads) if backend == "coo" else
          tbatch.collate_pallas(ts, v1=V1, vk=VK, **pads))
    jmodel = jmodels.make_model(jmodels.ModelConfig(**cfg))
    v = jmodel.init(jax.random.PRNGKey(0), jb, train=False)
    return jmodel, v, jb, carry(make_model(ModelConfig(**cfg)), v), tb


@pytest.mark.parametrize("backend", ["coo", "pallas"])
def test_kpginprime_k16_equals_jax_in_one_kernel_launch(tmp_path, backend):
    """The K=16 config's output equal to the JAX model's on COO; on the
    plan its 16 hops are one launch per direction."""
    from kpgnn_tpu_torch.ops import spmm

    assert spmm.MAX_HOPS == 16
    jmodel, v, jb, tmodel, tb = kpginprime_k16(tmp_path, backend)
    if backend == "pallas":
        assert tb.adj.K == 16 and spmm.hop_layout(
            tb.adj.fwd.n_rows, tb.adj.fwd.rows_per_hop,
            tb.adj.fwd.hop_live)[0] == 96
    with torch.no_grad():
        ours = tmodel(tb, train=False).numpy()[:4]
    np.testing.assert_allclose(
        ours, np.asarray(jmodel.apply(v, jb, train=False))[:4],
        atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("backend", ["coo", "pallas"])
def test_kpginprime_k16_step_gradients_equal_jax(tmp_path, backend):
    """One training step of the K=16 config (batch statistics, MSE):
    predictions, loss and every parameter gradient equal the JAX model's
    (gradients rtol 1e-4, atol 1e-4 of the largest)."""
    jmodel, v, jb, tmodel, tb = kpginprime_k16(tmp_path, backend)

    def jloss(params):
        pred, _ = jmodel.apply({"params": params,
                                "batch_stats": v["batch_stats"]}, jb,
                               train=True, mutable=["batch_stats"])
        lsum, cnt = jmasked_loss(pred, jb.y, jb.graph_mask, "mse")
        return lsum / cnt, pred

    (jl, jpred), jg = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    tpred = tmodel(tb, train=True)
    lsum, cnt = _masked_loss(tpred, tb.y, tb.graph_mask, "mse")
    real = tb.graph_mask.numpy()
    close(tpred[real], np.asarray(jpred)[real])
    loss = lsum / cnt
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    loss.backward()
    jg = params_from_flax(flat({"params": jg}))
    gscale = max(float(g.abs().max()) for g in jg.values())
    assert sorted(n for n, _ in tmodel.named_parameters()) == sorted(jg)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[name].numpy(),
                                   rtol=1e-4, atol=1e-4 * gscale,
                                   err_msg=name)


# ---- evaluation metrics ----

@pytest.mark.parametrize("metric", ["mae", "mse", "same"])
@pytest.mark.parametrize("targets", [1, 3])
def test_eval_metrics_equal_summarize_eval_sums(metric, targets):
    """evaluate's epoch metrics against the JAX eval step's sums through
    summarize_eval_sums, under QM9's MSE loss, for one target and for a
    2-D y (mae_per_target); padded graph slots count nowhere."""
    rng = np.random.default_rng(9)
    shape = (lambda g: (g,)) if targets == 1 else (lambda g: (g, targets))
    batches = []
    for g, real in ((5, 4), (5, 2)):
        pred = rng.normal(size=(g, targets)).astype(np.float32)
        y = rng.normal(size=shape(g)).astype(np.float32)
        mask = np.arange(g) < real
        batches.append((pred, y, mask))

    class Fixed(torch.nn.Module):
        def forward(self, batch, train=False):
            return batch.pred

    class JFixed:
        def apply(self, variables, batch, train=False):
            return batch.pred
    tbs, jsums = [], {}
    jstep = eval_step_body(JFixed(), "mse", metric=metric)
    state = types.SimpleNamespace(params={}, batch_stats=None)
    for pred, y, mask in batches:
        tbs.append(types.SimpleNamespace(
            pred=torch.from_numpy(pred), y=torch.from_numpy(y),
            graph_mask=torch.from_numpy(mask)))
        m = jstep(state, types.SimpleNamespace(
            pred=jnp.asarray(pred), y=jnp.asarray(y),
            graph_mask=jnp.asarray(mask)))
        for k, v in m.items():
            jsums.setdefault(k, []).append(np.asarray(v, np.float64))
    want = summarize_eval_sums({k: np.sum(v, axis=0)
                                for k, v in jsums.items()})
    got = evaluate(Fixed(), tbs, "mse", metric)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert got["count"] == 6.0
    assert ("mae" in got) == (metric == "mae")
    assert ("mae_per_target" in got) == (targets > 1)


# ---- train_qm9 end to end ----

TINY = ["--K", "2", "--num_layer", "2", "--hidden_size", "16",
        "--num_epochs", "2", "--batch_size", "8", "--virtual_node",
        "--use_rd"]


def final_line(save_dir):
    (run,) = os.listdir(os.path.join(save_dir, "train"))
    with open(os.path.join(save_dir, "train", run, "log.txt")) as f:
        lines = [ln for ln in f if "QM9 target" in ln]
    assert len(lines) == 1
    return lines[0]


@pytest.mark.parametrize("convert,backend", [
    ("pre", ["--backend", "coo"]), ("post", ["--backend", "pallas"]),
    ("post", ["--backend", "dense"]), ("post", ["--dense"])])
def test_train_qm9_main_on_cpu(tmp_path, convert, backend):
    from kpgnn_tpu_torch.scripts import train_qm9

    write_qm9_fixture(tmp_path, 40)
    rows = []
    save = str(tmp_path / "s")
    mae = train_qm9.main(["--device", "cpu", "--dataset_dir", str(tmp_path),
                          "--save_dir", save, "--convert", convert,
                          "--task", "1"] + backend + TINY,
                         epoch_callback=lambda e, m, row: rows.append(row))
    assert math.isfinite(mae) and mae > 0
    # 40 molecules: 32 train in 4 batches, 4 val, 4 test
    assert len(rows) == 2 and all(len(r["step_losses"]) == 4 for r in rows)
    assert all(np.isfinite(r["step_losses"]).all()
               and math.isfinite(r["val_mae"]) for r in rows)
    # min mode gates on the validation loss: the test metrics come from
    # epochs whose val_loss is the lowest so far
    best = math.inf
    for r in rows:
        assert ("test_mae" in r) == (r["val_loss"] < best)
        best = min(best, r["val_loss"])
    nums = [float(v) for v in re.findall(r"[-\d.]+(?=,|$)",
                                         final_line(save).strip())]
    mae_log, norm, conv = nums
    assert math.isclose(mae_log, mae, rel_tol=1e-4, abs_tol=1e-5)
    if convert == "pre":
        assert conv == 0.0
    else:
        assert math.isclose(conv, mae / tmol.QM9_CONVERSION[1],
                            rel_tol=1e-3, abs_tol=1e-5)


def test_train_qm9_main_from_raw_sdf(tmp_path):
    """No qm9_v3.pt: the raw gdb9 artifacts through the SDF parser."""
    from kpgnn_tpu_torch.scripts import train_qm9

    _write_qm9_raw_fixture(tmp_path)
    raw = tmp_path / "QM9" / "raw"
    # more molecules than the parser fixture's two: repeat its records
    recs = (raw / "gdb9.sdf").read_text().split("$$$$\n")[:2] * 10
    (raw / "gdb9.sdf").write_text("$$$$\n".join(recs) + "$$$$\n")
    rows = (raw / "gdb9.sdf.csv").read_text().splitlines()
    (raw / "gdb9.sdf.csv").write_text("\n".join(
        rows[:1] + [rows[1 + i % 2] for i in range(20)]) + "\n")
    (raw / "uncharacterized.txt").unlink()
    mae = train_qm9.main(["--device", "cpu", "--dataset_dir", str(tmp_path),
                          "--save_dir", str(tmp_path / "s"), "--task", "3",
                          "--batch_size", "4"] + TINY[:-4])
    assert math.isfinite(mae)


def test_task_splits_follow_the_jax_script():
    """The seeded 10/10/80 split and the float64 train-set mean and std of
    kpgnn_tpu/scripts/train_qm9.py, under --convert pre and post."""
    from kpgnn_tpu_torch.graph.data import Graph
    from kpgnn_tpu_torch.scripts import train_qm9

    rng = np.random.default_rng(4)
    graphs = [Graph(num_nodes=1, edge_index=np.zeros((2, 0), np.int64),
                    edge_attr=np.zeros((0, 1), np.int64),
                    y=rng.normal(size=19).astype(np.float32))
              for _ in range(53)]
    for convert in ("pre", "post"):
        args = train_qm9.parser().parse_args(
            ["--task", "4", "--seed", "11", "--convert", convert])
        (tr, va, te), std = train_qm9.task_splits(graphs, args)
        # the JAX script, line by line
        gs = graphs
        if convert == "pre":
            gs = [g.replace(y=np.asarray(
                g.y / np.float32(jmol.QM9_CONVERSION[4]), np.float32))
                for g in graphs]
        order = np.random.default_rng(11).permutation(53)
        val_idx, test_idx, train_idx = order[:5], order[5:10], order[10:]
        ys = np.array([float(np.asarray(gs[i].y).reshape(-1)[4])
                       for i in train_idx])
        mean, want_std = ys.mean(), ys.std()
        assert std == want_std
        for ours, idx in ((tr, train_idx), (va, val_idx), (te, test_idx)):
            want = [np.array([(float(np.asarray(gs[i].y).reshape(-1)[4])
                               - mean) / want_std], np.float32)
                    for i in idx]
            assert len(ours) == len(want)
            for g, w in zip(ours, want):
                np.testing.assert_array_equal(g.y, w)
