"""The port's KPGINPlus model and trainer against the JAX package.

* the kpginplus golden bundle, module by module, with its stored weights;
* a live small flagship-shaped model (attention combine, JK concat,
  residual, virtual node) with carried weights: forward, masked L1 loss,
  every gradient, and the losses of 3 Adam steps (dropout 0);
* ``train_zinc.main`` end to end on a tiny ZINC fixture, on the CPU.

Tolerances (f32): activations atol 1e-5 / rtol 1e-4, losses rtol 1e-4,
grads rtol 1e-4 with an atol of 1e-4 of the gradient scale — the two
sides sum in different orders, and pre-BN biases have exact gradient 0.
"""
import importlib.util
import json
import math
import os
import pickle

import jax
import numpy as np
import pytest
import torch

import kpgnn_tpu.graph.batch as jbatch
import kpgnn_tpu.models as jmodels
from kpgnn_tpu.train.loop import _masked_loss as jmasked_loss
from kpgnn_tpu.train.loop import train_step_body
from kpgnn_tpu.train.state import create_train_state
from kpgnn_tpu_torch.graph import batch as tbatch
from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.prep.khop import KHopConfig, extract_khop
from kpgnn_tpu_torch.train.loop import _masked_loss, train_step
from kpgnn_tpu_torch.train.state import make_optimizer
from kpgnn_tpu_torch.utils.convert import params_from_flax
from tests.test_torch_layers import flat
from tests.test_torch_prep_batch import both_prep, raw_molecules

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "kpgnn_tpu", "data", "parity_golden",
                      "kpginplus.npz")
ACT = dict(atol=1e-5, rtol=1e-4)


def golden_model_and_batch():
    g = np.load(GOLDEN)
    a = json.loads(bytes(g["meta"]).decode())
    kcfg = KHopConfig(K=a["K"], kernel=a["kernel"],
                      max_edge_attr_num=a["max_edge_attr_num"],
                      max_hop_num=a["max_hop_num"],
                      max_edge_type=a["max_edge_type"],
                      max_edge_count=a["max_edge_count"],
                      max_distance_count=a["max_distance_count"],
                      use_rd=a["use_rd"])
    n = int(g["raw/n"][0])
    gr = extract_khop(n, g["raw/edge_index"], g["raw/edge_attr"], kcfg,
                      x=g["raw/x"], y=np.array([0]))
    # the bundle's own layout: n_pad = n + 1, one graph + the pad slot
    batch = tbatch.collate_pallas([gr], v1=a["num_hop1_edge"] + 2,
                                  vk=a["max_pe_num"] + 2, n_pad=n + 1,
                                  e_pad=gr.num_edges + 8, g_pad=2)
    mcfg = ModelConfig(
        model_name=a["model_name"], hidden_size=a["hidden_size"],
        num_layer=a["num_layer"], K=a["K"], kernel=a["kernel"],
        num_hop1_edge=a["num_hop1_edge"], max_pe_num=a["max_pe_num"],
        max_edge_type=a["max_edge_type"],
        max_edge_count=a["max_edge_count"], max_hop_num=a["max_hop_num"],
        max_distance_count=a["max_distance_count"], JK=a["JK"],
        combine=a["combine"], residual=a["residual"], aggr=a["aggr"],
        virtual_node=a["virtual_node"], use_rd=a["use_rd"],
        input_encoder=("embedding", a["input_size"]),
        task="graph_classification", output_size=a["output_size"],
        pooling_method=a["pooling_method"], norm_type=a["norm_type"])
    model = make_model(mcfg)
    model.load_state_dict(params_from_flax({k: g[k] for k in g.files}),
                          strict=True)
    return g, model, batch


def test_golden_kpginplus_module_by_module():
    g, model, batch = golden_model_and_batch()
    acts = {}
    for name, mod in model.named_modules():
        mod.register_forward_hook(
            lambda m, i, o, name=name: acts.__setitem__(
                name.replace(".", "/"), o))
    with torch.no_grad():
        out = model(batch, train=False)
    np.testing.assert_allclose(out.numpy()[:1], g["act/__output__"], **ACT)
    compared = 0
    for key in g.files:
        name = key[len("act/"):-len("/__call__")]
        if not (key.startswith("act/") and key.endswith("/__call__")):
            continue
        ours = acts.get(name)
        if not torch.is_tensor(ours):
            continue        # flax-only intermediates (folded encoders)
        ours = ours.numpy()
        if name.endswith("attention_lstm"):
            ours = ours.transpose(1, 0, 2)      # captured node-major there
        np.testing.assert_allclose(ours, g[key], err_msg=name, **ACT)
        compared += 1
    # every layer, norm, vn MLP, peripheral and readout module was seen
    assert compared >= 40, compared


FLAGSHIP_SMALL = dict(model_name="KPGINPlus", hidden_size=24, num_layer=4,
                      K=3, num_hop1_edge=3, max_pe_num=9, max_edge_type=3,
                      max_edge_count=10, max_hop_num=3, max_distance_count=10,
                      JK="concat", combine="attention", residual=True,
                      virtual_node=True, drop_prob=0.0,
                      input_encoder=("embedding", 21),
                      task="graph_regression", pooling_method="sum")
PREP_SMALL = dict(K=3, kernel="spd", max_edge_attr_num=9, max_hop_num=3,
                  max_edge_type=3, max_edge_count=10, max_distance_count=10)


def live_setup(n_batches=3, per_batch=4):
    js, ts = both_prep(raw_molecules(n_batches * per_batch, seed=11),
                       **PREP_SMALL)
    pads = dict(n_pad=256, e_pad=4096, g_pad=per_batch + 1)
    jbs, tbs = [], []
    for i in range(n_batches):
        sl = slice(i * per_batch, (i + 1) * per_batch)
        jbs.append(jbatch.collate(js[sl], **pads))
        tbs.append(tbatch.collate_pallas(ts[sl], v1=5, vk=11, **pads))
    jmodel = jmodels.make_model(jmodels.ModelConfig(**FLAGSHIP_SMALL))
    tmodel = make_model(ModelConfig(**FLAGSHIP_SMALL))
    return jmodel, tmodel, jbs, tbs


def test_live_flagship_small_forward_loss_and_grads():
    jmodel, tmodel, jbs, tbs = live_setup(n_batches=1)
    jb, tb = jbs[0], tbs[0]
    v = jmodel.init(jax.random.PRNGKey(0), jb, train=False)
    tmodel.load_state_dict(params_from_flax(flat(v)), strict=True)

    def jloss(params):
        pred, upd = jmodel.apply({"params": params,
                                  "batch_stats": v["batch_stats"]}, jb,
                                 train=True, mutable=["batch_stats"])
        lsum, cnt = jmasked_loss(pred, jb.y, jb.graph_mask, "l1")
        return lsum / cnt, (pred, upd)

    (jl, (jpred, upd)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(v["params"])
    tpred = tmodel(tb, train=True)
    lsum, cnt = _masked_loss(tpred, tb.y, tb.graph_mask, "l1")
    tl = lsum / cnt
    np.testing.assert_allclose(tpred.detach().numpy(), np.asarray(jpred),
                               **ACT)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    tl.backward()
    jg = params_from_flax(flat({"params": jg}))
    gscale = max(float(g.abs().max()) for g in jg.values())
    names = [n for n, _ in tmodel.named_parameters()]
    assert sorted(names) == sorted(jg)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[name].numpy(),
                                   rtol=1e-4, atol=1e-4 * gscale,
                                   err_msg=name)
    stats = params_from_flax(flat({"batch_stats": upd["batch_stats"]}))
    for name, b in tmodel.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(), **ACT,
                                   err_msg=name)


def test_live_flagship_small_three_adam_steps():
    jmodel, tmodel, jbs, tbs = live_setup(n_batches=3)
    state, tx = create_train_state(jmodel, jbs[0], jax.random.PRNGKey(0),
                                   lr=1e-3)
    tmodel.load_state_dict(params_from_flax(flat(state.variables)),
                           strict=True)
    opt = make_optimizer(tmodel.parameters(), lr=1e-3)
    jstep = jax.jit(train_step_body(jmodel, tx, "l1"))
    rng = jax.random.PRNGKey(1)
    jl, tl = [], []
    for jb, tb in zip(jbs, tbs):
        state, m = jstep(state, jb, rng)
        jl.append(float(m["loss_sum"]) / float(m["count"]))
        lsum, cnt = train_step(tmodel, opt, tb, "l1")
        tl.append(float(lsum) / float(cnt))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    # the steps moved the weights: the three losses differ
    assert len(set(np.round(jl, 6))) == 3


def write_zinc_fixture(root, counts, seed=11):
    """A ZINC-format raw bundle from tools/make_zinc_fixture.py's
    molecule generator (numpy + torch only), at the given split sizes."""
    path = os.path.join(REPO, "tools", "make_zinc_fixture.py")
    spec = importlib.util.spec_from_file_location("make_zinc_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rng = np.random.default_rng(seed)
    raw = os.path.join(root, "ZINC", "raw")
    os.makedirs(raw, exist_ok=True)
    for split, c in zip(("train", "val", "test"), counts):
        with open(os.path.join(raw, f"{split}.pickle"), "wb") as f:
            pickle.dump([mod.make_mol(rng) for _ in range(c)], f)
        with open(os.path.join(raw, f"{split}.index"), "w") as f:
            f.write(",".join(str(i) for i in range(c)) + ",")


@pytest.mark.parametrize("subset", [True, False])
def test_load_zinc_matches_jax(tmp_path, subset):
    from kpgnn_tpu.data.molecules import load_zinc as jload_zinc
    from kpgnn_tpu_torch.data.molecules import load_zinc

    write_zinc_fixture(str(tmp_path), (6, 3, 3))
    root = os.path.join(str(tmp_path), "ZINC")
    js, ts = jload_zinc(root, subset=subset), load_zinc(root, subset=subset)
    assert js.keys() == ts.keys()
    for split in js:
        assert len(js[split]) == len(ts[split])
        for a, b in zip(js[split], ts[split]):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
                assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, k


TINY_ARGS = ["--K", "2", "--num_layer", "2", "--hidden_size", "16",
             "--batch_size", "8", "--num_epochs", "1", "--runs", "1",
             "--combine", "attention", "--residual", "--virtual_node",
             "--max_hop_num", "2"]


def test_train_zinc_main_on_cpu(tmp_path):
    from kpgnn_tpu_torch.scripts import train_zinc

    write_zinc_fixture(str(tmp_path), (24, 8, 8))
    rows = []
    mae = train_zinc.main(
        ["--dataset_dir", str(tmp_path), "--save_dir", str(tmp_path / "s"),
         "--backend", "pallas", "--device", "cpu"] + TINY_ARGS,
        epoch_callback=lambda e, m, row: rows.append(row))
    assert math.isfinite(mae)
    assert len(rows) == 1 and len(rows[0]["step_losses"]) == 3
    assert np.isfinite(rows[0]["step_losses"]).all()


def test_train_zinc_main_on_the_coo_backend(tmp_path):
    from kpgnn_tpu_torch.scripts import train_zinc

    write_zinc_fixture(str(tmp_path), (24, 8, 8))
    rows = []
    mae = train_zinc.main(
        ["--dataset_dir", str(tmp_path), "--save_dir", str(tmp_path / "s"),
         "--backend", "coo", "--device", "cpu"] + TINY_ARGS,
        epoch_callback=lambda e, m, row: rows.append(row))
    assert math.isfinite(mae)
    assert len(rows) == 1 and len(rows[0]["step_losses"]) == 3
    assert np.isfinite(rows[0]["step_losses"]).all()


@pytest.mark.parametrize("flag", [["--backend", "banded"], ["--dense"],
                                  ["--bf16"], ["--parallel"]])
def test_train_zinc_refuses_unported_options(tmp_path, flag):
    from kpgnn_tpu_torch.scripts import train_zinc

    base = ["--dataset_dir", str(tmp_path), "--save_dir",
            str(tmp_path / "s"), "--device", "cpu", "--backend", "pallas"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_zinc.main(base + flag + TINY_ARGS)


def test_init_parameters_depends_only_on_the_seed():
    from kpgnn_tpu_torch.nn.inits import init_parameters

    cfg = ModelConfig(**FLAGSHIP_SMALL)
    torch.manual_seed(1)
    a = init_parameters(make_model(cfg), 5).state_dict()
    torch.manual_seed(2)
    b = init_parameters(make_model(cfg), 5).state_dict()
    c = init_parameters(make_model(cfg), 6).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # every randomly initialized tensor moves with the seed
    moved = [k for k in a if not torch.equal(a[k], c[k])]
    fixed = {k for k in a if k not in moved}
    assert all(k.endswith(("running_mean", "running_var", "bn0.weight",
                           "bn0.bias", "bn1.weight", "bn1.bias"))
               or "norm" in k or k.endswith("virtualnode_embedding")
               for k in fixed), sorted(fixed)
