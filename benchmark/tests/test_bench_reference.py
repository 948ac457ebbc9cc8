"""The plain reference against the port on the CPU at a tiny size: the
k-hop prep array for array, one forward in train and in eval mode, and
a whole tiny training run's first steps (gradient and Adam's update)."""
import numpy as np
import pytest
import torch

from benchmark import drive, molecules
from benchmark.reference import common as ref_common
from benchmark.reference import for_model
from benchmark.reference import prep as ref_prep
from benchmark.weights import make_weights

from . import tiny


@pytest.mark.parametrize("name", ["zinc_train_coo", "qm9_train_coo"])
def test_prep_matches_port(name):
    from kpgnn_tpu_torch.prep.khop import extract_khop
    _, cfg, _, _, _ = tiny.cell(name)
    m = dict(cfg["model"], K=8)
    mols = molecules.generate(cfg["data"]["generator"], 25, tiny.SEED)
    kc, rc = drive.khop_config(m), drive.ref_prep_config(m)
    for mol in mols:
        g = extract_khop(mol["num_nodes"], mol["edge_index"],
                         mol["edge_attr"], kc)
        p = ref_prep.prep(mol, rc)
        for k in range(m["K"]):
            live = g.edge_attr[:, k] > 0
            a = sorted(zip(g.edge_index[0][live].tolist(),
                           g.edge_index[1][live].tolist(),
                           g.edge_attr[live, k].tolist()))
            assert a == sorted(zip(*(r.tolist() for r in p.hops[k])))
        assert np.array_equal(g.pe_attr, p.pe)
        assert np.array_equal(g.peripheral_edge_attr, p.per_edge)
        assert np.array_equal(g.peripheral_config_attr, p.per_config)
        if rc.use_rd:
            np.testing.assert_allclose(g.rd[:, 0], p.rd, rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("name", ["zinc_train_coo", "qm9_train_coo"])
@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_port(name, train):
    from kpgnn_tpu_torch.graph.batch import collate
    from kpgnn_tpu_torch.prep.runner import preprocess_graphs
    _, cfg, _, _, _ = tiny.cell(name)
    m = cfg["model"]
    ref_model = for_model(m["model_name"])
    mols = molecules.generate(cfg["data"]["generator"], 12, tiny.SEED)
    P = make_weights(ref_model.param_spec(m), tiny.SEED, "cpu")
    model = drive.program_model(m, "cpu")
    model.load_state_dict(P, strict=True)
    batch = collate(preprocess_graphs(mols, drive.khop_config(m)))
    with torch.no_grad():
        got = model(batch, train=train)[:len(mols)]
        ref = ref_model.forward(P, ref_common.make_batch(
            mols, [ref_prep.prep(x, drive.ref_prep_config(m))
                   for x in mols], "cpu"), m, train=train)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("name", ["zinc_train_coo", "qm9_train_coo"])
def test_training_steps_match_port(name):
    c, cfg, tr, lims, _ = tiny.cell(name)
    res = drive.run(cfg, tr, tiny.SEED, 0.5, False, "cpu", 0.0,
                    log=lambda s: None)
    assert res.numbers["loss_gap"] < 1e-5
    assert res.numbers["grad_gap"] < 1e-4
    assert res.numbers["update_gap"] < 1e-2
    assert res.record.steps >= 1 and res.record.graphs >= 16


@pytest.mark.parametrize("flag,value", [("task", "graph_classification"),
                                        ("kernel", "gd"),
                                        ("combine", "geometric"),
                                        ("drop_prob", 0.1)])
def test_reference_refuses_what_it_does_not_cover(flag, value):
    _, cfg, _, _, _ = tiny.cell("zinc_train_coo")
    m = dict(cfg["model"], **{flag: value})
    with pytest.raises(NotImplementedError):
        for_model(m["model_name"]).param_spec(m)


def test_reference_adam_refuses_weight_decay():
    _, cfg, _, _, _ = tiny.cell("zinc_train_coo")
    m = cfg["model"]
    with pytest.raises(NotImplementedError):
        ref_common.adam_steps(for_model(m["model_name"]), {}, [], m,
                              dict(cfg["train"], l2_wd=0.01))
