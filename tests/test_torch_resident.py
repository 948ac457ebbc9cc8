"""Resident epochs on the port (``train/resident.py``) against the JAX
package's stores and against the port's own per-batch path: a batch
gathered from a store equals the collated batch (dense: field for field;
COO: the same masked losses on its slot layout), the stores and the
epoch index chunks equal the JAX package's, the resident ``Trainer``'s
history equals the per-batch one's, each branch of the ``auto`` rule,
and ``train_tu``'s resident fold against its per-batch fold."""
import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import kpgnn_tpu.train.resident as jres
from chip_smoke import write_gin_fixture
from kpgnn_tpu.data import synthetic as jsyn
from kpgnn_tpu.prep.khop import KHopConfig as JKHopConfig
from kpgnn_tpu_torch.data import synthetic as tsyn
from kpgnn_tpu_torch.graph.batch import collate, collate_dense
from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.nn.inits import init_parameters
from kpgnn_tpu_torch.prep.khop import KHopConfig
from kpgnn_tpu_torch.scripts import train_tu
from kpgnn_tpu_torch.train import resident as tres
from kpgnn_tpu_torch.train.config import TrainConfig
from kpgnn_tpu_torch.train.loader import GraphLoader
from kpgnn_tpu_torch.train.loop import Trainer, eval_step, resident_rule
from tests.test_torch_model import FLAGSHIP_SMALL, PREP_SMALL
from tests.test_torch_prep_batch import both_prep, raw_molecules

torch.set_num_threads(1)
V1, VK = 5, 11          # num_hop1_edge + 2, max_pe_num + 2 of FLAGSHIP_SMALL
N_SLOT = 40
MODEL = dict(FLAGSHIP_SMALL, hidden_size=12, num_layer=3)


@pytest.fixture(scope="module")
def prepped():
    """(JAX graphs, port graphs) of the same 22 molecules."""
    return both_prep(raw_molecules(22, seed=5), **PREP_SMALL)


def assert_same(a, b, what):
    """Tensors (or nested batch/adjacency records) equal exactly."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{what}.{f.name}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    else:
        assert a == b, what


@pytest.mark.parametrize("idx", [[3, 0, 7, 12], [5, 9, 1]])
def test_dense_gather_equals_collate_dense(prepped, idx):
    """The full batch and the padded partial one (3 graphs in 4 slots:
    the pad slots are the store's empty graph)."""
    _, ts = prepped
    store = tres.build_dense_store(ts, N_SLOT, V1, VK)
    chunks = tres.epoch_index_chunks(np.array(idx), 4, store.num_graphs)
    assert chunks.shape == (1, 4)
    got = tres.gather_batch(store, torch.as_tensor(chunks[0]).long())
    want = collate_dense([ts[i] for i in idx], N_SLOT, V1, VK, g_pad=4)
    # the gathered batch gives padding nodes their slot's id (JAX's
    # repeat(arange(B), n)); collate_dense gives them graph 0, and no
    # masked norm or pool reads a padding node's id
    ids = torch.arange(4).repeat_interleave(N_SLOT)
    assert torch.equal(got.node_graph_ids, ids)
    live = want.node_mask
    assert torch.equal(got.node_graph_ids[live], want.node_graph_ids[live])
    assert_same(got.replace(node_graph_ids=None),
                want.replace(node_graph_ids=None), "batch")
    assert got.graph_mask.tolist() == [True] * len(idx) + [False] * (
        4 - len(idx))


@pytest.mark.parametrize("idx", [[3, 0, 7, 12, 21], [5, 9]])
def test_coo_gather_gives_the_collated_losses(prepped, idx):
    """The COO store's slot layout against collate's compact packing of
    the same graphs (the second a padded partial batch): the same masked
    loss sum, count and predictions of the real graphs."""
    _, ts = prepped
    store = tres.build_coo_store(ts)
    B = 5
    chunks = tres.epoch_index_chunks(np.array(idx), B, store.num_graphs)
    gathered = tres.gather_coo_batch(store, torch.as_tensor(chunks[0]).long())
    compact = collate([ts[i] for i in idx], g_pad=B + 1)
    model = init_parameters(make_model(ModelConfig(**MODEL)), 2).eval()
    a = eval_step(model, gathered, "l1")
    b = eval_step(model, compact, "l1")
    assert float(a["count"]) == float(b["count"]) == len(idx)
    np.testing.assert_allclose(float(a["loss_sum"]), float(b["loss_sum"]),
                               rtol=1e-5)
    with torch.no_grad():
        pa = model(gathered, train=False)[:len(idx)]
        pb = model(compact, train=False)[:len(idx)]
    np.testing.assert_allclose(pa.numpy(), pb.numpy(), rtol=1e-5,
                               atol=1e-5)


def assert_store_equals_jax(ours, theirs):
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        assert (a is None) == (b is None), f.name
        if isinstance(a, torch.Tensor):
            b = np.asarray(b)
            # the JAX store holds JAX's 32-bit canonical dtypes
            assert jnp.asarray(a.numpy()).dtype == b.dtype, f.name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)
        elif a is not None:
            assert a == b, f.name


@pytest.mark.parametrize("node_level", [False, True])
def test_stores_equal_jax(node_level):
    """Dense and COO stores of the same graphs, graph- and node-level y,
    array for array."""
    cfg = dict(K=3, kernel="spd", max_edge_attr_num=5, max_hop_num=2,
               max_edge_type=2, max_edge_count=5, max_distance_count=5)
    ts = tsyn.synthetic_molecules(9, KHopConfig(**cfg), seed=4,
                                  node_level_y=node_level)
    js = jsyn.synthetic_molecules(9, JKHopConfig(**cfg), seed=4,
                                  node_level_y=node_level)
    assert_store_equals_jax(
        tres.build_dense_store(ts, N_SLOT, 4, 7, node_level),
        jres.build_dense_store(js, N_SLOT, 4, 7, node_level))
    assert_store_equals_jax(
        tres.build_coo_store(ts, y_is_node_level=node_level),
        jres.build_coo_store(js, y_is_node_level=node_level))
    # the port counts its stores' bytes exactly
    for store, nbytes in (
            (tres.build_dense_store(ts, N_SLOT, 4, 7, node_level),
             tres.store_nbytes(ts, N_SLOT, node_level)),
            (tres.build_coo_store(ts, y_is_node_level=node_level),
             tres.coo_store_nbytes(ts, max(g.num_nodes for g in ts),
                                   max(g.num_edges for g in ts),
                                   node_level))):
        assert store.nbytes() == nbytes


@pytest.mark.parametrize("n,B", [(22, 8), (16, 8), (3, 5), (0, 4)])
def test_epoch_index_chunks_equal_jax(n, B):
    order = np.random.default_rng(n).permutation(n)
    got = tres.epoch_index_chunks(order, B, 99)
    want = jres.epoch_index_chunks(order, B, 99)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def fit(graphs, mode, resident, epochs=2, **kw):
    lk = dict(mode=mode, v1=V1, vk=VK) if mode == "dense" else dict(mode=mode)
    tl = GraphLoader(graphs, 8, shuffle=True, seed=3, **lk)
    vl = GraphLoader(graphs[:10], 8, **lk)
    el = GraphLoader(graphs[10:], 8, **lk)
    cfg = TrainConfig(lr=1e-3, num_epochs=epochs, batch_size=8, patience=50)
    tr = Trainer(make_model(ModelConfig(**MODEL)), cfg, loss="l1",
                 device="cpu", resident=resident, **kw)
    return tr.fit(tl, vl, el, seed=1)       # (model, results)


@pytest.mark.parametrize("mode,rtol,val_rtol", [("dense", 1e-6, 1e-6),
                                               ("coo", 1e-4, 5e-3)])
def test_resident_trainer_history_equals_per_batch(prepped, mode, rtol,
                                                   val_rtol):
    """Shuffled epochs in the loader's order, resident on against off:
    every step loss, the epoch loss (loss sum over count) and the
    evaluations.  Dense gathers exactly collate_dense's batch.  COO's
    slot layout sums in another order.  The weights that part are the
    biases ahead of each MLP's batch norms (``lin0.bias``, ``lin1.bias``):
    the train step's batch statistics cancel them, so their gradient is
    0 in exact arithmetic and rounding alone picks its sign, and Adam
    moves them by about lr either way (after these 6 steps the 9 leaves
    furthest apart, up to 8.1e-3).  The train losses stay within 1e-4;
    the evaluation, through the running statistics, sees those biases
    (1.4e-3 apart here)."""
    _, ts = prepped
    (m_on, r_on), (m_off, r_off) = fit(ts, mode, "on"), fit(ts, mode, "off")
    on, off = r_on["history"], r_off["history"]
    assert len(on) == len(off) == 2
    for a, b in zip(on, off):
        assert len(a["step_losses"]) == len(b["step_losses"]) == 3
        np.testing.assert_allclose(a["step_losses"], b["step_losses"],
                                   rtol=rtol)
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=rtol)
        np.testing.assert_allclose(a["val_loss"], b["val_loss"],
                                   rtol=val_rtol)
    if mode == "coo":
        p_off = dict(m_off.named_parameters())
        apart = sorted(((float((p - p_off[n]).detach().abs().max()), n)
                        for n, p in m_on.named_parameters()), reverse=True)
        assert all(n.endswith(("lin0.bias", "lin1.bias"))
                   for _, n in apart[:9]), apart[:10]


class Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def decision(graphs, mode, monkeypatch, cap=None):
    """The Trainer's logged decision under --resident auto."""
    if cap is not None:
        monkeypatch.setenv("KPGNN_RESIDENT_MAX_BYTES", str(cap))
    log = logging.getLogger("test_torch_resident")
    log.handlers[:] = [Capture()]
    log.setLevel(logging.INFO)
    fit(graphs, mode, "auto", epochs=1, logger=log)
    (line,) = [x for x in log.handlers[0].lines
               if x.startswith(("resident store:", "per-batch epochs"))]
    return line


def test_auto_takes_a_dense_store_that_fits(prepped, monkeypatch):
    _, ts = prepped
    assert decision(ts, "dense", monkeypatch).startswith("resident store:")


def test_auto_skips_a_store_over_the_cap(prepped, monkeypatch):
    _, ts = prepped
    nbytes = tres.store_nbytes(ts, GraphLoader(
        ts, 8, mode="dense", v1=V1, vk=VK).n_slot)
    line = decision(ts, "dense", monkeypatch, cap=nbytes - 1)
    assert line.startswith("per-batch epochs") and str(nbytes) in line
    monkeypatch.setenv("KPGNN_RESIDENT_MAX_BYTES", str(nbytes))
    assert resident_rule("auto", GraphLoader(ts, 8, mode="dense", v1=V1,
                                             vk=VK))[0]


def fill(graphs):
    """(node slot fill, edge slot fill) of a COO store of ``graphs``."""
    return tuple(sum(map(f, graphs)) / (len(graphs) * max(map(f, graphs)))
                 for f in (lambda g: g.num_nodes, lambda g: g.num_edges))


def test_auto_skips_coo_slots_less_than_half_full(prepped, monkeypatch):
    """The molecules fill their COO slots more than half and go
    resident; one 90-node molecule among them sets slots they fill less
    than half, and auto trains per batch."""
    _, ts = prepped
    big = both_prep(raw_molecules(1, seed=9, n_min=90, n_max=90),
                    **PREP_SMALL)[1]
    assert min(fill(ts)) >= 0.5 and min(fill(ts + big)) < 0.5
    assert decision(ts, "coo", monkeypatch).startswith("resident store:")
    line = decision(ts + big, "coo", monkeypatch)
    assert line.startswith("per-batch epochs") and "needs 0.5" in line
    loader = GraphLoader(ts + big, 8, mode="coo")
    assert resident_rule("on", loader)[0]
    assert not resident_rule("off", loader)[0]
    assert not resident_rule("on", GraphLoader(ts, 8, v1=V1, vk=VK))[0]


def test_train_tu_resident_fold_equals_per_batch_fold(tmp_path):
    """``--dense`` folds train resident (the JAX script's rule): the
    same step losses and test accuracies as ``--resident off``."""
    write_gin_fixture(str(tmp_path))
    runs = {}
    for resident in ("auto", "off"):
        rows = []
        acc = train_tu.main(
            ["--device", "cpu", "--K", "2", "--num_layer", "2",
             "--hidden_size", "16", "--num_epochs", "2", "--folds", "1",
             "--dense", "--drop_prob", "0", "--resident", resident,
             "--dataset_dir", str(tmp_path), "--save_dir",
             str(tmp_path / resident)],
            epoch_callback=lambda e, m, row: rows.append(row))
        (log,) = (tmp_path / resident / "train").glob("*/log.txt")
        runs[resident] = (acc, rows, "resident stores" in log.read_text())
    assert runs["auto"][2] and not runs["off"][2]
    assert runs["auto"][0] == runs["off"][0]
    for a, b in zip(runs["auto"][1], runs["off"][1]):
        assert len(a["step_losses"]) == len(b["step_losses"]) == 6
        np.testing.assert_allclose(a["step_losses"], b["step_losses"],
                                   rtol=1e-6)
        assert a["test_accuracy"] == b["test_accuracy"]
