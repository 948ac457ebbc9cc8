"""The port's banded resident store (``train/resident.py``) against the
JAX package's and against the port's own collated batches: the shared
shapes, the store's arrays, its device bytes (counted at the stored
dtype, where the JAX estimate counts the mask at 1 byte), a gathered
batch's per-graph predictions against the collated batch's (long chords
exercise the spill remap), a padded partial batch, hop slices through
GNNPlus, a resident epoch's step losses against the JAX resident epoch's
on carried weights, the resident ``Trainer`` against the per-batch one,
and ``resident_rule`` on banded loaders at the cap boundary.

Tolerances: stores array for array; f32 predictions and losses rtol 1e-5
(the same model on two layouts) or 1e-4 (against JAX)."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kpgnn_tpu.models as jmodels
import kpgnn_tpu.prep.khop as jkhop
import kpgnn_tpu.train.resident as jres
from kpgnn_tpu.train.loop import train_step_body
from kpgnn_tpu.train.state import create_train_state
from kpgnn_tpu_torch.graph.batch import collate_banded
from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.nn.inits import init_parameters
from kpgnn_tpu_torch.prep import khop as tkhop
from kpgnn_tpu_torch.train import resident as tres
from kpgnn_tpu_torch.train.config import TrainConfig
from kpgnn_tpu_torch.train.loader import GraphLoader
from kpgnn_tpu_torch.train.loop import (Trainer, eval_step, evaluate,
                                        resident_rule)
from kpgnn_tpu_torch.train.state import make_optimizer
from kpgnn_tpu_torch.utils.convert import params_from_flax
from tests.test_torch_layers import flat
from tests.test_torch_resident import Capture, assert_store_equals_jax

torch.set_num_threads(1)
MODEL = dict(model_name="KPGIN", hidden_size=12, num_layer=2, K=2,
             num_hop1_edge=1, max_pe_num=10, max_edge_type=1,
             max_edge_count=10, max_hop_num=2, max_distance_count=10,
             JK="last", combine="geometric", input_encoder=("embedding", 2),
             task="graph_regression", pooling_method="sum", output_size=1)
V1, VK = 3, 12          # num_hop1_edge + 2, max_pe_num + 2


def make_banded_dataset(n_graphs=6, seed=0, K=2):
    """(JAX graphs, port graphs): chains with short chords (banded under
    the node order); every other graph gets one long chord whose reach
    exceeds the halo cap, so the store's spill remap is exercised
    (tests/test_resident.py's dataset, prepped by both packages)."""
    rng = np.random.default_rng(seed)
    cfg = dict(K=K, kernel="spd", max_edge_attr_num=10, max_hop_num=2,
               max_edge_type=1, max_edge_count=10, max_distance_count=10)
    js, ts = [], []
    for i in range(n_graphs):
        n = int(rng.integers(540, 580))
        src = np.arange(n - 1)
        ch = rng.integers(0, n - 13, n // 4)
        s = np.concatenate([src, src + 1, ch])
        r = np.concatenate([src + 1, src, ch + rng.integers(2, 12, n // 4)])
        if i % 2 == 0:
            s = np.concatenate([s, [0]])
            r = np.concatenate([r, [n - 10]])     # reach > tile + halo
        ei = np.stack([s, r]).astype(np.int64)
        kw = dict(x=np.zeros((n, 1), np.int64),
                  y=np.array([s.shape[0] / n], np.float32))
        js.append(jkhop.extract_khop(n, ei, None, jkhop.KHopConfig(**cfg),
                                     **kw))
        ts.append(tkhop.extract_khop(n, ei, None, tkhop.KHopConfig(**cfg),
                                     **kw))
    return js, ts


@pytest.fixture(scope="module")
def dataset():
    return make_banded_dataset()


def test_plan_banded_store_shapes_equal_jax(dataset):
    js, ts = dataset
    for k in (1, 3, 6):
        got = tres.plan_banded_store_shapes(ts[:k])
        assert got == jres.plan_banded_store_shapes(js[:k]), k
    tile, halo, n_slot, spill = tres.plan_banded_store_shapes(ts)
    assert (tile, halo) == (256, 256) and n_slot % tile == 0 and spill > 0


@pytest.mark.parametrize("gcn_norm", [False, True])
def test_build_banded_store_equals_jax(dataset, gcn_norm):
    js, ts = dataset
    store = tres.build_banded_store(ts, V1, VK, gcn_norm=gcn_norm,
                                    device="cpu")
    assert_store_equals_jax(store, jres.build_banded_store(
        js, V1, VK, gcn_norm=gcn_norm))
    assert store.live.dtype == (torch.float32 if gcn_norm else torch.int8)
    # pinned shapes, as the Trainer plans them over every split
    shapes = tres.plan_banded_store_shapes(ts)
    assert_store_equals_jax(
        tres.build_banded_store(ts[:3], V1, VK, gcn_norm=gcn_norm,
                                shapes=shapes, device="cpu"),
        jres.build_banded_store(js[:3], V1, VK, gcn_norm=gcn_norm,
                                shapes=shapes))


@pytest.mark.parametrize("gcn_norm", [False, True])
def test_banded_store_nbytes_is_the_built_stores(dataset, gcn_norm):
    """The port counts the mask at the dtype it stores: 1 byte an entry,
    4 under gcn_norm.  The JAX estimate (kpgnn_tpu/train/resident.py:
    368-386) counts 1 byte either way, so it undercounts a KPGCN store
    by at least 3 bytes a mask entry: the port departs from it on
    purpose."""
    js, ts = dataset
    tile, halo, n_slot, spill = tres.plan_banded_store_shapes(ts)
    store = tres.build_banded_store(ts, V1, VK, gcn_norm=gcn_norm,
                                    device="cpu")
    ours = tres.banded_store_nbytes(ts, n_slot, tile, halo, spill, V1, VK,
                                    gcn_norm=gcn_norm)
    assert ours == store.nbytes()
    theirs = jres.banded_store_nbytes(js, n_slot, tile, halo, spill, V1, VK)
    entries = store.live.numel()
    if gcn_norm:
        assert ours - theirs >= 3 * entries
    else:
        assert abs(ours - theirs) < entries


def model_outputs(cfg, batch, n_graphs, seed=0):
    model = init_parameters(make_model(ModelConfig(**cfg)), seed).eval()
    with torch.no_grad():
        return model(batch, train=False)[:n_graphs]


@pytest.mark.parametrize("gcn_norm", [False, True])
def test_gather_gives_the_collated_predictions(dataset, gcn_norm):
    """The store's slot layout against collate_banded's packing of the
    same graphs (two with a spilling chord): every graph's prediction
    and the masked loss."""
    _, ts = dataset
    cfg = dict(MODEL, model_name="KPGCN") if gcn_norm else MODEL
    store = tres.build_banded_store(ts, V1, VK, gcn_norm=gcn_norm,
                                    device="cpu")
    assert store.spill_rows is not None
    idx = [0, 3, 2]
    got = tres.gather_banded_batch(store, torch.tensor(idx))
    # the batch's interleaved spill list is sorted by row once, on the
    # device, for the sorted spill sum
    rows = got.adj.spill_rows
    assert got.adj.spill_sorted and bool((rows[1:] >= rows[:-1]).all())
    assert got.adj.sender_scaled == gcn_norm
    want = collate_banded([ts[i] for i in idx], v1=V1, vk=VK, g_pad=3,
                          tile=store.tile, halo=store.halo,
                          gcn_norm=gcn_norm)
    np.testing.assert_allclose(model_outputs(cfg, got, 3).numpy(),
                               model_outputs(cfg, want, 3).numpy(),
                               rtol=1e-5, atol=1e-5)
    model = init_parameters(make_model(ModelConfig(**cfg)), 1).eval()
    a, b = eval_step(model, got, "l1"), eval_step(model, want, "l1")
    assert float(a["count"]) == float(b["count"]) == 3
    np.testing.assert_allclose(float(a["loss_sum"]), float(b["loss_sum"]),
                               rtol=1e-5)


def test_gather_pads_a_partial_batch(dataset):
    _, ts = dataset
    store = tres.build_banded_store(ts, V1, VK, device="cpu")
    chunks = tres.epoch_index_chunks(np.array([1, 4]), 4, store.num_graphs)
    got = tres.gather_banded_batch(store, torch.as_tensor(chunks[0]).long())
    assert got.graph_mask.tolist() == [True] * 2 + [False] * 2
    nm = got.node_mask.reshape(4, -1)
    assert not nm[2:].any()
    # the pad slots' plans are empty and their spill rows all drop
    n, K = store.n_slot, store.n_hops
    live = got.adj.live.reshape(K, 4, -1)
    assert not live[:, 2:].any()
    rows = got.adj.spill_rows.reshape(4, -1)
    assert (rows[2:] >= K * 4 * n).all()
    out = model_outputs(MODEL, got, 4)
    assert torch.isfinite(out).all()


def test_gather_slice_hops_through_gnnplus(dataset):
    """GNNPlus slices the gathered plan per layer (k = min(l + 1, K)); the
    remapped spill rows of hops >= k lie past k·B·n and drop."""
    _, ts = dataset
    cfg = dict(MODEL, model_name="KPGINPlus", num_layer=3,
               combine="attention")
    store = tres.build_banded_store(ts, V1, VK, device="cpu")
    idx = [0, 2]
    got = tres.gather_banded_batch(store, torch.tensor(idx))
    want = collate_banded([ts[i] for i in idx], v1=V1, vk=VK, g_pad=2,
                          tile=store.tile, halo=store.halo)
    np.testing.assert_allclose(model_outputs(cfg, got, 2).numpy(),
                               model_outputs(cfg, want, 2).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_resident_epoch_equals_jax_on_carried_weights(dataset):
    """One resident epoch (3 steps of 2 graphs, the last padded) on the
    port's store against the JAX package's: every step loss (the JAX
    scan's body on the same gathered batches) and the epoch's mean."""
    js, ts = dataset
    order = np.array([4, 1, 0, 5, 2])
    jstore = jres.build_banded_store(js, V1, VK)
    tstore = tres.build_banded_store(ts, V1, VK, device="cpu")
    chunks = tres.epoch_index_chunks(order, 2, tstore.num_graphs)
    jmodel = jmodels.make_model(jmodels.ModelConfig(**MODEL))
    state, tx = create_train_state(
        jmodel, jres.gather_banded_batch(jstore, jnp.asarray(chunks[0])),
        jax.random.PRNGKey(0), lr=5e-3)
    tmodel = make_model(ModelConfig(**MODEL))
    tmodel.load_state_dict(params_from_flax(flat(state.variables)),
                           strict=True)
    body = jax.jit(train_step_body(jmodel, tx, "l1"))
    st, jl = state, []
    for row in chunks:
        st, m = body(st, jres.gather_banded_batch(jstore, jnp.asarray(row)),
                     jax.random.PRNGKey(1))
        jl.append(float(m["loss_sum"]) / float(m["count"]))
    _, jsum, jcnt = jres.make_resident_train_epoch(
        jmodel, tx, "l1", donate=False)(state, jstore, jnp.asarray(chunks),
                                        jax.random.PRNGKey(1))
    epoch = tres.make_resident_train_epoch(
        tmodel, make_optimizer(tmodel.parameters(), 5e-3), "l1")
    mean, steps = epoch(tstore, chunks)
    np.testing.assert_allclose(steps, jl, rtol=1e-4)
    np.testing.assert_allclose(mean, float(jsum) / float(jcnt), rtol=1e-4)


def fit(ts, resident, epochs, bn_train_mode_eval=False, logger=None,
        model=MODEL):
    mk = lambda sh: GraphLoader(ts, batch_size=2, shuffle=sh, seed=0,   # noqa
                                mode="banded", v1=V1, vk=VK)
    cfg = TrainConfig(lr=5e-3, num_epochs=epochs, batch_size=2, patience=50)
    tr = Trainer(make_model(ModelConfig(**model)), cfg, loss="l1",
                 device="cpu", resident=resident, logger=logger,
                 bn_train_mode_eval=bn_train_mode_eval)
    return tr.fit(mk(True), mk(False), mk(False), seed=1)[1]


def test_resident_trainer_learns(dataset):
    """The resident Trainer on banded loaders: it logs the store, and
    the best validation loss falls below the first."""
    _, ts = dataset
    log = logging.getLogger("test_torch_resident_banded")
    log.handlers[:] = [Capture()]
    log.setLevel(logging.INFO)
    res = fit(ts, "on", 8, logger=log)
    assert any(x.startswith("resident store:") and "banded slots" in x
               for x in log.handlers[0].lines)
    first = res["history"][0]["val_loss"]
    assert np.isfinite(res["best_val"]) and res["best_val"] < first


@pytest.mark.parametrize("bn_train_mode_eval", [False, True])
def test_resident_trainer_equals_per_batch(dataset, bn_train_mode_eval):
    """Resident on against off, in the loader's shuffle order: the first
    step equal at rtol 1e-5 and every step at 1e-4 (the two layouts sum
    in another order), and finite evaluations on both paths.  Their
    evaluations are not compared: the chains' nodes all start alike, so
    the biases ahead of each batch norm have gradients of rounding noise
    and part by a few lr in 3 Adam steps, which the running statistics
    see (tests/test_torch_resident.py); the next test holds the two eval
    paths to each other on the same weights."""
    _, ts = dataset
    on = fit(ts, "on", 1, bn_train_mode_eval)["history"][0]
    off = fit(ts, "off", 1, bn_train_mode_eval)["history"][0]
    assert len(on["step_losses"]) == len(off["step_losses"]) == 3
    np.testing.assert_allclose(on["step_losses"][0], off["step_losses"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(on["step_losses"], off["step_losses"],
                               rtol=1e-4)
    assert all(np.isfinite(r[k]) for r in (on, off)
               for k in ("val_loss", "test_loss"))


@pytest.mark.parametrize("bn_train_mode", [False, True])
def test_resident_eval_equals_per_batch_eval(dataset, bn_train_mode):
    """The same weights evaluated on the store's gathered batches and on
    the loader's collated ones: the same loss (rtol 1e-5), with running
    statistics or batch statistics (``bn_train_mode``, which leaves the
    running statistics as they were)."""
    _, ts = dataset
    model = init_parameters(make_model(ModelConfig(**MODEL)), 3)
    store = tres.build_banded_store(ts, V1, VK, device="cpu")
    chunks = tres.epoch_index_chunks(np.arange(len(ts)), 4,
                                     store.num_graphs)
    before = {k: v.clone() for k, v in model.named_buffers()}
    got = tres.make_resident_eval(model, "l1", bn_train_mode=bn_train_mode)(
        store, chunks)
    want = evaluate(model, GraphLoader(ts, 4, mode="banded", v1=V1, vk=VK),
                    "l1", bn_train_mode=bn_train_mode)
    assert got["count"] == want["count"] == len(ts)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert all(torch.equal(v, before[k]) for k, v in model.named_buffers())


@pytest.mark.parametrize("gcn_norm", [False, True])
def test_resident_rule_on_banded_loaders(dataset, monkeypatch, gcn_norm):
    """auto takes the store at a cap of its bytes and not one byte
    under; on takes it, off never.  Under gcn_norm the port sizes the f32
    mask, so auto refuses a store the JAX estimate would take."""
    js, ts = dataset
    loader = GraphLoader(ts, 2, mode="banded", v1=V1, vk=VK,
                         banded_gcn_norm=gcn_norm)
    tile, halo, n_slot, spill = tres.plan_banded_store_shapes(ts)
    nbytes = tres.banded_store_nbytes(ts, n_slot, tile, halo, spill, V1,
                                      VK, gcn_norm=gcn_norm)
    monkeypatch.setenv("KPGNN_RESIDENT_MAX_BYTES", str(nbytes))
    go, why = resident_rule("auto", loader)
    assert go and f"banded store {nbytes} B" in why
    monkeypatch.setenv("KPGNN_RESIDENT_MAX_BYTES", str(nbytes - 1))
    assert not resident_rule("auto", loader)[0]
    assert resident_rule("on", loader)[0]
    assert not resident_rule("off", loader)[0]
    jax_estimate = jres.banded_store_nbytes(js, n_slot, tile, halo, spill,
                                            V1, VK)
    if gcn_norm:
        assert jax_estimate < nbytes
        monkeypatch.setenv("KPGNN_RESIDENT_MAX_BYTES", str(jax_estimate))
        assert not resident_rule("auto", loader)[0]
