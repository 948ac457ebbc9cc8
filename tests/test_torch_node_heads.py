"""The port's node heads and node-level training against the JAX package,
on node-property graphs (``generate_property_dataset``, scale 0.02):

* the node-level y collate, field by field, on the coo, pallas and dense
  loaders;
* a small KPGINPlus (K=2 L=2 H=16) under NodeRegression and
  NodeClassification with carried weights, on coo, on the kernel plan
  (its plain version on the CPU) and on dense: outputs on the real nodes;
* three AdamW steps with node-level MSE: losses;
* the node-level eval step: its sums and metrics, and no
  ``abs_per_target`` (a node-level y is 2-D, but per-target errors are a
  graph-level metric).

Tolerances (f32): outputs atol 1e-5 / rtol 1e-4, losses rtol 1e-4,
collated fields exact.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kpgnn_tpu.graph.batch as jbatch
import kpgnn_tpu.models as jmodels
import kpgnn_tpu.prep.khop as jkhop
from kpgnn_tpu.train.loader import GraphLoader as JGraphLoader
from kpgnn_tpu.train.loop import eval_step_body, summarize_eval_sums
from kpgnn_tpu.train.loop import train_step_body
from kpgnn_tpu.train.state import create_train_state
from kpgnn_tpu_torch.data.property import generate_property_dataset
from kpgnn_tpu_torch.graph import batch as tbatch
from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.models.heads import NodeClassification, NodeRegression
from kpgnn_tpu_torch.prep import khop as tkhop
from kpgnn_tpu_torch.train.loader import GraphLoader
from kpgnn_tpu_torch.train.loop import eval_step, evaluate, train_step
from kpgnn_tpu_torch.train.state import make_optimizer
from tests.test_torch_layers import carry

torch.set_num_threads(1)
PREP = dict(K=2, kernel="spd", max_edge_attr_num=50, max_hop_num=5,
            max_edge_type=1, max_edge_count=50, max_distance_count=100)
SMALL = dict(model_name="KPGINPlus", hidden_size=16, num_layer=2, K=2,
             max_pe_num=50, max_edge_type=1, max_edge_count=50,
             max_hop_num=5, max_distance_count=100, drop_prob=0.0,
             input_encoder=("linear", 2))
V1, VK = 3, 52
BACKENDS = ["coo", "pallas", "dense"]
PER_BATCH = 6


def node_graphs(n, classes=False):
    """Both packages' prep of ``n`` node-property graphs, y the sssp
    target (N, 1), or (classes) its distance class (N,)."""
    raws = generate_property_dataset(seed=1234, scale=0.02)["train"][::7][:n]
    for r in raws:
        y = r.pop("node_y")[:, :1]
        r["y"] = (np.rint(y[:, 0] * 4).astype(np.int64) if classes
                  else y.astype(np.float32))
    jc = jkhop.KHopConfig(**PREP)
    js = [jkhop.extract_khop(r["num_nodes"], r["edge_index"], None, jc,
                             x=r["x"], y=r["y"]) for r in raws]
    return js, tkhop.extract_graphs(raws, tkhop.KHopConfig(**PREP))


def batches(n_batches=1, classes=False):
    """Per batch the JAX (coo, dense) and the port's (coo, pallas, dense)
    node-level collations."""
    js, ts = node_graphs(n_batches * PER_BATCH, classes)
    pads = dict(n_pad=256, e_pad=2048, g_pad=PER_BATCH + 1,
                y_is_node_level=True)
    dense = dict(n_slot=24, v1=V1, vk=VK, y_is_node_level=True)
    out = []
    for i in range(n_batches):
        sl = slice(i * PER_BATCH, (i + 1) * PER_BATCH)
        out.append(({"coo": jbatch.collate(js[sl], **pads),
                     "dense": jbatch.collate_dense(js[sl], **dense)},
                    {"coo": tbatch.collate(ts[sl], **pads),
                     "pallas": tbatch.collate_pallas(ts[sl], v1=V1, vk=VK,
                                                     **pads),
                     "dense": tbatch.collate_dense(ts[sl], **dense)}))
    return out


def jax_side(backend):
    """The JAX batch a port backend is held against (the kernel plan
    against JAX's COO: the same sums)."""
    return "dense" if backend == "dense" else "coo"


@pytest.mark.parametrize("mode", BACKENDS)
def test_node_level_loader_batches_equal_jax(mode):
    """Ordered loader batches with a node-level y, field by field: y,
    the masks and the graph ids, on every loader mode (the JAX package's
    pallas loader collates its own plan layout, so the port's plan loader
    is held against the JAX COO loader's node fields)."""
    js, ts = node_graphs(2 * PER_BATCH + 3)
    kw = dict(v1=V1, vk=VK) if mode != "coo" else {}
    ours = GraphLoader(ts, PER_BATCH, mode=mode, y_is_node_level=True,
                       **kw)
    theirs = JGraphLoader(js, PER_BATCH, y_is_node_level=True,
                          mode="dense" if mode == "dense" else "coo",
                          **(dict(v1=V1, vk=VK) if mode == "dense" else {}))
    n = 0
    for a, b in zip(ours, theirs):
        for f in ("y", "node_mask", "graph_mask", "node_graph_ids", "x"):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f)
        assert a.y.shape == (a.n_pad, 1)
        n += 1
    assert n == 3


@functools.lru_cache(maxsize=None)
def jax_node_model(task):
    """The small model under ``task``'s head: (config, JAX variables, the
    port's batches, the JAX model's outputs per JAX backend)."""
    classes = task == "node_classification"
    cfg = dict(SMALL, task=task, output_size=5 if classes else 1)
    (jbs, tbs), = batches(classes=classes)
    jmodel = jmodels.make_model(jmodels.ModelConfig(**cfg))
    v = jax.jit(lambda key, b: jmodel.init(key, b, train=False))(
        jax.random.PRNGKey(0), jbs["coo"])
    apply = jax.jit(lambda v, b: jmodel.apply(v, b))
    return cfg, v, tbs, {k: np.asarray(apply(v, b)) for k, b in jbs.items()}


@pytest.mark.parametrize("task", ["node_regression", "node_classification"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_small_node_head_model_equals_jax(task, backend):
    cfg, v, tbs, theirs = jax_node_model(task)
    classes = task == "node_classification"
    tmodel = carry(make_model(ModelConfig(**cfg)), v)
    assert isinstance(tmodel, NodeClassification if classes
                      else NodeRegression)
    tb = tbs[backend]
    real = tb.node_mask.numpy()
    with torch.no_grad():
        ours = tmodel(tb, train=False).numpy()
    assert ours.shape == ((tb.n_pad, 5) if classes else (tb.n_pad,))
    np.testing.assert_allclose(ours[real],
                               theirs[jax_side(backend)][real], atol=1e-5,
                               rtol=1e-4)
    assert real.sum() > 80 and np.isfinite(ours[real]).all()


@functools.lru_cache(maxsize=None)
def jax_three_steps(side):
    """Three AdamW steps of the JAX model on its ``side`` batches: (the
    initial variables, the losses, the counts)."""
    cfg = dict(SMALL, task="node_regression", output_size=1)
    jmodel = jmodels.make_model(jmodels.ModelConfig(**cfg))
    bs = batches(n_batches=3)
    state, tx = create_train_state(jmodel, bs[0][0]["coo"],
                                   jax.random.PRNGKey(0), lr=1e-2,
                                   l2_wd=3e-7)
    v0 = state.variables
    jstep = jax.jit(train_step_body(jmodel, tx, "mse", node_level=True))
    losses, counts = [], []
    for jbs, _ in bs:
        state, m = jstep(state, jbs[side], jax.random.PRNGKey(1))
        losses.append(float(m["loss_sum"]) / float(m["count"]))
        counts.append(float(m["count"]))
    return v0, losses, counts


@pytest.mark.parametrize("backend", BACKENDS)
def test_small_node_regression_three_adamw_steps_equal_jax(backend):
    """The node-property optimizer (AdamW, lr 1e-2, l2_wd 3e-7) and the
    node-level MSE over the real nodes, dropout 0."""
    cfg = dict(SMALL, task="node_regression", output_size=1)
    v0, jl, jcounts = jax_three_steps(jax_side(backend))
    tmodel = carry(make_model(ModelConfig(**cfg)), v0)
    opt = make_optimizer(tmodel.parameters(), lr=1e-2, l2_wd=3e-7)
    tl = []
    for (_, tbs), jc in zip(batches(n_batches=3), jcounts):
        lsum, cnt = train_step(tmodel, opt, tbs[backend], "mse",
                               node_level=True)
        tl.append(float(lsum) / float(cnt))
        # counted per real node
        assert float(cnt) == jc == int(tbs[backend].node_mask.sum())
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert len(set(np.round(jl, 6))) == 3       # the steps moved weights


@pytest.mark.parametrize("loss,classes", [("mse", False),
                                          ("cross_entropy", True)])
def test_node_level_eval_step_equals_jax(loss, classes):
    """The node-level eval sums against the JAX eval step's, through
    summarize_eval_sums: counted over the real nodes, with ``correct``
    for classification and no ``abs_per_target`` for the 2-D node y."""
    rng = np.random.default_rng(9)
    tbs, jsums = [], {}
    jstep = eval_step_body(types.SimpleNamespace(
        apply=lambda v, b, train=False: b.pred), loss, node_level=True)
    for n, real in ((12, 9), (12, 4)):
        pred = rng.normal(size=(n, 3) if classes else (n,)).astype(
            np.float32)
        y = (rng.integers(0, 3, size=n) if classes
             else rng.normal(size=(n, 1)).astype(np.float32))
        node_mask = np.arange(n) < real
        graph_mask = np.array([True, True, False])
        tbs.append(types.SimpleNamespace(
            pred=torch.from_numpy(pred), y=torch.from_numpy(y),
            node_mask=torch.from_numpy(node_mask),
            graph_mask=torch.from_numpy(graph_mask)))
        m = jstep(types.SimpleNamespace(params={}, batch_stats=None),
                  types.SimpleNamespace(
                      pred=jnp.asarray(pred), y=jnp.asarray(y),
                      node_mask=jnp.asarray(node_mask),
                      graph_mask=jnp.asarray(graph_mask)))
        for k, v in m.items():
            jsums.setdefault(k, []).append(np.asarray(v, np.float64))

    class Fixed(torch.nn.Module):
        def forward(self, batch, train=False):
            return batch.pred
    steps = [eval_step(Fixed(), b, loss, node_level=True) for b in tbs]
    assert all(sorted(s) == sorted(jsums) for s in steps)
    assert "abs_per_target" not in steps[0]
    assert ("correct" in steps[0]) == classes
    want = summarize_eval_sums({k: np.sum(v, axis=0)
                                for k, v in jsums.items()})
    got = evaluate(Fixed(), tbs, loss, node_level=True)
    assert sorted(got) == sorted(want) and got["count"] == 13.0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    # the same batches graph-level: 2 real graphs a batch, and the 2-D y
    # of an l1/mse loss takes per-target errors there
    if not classes:
        graph = eval_step(Fixed(), types.SimpleNamespace(
            pred=tbs[0].pred[:3], y=tbs[0].y[:3],
            graph_mask=tbs[0].graph_mask), loss)
        assert float(graph["count"]) == 2.0 and "abs_per_target" in graph
