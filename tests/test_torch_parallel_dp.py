"""The port's data-parallel and multi-host steps against the JAX package.

Each case carries the weights of one JAX model into the port and runs
the same batches through both: the JAX step on the conftest's virtual
CPU mesh (``make_parallel_train_step`` / ``make_parallel_eval_step``;
the (dcn, data) step of parallel/multihost.py), the port's step in P
spawned ranks over gloo (parallel/dp.py, one rank per batch).  The JAX
step's optimizer here records the all-reduced gradients in its state,
so gradients are compared directly.  The cases cover the four poolings,
the virtual node, every norm type, a node-level head and a multi-target
eval.  The rank bodies live in this module and import no JAX: JAX is
imported inside the test functions only.

Tolerances (f32): loss sums rtol 1e-4; gradients rtol 1e-4 with an atol
of 1e-4 of the model's largest gradient (the two sides sum in different
orders); running statistics and eval sums atol 1e-5 / rtol 1e-4; counts
exact; every rank's gradients bitwise equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from kpgnn_tpu_torch.graph import batch as tbatch
from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.parallel import mesh as tmesh
from kpgnn_tpu_torch.parallel.dp import (ShardStream, mask_empty_batch,
                                         parallel_eval_step,
                                         parallel_train_step, shard_loader)
from kpgnn_tpu_torch.parallel.multihost import (dcn_mesh, host_shard,
                                                host_shard_loader,
                                                lockstep_group_count)
from kpgnn_tpu_torch.prep import khop as tkhop

torch.set_num_threads(1)

ACT = dict(atol=1e-5, rtol=1e-4)
BASE = dict(model_name="KPGIN", hidden_size=8, num_layer=2, K=2,
            num_hop1_edge=3, max_pe_num=9, max_edge_type=3,
            max_edge_count=10, max_hop_num=2, max_distance_count=10,
            drop_prob=0.0, input_encoder=("embedding", 21),
            task="graph_regression", norm_type="Batch",
            pooling_method="sum")
CONFIGS = {
    "sum_batch_vn": dict(virtual_node=True),
    "mean_layer_plus": dict(model_name="KPGINPlus", norm_type="Layer",
                            pooling_method="mean", combine="attention",
                            JK="concat", residual=True),
    "max_instance": dict(norm_type="Instance", pooling_method="max"),
    "attention_graphsize_vn": dict(norm_type="GraphSize",
                                   pooling_method="attention",
                                   virtual_node=True),
    "node_pair": dict(norm_type="Pair", task="node_regression"),
}
PREP = dict(K=2, kernel="spd", max_edge_attr_num=9, max_hop_num=2,
            max_edge_type=3, max_edge_count=10, max_distance_count=10)


def model_cfg(name, **over):
    return dict(BASE, **CONFIGS[name], **over)


def node_level(cfg):
    return cfg["task"].startswith("node")


# ---- rank bodies (no JAX) ----

def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def run_dp_case(case, mesh):
    """One data-parallel eval and train step of ``case`` on this rank's
    batch; returns the step's results (host tensors)."""
    cfg = case["cfg"]
    model = make_model(ModelConfig(**cfg))
    model.load_state_dict(case["sd"], strict=True)
    batch = case["batches"][mesh.rank]
    nl = node_level(cfg)
    out = {"eval": {k: v.numpy() for k, v in parallel_eval_step(
        model, batch, case["loss"], node_level=nl, mesh=mesh).items()}}
    if case.get("train", True):
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        lsum, cnt = parallel_train_step(model, opt, batch, case["loss"],
                                        None, nl, mesh=mesh)
        out.update(loss_sum=float(lsum), count=float(cnt),
                   grads=_grads(model),
                   bufs={n: b.clone() for n, b in model.named_buffers()})
    return out


def _dp_rank(rank, world, cases, dcn_cases):
    out = []
    if cases:
        mesh = tmesh.make_mesh(("data",))
        out += [run_dp_case(c, mesh) for c in cases]
    if dcn_cases:
        mesh = dcn_mesh(n_hosts=2)
        assert mesh.shape == (2, world // 2)
        out += [run_dp_case(c, mesh) for c in dcn_cases]
    return out


# ---- the JAX side (parent only) ----

def graph_sets(n, seed, node_targets=False, n_targets=None):
    """The same raw molecules prepped by both packages, with node-level
    or multi-target y where asked (the same values on both sides)."""
    from tests.test_torch_prep_batch import both_prep, raw_molecules

    js, ts = both_prep(raw_molecules(n, seed=seed, n_min=5, n_max=12),
                       **PREP)
    rng = np.random.default_rng(seed + 100)
    for jg, tg in zip(js, ts):
        if node_targets:
            y = rng.normal(size=(jg.num_nodes,)).astype(np.float32)
        elif n_targets:
            y = rng.normal(size=(n_targets,)).astype(np.float32)
        else:
            continue
        jg.y, tg.y = y, y.copy()
    return js, ts


def pads(graphs, per_batch):
    """(n_pad, e_pad) fitting any ``per_batch`` of ``graphs``."""
    ns = sorted((g.num_nodes for g in graphs), reverse=True)
    es = sorted((g.num_edges for g in graphs), reverse=True)
    return (tbatch.BucketSpec().pad_sizes(sum(ns[:per_batch]),
                                          sum(es[:per_batch])))


def collate_both(js, ts, n_pad, e_pad, g_pad, nl):
    import kpgnn_tpu.graph.batch as jbatch
    return (jbatch.collate(js, n_pad=n_pad, e_pad=e_pad, g_pad=g_pad,
                           y_is_node_level=nl),
            tbatch.collate(ts, n_pad=n_pad, e_pad=e_pad, g_pad=g_pad,
                           y_is_node_level=nl))


def grad_recorder():
    """An optax transformation whose state is the last gradients it was
    given (the parameters stay as they were)."""
    import jax
    import jax.numpy as jnp
    import optax
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def jax_model(cfg, example):
    """(flax model, variables initialized from PRNGKey(0), the port's
    state_dict of them)."""
    import jax
    import kpgnn_tpu.models as jmodels
    from kpgnn_tpu_torch.utils.convert import params_from_flax
    from tests.test_torch_layers import flat

    model = jmodels.make_model(jmodels.ModelConfig(**cfg))
    v = jax.jit(lambda r, b: model.init(r, b, train=False))(
        jax.random.PRNGKey(0), example)
    return model, v, params_from_flax(flat(v))


def fresh_state(v, tx):
    import jax
    import jax.numpy as jnp
    from kpgnn_tpu.train.state import TrainState

    params = jax.tree.map(jnp.array, v["params"])
    bs = v.get("batch_stats")
    return TrainState(params=params,
                      batch_stats=None if bs is None
                      else jax.tree.map(jnp.array, bs),
                      opt_state=tx.init(params), step=jnp.asarray(0))


def as_port(coll, tree):
    """A JAX pytree of one collection under the port's names."""
    from kpgnn_tpu_torch.utils.convert import params_from_flax
    from tests.test_torch_layers import flat
    return params_from_flax(flat({coll: tree}))


def assert_step(got, state, metrics, label):
    """The port's step results against the JAX step's new state (grads in
    its optimizer state) and metrics."""
    assert got["count"] == float(metrics["count"]), label
    np.testing.assert_allclose(got["loss_sum"], float(metrics["loss_sum"]),
                               rtol=1e-4, err_msg=label)
    ref = as_port("params", state.opt_state)
    gscale = max(float(g.abs().max()) for g in ref.values())
    for name, want in ref.items():
        g = got["grads"].get(name, torch.zeros_like(want))
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4 * gscale,
                                   err_msg=f"{label}: {name}")
    if state.batch_stats is not None:
        for name, want in as_port("batch_stats", state.batch_stats).items():
            np.testing.assert_allclose(got["bufs"][name].numpy(),
                                       want.numpy(), **ACT,
                                       err_msg=f"{label}: {name}")


def assert_eval(got, ref, label):
    assert sorted(got) == sorted(ref), label
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(ref[k], np.float64), **ACT,
                                   err_msg=f"{label}: {k}")


def assert_ranks_equal(results):
    """Every rank holds the same all-reduced results, bit for bit."""
    for other in results[1:]:
        for a, b in zip(results[0], other):
            assert a.get("loss_sum") == b.get("loss_sum")
            for name, g in a.get("grads", {}).items():
                assert torch.equal(g, b["grads"][name]), name


def dp_case(name, P, per_batch, seed, loss="mse", n_targets=None,
            train=True):
    """A data-parallel case: P batches of ``per_batch`` graphs, the JAX
    model's weights, and the JAX step's results on a P-device mesh."""
    import jax
    from kpgnn_tpu.parallel import make_mesh, stack_batches
    from kpgnn_tpu.parallel.dp import (make_parallel_eval_step,
                                       make_parallel_train_step)

    cfg = model_cfg(name, **({"output_size": n_targets} if n_targets
                             else {}))
    nl = node_level(cfg)
    js, ts = graph_sets(P * per_batch, seed, node_targets=nl,
                        n_targets=n_targets)
    n_pad, e_pad = pads(ts, per_batch)
    jb, tb = zip(*(collate_both(js[i * per_batch:(i + 1) * per_batch],
                                ts[i * per_batch:(i + 1) * per_batch],
                                n_pad, e_pad, per_batch + 1, nl)
                   for i in range(P)))
    model, v, sd = jax_model(cfg, jb[0])
    mesh = make_mesh(P)
    stacked = stack_batches(list(jb))
    tx = grad_recorder()
    ref = {"eval": jax.device_get(make_parallel_eval_step(
        model, mesh, loss=loss, node_level=nl)(fresh_state(v, tx),
                                               stacked))}
    if train:
        state, metrics = make_parallel_train_step(
            model, tx, mesh, loss=loss, node_level=nl)(
                fresh_state(v, tx), stacked, jax.random.PRNGKey(1))
        ref.update(state=state, metrics=metrics)
    case = dict(cfg=cfg, sd=sd, batches=list(tb), loss=loss, train=train)
    return case, ref, (model, v, jb)


def check_case(got, ref, label):
    assert_eval(got["eval"], ref["eval"], label)
    if "state" in ref:
        assert_step(got, ref["state"], ref["metrics"], label)


def test_data_parallel_steps_two_ranks_match_jax():
    """P=2: every config's train step (grads, loss, running statistics)
    and eval step, and a QM9-shaped three-target eval's abs_per_target,
    against the JAX package's data-parallel steps."""
    built = [dp_case(name, 2, 3, seed=i) for i, name in enumerate(CONFIGS)]
    built.append(dp_case("sum_batch_vn", 2, 3, seed=17, loss="l1",
                         n_targets=3, train=False))
    results = tmesh.spawn(_dp_rank, 2, "gloo",
                          args=([c for c, _, _ in built], []))
    assert_ranks_equal(results)
    labels = list(CONFIGS) + ["three targets"]
    for got, (_, ref, _), label in zip(results[0], built, labels):
        check_case(got, ref, label)
    assert "abs_per_target" in results[0][-1]["eval"]


def test_data_parallel_and_dcn_steps_four_ranks_match_jax():
    """P=4 on one axis, and the same four ranks as a 2 x 2 (dcn, data)
    mesh, whose step sums inside a host and then across hosts, against
    the JAX data-parallel step and its (dcn, data) step."""
    import jax
    from kpgnn_tpu.parallel.dp import make_parallel_train_step
    from kpgnn_tpu.parallel.multihost import (dcn_mesh as jdcn_mesh,
                                              make_global_super_batch)

    dp, ref, _ = dp_case("sum_batch_vn", 4, 2, seed=5)
    dcn, _, (model, v, jb) = dp_case("mean_layer_plus", 4, 2, seed=6)
    mesh = jdcn_mesh(n_hosts=2, devices=jax.devices()[:4])
    tx = grad_recorder()
    state, metrics = make_parallel_train_step(
        model, tx, mesh, loss="mse", axis=("dcn", "data"))(
            fresh_state(v, tx), make_global_super_batch(list(jb), mesh),
            jax.random.PRNGKey(1))
    dcn = dict(dcn, train=True)
    results = tmesh.spawn(_dp_rank, 4, "gloo", args=([dp], [dcn]))
    assert_ranks_equal(results)
    check_case(results[0][0], ref, "P=4")
    assert_step(results[0][1], state, metrics, "dcn 2x2")


# ---- loaders (no process group) ----

def port_graphs(n, seed):
    from kpgnn_tpu_torch.prep.khop import KHopConfig
    from tests.test_torch_prep_batch import raw_molecules
    return tkhop.extract_graphs(raw_molecules(n, seed=seed, n_min=4,
                                              n_max=8), KHopConfig(**PREP))


def test_shard_loader_pads_trailing_group():
    """5 batches over 4 ranks: each rank steps twice, the second group
    padded with masked-empty batches; the live graphs over all ranks are
    the dataset."""
    gs = port_graphs(20, 7)
    batches = [tbatch.collate(gs[i * 4:(i + 1) * 4], n_pad=64, e_pad=512,
                              g_pad=5) for i in range(5)]
    live, steps = 0, []
    for r in range(4):
        got = list(shard_loader(batches, 4, r))
        steps.append(len(got))
        live += sum(int(b.graph_mask.sum()) for b in got)
    assert steps == [2, 2, 2, 2] and live == 20
    stream = ShardStream(batches, 4, 3)
    assert len(list(stream)) == len(list(stream)) == 2    # re-iterable
    empty = mask_empty_batch(batches[0])
    assert not empty.node_mask.any() and not empty.graph_mask.any()
    assert empty.x.shape == batches[0].x.shape


def hosts_mesh(n_hosts, per_host, host, local):
    """A (dcn, data) Mesh's coordinates without a process group (the
    loaders read only its shape and this rank's place)."""
    return tmesh.Mesh(("dcn", "data"), (n_hosts, per_host), (host, local),
                      {}, torch.device("cpu"), "gloo")


def test_host_shard_partition():
    items = list(range(23))
    shards = [host_shard(items, pi, 4) for pi in range(4)]
    assert sorted(sum(shards, [])) == items
    assert max(map(len, shards)) - min(map(len, shards)) <= 1
    assert host_shard(items, 2, 4) == shards[2]


def test_host_shard_loader_covers_every_graph():
    """2 hosts x 2 ranks, 11 graphs in 2-graph batches: each host loads
    its strided shard, each rank its member of each group; a partial
    group pads with masked-empty batches; the live graphs over every
    rank are the dataset."""
    gs = port_graphs(11, 9)
    seen = 0
    for h in range(2):
        shard = host_shard(gs, h, 2)
        batches = [tbatch.collate(shard[i:i + 2], n_pad=32, e_pad=256,
                                  g_pad=3) for i in range(0, len(shard), 2)]
        for local in range(2):
            for b in host_shard_loader(batches, hosts_mesh(2, 2, h, local)):
                seen += int(b.graph_mask.sum())
    assert seen == 11


def test_host_shard_loader_lockstep_groups():
    """A short host pads whole masked groups up to the lockstep count, so
    every rank of every host takes as many steps; more groups than the
    count raise."""
    gs = port_graphs(17, 11)
    per_host = 8
    n_groups = lockstep_group_count(17, 1, hosts_mesh(2, per_host, 0, 0))
    assert n_groups == 2
    counts, live = set(), 0
    for h in range(2):
        batches = [tbatch.collate([g], n_pad=32, e_pad=256, g_pad=2)
                   for g in host_shard(gs, h, 2)]
        for local in range(per_host):
            got = list(host_shard_loader(
                batches, hosts_mesh(2, per_host, h, local), n_groups))
            counts.add(len(got))
            live += sum(int(b.graph_mask.sum()) for b in got)
    assert counts == {n_groups} and live == 17
    batches = [tbatch.collate([g], n_pad=32, e_pad=256, g_pad=2)
               for g in host_shard(gs, 0, 2)]
    with pytest.raises(ValueError, match="lockstep"):
        list(host_shard_loader(batches, hosts_mesh(2, per_host, 0, 0), 1))


def test_mesh_coordinates_and_axes():
    m = hosts_mesh(2, 3, 1, 2)
    assert m.size == 6 and m.rank == 5
    assert m.axis_size("data") == 3 and m.axis_index("dcn") == 1
    assert m.axis_index(("dcn", "data")) == 5
    assert dataclasses.replace(m, coords=(0, 0)).rank == 0
