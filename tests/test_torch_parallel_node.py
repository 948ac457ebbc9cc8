"""The port's node-sharded train and eval steps against the JAX package.

One collated batch is partitioned over P ranks (parallel/partition.py):
the JAX step runs it under ``shard_map`` on the conftest's virtual CPU
mesh (``make_sharded_train_step`` / ``make_sharded_eval_step`` on COO
shards); the port's step runs in P spawned ranks over gloo, each on its
own shard, aggregating on COO, on its rectangular kernel plan (the plain
version on the CPU) or on its banded plan, after the halo exchange.  The
JAX step's optimizer records the gradients, so gradients are compared
directly, for the same carried weights.  The cases cover the four
poolings, the virtual node, every norm type, GNNPlus's hop windows and
a node-level head.

Tolerances: as tests/test_torch_parallel_dp.py.
"""
import numpy as np
import torch

from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.ops.adjacency import hop_major_native
from kpgnn_tpu_torch.parallel import mesh as tmesh
from kpgnn_tpu_torch.parallel.partition import (partition_batch,
                                                sharded_eval_step,
                                                sharded_train_step)
from tests.test_torch_parallel_dp import (CONFIGS, _grads, assert_eval,
                                          assert_ranks_equal, assert_step,
                                          collate_both, fresh_state,
                                          graph_sets, grad_recorder,
                                          jax_model, model_cfg, node_level,
                                          pads)

torch.set_num_threads(1)

V1, VK = 5, 11          # num_hop1_edge + 2, max_pe_num + 2


def run_node_case(case, mesh):
    """One node-sharded eval and train step of ``case`` on this rank's
    shard, aggregating on ``case["backend"]``."""
    cfg = case["cfg"]
    nl = node_level(cfg)
    model = make_model(ModelConfig(**cfg))
    model.load_state_dict(case["sd"], strict=True)
    backend = case["backend"]
    plans = ({} if backend == "coo"
             else {backend: {"v1": V1, "vk": VK}})
    shard = partition_batch(case["batch"], mesh.size, mesh.rank,
                            mesh.group("node"), nl, **plans)
    assert hop_major_native(shard.adj) == (backend != "coo")
    out = {"eval": {k: v.numpy() for k, v in sharded_eval_step(
        model, shard, case["loss"], node_level=nl, mesh=mesh).items()}}
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    lsum, cnt = sharded_train_step(model, opt, shard, case["loss"], None,
                                   nl, mesh=mesh)
    out.update(loss_sum=float(lsum), count=float(cnt), grads=_grads(model),
               bufs={n: b.clone() for n, b in model.named_buffers()},
               halo=shard.adj.halo)
    return out


def _node_rank(rank, world, cases):
    mesh = tmesh.make_mesh(("node",))
    return [run_node_case(c, mesh) for c in cases]


def node_refs(name, P, n_graphs, seed, loss="mse"):
    """The port's batch and weights for config ``name``, and the JAX
    sharded steps' results on a P-device node mesh."""
    import jax
    from kpgnn_tpu.parallel import (make_mesh, make_sharded_eval_step,
                                    make_sharded_train_step,
                                    partition_batch as jpartition)

    cfg = model_cfg(name)
    nl = node_level(cfg)
    js, ts = graph_sets(n_graphs, seed, node_targets=nl)
    _, e_pad = pads(ts, n_graphs)
    # the tightest n_pad whose shards hold whole banded tiles (32 rows),
    # so that graphs straddle the shard boundaries
    n_pad = -(-(sum(g.num_nodes for g in ts) + 1) // (32 * P)) * 32 * P
    jb, tb = collate_both(js, ts, n_pad, e_pad, n_graphs + 1, nl)
    model, v, sd = jax_model(cfg, jb)
    mesh = make_mesh(P, axis_names=("node",))
    pb = jpartition(jb, P)
    tx = grad_recorder()
    ev = jax.device_get(make_sharded_eval_step(
        model, mesh, loss=loss, node_level=nl)(fresh_state(v, tx), pb))
    state, metrics = make_sharded_train_step(
        model, tx, mesh, loss=loss, node_level=nl)(
            fresh_state(v, tx), pb, jax.random.PRNGKey(1))
    return dict(cfg=cfg, sd=sd, batch=tb, loss=loss), (ev, state, metrics)


def run_and_check(P, specs, n_graphs):
    """specs: (config name, backends, seed).  Every backend's shard step
    against the JAX sharded step of the same config."""
    cases, refs, labels = [], [], []
    for name, backends, seed in specs:
        case, ref = node_refs(name, P, n_graphs, seed)
        for backend in backends:
            cases.append(dict(case, backend=backend))
            refs.append(ref)
            labels.append(f"P={P} {name} {backend}")
    results = tmesh.spawn(_node_rank, P, "gloo", args=(cases,))
    assert_ranks_equal(results)
    for got, (ev, state, metrics), label in zip(results[0], refs, labels):
        assert_eval(got["eval"], ev, label)
        assert_step(got, state, metrics, label)
    return results


def test_node_sharded_steps_two_ranks_match_jax():
    """P=2: every config on COO shards; the kernel plan under KPGIN and
    under KPGINPlus (its layers slice the plan to hop windows 1..K); the
    banded plan under KPGIN and the node-level head."""
    # seeds whose batches put a graph across the shard boundary
    specs = [("sum_batch_vn", ("coo", "pallas", "banded"), 1),
             ("mean_layer_plus", ("coo", "pallas", "banded"), 2),
             ("max_instance", ("coo",), 3),
             ("attention_graphsize_vn", ("coo",), 6),
             ("node_pair", ("coo", "banded"), 5)]
    assert [s[0] for s in specs] == list(CONFIGS)
    results = run_and_check(2, specs, 6)
    halos = [r["halo"] for r in results[0]]
    assert all(h > 1 for h in halos), halos   # real boundary rows


def test_node_sharded_steps_four_ranks_match_jax():
    """P=4: KPGIN with the virtual node on COO, the kernel plan and the
    banded plan; max pooling on COO."""
    results = run_and_check(4, [("sum_batch_vn", ("coo", "pallas",
                                                  "banded"), 7),
                                ("max_instance", ("coo",), 8)], 12)
    assert all(r["halo"] > 1 for r in results[0])


def test_partition_batch_slices_node_rows():
    """A shard holds its node rows (and a node-level y's), the whole
    per-graph arrays, and masks whose union is the batch's."""
    from tests.test_torch_parallel_dp import port_graphs
    from kpgnn_tpu_torch.graph import batch as tbatch

    gs = port_graphs(6, 3)
    for g in gs:
        g.y = np.arange(g.num_nodes, dtype=np.float32)
    b = tbatch.collate(gs, n_pad=64, e_pad=512, g_pad=7,
                       y_is_node_level=True)
    shards = [partition_batch(b, 4, r, node_level=True) for r in range(4)]
    for f in ("x", "node_mask", "node_graph_ids", "pe_attr", "y"):
        np.testing.assert_array_equal(
            torch.cat([getattr(s, f) for s in shards]).numpy(),
            getattr(b, f).numpy(), err_msg=f)
    for s in shards:
        assert torch.equal(s.graph_mask, b.graph_mask)
        assert s.n_pad == 16 and s.adj.n_local == 16
