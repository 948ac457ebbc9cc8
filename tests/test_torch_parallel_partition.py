"""The port's partition plan and node-sharded aggregation against the JAX
package.

* ``partition_adj``: every rank's shard array-equal to the JAX package's
  stacked plan at P=2 and P=4, on a random edge list and on a batch
  whose graphs align with the shard boundaries (empty halo);
* the communication accounting (boundary, not the full table);
* the rectangular kernel plan's hop windows: its prefix slice equals the
  plan built over the first k hop columns, as the JAX package builds one
  per window;
* the sharded aggregation in P spawned gloo ranks (halo exchange, then
  COO, the kernel plan's plain version or the banded plan; add, scaled
  and mean; node- and hop-major) against the JAX COO aggregation of the
  whole edge list, forward and the gradients of x and both tables.

Tolerances (f32): atol 1e-5 / rtol 1e-4 (the shards sum in other
orders); partition arrays exact.
"""
import numpy as np
import pytest
import torch

from kpgnn_tpu_torch.ops.adjacency import COOAdj, khop_aggregate_adj
from kpgnn_tpu_torch.ops.spmm import build_plan
from kpgnn_tpu_torch.parallel import mesh as tmesh
from kpgnn_tpu_torch.parallel.partition import (attach_banded_plans,
                                                attach_pallas_plans,
                                                partition_adj)

torch.set_num_threads(1)

ACT = dict(atol=1e-5, rtol=1e-4)
V = 6


def random_coo(n, e, K, seed):
    """The JAX test's random edge list (numpy arrays)."""
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, n - 1, e).astype(np.int32)
    receivers = np.sort(rng.integers(0, n - 1, e)).astype(np.int32)
    attr = rng.integers(0, 5, size=(e, K)).astype(np.int32)
    mask = rng.random(e) < 0.9
    attr[~mask] = 0
    return senders, receivers, attr, mask, rng


def block_coo(K, seed=21):
    """Four 16-node blocks, each block's edges inside it."""
    rng = np.random.default_rng(seed)
    s = np.concatenate([rng.integers(16 * b, 16 * (b + 1), 50)
                        for b in range(4)])
    r = np.concatenate([np.sort(rng.integers(16 * b, 16 * (b + 1), 50))
                        for b in range(4)])
    attr = rng.integers(1, 5, size=(200, K)).astype(np.int32)
    return (s.astype(np.int32), r.astype(np.int32), attr,
            np.ones(200, bool))


def port_adj(s, r, a, m, n):
    return COOAdj(senders=torch.from_numpy(s), receivers=torch.from_numpy(r),
                  edge_attr=torch.from_numpy(a), edge_mask=torch.from_numpy(m),
                  n_nodes=n)


def jax_adj(s, r, a, m, n):
    import jax.numpy as jnp
    from kpgnn_tpu.ops.adjacency import COOAdj as JCOOAdj
    return JCOOAdj(senders=jnp.asarray(s), receivers=jnp.asarray(r),
                   edge_attr=jnp.asarray(a), edge_mask=jnp.asarray(m),
                   n_nodes=n)


@pytest.mark.parametrize("P", [2, 4])
def test_partition_adj_matches_jax(P):
    """Each rank's arrays are its row of the JAX stacked plan; the halo
    width and the pairwise boundary sizes are the JAX plan's; an aligned
    batch has an empty boundary and a one-row halo."""
    from kpgnn_tpu.parallel import partition_adj as jpartition

    for args, n in ((random_coo(64, 200, 3, seed=P)[:4], 64),
                    (block_coo(3), 64)):
        ref = jpartition(jax_adj(*args, n), P)
        shards = [partition_adj(port_adj(*args, n), P, r) for r in range(P)]
        for f in ("senders", "receivers", "edge_attr", "edge_mask"):
            np.testing.assert_array_equal(
                np.stack([getattr(s, f).numpy() for s in shards]),
                np.asarray(getattr(ref, f)), err_msg=f)
        # rank r sends send_rows[r] (JAX: send_rows[r, j] to shard j)
        np.testing.assert_array_equal(
            np.stack([s.send_rows.numpy() for s in shards]),
            np.asarray(ref.send_rows))
        for s in shards:
            assert (s.halo, s.boundary, s.n_local) == (
                ref.halo, ref.boundary, ref.n_local)
    assert ref.boundary_total() == 0 and ref.halo == 1


def test_sharded_comm_is_boundary_not_full_table():
    K, D = 3, 16
    sharded = partition_adj(port_adj(*random_coo(256, 1000, K, 0)[:4], 256),
                            4, 0)
    assert sharded.comm_elems_per_layer(K, D) < \
        sharded.psum_elems_per_layer(K, D)
    assert sharded.boundary_total() > 0 and sharded.halo <= 256 // 4
    aligned = partition_adj(port_adj(*block_coo(K), 64), 4, 1)
    assert aligned.boundary_total() == 0 and aligned.halo == 1
    assert aligned.comm_elems_per_layer(K, D) <= 4 * K * D


def test_rectangular_plan_hop_windows_are_its_prefixes():
    """slice_hops(k) of a shard's kernel plan equals the plan built over
    the first k hop columns (the JAX package's per-window plan), CSRs,
    histograms and degrees alike."""
    adj = attach_pallas_plans(partition_adj(
        port_adj(*random_coo(128, 400, 3, 5)[:4], 128), 2, 1), V, V)
    assert adj.plan.fwd.n_rows == 3 * adj.n_local
    assert adj.plan.fwd.n_cols == 3 * adj.n_ext and adj.n_ext > adj.n_local
    m = adj.edge_mask.numpy()
    for k in (1, 2):
        got = adj.slice_hops(k).plan
        want = build_plan(adj.receivers.numpy()[m], adj.senders.numpy()[m],
                          adj.edge_attr.numpy()[m][:, :k], adj.n_local, V,
                          V, n_cols_nodes=adj.n_ext)
        for side in ("fwd", "bwd"):
            a, b = getattr(got, side), getattr(want, side)
            assert (a.n_rows, a.n_cols, a.rows_per_hop, a.hop_live,
                    a.hop_ends) == (b.n_rows, b.n_cols, b.rows_per_hop,
                                    b.hop_live, b.hop_ends), (k, side)
            for f in ("indptr", "senders"):
                assert torch.equal(getattr(a, f), getattr(b, f)), (k, f)
        assert torch.equal(got.fwd.codes, want.fwd.codes)
        for f in ("counts1", "union_deg", "hop_deg"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (k, f)
        assert (got.countsk_hm is None) == (want.countsk_hm is None)
        if k > 1:
            assert torch.equal(got.countsk_hm, want.countsk_hm)


MODES = ("add", "scale", "mean")


def _aggregate_rank(rank, world, case):
    """This rank's shard of the aggregation on each backend and mode:
    the output rows, and the gradients of sum(out * w) in x, the scales
    and both tables."""
    mesh = tmesh.make_mesh(("node",))
    n = case["n"]
    adj = partition_adj(port_adj(*case["coo"], n), world, rank,
                        mesh.group("node"))
    plans = {"coo": adj, "pallas": attach_pallas_plans(adj, V, V),
             "banded": attach_banded_plans(adj, V, V)}
    rows = slice(rank * adj.n_local, (rank + 1) * adj.n_local)
    out = {}
    for backend, a in plans.items():
        for mode in MODES:
            for hm in (False, True):
                x = torch.from_numpy(case["x"][rows]).requires_grad_(True)
                t1, tk = (torch.from_numpy(case[t]).requires_grad_(True)
                          for t in ("t1", "tk"))
                kw = {"aggr": "mean" if mode == "mean" else "add"}
                if mode == "scale":
                    kw["scale"] = torch.from_numpy(case["s"][rows])
                    kw["sender_scale"] = torch.from_numpy(case["ss"][rows])
                xin = x.transpose(0, 1) if hm else x
                y = khop_aggregate_adj(a, xin, t1, tk, hop_major=hm, **kw)
                y = y.transpose(0, 1) if hm else y
                (y * torch.from_numpy(case["w"][rows])).sum().backward()
                out[backend, mode, hm] = (y.detach(), x.grad, t1.grad,
                                          tk.grad)
    return out


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_aggregation_matches_jax_coo(P):
    import jax
    import jax.numpy as jnp
    from kpgnn_tpu.ops.adjacency import khop_aggregate_adj as jaggregate

    n, K, D = 64 * P, 3, 8
    s, r, a, m, rng = random_coo(n, 120 * P, K, seed=10 + P)
    case = dict(n=n, coo=(s, r, a, m),
                x=rng.normal(size=(n, K, D)).astype(np.float32),
                t1=rng.normal(size=(V, D)).astype(np.float32),
                tk=rng.normal(size=(V, D)).astype(np.float32),
                s=rng.random((n, K)).astype(np.float32),
                ss=rng.random((n, K)).astype(np.float32),
                w=np.cos(np.arange(n * K * D)).reshape(n, K, D)
                .astype(np.float32))
    jadj = jax_adj(s, r, a, m, n)
    refs = {}
    for mode in MODES:
        def f(x, t1, tk, mode=mode):
            kw = {"aggr": "mean" if mode == "mean" else "add"}
            if mode == "scale":
                kw.update(scale=jnp.asarray(case["s"]),
                          sender_scale=jnp.asarray(case["ss"]))
            return jaggregate(jadj, x, t1, tk, **kw)
        args = tuple(jnp.asarray(case[k]) for k in ("x", "t1", "tk"))
        out, vjp = jax.vjp(f, *args)
        refs[mode] = (np.asarray(out),) + tuple(
            np.asarray(g) for g in vjp(jnp.asarray(case["w"])))
    results = tmesh.spawn(_aggregate_rank, P, "gloo", args=(case,))
    for key in results[0]:
        label = f"P={P} {key}"
        got = [torch.cat([res[key][i] for res in results]).numpy()
               for i in (0, 1)]
        tables = [sum(res[key][i] for res in results).numpy()
                  for i in (2, 3)]
        for g, want, what in zip(got + tables, refs[key[1]],
                                 ("out", "dx", "dt1", "dtk")):
            np.testing.assert_allclose(g, want, **ACT,
                                       err_msg=f"{label} {what}")
