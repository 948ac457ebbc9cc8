"""The port's gather/segment-sum and k-hop aggregation against the JAX
package's Pallas kernel (run in interpret mode on the CPU).

On the CPU the port's ``gather_segment_sum`` takes its plain version;
the CUDA kernel itself is held against that plain version on the card by
chip_smoke.py.  Tolerances (f32): forward atol 1e-5 / rtol 1e-4, grads
rtol 1e-4 — the two sides sum edges in different orders.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kpgnn_tpu.ops.pallas_spmm as ps
from kpgnn_tpu.ops.adjacency import COOAdj, degree as jdegree
from kpgnn_tpu.ops.adjacency import union_in_degree as junion
from kpgnn_tpu_torch.ops import spmm
from kpgnn_tpu_torch.ops.adjacency import (degree, hop_major_native,
                                           khop_aggregate_adj)
from kpgnn_tpu_torch.ops.adjacency import union_in_degree

torch.set_num_threads(1)
FWD = dict(atol=1e-5, rtol=1e-4)


def edges(name, rng):
    """(receivers, senders, n_rows, n_cols, D) of one kernel case."""
    if name == "basic":
        n, e = 256, 600
        return (rng.integers(0, n, e), rng.integers(0, n - 1, e), n, n, 16)
    if name == "heavy_row":
        n, e = 256, 900
        recv = np.where(np.arange(e) < 400, 17, rng.integers(0, n, e))
        return recv, rng.integers(0, n - 1, e), n, n, 8
    if name == "hub":
        n = 1024
        recv = np.concatenate([np.full(2000, 3), rng.integers(0, n, 800)])
        return recv, rng.integers(0, n - 1, 2800), n, n, 13
    if name == "multi_window":
        n, e = 384, 900
        return rng.integers(0, n, e), rng.integers(0, n - 1, e), n, n, 24
    if name == "rectangular":
        nr, nc, e = 256, 384, 700
        return rng.integers(0, nr, e), rng.integers(0, nc, e), nr, nc, 16
    if name == "graph_sorted":
        n, gsize = 1024, 32
        s, r = [], []
        for g0 in range(0, n - gsize, gsize):          # intra-graph edges
            s.append(rng.integers(g0, g0 + gsize, 40))
            r.append(rng.integers(g0, g0 + gsize, 40))
        return np.concatenate(r), np.concatenate(s), n, n, 8
    raise KeyError(name)


CASES = ["basic", "heavy_row", "hub", "multi_window", "rectangular",
         "graph_sorted"]


@pytest.mark.parametrize("name", CASES)
def test_gather_segment_sum_matches_jax_kernel(name):
    rng = np.random.default_rng(CASES.index(name))
    recv, send, nr, nc, D = edges(name, rng)
    recv, send = recv.astype(np.int32), send.astype(np.int32)
    x = rng.normal(size=(nc, D)).astype(np.float32)
    jcsr = ps._build_one(recv, send, nr, 128, n_cols=nc,
                         wblock=128 if name == "multi_window" else 512)
    if name == "multi_window":
        assert jcsr.max_wblocks > 1
    expect = np.asarray(ps.gather_segment_sum(jnp.asarray(x), jcsr,
                                              interpret=True))
    csr, _ = spmm.build_csr(recv, send, nr, nc)
    out = spmm.gather_segment_sum(torch.from_numpy(x), csr.indptr,
                                  csr.senders, csr.n_rows)
    assert out.dtype == torch.float32 and out.shape == (nr, D)
    np.testing.assert_allclose(out.numpy(), expect, **FWD)


def test_gather_segment_sum_null_senders_and_empty_rows():
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    indptr = torch.tensor([0, 0, 3, 3, 5], dtype=torch.int32)
    senders = torch.tensor([1, 4, 3, 7, 0], dtype=torch.int32)  # 4, 7 null
    out = spmm.gather_segment_sum(x, indptr, senders, 4)
    xn = x.numpy()
    expect = np.zeros((4, 3), np.float32)
    expect[1] = xn[1] + xn[3]
    expect[3] = xn[0]
    np.testing.assert_array_equal(out.numpy(), expect)


def test_gather_segment_sum_bf16_accumulates_in_f32():
    rng = np.random.default_rng(5)
    csr, _ = spmm.build_csr(rng.integers(0, 64, 500),
                            rng.integers(0, 64, 500), 64, 64)
    xb = torch.from_numpy(rng.normal(size=(64, 13)).astype(np.float32)
                          ).to(torch.bfloat16)
    out = spmm.gather_segment_sum(xb, csr.indptr, csr.senders, 64)
    ref = spmm.gather_segment_sum(xb.float(), csr.indptr, csr.senders, 64)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6)


def test_gather_segment_sum_rejects_other_devices_and_types():
    csr, _ = spmm.build_csr(np.array([0, 1]), np.array([1, 0]), 2, 2)
    with pytest.raises(ValueError, match="no kernel"):
        spmm.gather_segment_sum(torch.zeros(2, 4, device="meta"),
                                csr.indptr.to("meta"),
                                csr.senders.to("meta"), 2)
    with pytest.raises(TypeError):
        spmm.gather_segment_sum(torch.zeros(2, 4, dtype=torch.float64),
                                csr.indptr, csr.senders, 2)
    with pytest.raises(TypeError):
        spmm.gather_segment_sum(torch.zeros(2, 4), csr.indptr.long(),
                                csr.senders, 2)
    before = dict(spmm.gather_segment_sum.variant_launches)
    spmm.gather_segment_sum(torch.zeros(2, 4), csr.indptr, csr.senders, 2)
    assert dict(spmm.gather_segment_sum.variant_launches) == before  # plain


def khop_case(seed=0, n=256, e=700, K=3, D=8, V1=5, Vk=7):
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, n - 1, e).astype(np.int32)
    receivers = np.sort(rng.integers(0, n - 1, e)).astype(np.int32)
    attr = rng.integers(0, Vk, size=(e, K)).astype(np.int32)
    attr[:, 0] = rng.integers(0, V1, e)
    x = rng.normal(size=(n, K, D)).astype(np.float32)
    t1 = rng.normal(size=(V1, D)).astype(np.float32)
    tk = rng.normal(size=(Vk, D)).astype(np.float32)
    return senders, receivers, attr, x, t1, tk


def both_plans(senders, receivers, attr, n, V1, Vk):
    return (ps.build_plan(receivers, senders, attr, n, V1, Vk),
            spmm.build_plan(receivers, senders, attr, n, V1, Vk))


def grads_close(ours, theirs, rtol=1e-4):
    """rtol 1e-4 against the tensor's own scale (entries near zero carry
    the summation-order noise of the large ones)."""
    scale = float(np.abs(theirs).max())
    np.testing.assert_allclose(ours, theirs, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("hop_major", [False, True])
def test_khop_spmm_forward_and_grads_every_prefix(hop_major):
    senders, receivers, attr, x, t1, tk = khop_case(seed=3, n=128, e=300)
    n, K = x.shape[0], attr.shape[1]
    jplan, tplan = both_plans(senders, receivers, attr, n, 5, 7)
    w_all = np.cos(np.arange(x.size).reshape(x.shape) * 0.01
                   ).astype(np.float32)
    for k in range(1, K + 1):
        xk, wk = x[:, :k], w_all[:, :k]
        if hop_major:
            xk, wk = xk.transpose(1, 0, 2).copy(), wk.transpose(1, 0, 2).copy()
        jp, tp = jplan.slice_hops(k), tplan.slice_hops(k)
        assert tp.K == k and tp.fwd.n_rows == k * n

        def jloss(a, b, c):
            return jnp.sum(ps.khop_spmm(a, b, c, jp, hop_major=hop_major)
                           * wk)
        jargs = (jnp.asarray(xk), jnp.asarray(t1), jnp.asarray(tk))
        jout = ps.khop_spmm(*jargs, jp, hop_major=hop_major)
        jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)

        targs = [torch.tensor(a, requires_grad=True) for a in (xk, t1, tk)]
        tout = spmm.khop_spmm(*targs, tp, hop_major=hop_major)
        np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                                   **FWD)
        (tout * torch.from_numpy(wk)).sum().backward()
        for t, g, name in zip(targs, jgrads, ("x", "table1", "tablek")):
            if k == 1 and name == "tablek":
                assert t.grad is None or not t.grad.any()
                continue
            grads_close(t.grad.numpy(), np.asarray(g))


@pytest.mark.parametrize("variant", ["scale", "sender_scale", "both",
                                     "mean"])
def test_khop_spmm_variants_match_jax(variant):
    senders, receivers, attr, x, t1, tk = khop_case(seed=7)
    n, K = x.shape[0], attr.shape[1]
    rng = np.random.default_rng(8)
    s_i = rng.uniform(0.5, 2.0, (n, K)).astype(np.float32)
    s_j = rng.uniform(0.5, 2.0, (n, K)).astype(np.float32)
    kw = {"scale": dict(scale=s_i), "sender_scale": dict(sender_scale=s_j),
          "both": dict(scale=s_i, sender_scale=s_j),
          "mean": dict(aggr="mean")}[variant]
    jplan, tplan = both_plans(senders, receivers, attr, n, 5, 7)
    jout = ps.khop_spmm(jnp.asarray(x), jnp.asarray(t1), jnp.asarray(tk),
                        jplan, **{k: jnp.asarray(v) if k != "aggr" else v
                                  for k, v in kw.items()})
    tout = spmm.khop_spmm(torch.from_numpy(x), torch.from_numpy(t1),
                          torch.from_numpy(tk), tplan,
                          **{k: torch.from_numpy(v) if k != "aggr" else v
                             for k, v in kw.items()})
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **FWD)


def test_khop_spmm_max_raises():
    senders, receivers, attr, x, t1, tk = khop_case(seed=1)
    plan = spmm.build_plan(receivers, senders, attr, x.shape[0], 5, 7)
    with pytest.raises(ValueError, match="max"):
        spmm.khop_spmm(torch.from_numpy(x), torch.from_numpy(t1),
                       torch.from_numpy(tk), plan, aggr="max")


def test_slice_hops_equals_plan_of_prefix_columns():
    senders, receivers, attr, x, t1, tk = khop_case(seed=21, K=4)
    n = x.shape[0]
    plan = spmm.build_plan(receivers, senders, attr, n, 5, 7)
    for k in (1, 2, 3):
        sub = plan.slice_hops(k)
        ref = spmm.build_plan(receivers, senders, attr[:, :k], n, 5, 7)
        for d in ("fwd", "bwd"):
            a, b = getattr(sub, d), getattr(ref, d)
            assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols)
            assert torch.equal(a.indptr, b.indptr)
            assert torch.equal(a.senders, b.senders)
        assert torch.equal(sub.fwd.codes, ref.fwd.codes)
        assert sub.bwd.codes is None and ref.bwd.codes is None
        for f in ("edge_recv", "hop_deg", "union_deg"):
            assert torch.equal(getattr(sub, f), getattr(ref, f)), f
        if k > 1:
            assert torch.equal(sub.countsk_hm, ref.countsk_hm)
        else:
            assert sub.countsk_hm is None and ref.countsk_hm is None


def test_plan_degrees_match_jax_coo():
    senders, receivers, attr, x, t1, tk = khop_case(seed=11)
    n = x.shape[0]
    plan = spmm.build_plan(receivers, senders, attr, n, 5, 7)
    adj = COOAdj(senders=jnp.asarray(senders),
                 receivers=jnp.asarray(receivers),
                 edge_attr=jnp.asarray(attr),
                 edge_mask=jnp.ones(len(senders), bool), n_nodes=n)
    np.testing.assert_array_equal(degree(plan, add_self_loop=True).numpy(),
                                  np.asarray(jdegree(adj, True)))
    np.testing.assert_array_equal(union_in_degree(plan).numpy(),
                                  np.asarray(junion(adj)))


def test_adjacency_dispatch_matches_khop_spmm():
    senders, receivers, attr, x, t1, tk = khop_case(seed=12)
    plan = spmm.build_plan(receivers, senders, attr, x.shape[0], 5, 7)
    args = [torch.from_numpy(a) for a in (x, t1, tk)]
    np.testing.assert_array_equal(
        khop_aggregate_adj(plan, *args).numpy(),
        spmm.khop_spmm(*args, plan).numpy())
    with pytest.raises(NotImplementedError,
                       match="COOAdj, KHopPlan, DenseAdj or BandedAdj"):
        khop_aggregate_adj(object(), *args)
    assert hop_major_native(plan) and not hop_major_native(object())
