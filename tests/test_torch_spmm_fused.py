"""The fused gather + edge-embedding form of the port's k-hop aggregation
against the JAX package's ``khop_spmm`` (Pallas in interpret mode on the
CPU, as tests/test_pallas.py runs it).

On the CPU the wrapper takes the fused plain version; the CUDA kernel is
held against that plain version on the card by chip_smoke.py.
Tolerances (f32): atol 1e-5 / rtol 1e-4 — the JAX side sums the gather
and the ``counts @ table`` matmuls separately, the port edge by edge.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import kpgnn_tpu.ops.pallas_spmm as ps
from kpgnn_tpu_torch.ops import spmm
from kpgnn_tpu_torch.utils.profiling import launch_counts

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-4)
V1, VK = 5, 7


def padded_case(seed, n_real=50, n_pad=128, e=180, K=4, D=8):
    """Edges among the first n_real of n_pad nodes (the loader pads the
    row space to its worst case, so most hop rows are empty), attr codes
    with 0 = hop absent."""
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, n_real, e).astype(np.int32)
    receivers = np.sort(rng.integers(0, n_real, e)).astype(np.int32)
    attr = rng.integers(0, VK, size=(e, K)).astype(np.int32)
    attr[:, 0] = rng.integers(0, V1, e)
    x = rng.normal(size=(K, n_pad, D)).astype(np.float32)
    t1 = rng.normal(size=(V1, D)).astype(np.float32)
    tk = rng.normal(size=(VK, D)).astype(np.float32)
    w = rng.normal(size=(K, n_pad, D)).astype(np.float32)
    return senders, receivers, attr, x, t1, tk, w


def grads_close(ours, theirs, rtol=1e-4):
    """rtol 1e-4 against the tensor's own scale (entries near zero carry
    the summation-order noise of the large ones)."""
    scale = float(np.abs(theirs).max())
    np.testing.assert_allclose(ours, theirs, rtol=rtol, atol=rtol * scale)


def jax_khop(jplan, x, t1, tk, w):
    """JAX hop-major khop_spmm output and grads of (x, table1, tablek)."""
    def loss(a, b, c):
        return jnp.sum(ps.khop_spmm(a, b, c, jplan, hop_major=True) * w)
    args = (jnp.asarray(x), jnp.asarray(t1), jnp.asarray(tk))
    out = ps.khop_spmm(*args, jplan, hop_major=True)
    return np.asarray(out), [np.asarray(g) for g in
                             jax.grad(loss, argnums=(0, 1, 2))(*args)]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_fused_plain_version_matches_jax_every_prefix(k):
    senders, receivers, attr, x, t1, tk, w = padded_case(seed=k)
    n = x.shape[1]
    jplan = ps.build_plan(receivers, senders, attr, n, V1, VK).slice_hops(k)
    plan = spmm.build_plan(receivers, senders, attr, n, V1, VK).slice_hops(k)
    jout, jgrads = jax_khop(jplan, x[:k], t1, tk, w[:k])

    xt, t1t, tkt = (torch.tensor(a, requires_grad=True)
                    for a in (x[:k].reshape(k * n, -1), t1, tk))
    f = plan.fwd
    out = spmm.gather_segment_sum_reference(
        xt, f.indptr, f.senders, f.n_rows, f.codes, t1t,
        tkt if k > 1 else None, n)
    np.testing.assert_allclose(out.detach().numpy().reshape(k, n, -1), jout,
                               **TOL)
    (out * torch.from_numpy(w[:k].reshape(k * n, -1))).sum().backward()
    grads_close(xt.grad.numpy().reshape(k, n, -1), jgrads[0])
    grads_close(t1t.grad.numpy(), jgrads[1])
    if k > 1:
        grads_close(tkt.grad.numpy(), jgrads[2])
    else:
        assert tkt.grad is None and not jgrads[2].any()


@pytest.mark.parametrize("k", [1, 2, 4])
def test_fused_khop_spmm_matches_jax_on_padded_rows(k):
    """khop_spmm's fused path (kernel wrapper + counts-matmul backward)."""
    senders, receivers, attr, x, t1, tk, w = padded_case(seed=10 + k)
    n = x.shape[1]
    jplan = ps.build_plan(receivers, senders, attr, n, V1, VK).slice_hops(k)
    plan = spmm.build_plan(receivers, senders, attr, n, V1, VK).slice_hops(k)
    jout, jgrads = jax_khop(jplan, x[:k], t1, tk, w[:k])
    targs = [torch.tensor(a, requires_grad=True) for a in (x[:k], t1, tk)]
    out = spmm.khop_spmm(*targs, plan, hop_major=True)
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    (out * torch.from_numpy(w[:k])).sum().backward()
    for t, g in zip(targs, jgrads):
        if t.grad is None:
            assert k == 1 and not g.any()
            continue
        grads_close(t.grad.numpy(), g)


def test_fused_backward_equals_autograd_of_plain_version():
    senders, receivers, attr, x, t1, tk, w = padded_case(seed=5)
    K, n = x.shape[:2]
    plan = spmm.build_plan(receivers, senders, attr, n, V1, VK)
    wt = torch.from_numpy(w.reshape(K * n, -1))
    a = [torch.tensor(v, requires_grad=True)
         for v in (x.reshape(K * n, -1), t1, tk)]
    (spmm._FusedKHop.apply(*a, plan) * wt).sum().backward()
    b = [torch.tensor(v, requires_grad=True)
         for v in (x.reshape(K * n, -1), t1, tk)]
    f = plan.fwd
    (spmm.gather_segment_sum_reference(b[0], f.indptr, f.senders, f.n_rows,
                                       f.codes, b[1], b[2], n)
     * wt).sum().backward()
    for ta, tb in zip(a, b):
        np.testing.assert_allclose(ta.grad.numpy(), tb.grad.numpy(), **TOL)


def test_table_gradients_row0_exactly_zero():
    senders, receivers, attr, x, t1, tk, w = padded_case(seed=6)
    n = x.shape[1]
    plan = spmm.build_plan(receivers, senders, attr, n, V1, VK)
    targs = [torch.tensor(a, requires_grad=True) for a in (x, t1, tk)]
    (spmm.khop_spmm(*targs, plan, hop_major=True)
     * torch.from_numpy(w)).sum().backward()
    for t in targs[1:]:
        assert t.grad[0].eq(0).all() and t.grad[1:].abs().sum() > 0


def test_hopcsr_cut_slices_codes_with_senders():
    senders, receivers, attr, x, *_ = padded_case(seed=7)
    n = x.shape[1]
    plan = spmm.build_plan(receivers, senders, attr, n, V1, VK)
    f = plan.fwd
    assert f.codes.dtype == torch.int32
    assert f.codes.shape == f.senders.shape
    for k in range(1, plan.K + 1):
        cut = f.cut(k, n, n)
        e = f.hop_ends[k - 1]
        assert cut.senders.shape[0] == cut.codes.shape[0] == e
        assert torch.equal(cut.codes, f.codes[:e])
        # every live edge carries its hop's attr code (> 0)
        assert bool((cut.codes > 0).all())
        assert torch.equal(plan.slice_hops(k).fwd.codes, cut.codes)


def test_hop_major_countsk_prefix_equals_node_major_slice():
    senders, receivers, attr, x, *_ = padded_case(seed=8)
    n = x.shape[1]
    plan = spmm.build_plan(receivers, senders, attr, n, V1, VK)
    jplan = ps.build_plan(receivers, senders, attr, n, V1, VK)
    np.testing.assert_array_equal(plan.countsk.numpy(),
                                  np.asarray(jplan.countsk))
    for k in range(2, plan.K + 1):
        hm = plan.slice_hops(k).countsk_hm
        assert hm.shape == (k - 1, n, VK) and hm.is_contiguous()
        assert torch.equal(hm.transpose(0, 1), plan.countsk[:, :k - 1])
    assert plan.slice_hops(1).countsk_hm is None


def test_fused_plain_version_by_hand():
    """Code 0 adds nothing; a null sender still adds its edge's table
    row; rows below rows_per_hop read table1, the rest tablek."""
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    t1 = torch.tensor([[100., 100.], [1., 2.], [3., 4.]])
    tk = torch.tensor([[200., 200.], [10., 20.]])
    indptr = torch.tensor([0, 2, 2, 3, 5], dtype=torch.int32)
    senders = torch.tensor([1, 9, 0, 3, 2], dtype=torch.int32)  # 9 null
    codes = torch.tensor([2, 1, 0, 1, 0], dtype=torch.int32)
    out = spmm.gather_segment_sum(x, indptr, senders, 4, codes=codes,
                                  table1=t1, tablek=tk, rows_per_hop=2)
    expect = torch.tensor([[2 + 3 + 1, 3 + 4 + 2],    # x1 + t1[2] + t1[1]
                           [0, 0],                     # empty row
                           [0, 1],                     # x0, code 0
                           [6 + 10 + 4, 7 + 20 + 5]])  # x3 + tk[1] + x2
    assert torch.equal(out, expect.float())
    # without tablek, hop >= 1 rows add no table row
    out = spmm.gather_segment_sum(x, indptr, senders, 4, codes=codes,
                                  table1=t1, rows_per_hop=2)
    assert torch.equal(out[3], torch.tensor([10., 12.]))


def test_fused_wrapper_rejects_bad_codes_and_tables():
    indptr = torch.tensor([0, 1, 2], dtype=torch.int32)
    senders = torch.tensor([1, 0], dtype=torch.int32)
    codes = torch.tensor([1, 2], dtype=torch.int32)
    x, t1, tk = torch.zeros(2, 4), torch.zeros(3, 4), torch.zeros(5, 4)

    def call(**kw):
        args = dict(codes=codes, table1=t1, tablek=tk, rows_per_hop=1)
        args.update(kw)
        return spmm.gather_segment_sum(x, indptr, senders, 2, **args)

    call()
    with pytest.raises(TypeError, match="codes must be int32"):
        call(codes=codes.long())
    with pytest.raises(ValueError, match="codes for"):
        call(codes=codes[:1])
    with pytest.raises(ValueError, match="table1 must be"):
        call(table1=torch.zeros(3, 5))
    with pytest.raises(ValueError, match="tablek must be"):
        call(tablek=torch.zeros(5, 3))
    with pytest.raises(TypeError, match="tablek must be float32"):
        call(tablek=tk.double())
    with pytest.raises(ValueError, match="need table1"):
        call(table1=None)
    with pytest.raises(ValueError, match="rows_per_hop"):
        call(rows_per_hop=0)


def test_khop_spmm_rejects_tables_of_other_vocabularies():
    senders, receivers, attr, x, t1, tk, w = padded_case(seed=9)
    plan = spmm.build_plan(receivers, senders, attr, x.shape[1], V1, VK)
    args = [torch.from_numpy(a) for a in (x, t1, tk)]
    with pytest.raises(ValueError, match="vocabularies"):
        spmm.khop_spmm(args[0], args[1][:3], args[2], plan, hop_major=True)
    with pytest.raises(ValueError, match="vocabularies"):
        spmm.khop_spmm(args[0], args[1], args[2][:4], plan, hop_major=True)


def test_cpu_calls_count_no_launch_and_variant_names():
    senders, receivers, attr, x, t1, tk, w = padded_case(seed=3)
    plan = spmm.build_plan(receivers, senders, attr, x.shape[1], V1, VK)
    before = dict(launch_counts("gather_segment_sum"))
    spmm.khop_spmm(*(torch.from_numpy(a) for a in (x, t1, tk)), plan,
                   hop_major=True)
    assert dict(launch_counts("gather_segment_sum")) == before
    assert spmm.variant_name(torch.float32, True, True) \
        == "gather_segment_sum_fused[f32,vec]"
    assert spmm.variant_name(torch.bfloat16, False, False) \
        == "gather_segment_sum[bf16,scalar]"


def test_hop_live_marks_each_hops_last_row_with_an_edge():
    senders, receivers, attr, x, *_ = padded_case(seed=4)
    n = x.shape[1]
    plan = spmm.build_plan(receivers, senders, attr, n, V1, VK)
    for csr in (plan.fwd, plan.bwd):
        assert csr.rows_per_hop == n and len(csr.hop_live) == plan.K
        deg = np.diff(csr.indptr.numpy()).reshape(plan.K, n)
        for k, live in enumerate(csr.hop_live):
            assert not deg[k, live:].any()         # the dead suffix
            assert live == 0 or deg[k, live - 1] > 0
        assert csr.cut(2, n, n).hop_live == csr.hop_live[:2]
    empty, _ = spmm.build_csr(np.zeros(0, int), np.zeros(0, int), 8, 8, 4)
    assert empty.hop_live == (0, 0)


def test_gather_rejects_hop_live_that_does_not_fit():
    csr, _ = spmm.build_csr(np.array([0, 5]), np.array([1, 0]), 8, 8, 4)
    assert csr.hop_live == (1, 2)
    x = torch.ones(8, 4)
    assert torch.equal(csr.gather(x), spmm.gather_segment_sum(
        x, csr.indptr, csr.senders, 8))
    for bad in (dict(rows_per_hop=0), dict(hop_live=(1, 2, 0)),
                dict(hop_live=(5, 0))):
        kw = dict(rows_per_hop=4, hop_live=(1, 2))
        kw.update(bad)
        with pytest.raises(ValueError, match="hop_live"):
            spmm.gather_segment_sum(x, csr.indptr, csr.senders, 8, **kw)


def test_gather_rejects_rows_that_are_not_whole_hops():
    csr, _ = spmm.build_csr(np.array([0, 5]), np.array([1, 0]), 8, 8, 4)
    with pytest.raises(ValueError, match="whole hops"):
        spmm.gather_segment_sum(torch.ones(8, 4), csr.indptr, csr.senders, 8,
                                rows_per_hop=3)


@pytest.mark.parametrize("rows_per_hop, hop_live, expect", [
    (0, (), (8, (8,))),                 # no hop structure: one live hop
    (4, (), (4, (4, 4))),               # hops live to their end
    (4, (1, 0), (4, (1, 0))),           # the plan's own
    (0, (), (0, (0,))),                 # no rows
])
def test_hop_layout_is_what_the_kernel_takes(rows_per_hop, hop_live, expect):
    n_rows = expect[0] * len(expect[1])
    assert spmm.hop_layout(n_rows, rows_per_hop, hop_live) == expect


def test_hop_layout_raises_beyond_the_kernels_hops():
    n = spmm.MAX_HOPS
    assert spmm.hop_layout(2 * n, 2, ()) == (2, (2,) * n)
    with pytest.raises(ValueError, match="at most"):
        spmm.hop_layout(2 * (n + 1), 2, ())
