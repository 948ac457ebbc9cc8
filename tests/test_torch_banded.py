"""The port's banded backend (``ops/banded.py``, ``collate_banded``, the
loader's banded mode, the layers on a banded plan) against the JAX
package's ``banded_khop_aggregate`` and against the COO oracle of
``tests/test_banded.py``.

Host-side plans, collated batches and the loader's pins are compared
array for array; f32 outputs at atol 1e-5 / rtol 1e-4 (the window
product and the oracle sum in different orders), gradients at rtol 1e-4
with an atol of 1e-4 of the gradient's scale, losses at rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kpgnn_tpu.graph.batch as jbatch
import kpgnn_tpu.models as jmodels
import kpgnn_tpu.ops.adjacency as jadjacency
from kpgnn_tpu.graph.data import Graph as JGraph
from kpgnn_tpu.ops import banded as jbanded
from kpgnn_tpu.train.loader import GraphLoader as JGraphLoader
from kpgnn_tpu.train.loop import train_step_body
from kpgnn_tpu.train.state import create_train_state
from kpgnn_tpu_torch.graph import batch as tbatch
from kpgnn_tpu_torch.graph.data import Graph
from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.ops import adjacency, banded
from kpgnn_tpu_torch.train.loader import GraphLoader
from kpgnn_tpu_torch.train.loop import train_step
from kpgnn_tpu_torch.train.state import make_optimizer
from kpgnn_tpu_torch.utils.convert import params_from_flax
from tests.test_banded import banded_case, oracle
from tests.test_torch_layers import flat
from tests.test_torch_model import FLAGSHIP_SMALL, PREP_SMALL
from tests.test_torch_prep_batch import NODE_FIELDS, both_prep, raw_molecules

torch.set_num_threads(1)
ACT = dict(atol=1e-5, rtol=1e-4)
PLAN_ARRAYS = ("live", "counts1", "countsk", "union_deg", "hop_deg",
               "spill_senders", "spill_rows", "spill_weights")
PLAN_STATIC = ("spill_hop_ends", "sender_scaled", "spill_sorted", "tile",
               "halo", "n_hops", "n_cols_static")


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def assert_plan_equal(jp, tp):
    """A JAX plan and a port plan: every array equal, in JAX's 32-bit
    canonical dtypes, and every static field equal."""
    for f in PLAN_ARRAYS:
        a, b = getattr(jp, f), getattr(tp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a = np.asarray(a)
            assert jnp.asarray(b.numpy()).dtype == a.dtype, f
            np.testing.assert_array_equal(b.numpy(), a, err_msg=f)
    for f in PLAN_STATIC:
        assert getattr(jp, f) == getattr(tp, f), f


def both_aggregates(x, t1, tk, jp, tp, **kw):
    """(JAX out, port out) of the same aggregation; kw as
    khop_aggregate_adj takes it (scale a numpy array)."""
    sc = kw.pop("scale", None)
    jo = jbanded.banded_khop_aggregate(
        jnp.asarray(x), jnp.asarray(t1),
        None if tk is None else jnp.asarray(tk), jp,
        scale=None if sc is None else jnp.asarray(sc), **kw)
    to = banded.banded_khop_aggregate(t(x), t(t1), t(tk), tp, scale=t(sc),
                                      **kw)
    return np.asarray(jo), to.numpy()


# ---- the plan ----

BUILD_CASES = {
    "auto halo": (dict(seed=1), {}),
    "auto halo, long edges": (dict(seed=2, long_edges=40), {}),
    "halo_cap": (dict(seed=3, long_edges=40), dict(halo_cap=64)),
    "tile 128": (dict(seed=4), dict(tile=128)),
    "spill_pad": (dict(seed=5, long_edges=10), dict(halo=64,
                                                     spill_pad=256)),
    "spill_pad, no spill": (dict(seed=6), dict(spill_pad=32)),
    "sender_weights": (dict(seed=7, long_edges=12), dict(halo=64)),
    "n_cols": (dict(seed=8, long_edges=12), dict(halo=64)),
}


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_build_banded_equals_jax(case):
    data, kw = BUILD_CASES[case]
    s, r, a, x, t1, tk = banded_case(**data)
    n, K = x.shape[0], x.shape[1]
    if case == "sender_weights":
        kw = dict(kw, sender_weights=np.random.default_rng(0).uniform(
            0.2, 1.0, size=(n, K)).astype(np.float32))
    if case == "n_cols":
        kw = dict(kw, n_cols=n + 128)
    jp = jbanded.build_banded(r, s, a, n, t1.shape[0], tk.shape[0], **kw)
    tp = banded.build_banded(r, s, a, n, t1.shape[0], tk.shape[0], **kw)
    assert_plan_equal(jp, tp)
    np_plan = banded.build_banded(r, s, a, n, t1.shape[0], tk.shape[0],
                                  as_numpy=True, **kw)
    assert isinstance(np_plan.live, np.ndarray)
    np.testing.assert_array_equal(np_plan.live, tp.live.numpy())
    if case == "spill_pad":
        assert tp.spill_rows.shape == (256,) and tp.spill_hop_ends == ()
    if case in ("halo_cap", "sender_weights"):
        assert tp.halo == 64 and tp.spill_senders is not None


def test_build_banded_errors_equal_jax():
    s, r, a, x, t1, tk = banded_case(seed=9, long_edges=20)
    n = x.shape[0]
    for kw, match in ((dict(halo=64, spill_pad=4), "spill_pad"),
                      (dict(halo=320), "exceeds tile")):
        for build in (jbanded.build_banded, banded.build_banded):
            with pytest.raises(ValueError, match=match):
                build(r, s, a, n, t1.shape[0], tk.shape[0], **kw)


# ---- the aggregation ----

AGG_CASES = {
    "add": (dict(seed=0), {}, {}),
    "hop-major": (dict(seed=3), {}, dict(hop_major=True)),
    "scale": (dict(seed=5), {}, dict(scale=True)),
    "mean": (dict(seed=5), {}, dict(aggr="mean")),
    "spill, long edges": (dict(seed=7, long_edges=40), dict(halo=64), {}),
    "spill, mean and scale": (dict(seed=7, long_edges=40), dict(halo=64),
                              dict(aggr="mean", scale=True)),
    "padded spill": (dict(seed=17, long_edges=10),
                     dict(halo=64, spill_pad=256), {}),
}


@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_aggregate_equals_jax_and_the_oracle(case):
    data, build_kw, kw = AGG_CASES[case]
    s, r, a, x, t1, tk = banded_case(**data)
    n, K = x.shape[0], x.shape[1]
    jp = jbanded.build_banded(r, s, a, n, t1.shape[0], tk.shape[0],
                              **build_kw)
    tp = banded.build_banded(r, s, a, n, t1.shape[0], tk.shape[0],
                             **build_kw)
    sc = None
    if kw.pop("scale", False):
        sc = np.random.default_rng(0).uniform(0.5, 2.0, (n, K)).astype(
            np.float32)
    want = oracle(s, r, a, x, t1, tk, sc, kw.get("aggr", "add"))
    xin = x.transpose(1, 0, 2).copy() if kw.get("hop_major") else x
    jo, to = both_aggregates(xin, t1, tk, jp, tp, scale=sc, **kw)
    if kw.get("hop_major"):
        assert to.shape == xin.shape
        jo, to = jo.transpose(1, 0, 2), to.transpose(1, 0, 2)
    np.testing.assert_allclose(to, jo, **ACT)
    np.testing.assert_allclose(to, want, **ACT)


@pytest.mark.parametrize("spill_pad", [None, 256])
def test_slice_hops_every_k(spill_pad):
    """Every hop prefix, with the static hop cuts and with the padded
    list whose rows of hops >= k (and its sentinel rows) must drop."""
    s, r, a, x, t1, tk = banded_case(seed=9, long_edges=16)
    n = x.shape[0]
    jp = jbanded.build_banded(r, s, a, n, t1.shape[0], tk.shape[0],
                              halo=64, spill_pad=spill_pad)
    tp = banded.build_banded(r, s, a, n, t1.shape[0], tk.shape[0],
                             halo=64, spill_pad=spill_pad)
    for k in (1, 2, 3):
        js, ts = jp.slice_hops(k), tp.slice_hops(k)
        assert ts.K == k
        assert_plan_equal(js, ts)
        tkk = tk if k > 1 else None
        jo, to = both_aggregates(x[:, :k].copy(), t1, tkk, js, ts)
        np.testing.assert_allclose(to, jo, **ACT)
        np.testing.assert_allclose(
            to, oracle(s, r, a[:, :k], x[:, :k], t1, tkk), **ACT)


def test_mask_is_cast_once_per_plan():
    """Every hop slice reads a view of the one cast of the plan's mask."""
    s, r, a, x, t1, tk = banded_case(seed=2)
    tp = banded.build_banded(r, s, a, x.shape[0], t1.shape[0], tk.shape[0])
    assert tp.live.dtype == torch.int8
    sub = tp.slice_hops(1)
    m1 = sub.mask(torch.float32)            # a slice asks first
    full = tp.mask(torch.float32)
    assert full.shape == tp.live.shape and m1.shape[0] == 1
    assert m1.data_ptr() == full.data_ptr()
    assert tp.slice_hops(2).mask(torch.float32).data_ptr() == full.data_ptr()
    assert torch.equal(full, tp.live.float())
    moved = tp.to("cpu")
    assert moved.mask_cache is not tp.mask_cache


@pytest.mark.parametrize("case", ["spill", "padded spill", "sender-scaled"])
def test_gradients_of_x_and_tables_equal_jax(case):
    s, r, a, x, t1, tk = banded_case(seed=11, long_edges=8)
    n, K = x.shape[0], x.shape[1]
    kw = dict(halo=64)
    if case == "padded spill":
        kw["spill_pad"] = 64
    if case == "sender-scaled":
        kw["sender_weights"] = np.random.default_rng(1).uniform(
            0.2, 1.0, (n, K)).astype(np.float32)
    sc = np.random.default_rng(2).uniform(0.5, 2.0, (n, K)).astype(np.float32)
    jp = jbanded.build_banded(r, s, a, n, t1.shape[0], tk.shape[0], **kw)
    tp = banded.build_banded(r, s, a, n, t1.shape[0], tk.shape[0], **kw)

    def jloss(xx, a1, ak):
        out = jbanded.banded_khop_aggregate(xx, a1, ak, jp,
                                            scale=jnp.asarray(sc))
        return jnp.sum(out * jnp.cos(out))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(t1),
                                           jnp.asarray(tk))
    args = [torch.tensor(v, requires_grad=True) for v in (x, t1, tk)]
    out = adjacency.khop_aggregate_adj(tp, *args, scale=t(sc))
    (out * torch.cos(out)).sum().backward()
    for name, got, want in zip(("x", "table1", "tablek"), args, jg):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.grad.numpy(), want, rtol=1e-4,
            atol=1e-4 * float(np.abs(want).max()), err_msg=name)
        assert not np.all(want == 0), name


def test_rejects_sender_scale_and_max():
    s, r, a, x, t1, tk = banded_case(seed=13)
    tp = banded.build_banded(r, s, a, x.shape[0], t1.shape[0], tk.shape[0])
    with pytest.raises(ValueError, match="sender_scale"):
        adjacency.khop_aggregate_adj(tp, t(x), t(t1), t(tk),
                                     sender_scale=torch.ones(x.shape[:2]))
    with pytest.raises(ValueError, match="aggr='max'"):
        adjacency.khop_aggregate_adj(tp, t(x), t(t1), t(tk), aggr="max")


def test_degree_helpers_equal_jax():
    s, r, a, x, t1, tk = banded_case(seed=15, long_edges=12)
    n = x.shape[0]
    jp = jbanded.build_banded(r, s, a, n, t1.shape[0], tk.shape[0], halo=64)
    tp = banded.build_banded(r, s, a, n, t1.shape[0], tk.shape[0], halo=64)
    assert adjacency.hop_major_native(tp)
    for add in (False, True):
        np.testing.assert_array_equal(
            adjacency.degree(tp, add).numpy(),
            np.asarray(jadjacency.degree(jp, add)))
    np.testing.assert_array_equal(adjacency.union_in_degree(tp).numpy(),
                                  np.asarray(jadjacency.union_in_degree(jp)))


# ---- collate_banded and the loader ----

def chain_graphs(seed, count, span, n_lo=260, n_hi=300, K=2, chords=2):
    """(JAX graphs, port graphs) of the same chains with ``chords`` long
    edges of span ``span`` each and random hop attrs (some dead)."""
    rng = np.random.default_rng(seed)
    js, ts = [], []
    for _ in range(count):
        n = int(rng.integers(n_lo, n_hi))
        src = np.arange(n - 1)
        a = rng.integers(0, n - span, chords)
        s = np.concatenate([src, src + 1, a])
        r = np.concatenate([src + 1, src, a + span])
        ei = np.stack([s, r]).astype(np.int32)
        e = ei.shape[1]
        ea = rng.integers(1, 6, size=(e, K)).astype(np.int32)
        ea[rng.random((e, K)) < 0.2] = 0
        f = dict(num_nodes=n, edge_index=ei, edge_attr=ea,
                 x=rng.integers(0, 21, size=(n, 1)),
                 y=rng.normal(size=(1,)).astype(np.float32),
                 pe_attr=rng.integers(0, 6, size=(n, K - 1)).astype(
                     np.int32))
        js.append(JGraph(**f))
        ts.append(Graph(**f))
    return js, ts


def assert_batch_equal(jb, tb):
    assert jb.n_pad == tb.n_pad and jb.g_pad == tb.g_pad
    for f in NODE_FIELDS + ("graph_mask",):
        a, b = getattr(jb, f), getattr(tb, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f)
    assert_plan_equal(jb.adj, tb.adj)


@pytest.mark.parametrize("span,tile", [(40, 128), (200, 256)])
@pytest.mark.parametrize("gcn_norm", [False, True])
def test_collate_banded_equals_jax(span, tile, gcn_norm):
    """The auto tile (128 under a span-estimated halo <= 128, else 256),
    n_pad rounded to it, and gcn_norm's folded (deg + 1)^-0.5."""
    js, ts = chain_graphs(span, 3, span)
    jb = jbatch.collate_banded(js, v1=6, vk=7, gcn_norm=gcn_norm)
    tb = tbatch.collate_banded(ts, v1=6, vk=7, gcn_norm=gcn_norm)
    assert tb.adj.tile == tile and tb.n_pad % tile == 0
    assert tb.adj.sender_scaled == gcn_norm
    assert_batch_equal(jb, tb)
    # a pinned halo and spill pad, as the loader gives them
    jb = jbatch.collate_banded(js, v1=6, vk=7, halo=64, spill_pad=64,
                               n_pad=1024, gcn_norm=gcn_norm)
    tb = tbatch.collate_banded(ts, v1=6, vk=7, halo=64, spill_pad=64,
                               n_pad=1024, gcn_norm=gcn_norm)
    assert tb.adj.spill_rows.shape == (64,)
    assert_batch_equal(jb, tb)


@pytest.mark.parametrize("gcn_norm", [False, True])
def test_banded_loader_equals_jax(gcn_norm):
    """The loader's pins (the dataset's worst-case halo and spill pad),
    its pad sizes and every shuffled batch, array for array; every batch
    has one shape."""
    # chords of span 300 reach beyond the capped dataset halo and spill
    js, ts = chain_graphs(3, 12, 300, n_lo=520, n_hi=640, chords=3)
    kw = dict(batch_size=4, shuffle=True, seed=0, mode="banded", v1=6,
              vk=6, banded_gcn_norm=gcn_norm)
    jl, tl = JGraphLoader(js, **kw), GraphLoader(ts, **kw)
    assert (tl.banded_halo, tl.banded_spill_pad) == (jl.banded_halo,
                                                     jl.banded_spill_pad)
    assert (tl.n_pad, tl.e_pad, tl.g_pad) == (jl.n_pad, jl.e_pad, jl.g_pad)
    assert tl.banded_spill_pad and tl.banded_halo == 256
    shapes = set()
    for jb, tb in zip(jl, tl):
        assert_batch_equal(jb, tb)
        shapes.add((tb.n_pad, tuple(tb.adj.live.shape),
                    tuple(tb.adj.spill_rows.shape)))
    assert len(shapes) == 1, shapes


# ---- the layers and models on a banded plan ----

MODEL_CASES = [("KPGIN", None), ("KPGINPlus", 0), ("KPGraphSAGE", None),
               ("KPGCN", 0)]


@pytest.mark.parametrize("name,halo", MODEL_CASES)
def test_model_forward_and_adamw_step_equal_jax(name, halo):
    """Each family's model on the same collated banded batch in both
    packages, with carried weights: the loss of the forward and the loss
    after one AdamW step.  halo=0 sends every cross-tile edge through the
    spill; KPGINPlus slices the plan's hops per layer window; KPGCN takes
    the gcn_norm plan."""
    cfg = dict(FLAGSHIP_SMALL, model_name=name, hidden_size=12, num_layer=3)
    if name == "KPGraphSAGE":
        cfg["aggr"] = "mean"
    js, ts = both_prep(raw_molecules(10, seed=13), **PREP_SMALL)
    kw = dict(v1=5, vk=11, halo=halo, gcn_norm=name == "KPGCN")
    jb = jbatch.collate_banded(js, **kw)
    tb = tbatch.collate_banded(ts, **kw)
    assert_batch_equal(jb, tb)
    if halo == 0:
        assert tb.adj.spill_senders is not None
    jmodel = jmodels.make_model(jmodels.ModelConfig(**cfg))
    tmodel = make_model(ModelConfig(**cfg))
    state, tx = create_train_state(jmodel, jb, jax.random.PRNGKey(0),
                                   lr=1e-3, l2_wd=1e-4)
    tmodel.load_state_dict(params_from_flax(flat(state.variables)),
                           strict=True)
    opt = make_optimizer(tmodel.parameters(), lr=1e-3, l2_wd=1e-4)
    assert isinstance(opt, torch.optim.AdamW)
    jstep = jax.jit(train_step_body(jmodel, tx, "l1"))
    jl, tl = [], []
    for _ in range(2):
        state, m = jstep(state, jb, jax.random.PRNGKey(1))
        jl.append(float(m["loss_sum"]) / float(m["count"]))
        lsum, cnt = train_step(tmodel, opt, tb, "l1")
        tl.append(float(lsum) / float(cnt))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert jl[0] != jl[1]


def test_plain_plan_refuses_kpgcn():
    cfg = dict(FLAGSHIP_SMALL, model_name="KPGCN", hidden_size=12,
               num_layer=3)
    _, ts = both_prep(raw_molecules(3, seed=2), **PREP_SMALL)
    tb = tbatch.collate_banded(ts, v1=5, vk=11)
    with pytest.raises(ValueError, match="gcn_norm"):
        make_model(ModelConfig(**cfg))(tb, train=False)


def test_cli_takes_the_banded_backend_and_refuses_max_on_it():
    """``--backend banded``: KPGCN's loader gets the gcn_norm plan;
    ``--aggr max`` exits as in the JAX CLI; under ``--parallel node`` the
    loader collates COO and the banded plan attaches at partition time,
    as in the JAX CLI."""
    from kpgnn_tpu_torch.scripts import common

    p = common.base_parser("banded")
    mcfg = ModelConfig(**dict(FLAGSHIP_SMALL, model_name="KPGCN",
                              hidden_size=12, num_layer=3))
    args = p.parse_args(["--backend", "banded", "--model_name", "KPGCN"])
    assert common.loader_kwargs(args, mcfg) == {
        "mode": "banded", "v1": 5, "vk": 11, "banded_gcn_norm": True}
    with pytest.raises(SystemExit, match="--aggr max is not available on "
                       "the banded backend"):
        common.loader_kwargs(p.parse_args(["--backend", "banded", "--aggr",
                                           "max"]), mcfg)
    node = p.parse_args(["--backend", "banded", "--parallel", "node"])
    assert common.loader_kwargs(node, mcfg) == {"mode": "coo"}
