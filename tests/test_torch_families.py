"""The port's KP layer families, backbones, COO backend and norms against
the JAX package, on both of the port's backends.

* the seven golden bundles, module by module, with their stored weights,
  on the COO backend and on the kernel plan (plain version on the CPU);
* each family's layer (KPGIN, KPGCN, KPGraphSAGE mean and max, GINE) on
  a real batch with carried weights: forward and every gradient, the
  JAX layer on its COO backend;
* the COO ``khop_aggregate`` (add / mean / max) and
  ``khop_aggregate_adj`` with GCN scales against ``kpgnn_tpu.ops``;
* the Layer, Instance, GraphSize and Pair norms.

Tolerances (f32): activations atol 1e-5 / rtol 1e-4, grads rtol 1e-4
with an atol of 1e-4 of the gradient scale (the two sides sum in
different orders, and some gradients are exactly 0 on one side).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kpgnn_tpu.graph.batch as jbatch
import kpgnn_tpu.nn.encoders as jenc
import kpgnn_tpu.nn.layers as jlayers
import kpgnn_tpu.nn.norms as jnorms
import kpgnn_tpu.ops.adjacency as jadjacency
import kpgnn_tpu.ops.segment as jsegment
from kpgnn_tpu_torch.graph import batch as tbatch
from kpgnn_tpu_torch.models.factory import MODEL_NAMES, ModelConfig, make_model
from kpgnn_tpu_torch.nn import encoders, layers, norms
from kpgnn_tpu_torch.ops import adjacency, segment
from kpgnn_tpu_torch.prep.khop import KHopConfig, extract_khop
from kpgnn_tpu_torch.utils.convert import params_from_flax
from tests.test_torch_layers import carry, close, flat
from tests.test_torch_prep_batch import both_prep, raw_molecules

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "kpgnn_tpu", "data", "parity_golden")
BUNDLES = ("kpgin_spd", "kpgin_gd", "kpgin_attn", "kpgcn", "kpsage",
           "kpginprime", "kpginplus")
BACKENDS = ("coo", "pallas")
ACT = dict(atol=1e-5, rtol=1e-4)
# flax-only captures: FeatureConcatEncoder calls its emb*/proj children
# on dummy input only, to create their parameters (the fold uses the
# weights directly), so the port has no such module call
FLAX_ONLY = ("peripheral_edge_embedding/", "peripheral_configuration_embedding/")


def golden_setup(name, backend):
    g = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    a = json.loads(bytes(g["meta"]).decode())
    kcfg = KHopConfig(K=a["K"], kernel=a["kernel"],
                      max_edge_attr_num=a["max_edge_attr_num"],
                      max_hop_num=a["max_hop_num"],
                      max_edge_type=a["max_edge_type"],
                      max_edge_count=a["max_edge_count"],
                      max_distance_count=a["max_distance_count"],
                      use_rd=a["use_rd"])
    n = int(g["raw/n"][0])
    gr = extract_khop(n, g["raw/edge_index"], g["raw/edge_attr"], kcfg,
                      x=g["raw/x"], y=np.array([0]))
    # the bundle's own layout: n_pad = n + 1, one graph + the pad slot
    pads = dict(n_pad=n + 1, e_pad=gr.num_edges + 8, g_pad=2)
    batch = (tbatch.collate([gr], **pads) if backend == "coo" else
             tbatch.collate_pallas([gr], v1=a["num_hop1_edge"] + 2,
                                   vk=a["max_pe_num"] + 2, **pads))
    model = make_model(ModelConfig(
        model_name=a["model_name"], hidden_size=a["hidden_size"],
        num_layer=a["num_layer"], K=a["K"], kernel=a["kernel"],
        num_hop1_edge=a["num_hop1_edge"], max_pe_num=a["max_pe_num"],
        max_edge_type=a["max_edge_type"],
        max_edge_count=a["max_edge_count"], max_hop_num=a["max_hop_num"],
        max_distance_count=a["max_distance_count"], JK=a["JK"],
        combine=a["combine"], residual=a["residual"], aggr=a["aggr"],
        virtual_node=a["virtual_node"], use_rd=a["use_rd"],
        num_l1_layer=a["num_l1_layer"],
        input_encoder=("embedding", a["input_size"]),
        task="graph_classification", output_size=a["output_size"],
        pooling_method=a["pooling_method"], norm_type=a["norm_type"]))
    model.load_state_dict(params_from_flax({k: g[k] for k in g.files}),
                          strict=True)
    return g, model, batch


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", BUNDLES)
def test_golden_bundle_module_by_module(name, backend):
    g, model, batch = golden_setup(name, backend)
    acts = {}
    for mname, mod in model.named_modules():
        mod.register_forward_hook(
            lambda m, i, o, mname=mname: acts.__setitem__(
                mname.replace(".", "/"), o))
    with torch.no_grad():
        out = model(batch, train=False)
    close(out[:1], g["act/__output__"])
    compared = []
    for key in g.files:
        if not (key.startswith("act/") and key.endswith("__call__")):
            continue
        mname = key[len("act/"):-len("__call__")].rstrip("/")
        if any(f in mname for f in FLAX_ONLY):
            continue
        ours = acts[mname].numpy()
        want = g[key]
        if mname.endswith("attention_lstm") and ours.shape != want.shape:
            ours = ours.transpose(1, 0, 2)  # a hop-major combine's LSTM
        np.testing.assert_allclose(ours, want, err_msg=mname, **ACT)
        compared.append(mname)
    # every layer, norm, head and backbone call of the bundle was seen
    assert {"", "classifier", "embedding_model",
            "embedding_model/peripheral", "embedding_model/norm1"
            } <= set(compared), compared
    assert len(compared) >= 17, compared


# ---- single layers, forward and grads, with carried weights ----

LAYER_CASES = [("KPGIN", "coo"), ("KPGIN", "pallas"), ("KPGCN", "coo"),
               ("KPGCN", "pallas"), ("SAGE_mean", "coo"),
               ("SAGE_mean", "pallas"), ("SAGE_max", "coo"), ("GINE", "coo"),
               ("GINE", "pallas")]
K, H = 3, 12


def layer_pair(family):
    """(JAX layer, port layer, takes the K-hop extras)."""
    kw = dict(num_hop1_edge=3, num_pe=9)
    if family == "KPGIN":
        return (jlayers.KPGINConv(H, K, combine="attention", train_eps=True,
                                  **kw),
                layers.KPGINConv(H, K, combine="attention", train_eps=True,
                                 **kw), True)
    if family == "KPGCN":
        return (jlayers.KPGCNConv(H, K, **kw), layers.KPGCNConv(H, K, **kw),
                True)
    if family.startswith("SAGE"):
        aggr = family.split("_")[1]
        comb = "attention" if aggr == "max" else "geometric"
        return (jlayers.KPGraphSAGEConv(H, K, aggr, combine=comb, **kw),
                layers.KPGraphSAGEConv(H, K, aggr, combine=comb, **kw), True)
    return (jlayers.GINEConv(H, 3, eps_init=0.25, train_eps=True),
            layers.GINEConv(H, 3, eps_init=0.25, train_eps=True), False)


def layer_batches():
    js, ts = both_prep(raw_molecules(6, seed=7),
                       K=K, kernel="spd", max_edge_attr_num=9, max_hop_num=3,
                       max_edge_type=3, max_edge_count=10,
                       max_distance_count=10)
    pads = dict(n_pad=256, e_pad=2048, g_pad=7)
    return (jbatch.collate(js, **pads), tbatch.collate(ts, **pads),
            tbatch.collate_pallas(ts, v1=5, vk=11, **pads))


@pytest.mark.parametrize("family,backend", LAYER_CASES)
def test_layer_forward_and_grads_against_jax(family, backend):
    jb, tb_coo, tb_plan = layer_batches()
    tb = tb_coo if backend == "coo" else tb_plan
    n = jb.n_pad
    jm, tm, khop = layer_pair(family)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(n, H)).astype(np.float32)
    per = rng.normal(size=(n, K, H // K)).astype(np.float32)
    pe = np.array(jb.pe_attr)
    w = rng.normal(size=(n, H)).astype(np.float32)
    jargs = (jnp.asarray(pe), jnp.asarray(per)) if khop else ()
    v = jm.init(jax.random.PRNGKey(9), jnp.asarray(x), jb.adj, *jargs,
                node_mask=jb.node_mask)
    carry(tm, v)
    # the plan backend takes the peripheral hop-major, as its backbone
    # gives it
    per_t = torch.from_numpy(per)
    if adjacency.hop_major_native(tb.adj):
        per_t = per_t.transpose(0, 1)
    targs = (torch.from_numpy(pe), per_t) if khop else ()

    def jloss(params, xx):
        y, upd = jm.apply({**v, "params": params}, xx, jb.adj, *jargs,
                          node_mask=jb.node_mask, train=True,
                          mutable=["batch_stats"])
        return jnp.sum(y * w), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty = tm(tx, tb.adj, *targs, node_mask=tb.node_mask, train=True)
    close(ty, jy)
    (ty * torch.from_numpy(w)).sum().backward()
    close(tx.grad, jgx, rtol=1e-4,
          atol=1e-4 * float(np.abs(np.asarray(jgx)).max()))
    jg = params_from_flax(flat({"params": jgp}))
    gscale = max(float(g.abs().max()) for g in jg.values())
    assert sorted(jg) == sorted(n_ for n_, _ in tm.named_parameters())
    for pname, p in tm.named_parameters():
        close(p.grad, jg[pname].numpy(), rtol=1e-4, atol=1e-4 * gscale)


def test_sage_max_on_the_plan_backend_raises():
    _, _, tb = layer_batches()
    tm = layers.KPGraphSAGEConv(H, K, "max", num_hop1_edge=3, num_pe=9)
    with pytest.raises(ValueError, match="max"):
        tm(torch.zeros(tb.n_pad, H), tb.adj)


# ---- the COO backend's aggregation ----

def coo_case(seed, n=64, e=300, k=3, D=5):
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, n, e).astype(np.int32)
    receivers = np.sort(rng.integers(0, n - 8, e)).astype(np.int32)
    attr = rng.integers(0, 4, size=(e, k)).astype(np.int32)
    mask = np.ones(e, bool)
    mask[-20:] = False              # padded edges: attr 0 on every hop
    attr[-20:] = 0
    x = rng.normal(size=(n, k, D)).astype(np.float32)
    emb = rng.normal(size=(e, k, D)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=(e, k)).astype(np.float32)
    return senders, receivers, attr, mask, x, emb, scale


@pytest.mark.parametrize("aggr", ["add", "mean", "max"])
def test_coo_khop_aggregate_against_jax(aggr):
    senders, receivers, attr, mask, x, emb, scale = coo_case(3)
    cot = np.cos(np.arange(x.size).reshape(x.shape)).astype(np.float32)

    def jf(xx, ee, ss):
        out = jsegment.khop_aggregate(
            xx, jnp.asarray(senders), jnp.asarray(receivers), ee,
            jnp.asarray(attr), scale=ss, aggr=aggr,
            edge_mask=jnp.asarray(mask))
        return jnp.sum(out * cot), out

    (_, jout), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(emb), jnp.asarray(scale))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, emb, scale)]
    tout = segment.khop_aggregate(
        ts[0], torch.from_numpy(senders), torch.from_numpy(receivers), ts[1],
        torch.from_numpy(attr), torch.from_numpy(mask), scale=ts[2],
        aggr=aggr)
    close(tout, jout)
    (tout * torch.from_numpy(cot)).sum().backward()
    for t, g in zip(ts, jg):
        close(t.grad, g, rtol=1e-4, atol=1e-4 * float(np.abs(g).max()))


def test_multi_hop_degree_and_coo_degrees_against_jax():
    senders, receivers, attr, mask, *_ = coo_case(4)
    jadj = jadjacency.COOAdj(
        senders=jnp.asarray(senders), receivers=jnp.asarray(receivers),
        edge_attr=jnp.asarray(attr), edge_mask=jnp.asarray(mask), n_nodes=64)
    tadj = adjacency.COOAdj(
        senders=torch.from_numpy(senders),
        receivers=torch.from_numpy(receivers),
        edge_attr=torch.from_numpy(attr), edge_mask=torch.from_numpy(mask),
        n_nodes=64)
    for self_loop in (False, True):
        np.testing.assert_array_equal(
            segment.multi_hop_degree(tadj.edge_attr, tadj.receivers, 64,
                                     self_loop).numpy(),
            np.asarray(jsegment.multi_hop_degree(jadj.edge_attr,
                                                 jadj.receivers, 64,
                                                 self_loop)))
        np.testing.assert_array_equal(
            adjacency.degree(tadj.slice_hops(2), self_loop).numpy(),
            np.asarray(jadjacency.degree(jadj.slice_hops(2), self_loop)))
    np.testing.assert_array_equal(adjacency.union_in_degree(tadj).numpy(),
                                  np.asarray(jadjacency.union_in_degree(jadj)))


@pytest.mark.parametrize("hop_major", [False, True])
@pytest.mark.parametrize("kw", ["gcn", "mean"])
def test_coo_khop_aggregate_adj_against_jax(kw, hop_major):
    """Edge tables with row 0 zeroed at use, receiver and sender scales,
    and the hop-major boundary transpose of the COO backend."""
    senders, receivers, attr, mask, x, *_ = coo_case(5, D=6)
    rng = np.random.default_rng(6)
    t1 = rng.normal(size=(4, 6)).astype(np.float32)
    tk = rng.normal(size=(80, 6)).astype(np.float32)     # a gathered table
    attr[:, 1:] = rng.integers(0, 80, size=attr[:, 1:].shape) * (attr[:, 1:] > 0)
    s = rng.uniform(0.5, 2.0, size=(64, 3)).astype(np.float32)
    if hop_major:
        x = x.transpose(1, 0, 2).copy()
    jadj = jadjacency.COOAdj(
        senders=jnp.asarray(senders), receivers=jnp.asarray(receivers),
        edge_attr=jnp.asarray(attr), edge_mask=jnp.asarray(mask), n_nodes=64)
    tadj = adjacency.COOAdj(
        senders=torch.from_numpy(senders),
        receivers=torch.from_numpy(receivers),
        edge_attr=torch.from_numpy(attr), edge_mask=torch.from_numpy(mask),
        n_nodes=64)
    jkw = (dict(scale=jnp.asarray(s), sender_scale=jnp.asarray(1 / s))
           if kw == "gcn" else dict(aggr="mean"))
    tkw = (dict(scale=torch.from_numpy(s),
                sender_scale=torch.from_numpy(1 / s))
           if kw == "gcn" else dict(aggr="mean"))

    def jf(xx, a, b):
        out = jadjacency.khop_aggregate_adj(jadj, xx, a, b,
                                            hop_major=hop_major, **jkw)
        return jnp.sum(out * jnp.sin(out)), out

    (_, jout), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(t1), jnp.asarray(tk))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, t1, tk)]
    tout = adjacency.khop_aggregate_adj(tadj, *ts, hop_major=hop_major,
                                        **tkw)
    close(tout, jout)
    (tout * torch.sin(tout)).sum().backward()
    for t, g in zip(ts, jg):
        close(t.grad, g, rtol=1e-4, atol=1e-4 * float(np.abs(g).max()))
    assert not ts[1].grad[0].any() and not ts[2].grad[0].any()


# ---- norms and the linear encoder ----

NORMS = ["Layer", "Instance", "GraphSize", "Pair"]


@pytest.mark.parametrize("kind", NORMS)
def test_norm_forward_and_grads_against_jax(kind):
    rng = np.random.default_rng(11)
    n, g, F = 40, 5, 6
    x = rng.normal(2.0, 3.0, size=(n, F)).astype(np.float32)
    gid = np.sort(rng.integers(0, g - 1, n))
    mask = rng.random(n) < 0.8
    gid[~mask] = g - 1
    cot = rng.normal(size=(n, F)).astype(np.float32)
    jm = jnorms.make_norm(kind)()
    per_graph = kind != "Pair"
    jin = ((jnp.asarray(x), jnp.asarray(gid), g) if per_graph
           else (jnp.asarray(x),))
    v = jm.init(jax.random.PRNGKey(0), *jin, mask=jnp.asarray(mask))
    if kind == "Layer":         # a non-trivial affine to carry over
        v = jax.tree.map(lambda a: a + jnp.asarray(
            rng.normal(size=a.shape).astype(np.float32)) * 0.3, v)
    tm = {"Layer": lambda: norms.MaskedGraphLayerNorm(F),
          "Instance": norms.MaskedInstanceNorm,
          "GraphSize": norms.GraphSizeNorm, "Pair": norms.PairNorm}[kind]()
    carry(tm, v)

    def jf(params, xx):
        out = jm.apply({"params": params}, xx, *jin[1:],
                       mask=jnp.asarray(mask))
        return jnp.sum(out * cot), out

    (_, jy), (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1),
                                             has_aux=True)(
        v.get("params", {}), jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tin = (torch.from_numpy(gid), g) if per_graph else ()
    ty = tm(tx, *tin, mask=torch.from_numpy(mask))
    close(ty, jy)
    (ty * torch.from_numpy(cot)).sum().backward()
    close(tx.grad, jgx, rtol=1e-4, atol=1e-4 * float(np.abs(jgx).max()))
    jg = params_from_flax(flat({"params": jgp})) if jgp else {}
    assert sorted(jg) == sorted(n_ for n_, _ in tm.named_parameters())
    for pname, p in tm.named_parameters():
        close(p.grad, jg[pname].numpy())


def test_linear_encoder_against_jax():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(30, 3)).astype(np.float32)

    class B:
        pass
    jb, tb = B(), B()
    jb.x, tb.x = jnp.asarray(x), torch.from_numpy(x)
    jm = jenc.LinearEncoder(3, 8)
    v = jm.init(jax.random.PRNGKey(1), jb)
    close(carry(encoders.LinearEncoder(3, 8), v)(tb), jm.apply(v, jb))


# ---- the factory ----

@pytest.mark.parametrize("backend", BACKENDS)
def test_every_family_builds_and_runs_on_both_backends(backend):
    """Every family of MODEL_NAMES trains a step on either backend with
    the linear encoder and every norm; the plan refuses only max."""
    from kpgnn_tpu_torch.nn.inits import init_parameters
    from kpgnn_tpu_torch.train.loop import train_step
    from kpgnn_tpu_torch.train.state import make_optimizer

    _, tb_coo, tb_plan = layer_batches()
    tb = tb_coo if backend == "coo" else tb_plan
    tb = tb.replace(x=tb.x.float(), y=torch.arange(tb.g_pad) % 3)
    for name, norm in zip(MODEL_NAMES, ["Batch"] + NORMS):
        cfg = ModelConfig(model_name=name, hidden_size=H, num_layer=K, K=K,
                          num_hop1_edge=3, max_pe_num=9, max_edge_count=10,
                          max_hop_num=3, max_distance_count=10,
                          norm_type=norm, virtual_node=True,
                          input_encoder=("linear", 1), output_size=3)
        model = init_parameters(make_model(cfg), 0)
        lsum, cnt = train_step(model, make_optimizer(model.parameters(),
                                                     1e-3),
                               tb, "cross_entropy")
        assert torch.isfinite(lsum) and cnt == 6, name
