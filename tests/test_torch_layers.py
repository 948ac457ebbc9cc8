"""The port's modules against their JAX counterparts, with carried weights.

Each flax module is initialized, its variables are flattened and mapped
with ``params_from_flax`` into the torch module, and both run on the same
numpy inputs.  Tolerances (f32): activations atol 1e-5 / rtol 1e-4 (the
two sides sum in different orders), grads rtol 1e-4 with an atol of 1e-4
of the gradient scale.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kpgnn_tpu.graph.batch as jbatch
import kpgnn_tpu.models.heads as jheads
import kpgnn_tpu.nn.basic as jbasic
import kpgnn_tpu.nn.combine as jcombine
import kpgnn_tpu.nn.encoders as jenc
import kpgnn_tpu.nn.layers as jlayers
import kpgnn_tpu.nn.norms as jnorms
import kpgnn_tpu.ops.lstm as jlstm
from kpgnn_tpu.nn.embed import small_table_lookup as jlookup
from kpgnn_tpu_torch.graph import batch as tbatch
from kpgnn_tpu_torch.models.heads import pool_nodes
from kpgnn_tpu_torch.nn import basic, combine, encoders, layers, norms
from kpgnn_tpu_torch.nn.embed import small_table_lookup
from kpgnn_tpu_torch.ops.lstm import BiLSTM
from kpgnn_tpu_torch.utils.convert import params_from_flax
from tests.test_torch_prep_batch import ZINC_PREP, both_prep, raw_molecules

torch.set_num_threads(1)
ACT = dict(atol=1e-5, rtol=1e-4)


def flat(variables):
    """Flax variables -> the flattened 'coll/a/b/leaf' numpy dict the
    golden bundles store."""
    out = {}
    for coll, tree in variables.items():
        for k, v in flax.traverse_util.flatten_dict(tree).items():
            out[coll + "/" + "/".join(map(str, k))] = np.asarray(v)
    return out


def carry(tmod, variables):
    tmod.load_state_dict(params_from_flax(flat(variables)), strict=True)
    return tmod


def close(ours, theirs, **kw):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               **(kw or ACT))


def test_masked_batchnorm_train_eval_and_running_stats():
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, size=(40, 6)).astype(np.float32)
    mask = rng.random(40) < 0.7
    jm = jnorms.MaskedBatchNorm()
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # non-trivial affine and running stats to carry over
    v = jax.tree.map(lambda a: a + jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)) * 0.1, v)
    tm = carry(norms.MaskedBatchNorm(6), v)
    jy, upd = jm.apply(v, jnp.asarray(x), mask=jnp.asarray(mask),
                       use_running_average=False, mutable=["batch_stats"])
    ty = tm(torch.from_numpy(x), mask=torch.from_numpy(mask),
            use_running_average=False)
    close(ty, jy)
    close(tm.running_mean, upd["batch_stats"]["mean"])
    close(tm.running_var, upd["batch_stats"]["var"])
    v2 = {"params": v["params"], "batch_stats": upd["batch_stats"]}
    close(tm(torch.from_numpy(x)), jm.apply(v2, jnp.asarray(x)))


def test_mlp_with_masked_bn():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(30, 8)).astype(np.float32)
    mask = rng.random(30) < 0.8
    jm = jbasic.MLP([12, 12], use_batchnorm=True)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tm = carry(basic.MLP(8, [12, 12], use_batchnorm=True), v)
    jy, _ = jm.apply(v, jnp.asarray(x), mask=jnp.asarray(mask), train=True,
                     mutable=["batch_stats"])
    close(tm(torch.from_numpy(x), mask=torch.from_numpy(mask), train=True),
          jy)


@pytest.mark.parametrize("sum_axis", [None, -1])
def test_feature_concat_encoder(sum_axis):
    rng = np.random.default_rng(2)
    dims = [5, 11]
    # ids include out-of-range values, which read zero rows on both sides
    x = rng.integers(0, 13, size=(20, 3, 4, 2)).astype(np.int32)
    if sum_axis is None:
        x = x[:, :, 0]
    jm = jenc.FeatureConcatEncoder(dims, 16, padding=False)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), sum_axis=sum_axis)
    tm = carry(encoders.FeatureConcatEncoder(dims, 16), v)
    close(tm(torch.from_numpy(x), sum_axis=sum_axis),
          jm.apply(v, jnp.asarray(x), sum_axis=sum_axis))


def test_embedding_encoder_and_lookup_rules():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(21, 8)).astype(np.float32)
    ids = np.array([0, 5, 20, 21, 30, -1])
    np.testing.assert_array_equal(
        small_table_lookup(torch.from_numpy(table), torch.from_numpy(ids)),
        np.asarray(jlookup(jnp.asarray(table), jnp.asarray(ids))))
    big = rng.normal(size=(80, 4)).astype(np.float32)
    ids = np.array([0, 79, 85])
    np.testing.assert_array_equal(
        small_table_lookup(torch.from_numpy(big), torch.from_numpy(ids)),
        np.asarray(jlookup(jnp.asarray(big), jnp.asarray(ids))))


@pytest.mark.parametrize("time_major", [False, True])
def test_bilstm(time_major):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 17, 10) if time_major else (17, 3, 10)
                   ).astype(np.float32)
    jm = jlstm.BiLSTM(4, time_major=time_major)
    v = jm.init(jax.random.PRNGKey(4), jnp.asarray(x))
    tm = carry(BiLSTM(10, 4), v)
    close(tm(torch.from_numpy(x), time_major=time_major),
          jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["attention", "geometric"])
def test_combines_hop_major(kind):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 25, 12)).astype(np.float32)
    jm = jcombine.make_combine(kind, 3, 12, hop_major=True)
    v = jm.init(jax.random.PRNGKey(5), jnp.asarray(x))
    if kind == "geometric":     # non-zero alphas so the weights differ
        v = {"params": {"alphas": jnp.asarray(
            rng.normal(size=12).astype(np.float32))}}
    tm = carry(combine.make_combine(kind, 3, 12), v)
    close(tm(torch.from_numpy(x), hop_major=True),
          jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("k,combine_kind", [(1, "attention"),
                                            (3, "attention"),
                                            (3, "geometric")])
def test_kpginplus_conv_forward_grads_and_stats(k, combine_kind):
    """One layer on a real batch: the JAX layer on the COO backend, the
    port's on the kernel plan (plain version on the CPU)."""
    js, ts = both_prep(raw_molecules(6, seed=7),
                       **dict(ZINC_PREP, K=3, max_edge_attr_num=9))
    n_pad, e_pad, g_pad = 256, 2048, 7
    jb = jbatch.collate(js, n_pad=n_pad, e_pad=e_pad, g_pad=g_pad)
    tb = tbatch.collate_pallas(ts, v1=5, vk=11, n_pad=n_pad, e_pad=e_pad,
                               g_pad=g_pad)
    H = 16
    rng = np.random.default_rng(8)
    x = rng.normal(size=(k, n_pad, H)).astype(np.float32)
    per = rng.normal(size=(k, n_pad, H)).astype(np.float32)
    pe = np.array(jb.pe_attr)[:, :k - 1]
    jm = jlayers.KPGINPlusConv(H, k, num_hop1_edge=3, num_pe=9,
                               combine=combine_kind)
    jadj = jb.adj.slice_hops(k)
    v = jm.init(jax.random.PRNGKey(9), jnp.asarray(x), jadj, jnp.asarray(pe),
                jnp.asarray(per), node_mask=jb.node_mask)
    tm = carry(layers.KPGINPlusConv(H, k, num_hop1_edge=3, num_pe=9,
                                    combine=combine_kind), v)
    w = rng.normal(size=(n_pad, H)).astype(np.float32)

    def jloss(params, xx):
        y, upd = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, xx, jadj,
                          jnp.asarray(pe), jnp.asarray(per),
                          node_mask=jb.node_mask, train=True,
                          mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd)

    (_, (jy, upd)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty = tm(tx, tb.adj.slice_hops(k), torch.from_numpy(pe),
            torch.from_numpy(per), node_mask=tb.node_mask, train=True)
    close(ty, jy)
    (ty * torch.from_numpy(w)).sum().backward()
    scale = float(np.abs(np.asarray(jgx)).max())
    close(tx.grad, jgx, rtol=1e-4, atol=1e-4 * scale)
    # atol against the largest parameter gradient: the pre-BN biases
    # have an exact gradient of 0, so both sides only carry rounding there
    jg = params_from_flax(flat({"params": jgp}))
    gscale = max(float(g.abs().max()) for g in jg.values())
    for name, p in tm.named_parameters():
        close(p.grad, jg[name].numpy(), rtol=1e-4, atol=1e-4 * gscale)
    stats = params_from_flax(flat({"batch_stats": upd["batch_stats"]}))
    for name, b in tm.named_buffers():
        close(b, stats[name])
    # eval mode, on the running statistics the train step left behind
    v2 = {"params": v["params"], "batch_stats": upd["batch_stats"]}
    close(tm(torch.from_numpy(x), tb.adj.slice_hops(k), torch.from_numpy(pe),
             torch.from_numpy(per), node_mask=tb.node_mask),
          jm.apply(v2, jnp.asarray(x), jadj, jnp.asarray(pe),
                   jnp.asarray(per), node_mask=jb.node_mask))


@pytest.mark.parametrize("method", ["sum", "mean", "max", "attention"])
def test_pool_nodes_forward_and_grads(method):
    """Masked pooling (and the segment reductions under it) against the
    JAX head's, with an empty real graph slot among the padded ones."""
    js, ts = both_prep(raw_molecules(5, seed=9), K=2, max_edge_attr_num=5)
    pads = dict(n_pad=256, e_pad=2048, g_pad=7)
    jb, tb = jbatch.collate(js, **pads), tbatch.collate(ts, **pads)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(256, 6)).astype(np.float32)
    w = rng.normal(size=(6, 1)).astype(np.float32)
    cot = rng.normal(size=(7, 6)).astype(np.float32)

    def jloss(xx):
        out = jheads.pool_nodes(xx, jb, method,
                                gate=lambda v: v @ jnp.asarray(w))
        return jnp.sum(out * cot), out

    (_, jout), jgx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tout = pool_nodes(tx, tb, method,
                      gate=lambda v: v @ torch.from_numpy(w))
    close(tout, jout)
    (tout * torch.from_numpy(cot)).sum().backward()
    close(tx.grad, jgx)
