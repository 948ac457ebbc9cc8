"""``--bf16`` on the port against the JAX package's bf16 twin: bf16
activations, f32 parameters, norm statistics and losses.

A small flagship-shaped KPGINPlus (attention combine, JK concat,
residual, virtual node) with carried weights.  The JAX twin runs on its
COO batches (its kernel path casts to f32 on the CPU, so every JAX
backend computes the same function); the port runs coo, the kernel plan
(its plain version on the CPU) and dense.  Tolerances: bf16 keeps 8
mantissa bits (relative rounding 2**-9 per op) and the two frameworks
round at different places (the port's fused kernel adds the edge
embeddings in f32 before its one cast, the JAX package adds them in bf16
after it; matmuls accumulate in f32 on both sides but round at other
points), so outputs agree to 2e-2 of the output's scale and losses to
rtol 2e-2; bf16 against the port's own f32 within 5e-2 of scale (the
bound of tests/test_bf16.py).  The three AdamW steps run at lr 1e-4:
Adam's first updates move each weight by about lr * sign(g), and bf16
rounding gives ~6% of this model's gradient entries the other sign on
either side (the JAX twin's own bf16 and f32 gradients differ in sign as
often), so at lr 1e-3 the third loss moved 7% apart while the first
agreed to 0.3%; at 1e-4 all three agree to 0.4%.
"""
import math

import jax
import numpy as np
import pytest
import torch

import kpgnn_tpu.graph.batch as jbatch
import kpgnn_tpu.models as jmodels
from kpgnn_tpu.train.loop import train_step_body
from kpgnn_tpu.train.state import create_train_state
from kpgnn_tpu_torch.graph import batch as tbatch
from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.train.loop import train_step
from kpgnn_tpu_torch.train.state import make_optimizer
from kpgnn_tpu_torch.utils.convert import params_from_flax
from tests.test_torch_layers import flat
from tests.test_torch_model import (FLAGSHIP_SMALL, PREP_SMALL, TINY_ARGS,
                                    write_zinc_fixture)
from tests.test_torch_prep_batch import both_prep, raw_molecules

torch.set_num_threads(1)
PER_BATCH = 4
PADS = dict(n_pad=256, e_pad=4096, g_pad=PER_BATCH + 1)
BF16 = dict(FLAGSHIP_SMALL, compute_dtype="bfloat16")
# the l2_wd of every AdamW script, so the three steps take AdamW
LR, WD = 1e-4, 3e-6


def batches(n_batches, **prep):
    """(JAX coo batches, {port backend: batches}) of the same graphs."""
    js, ts = both_prep(raw_molecules(n_batches * PER_BATCH, seed=11),
                       **dict(PREP_SMALL, **prep))
    n_slot = -(-max(g.num_nodes for g in ts) // 8) * 8
    jbs, tbs = [], {"coo": [], "pallas": [], "dense": []}
    for i in range(n_batches):
        sl = slice(i * PER_BATCH, (i + 1) * PER_BATCH)
        jbs.append(jbatch.collate(js[sl], **PADS))
        tbs["coo"].append(tbatch.collate(ts[sl], **PADS))
        tbs["pallas"].append(tbatch.collate_pallas(ts[sl], v1=5, vk=11,
                                                   **PADS))
        tbs["dense"].append(tbatch.collate_dense(ts[sl], n_slot, v1=5, vk=11,
                                                 g_pad=PER_BATCH))
    return jbs, tbs


def carried(jmodel, jb, cfg):
    """The JAX twin's state and a port model of ``cfg`` on its
    weights."""
    state, tx = create_train_state(jmodel, jb, jax.random.PRNGKey(0),
                                   lr=LR, l2_wd=WD)
    tmodel = make_model(ModelConfig(**cfg))
    tmodel.load_state_dict(params_from_flax(flat(state.variables)),
                           strict=True)
    return state, tx, tmodel


@pytest.fixture(scope="module")
def one_batch():
    return batches(1)


@pytest.fixture(scope="module")
def rd_batch():
    return batches(1, use_rd=True)


# QM9's heads on the small model: attention pooling and the rd
# projection, whose f32 sum is what the backbone casts to bf16
ATTENTION_RD = dict(BF16, pooling_method="attention", use_rd=True)


@pytest.mark.parametrize("cfg", ["flagship", "attention_rd"])
@pytest.mark.parametrize("backend", ["coo", "pallas", "dense"])
def test_bf16_forward_equals_jax_bf16_twin(one_batch, rd_batch, backend,
                                           cfg):
    jbs, tbs = one_batch if cfg == "flagship" else rd_batch
    cfg = BF16 if cfg == "flagship" else ATTENTION_RD
    jmodel = jmodels.make_model(jmodels.ModelConfig(**cfg))
    state, _, tmodel = carried(jmodel, jbs[0], cfg)
    want = np.asarray(jmodel.apply(state.variables, jbs[0], train=False),
                      np.float32)[:PER_BATCH]
    with torch.no_grad():
        got = tmodel(tbs[backend][0], train=False)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()[:PER_BATCH]
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale)


def backbone_output(jmodel, variables, jb):
    """The JAX model's backbone (``embedding_model``) output."""
    _, inter = jmodel.apply(variables, jb, train=False,
                            capture_intermediates=True,
                            mutable=["intermediates"])
    return np.asarray(inter["intermediates"]["embedding_model"]["__call__"]
                      [0], np.float32)


@pytest.mark.parametrize("cfg", ["flagship", "attention_rd"])
@pytest.mark.parametrize("backend", ["coo", "pallas", "dense"])
def test_bf16_rounds_as_much_as_jax_bf16_twin(one_batch, rd_batch, backend,
                                              cfg):
    """The activations run in bf16, not only the output: the backbone's
    bf16 output against its f32 output on the same weights (real nodes,
    over the f32 output's largest |value|) must lie within a factor 2 of
    the JAX twin's own bf16-to-f32 gap, and above twice the gap of an f32
    control (the port's f32 backbone output cast to bf16, what a model
    that computed in f32 and cast at the end would give).  Two bf16
    computations that round at different places lie as far from each
    other as from f32 (here the port's bf16 is 5.0e-3 to 5.1e-3 from
    the twin's), so the port is not held closer to the twin than to f32.
    Readings: the port 5.5e-3 to 7.0e-3, the twin 5.9e-3 to 7.0e-3, the
    control 2.3e-3 to 2.5e-3."""
    jbs, tbs = one_batch if cfg == "flagship" else rd_batch
    cfg = BF16 if cfg == "flagship" else ATTENTION_RD
    f32 = dict(cfg, compute_dtype="float32")
    jmodel = jmodels.make_model(jmodels.ModelConfig(**cfg))
    state, _, tmodel = carried(jmodel, jbs[0], cfg)
    live = np.asarray(jbs[0].node_mask)
    j16 = backbone_output(jmodel, state.variables, jbs[0])[live]
    j32 = backbone_output(jmodels.make_model(jmodels.ModelConfig(**f32)),
                          state.variables, jbs[0])[live]
    m32 = make_model(ModelConfig(**f32))
    m32.load_state_dict(tmodel.state_dict())
    batch = tbs[backend][0]
    with torch.no_grad():
        p16 = tmodel.embedding_model(batch, train=False)[batch.node_mask]
        p32 = m32.embedding_model(batch, train=False)[batch.node_mask]
    assert p16.dtype == torch.bfloat16 and p32.dtype == torch.float32
    scale = float(p32.abs().max())
    port = float((p16.float() - p32).abs().max()) / scale
    control = float((p32.bfloat16().float() - p32).abs().max()) / scale
    twin = float(np.abs(j16 - j32).max()) / scale
    assert twin / 2 <= port <= 2 * twin, (port, twin)
    assert port > 2 * control, (port, control)


@pytest.mark.parametrize("backend", ["coo", "pallas"])
def test_bf16_three_adamw_steps_equal_jax_bf16_twin(backend):
    jbs, tbs = batches(3)
    jmodel = jmodels.make_model(jmodels.ModelConfig(**BF16))
    state, tx, tmodel = carried(jmodel, jbs[0], BF16)
    opt = make_optimizer(tmodel.parameters(), LR, WD)
    assert isinstance(opt, torch.optim.AdamW)
    jstep = jax.jit(train_step_body(jmodel, tx, "l1"))
    jl, tl = [], []
    for jb, tb in zip(jbs, tbs[backend]):
        state, m = jstep(state, jb, jax.random.PRNGKey(1))
        jl.append(float(m["loss_sum"]) / float(m["count"]))
        lsum, cnt = train_step(tmodel, opt, tb, "l1")
        assert lsum.dtype == torch.float32      # the loss is f32
        tl.append(float(lsum) / float(cnt))
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert len(set(np.round(jl, 4))) == 3


@pytest.mark.parametrize("backend", ["coo", "pallas", "dense"])
def test_bf16_close_to_own_f32(one_batch, backend):
    _, tbs = one_batch
    from kpgnn_tpu_torch.nn.inits import init_parameters
    m32 = init_parameters(make_model(ModelConfig(**FLAGSHIP_SMALL)), 3)
    m16 = make_model(ModelConfig(**BF16))
    m16.load_state_dict(m32.state_dict())
    with torch.no_grad():
        out32 = m32(tbs[backend][0], train=False)
        out16 = m16(tbs[backend][0], train=False).float()
    scale = max(float(out32.abs().max()), 1.0)
    assert float((out32 - out16).abs().max()) <= 5e-2 * scale


def test_bf16_parameters_and_norm_statistics_stay_f32(one_batch):
    _, tbs = one_batch
    from kpgnn_tpu_torch.nn.inits import init_parameters
    model = init_parameters(make_model(ModelConfig(**BF16)), 0)
    opt = make_optimizer(model.parameters(), LR, WD)
    for backend in ("pallas", "coo", "dense"):
        train_step(model, opt, tbs[backend][0], "l1")
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    stats = [b for n, b in model.named_buffers() if "running" in n]
    assert stats and all(b.dtype == torch.float32 for b in stats)
    # the steps updated the statistics (in f32)
    assert any(float((b - 1.0).abs().max()) > 0 for n, b in
               model.named_buffers() if n.endswith("running_var"))


def test_bf16_lstm_runs_in_bf16_with_f32_weights():
    """The combine's LSTM: bf16 in, bf16 out, the f32 weights cast at use;
    close to the f32 LSTM on the same values."""
    from kpgnn_tpu_torch.ops.lstm import BiLSTM
    lstm = BiLSTM(6, 3)
    lstm.init_params(torch.Generator().manual_seed(0))
    x = torch.randn(4, 5, 6, generator=torch.Generator().manual_seed(1))
    out16 = lstm(x.bfloat16(), time_major=True)
    assert out16.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in lstm.parameters())
    out32 = lstm(x.bfloat16().float(), time_major=True)
    assert float((out16.float() - out32).abs().max().detach()) <= 2e-2


def test_train_zinc_bf16_on_cpu(tmp_path):
    from kpgnn_tpu_torch.scripts import train_zinc

    write_zinc_fixture(str(tmp_path), (24, 8, 8))
    rows = {}
    for extra in ([], ["--bf16"]):
        got = []
        mae = train_zinc.main(
            ["--dataset_dir", str(tmp_path), "--save_dir",
             str(tmp_path / "s"), "--backend", "pallas", "--device", "cpu"]
            + extra + TINY_ARGS,
            epoch_callback=lambda e, m, row: got.append(row))
        assert math.isfinite(mae) and len(got) == 1
        rows[bool(extra)] = got[0]["step_losses"]
    # the first step (before any update) within the f32 bound
    np.testing.assert_allclose(rows[True][0], rows[False][0], rtol=5e-2)
