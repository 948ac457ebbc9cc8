"""The virtual node's broadcast (``_VirtualNode.broadcast``, an embedding
lookup) against the indexing form it replaced, ``vn[node_graph_ids]``,
whose backward serialised on the pad graph's id on the card: the same
rows and the same gradients, alone and through a whole model."""
import numpy as np
import pytest
import torch

from kpgnn_tpu_torch.graph import batch as tbatch
from kpgnn_tpu_torch.models.backbones import _VirtualNode
from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.nn.inits import init_parameters
from kpgnn_tpu_torch.train.loop import _masked_loss
from tests.test_torch_model import FLAGSHIP_SMALL, PREP_SMALL
from tests.test_torch_prep_batch import both_prep, raw_molecules

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def batch():
    """Four molecules in a padded plan batch: every padding node belongs
    to the pad graph, id 4."""
    _, ts = both_prep(raw_molecules(4, seed=2), **PREP_SMALL)
    b = tbatch.collate_pallas(ts, v1=5, vk=11, n_pad=256, e_pad=4096,
                              g_pad=5)
    assert int((b.node_graph_ids == 4).sum()) == int((~b.node_mask).sum())
    return b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_broadcast_equals_indexing_with_grads(batch, dtype):
    gen = torch.Generator().manual_seed(0)
    vn = torch.randn(5, 24, generator=gen)
    up = torch.randn(batch.n_pad, 24, generator=gen).to(dtype)
    a = vn.clone().requires_grad_(True)
    b = vn.clone().requires_grad_(True)
    got = _VirtualNode.broadcast(a, batch, dtype)
    want = b[batch.node_graph_ids].to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    (got.float() * up.float()).sum().backward()
    (want.float() * up.float()).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)


def test_model_gradients_equal_the_indexing_form(batch, monkeypatch):
    """One loss and every parameter gradient of a virtual-node model, the
    broadcast as an embedding lookup against the indexing gather."""
    cfg = ModelConfig(**FLAGSHIP_SMALL)
    assert cfg.virtual_node

    def grads():
        model = init_parameters(make_model(cfg), 4)
        lsum, cnt = _masked_loss(model(batch, train=True), batch.y,
                                 batch.graph_mask, "l1")
        (lsum / cnt).backward()
        return float(lsum.detach()), {
            n: p.grad.clone() for n, p in model.named_parameters()}
    loss, got = grads()
    with monkeypatch.context() as m:
        m.setattr(_VirtualNode, "broadcast", staticmethod(
            lambda vn, b, dtype: vn[b.node_graph_ids].to(dtype)))
        loss_idx, want = grads()
    assert loss == loss_idx
    scale = max(float(g.abs().max()) for g in want.values())
    assert any(n.startswith("embedding_model.virtualnode") for n in got)
    for n, g in want.items():
        np.testing.assert_allclose(got[n].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=n)
