"""A run with the timed path broken underneath comes out not correct:
the rest of a run (``run.execute``) on the CPU at a tiny size, past the
look for a card, with one fault planted in the program at a time (a
step that leaves the state unchanged, half the batch left out of the
loss's mean, half of each batch left out by the loader, an answer
altered where it is produced).  The
exchange between chips is no fault these one-chip cells can have.  And
a traced run whose profile holds no device event (the CPU's) exits
non-zero with no result."""
import pytest
import torch

from benchmark import run

from . import tiny


def _execute(name, trace=False):
    c, cfg, tr, lims, mets = tiny.cell(name)
    return run.execute(c, cfg, tr, lims, mets, tiny.SEED, 0.3, trace, "cpu",
                       lambda s: None)


def _state_unchanged(monkeypatch):
    from kpgnn_tpu_torch.train import loop

    def step(model, opt, batch, loss="l1", generator=None,
             node_level=False):
        pred = model(batch, train=True, generator=generator)
        lsum, cnt = loop._masked_loss(pred, batch.y, batch.graph_mask, loss)
        return lsum.detach(), cnt.detach()
    monkeypatch.setattr(loop, "train_step", step)


def _half_batch(monkeypatch):
    from kpgnn_tpu_torch.train import loop
    real = loop._masked_loss

    def masked_loss(pred, y, mask, loss):
        keep = mask & (torch.cumsum(mask.long(), 0) <= mask.sum() // 2)
        return real(pred, y, keep, loss)
    monkeypatch.setattr(loop, "_masked_loss", masked_loss)


def _loader_drops_half(monkeypatch):
    from kpgnn_tpu_torch.train.loader import GraphLoader
    real = GraphLoader._collate

    def collate(self, batch_graphs):
        return real(self, list(batch_graphs)[:max(1, len(batch_graphs)
                                                   // 2)])
    monkeypatch.setattr(GraphLoader, "_collate", collate)


def _answer_altered(monkeypatch):
    from kpgnn_tpu_torch.models import heads
    real = heads.GraphRegression.forward

    def forward(self, batch, train=False, generator=None):
        out = real(self, batch, train, generator)
        return out + (torch.arange(out.shape[0]) == 3).to(out.dtype)
    monkeypatch.setattr(heads.GraphRegression, "forward", forward)


@pytest.mark.parametrize("name", ["zinc_train_coo", "qm9_train_coo",
                                  "zinc_score_kernel", "qm9_score_kernel"])
def test_sound_run_is_correct(name):
    rc, out = _execute(name)
    assert rc == 0 and out["correct"], out["check"]
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("name,fault", [
    ("zinc_train_coo", _state_unchanged),
    ("zinc_train_coo", _half_batch),
    ("zinc_train_coo", _answer_altered),
    ("zinc_train_coo", _loader_drops_half),
    ("zinc_score_kernel", _loader_drops_half),
    ("qm9_train_coo", _state_unchanged),
    ("qm9_train_coo", _half_batch),
    ("zinc_score_kernel", _answer_altered),
    ("qm9_score_kernel", _answer_altered),
])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    rc, out = _execute(name)
    assert rc == 0 and out["correct"] is False, out["check"]


def test_trace_without_device_events_fails():
    rc, out = _execute("zinc_score_kernel", trace=True)
    assert rc == 1 and out is None
