"""The BiLSTM recurrence kernel (csrc/bilstm.cu) on the card, against its
plain version (``ops/lstm.recurrence_reference``) on the same values.

Every (T, H) the source's note lists: the attention combine's H = T = K
(2, 3, 4, 6, 8, 16) and JK attention's H = L = 2 at T = L + 1 = 3, and H
= 1 and 12 (padded to the kernel's capacities 2 and 16), at B
= 77 sequences (the last block part full at every capacity), f32 and
bf16, forward (y) and backward (dxg, dW_hh, db_hh from a random dy).  The
values lie on a grid of 1/256 with |v| < 1, exact in bf16, so the f32,
bf16 and float64 runs see the same inputs.  The gate: the kernel's
largest error against the plain version in float64 is at most twice the
plain version's own in the kernel's dtype, plus one ulp of that dtype at
the output's scale.  The kernel sums the gate products in another order
than cuBLAS and rounds where the plain cell's ops round, so in f32 and
in the bf16 forward the two err alike; its bf16 backward computes in f32
from the rounded activations and errs less than autograd in bf16, which
rounds at every op.  A second run repeats every output bit for bit
(partials of dW_hh and db_hh a block, no atomics), each run launches the
forward and the backward kernel once, and a hidden size past 16 raises.

A CUDA kernel has no CPU form, so every case needs a card and skips
without one.  On the card, without the JAX package's conftest:

    python -m pytest -q -p no:cacheprovider --noconftest -o addopts= \\
        tests/test_torch_lstm_cuda.py
"""
import numpy as np
import pytest
import torch

from kpgnn_tpu_torch.ops import lstm

pytestmark = pytest.mark.cuda

# (T, H): the combine's H = T = K, JK attention's T = L + 1, H = L, and
# two more hidden sizes padded to the kernel's capacities 2 and 16
SHAPES = [(2, 2), (3, 3), (4, 4), (6, 6), (8, 8), (16, 16), (3, 2), (2, 1),
          (5, 12)]
B = 77
ULP = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -8}


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU form")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def grid_inputs(T, H, dev, seed=0):
    """xg (T, B, 8H), w_hh (2, 4H, H), b_hh (2, 4H) and dy (T, B, 2H) on
    a 1/256 grid in (-1, 1), float64."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(np.round(rng.uniform(-1, 1, s) * 255) / 256
                             ).to(dev)
            for s in ((T, B, 8 * H), (2, 4 * H, H), (2, 4 * H),
                      (T, B, 2 * H))]


def run(fn, xg, w_hh, b_hh, dy):
    """(y, dxg, dw_hh, db_hh) of ``fn`` under autograd."""
    leaves = [t.clone().requires_grad_() for t in (xg, w_hh, b_hh)]
    y = fn(*leaves)
    y.backward(dy.to(y.dtype))
    return [y.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,H", SHAPES)
def test_kernel_against_plain_version(dev, T, H, dtype):
    inputs = grid_inputs(T, H, dev)
    exact = run(lstm.recurrence_reference, *inputs)
    cast = [t.to(dtype) for t in inputs]
    plain = run(lstm.recurrence_reference, *cast)
    lstm.reset_launch_counts()
    got = run(lstm.recurrence, *cast)
    torch.cuda.synchronize()
    assert dict(lstm.launches) == {(lstm.variant_name("fwd", dtype), T, H): 1,
                                   (lstm.variant_name("bwd", dtype), T, H): 1}
    for name, g, p, e in zip(("y", "dxg", "dw_hh", "db_hh"), got, plain,
                             exact):
        assert g.dtype == dtype and g.shape == e.shape, name
        err = float((g.double() - e).abs().max())
        own = float((p.double() - e).abs().max())
        tol = 2 * own + ULP[dtype] * float(e.abs().max())
        assert err <= tol, (f"{name}: kernel {err:.3e}, plain {own:.3e} "
                            f"from float64 (tol {tol:.3e})")
    again = run(lstm.recurrence, *cast)
    for name, g, a in zip(("y", "dxg", "dw_hh", "db_hh"), got, again):
        assert torch.equal(g, a), f"{name} differs on a repeat"


def test_eval_forward_saves_nothing_and_equals_train_forward(dev):
    xg, w_hh, b_hh, _ = grid_inputs(8, 8, dev)
    with torch.no_grad():
        y_eval = lstm.recurrence(xg.float(), w_hh.float(), b_hh.float())
    y_train = lstm.recurrence(xg.float().requires_grad_(), w_hh.float(),
                              b_hh.float())
    assert torch.equal(y_eval, y_train.detach())


def test_unsupported_hidden_size_raises(dev):
    xg, w_hh, b_hh, _ = grid_inputs(2, lstm.MAX_HIDDEN + 1, dev)
    with pytest.raises(ValueError, match="hidden sizes 1 to 16"):
        lstm.recurrence(xg.float(), w_hh.float(), b_hh.float())
