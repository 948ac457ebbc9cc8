"""The BiLSTM recurrence kernels (csrc/bilstm.cu) on the card, against
their plain version (``ops/lstm.recurrence_reference``) on the same
values.

Every case runs T in {1, 2, 8, 9, 16, 17} (17 passes the kernels' 16
staged steps and takes their rings; T = H = 8 is the flagship's combine),
every hidden size H in {1, 2, 3, 4, 5, 6, 8, 9, 16} (each of the kernels'
capacities 2, 4, 8 and 16, full and padded, and the repo's H = 4 and 6),
and B in {0, 1, 7, tile + 1, 4,095} sequences (the tiles are the
forward's block of 64 / capacity sequences and the backward's of 128 /
capacity, so tile + 1 leaves a last block of one), f32 and
bf16, forward (y) and backward (dxm, dW_hh, db_hh, db_ih from a random
dy).  The values lie on a grid of 1/256 with |v| < 1, exact in bf16, so
the f32, bf16 and float64 runs see the same inputs.  The gate for y,
dxm, dW_hh and db_hh: the kernel's largest error against the plain
version in float64 is at most twice the plain version's own in the
kernel's dtype, plus one ulp of that dtype at the output's scale.  The
kernels sum the gate products in the plain cell's order and round where
its ops and autograd's round, so in f32 y equals the plain version's bit
for bit from B = 7 on (for one sequence cuBLAS sums the plain version's
h @ W_hh.T in another order).  The bias gradient is also held to what it is, the
sum of dxm over the sequences at each step, folded over the steps as
autograd folds the plain version's (``lstm.bias_gradient`` of the
kernel's own dxm, within one ulp of the dtype at the scale of the
fold's terms).  db_ih is a copy of the kernels' one bias gradient and
must equal db_hh bit for bit.  A second run
repeats every output bit for bit (dW_hh and db summed in a fixed order,
no atomics), each run launches the forward and the backward kernel
once, and a hidden size past 16 raises.

A CUDA kernel has no CPU form, so every case needs a card and skips
without one.  On the card, without the JAX package's conftest:

    python -m pytest -q -p no:cacheprovider --noconftest -o addopts= \\
        tests/test_torch_lstm_cuda.py
"""
import numpy as np
import pytest
import torch

from kpgnn_tpu_torch.ops import lstm
from kpgnn_tpu_torch.utils.profiling import launch_counts, reset_launch_counts

pytestmark = pytest.mark.cuda

STEPS = [1, 2, 8, 9, 16, 17]
HIDDEN = [1, 2, 3, 4, 5, 6, 8, 9, 16]
ULP = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -8}
NAMES = ("y", "dxm", "dw_hh", "db_ih", "db_hh")


def tiles(H):
    """Sequences a block of the forward and of the backward kernel holds
    at hidden size H (the source's tiles: 64 and 128 / the least capacity
    2, 4, 8, 16 that holds H)."""
    cap = next(c for c in (2, 4, 8, 16) if H <= c)
    return 64 // cap, 128 // cap


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU form")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def grid_inputs(T, B, H, dev, seed=0):
    """xm (T, B, 8H), w_hh (2, 4H, H), b_ih (8H,), b_hh (2, 4H) and dy (T,
    B, 2H) on a 1/256 grid in (-1, 1), float64."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(np.round(rng.uniform(-1, 1, s) * 255) / 256
                             ).to(dev)
            for s in ((T, B, 8 * H), (2, 4 * H, H), (8 * H,), (2, 4 * H),
                      (T, B, 2 * H))]


def run(fn, xm, w_hh, b_ih, b_hh, dy):
    """(y, dxm, dw_hh, db_ih, db_hh) of ``fn`` under autograd."""
    leaves = [t.clone().requires_grad_() for t in (xm, w_hh, b_ih, b_hh)]
    y = fn(*leaves)
    y.backward(dy.to(y.dtype))
    return [y.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", HIDDEN)
@pytest.mark.parametrize("T", STEPS)
def test_kernel_against_plain_version(dev, T, H, dtype):
    for B in (0, 1, 7, *(n + 1 for n in tiles(H)), 4095):
        inputs = grid_inputs(T, B, H, dev)
        exact = run(lstm.recurrence_reference, *inputs)
        cast = [t.to(dtype) for t in inputs]
        plain = run(lstm.recurrence_reference, *cast)
        reset_launch_counts()
        got = run(lstm.recurrence, *cast)
        torch.cuda.synchronize()
        assert dict(launch_counts("bilstm", by_shape=True)) == {
            (lstm.variant_name("fwd", dtype), (T, H)): 1,
            (lstm.variant_name("bwd", dtype), (T, H)): 1}, B
        for name, g, p, e in zip(NAMES, got, plain, exact):
            assert g.dtype == dtype and g.shape == e.shape, (name, B)
            if B == 0:
                assert not g.any(), (name, B)
                continue
            if name == "db_ih":                # equal to db_hh, below
                continue
            err = float((g.double() - e).abs().max())
            own = float((p.double() - e).abs().max())
            tol = 2 * own + ULP[dtype] * float(e.abs().max())
            assert err <= tol, (f"B={B} {name}: kernel {err:.3e}, plain "
                                f"{own:.3e} from float64 (tol {tol:.3e})")
        if dtype == torch.float32 and B >= 7:
            assert torch.equal(got[0], plain[0]), f"B={B}: y != plain"
        assert torch.equal(got[3], got[4].reshape(-1)), f"B={B}: db_ih"
        if B:                               # db is the fold of its dxm
            want = lstm.bias_gradient(got[1]).double()
            tol = (torch.finfo(dtype).eps
                   * lstm.step_sums(got[1]).abs().sum(0))
            err = (got[4].double() - want).abs()
            assert bool((err <= tol).all()), (
                f"B={B} db: {float(err.max()):.3e} from the fold of dxm")
        again = run(lstm.recurrence, *cast)
        for name, g, a in zip(NAMES, got, again):
            assert torch.equal(g, a), f"B={B}: {name} differs on a repeat"


def test_eval_forward_equals_train_forward(dev):
    """The forward is one launch with or without a gradient to come."""
    xm, w_hh, b_ih, b_hh, _ = (t.float() for t in grid_inputs(8, 300, 8,
                                                               dev))
    with torch.no_grad():
        y_eval = lstm.recurrence(xm, w_hh, b_ih, b_hh)
    y_train = lstm.recurrence(xm.requires_grad_(), w_hh, b_ih, b_hh)
    assert torch.equal(y_eval, y_train.detach())


@pytest.mark.parametrize("H", [1, 3, 8])
def test_backward_takes_unaligned_inputs(dev, H):
    """dy, y and c at an address off 16 bytes, or ending inside a 16-byte
    word of their storage, give the aligned launch's gradients bit for
    bit (the wrapper stages a padded copy)."""
    xm, w_hh, b_ih, b_hh, dy = (t.float() for t in grid_inputs(5, 33, H,
                                                                dev))
    y, c = lstm.launch_forward(xm, w_hh, b_ih, b_hh)
    want = lstm.launch_backward(dy, y, c, xm, w_hh, b_ih, b_hh)

    def shifted(t):
        return torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
    got = lstm.launch_backward(shifted(dy), shifted(y), shifted(c), xm,
                               w_hh, b_ih, b_hh)
    for name, g, w in zip(("dxm", "dw_hh", "db_hh", "db_ih"), got, want):
        assert torch.equal(g, w), name


def test_unsupported_hidden_size_raises(dev):
    xm, w_hh, b_ih, b_hh, _ = grid_inputs(2, 3, lstm.MAX_HIDDEN + 1, dev)
    with pytest.raises(ValueError, match="hidden sizes 1 to 16"):
        lstm.recurrence(xm.float(), w_hh.float(), b_ih.float(),
                        b_hh.float())
