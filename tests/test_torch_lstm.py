"""The BiLSTM's plain version (ops/lstm.py) on the CPU: against the JAX
``BiLSTM`` (forward, and every gradient through ``jax.vjp``), its
written-out backward through time (the backward kernel's algorithm)
against autograd, and the cuDNN-form call the port used before
(``torch._VF.lstm``, ATen's CPU LSTM here).  The recurrence adds b_ih
itself and the backward kernel returns one bias gradient for b_ih and
b_hh: the JAX package's gradients of the two biases agree within f32
summation order, which is the algebra that rests on.

Inputs are made with numpy from a seed.  Tolerances: against JAX, f32
atol 1e-5 / rtol 1e-4 (the two sides sum the gate products in different
orders); the backward reference against autograd in float64 at 1e-12
(the same arithmetic in another order) and in f32 at atol 1e-5 of the
gradient's scale / rtol 1e-4; against ATen's LSTM at atol 2e-6 / rtol
1e-5 (ATen adds b_ih to the input projection and b_hh to the recurrent
product before the two meet, the plain cell adds xg, the product and
b_hh in that order: an ulp or two of each gate).
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kpgnn_tpu.ops.lstm as jlstm
from kpgnn_tpu_torch.ops import lstm
from kpgnn_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)
SHAPES = [(3, 17, 10, 4), (8, 64, 104, 8), (16, 9, 8, 16)]   # (T, B, F, H)


def flat(tree, coll="params"):
    return {f"{coll}/" + "/".join(map(str, k)): np.asarray(v)
            for k, v in flax.traverse_util.flatten_dict(tree).items()}


def jax_and_port(shape, time_major, seed=0):
    """The JAX module's variables and the port's module holding them, an
    input and an output cotangent in the call's layout."""
    T, B, F, H = shape
    rng = np.random.default_rng(seed)
    lay = (T, B) if time_major else (B, T)
    x = rng.normal(size=lay + (F,)).astype(np.float32)
    dy = rng.normal(size=lay + (2 * H,)).astype(np.float32)
    jm = jlstm.BiLSTM(H, time_major=time_major)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    tm = lstm.BiLSTM(F, H)
    tm.load_state_dict(params_from_flax(flat(v["params"])), strict=True)
    return jm, v, tm, x, dy


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_against_jax(shape, time_major):
    jm, v, tm, x, dy = jax_and_port(shape, time_major)
    out, vjp = jax.vjp(lambda p, x: jm.apply(p, x), v, jnp.asarray(x))
    gv, gx = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt, time_major=time_major)
    got.backward(torch.from_numpy(dy))
    tol = dict(atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    want = params_from_flax(flat(gv["params"]))
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **tol,
                                   err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_jax_bias_gradients_are_equal(shape):
    """gates = x W_ih^T + b_ih + h W_hh^T + b_hh: the JAX package's
    gradients of b_ih_fwd and b_hh_fwd (and of the _bwd pair) are one sum
    of the gate gradients, equal up to f32 summation order (rtol 1e-5,
    atol 1e-6 of the gradient's scale)."""
    jm, v, _, x, dy = jax_and_port(shape, time_major=True)
    _, vjp = jax.vjp(lambda p: jm.apply(p, jnp.asarray(x)), v)
    grads = flat(vjp(jnp.asarray(dy))[0]["params"])
    for d in ("fwd", "bwd"):
        g_ih, g_hh = grads[f"params/b_ih_{d}"], grads[f"params/b_hh_{d}"]
        assert g_ih.shape == g_hh.shape == (4 * shape[3],)
        np.testing.assert_allclose(g_ih, g_hh, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(g_hh).max()),
                                   err_msg=d)


def recurrence_inputs(shape, dtype, seed=1):
    """xm (T, B, 8H), w_hh (2, 4H, H), b_ih (8H,), b_hh (2, 4H), dy (T, B,
    2H)."""
    T, B, _, H = shape
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(H)
    return [torch.from_numpy(a).to(dtype) for a in (
        rng.normal(size=(T, B, 8 * H)),
        rng.uniform(-bound, bound, size=(2, 4 * H, H)),
        rng.uniform(-bound, bound, size=(8 * H,)),
        rng.uniform(-bound, bound, size=(2, 4 * H)),
        rng.normal(size=(T, B, 2 * H)))]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_reference_against_autograd(shape, dtype):
    """dxm, dw_hh and db against autograd's grads of xm, w_hh and b_hh,
    and db laid out as (8H,) against b_ih's."""
    xm, w_hh, b_ih, b_hh, dy = recurrence_inputs(shape, dtype)
    leaves = [t.clone().requires_grad_() for t in (xm, w_hh, b_ih, b_hh)]
    lstm.recurrence_reference(*leaves).backward(dy)
    dxm, dw, db = lstm.bilstm_backward_reference(xm, w_hh, b_ih, b_hh, dy)
    for name, g, want in (("dxm", dxm, leaves[0].grad),
                          ("dw_hh", dw, leaves[1].grad),
                          ("db_hh", db, leaves[3].grad),
                          ("db_ih", db.reshape(-1), leaves[2].grad)):
        if dtype == torch.float64:
            tol = dict(atol=1e-12, rtol=1e-12)
        else:
            tol = dict(atol=1e-5 * float(want.abs().max()), rtol=1e-4)
        torch.testing.assert_close(g, want, **tol, msg=lambda m: f"{name}: "
                                   f"{m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_bias_gradient_folds_as_autograd(shape, dtype):
    """``bias_gradient`` of autograd's own dxm gives autograd's b_hh
    gradient, and the backward reference's db is that fold: the order and
    the rounding the backward kernel reproduces.  The step sums run in
    float64 here and in torch's order in autograd, so each of the T terms
    of the fold and each partial sum may differ by an ulp: the bound is
    2T ulps at the scale of the sum of the terms' magnitudes."""
    T = shape[0]
    xm, w_hh, b_ih, b_hh, dy = (t.to(dtype) for t in recurrence_inputs(
        shape, torch.float64))
    leaves = [t.clone().requires_grad_() for t in (xm, w_hh, b_ih, b_hh)]
    lstm.recurrence_reference(*leaves).backward(dy)
    dxm = leaves[0].grad
    folded = lstm.bias_gradient(dxm)
    assert folded.dtype == dtype and folded.shape == b_hh.shape
    tol = 2 * T * torch.finfo(dtype).eps * lstm.step_sums(dxm).abs().sum(0)
    db = lstm.bilstm_backward_reference(xm, w_hh, b_ih, b_hh, dy)[2]
    for name, got in (("autograd", leaves[3].grad), ("reference", db)):
        over = (got.double() - folded.double()).abs() - tol
        assert float(over.max()) <= 0, name


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_against_aten_lstm(shape):
    T, B, F, H = shape
    tm = lstm.BiLSTM(F, H)
    tm.init_params(torch.Generator().manual_seed(2))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(T, B, F)).astype(np.float32))
    h0 = x.new_zeros(2, B, H)
    with torch.no_grad():
        want = torch._VF.lstm(x, (h0, h0), list(tm.lstm._flat_weights),
                              True, 1, 0.0, False, True, False)[0]
        torch.testing.assert_close(tm(x, time_major=True), want, atol=2e-6,
                                   rtol=1e-5)


def test_kernel_wrappers_refuse_what_the_kernel_does_not_take():
    """The checks run before any launch: a hidden size past MAX_HIDDEN,
    mismatched shapes or dtypes, and a CPU tensor (the kernel's wrappers
    launch or raise; only ``recurrence`` takes the plain version there)."""
    H = lstm.MAX_HIDDEN + 1
    xm, w_hh, b_ih, b_hh, _ = recurrence_inputs((2, 3, 0, H), torch.float32)
    with pytest.raises(ValueError, match="hidden sizes 1 to 16"):
        lstm.launch_forward(xm, w_hh, b_ih, b_hh)
    xm, w_hh, b_ih, b_hh, dy = recurrence_inputs((2, 3, 0, 4),
                                                 torch.float32)
    with pytest.raises(ValueError, match="do not fit"):
        lstm.launch_forward(xm[..., :-1], w_hh, b_ih, b_hh)
    with pytest.raises(ValueError, match="w_hh is torch.float64"):
        lstm.launch_forward(xm, w_hh.double(), b_ih, b_hh)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        lstm.launch_forward(xm, w_hh, b_ih, b_hh)
    y = lstm.recurrence_reference(xm, w_hh, b_ih, b_hh)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        lstm.launch_backward(dy, y, y, xm, w_hh, b_ih, b_hh)
    torch.testing.assert_close(lstm.recurrence(xm, w_hh, b_ih, b_hh), y,
                               rtol=0, atol=0)


# (what is wrong, the arguments' change, the error's pattern)
REFUSALS = [
    ("b_ih of one direction", lambda a: a.update(b_ih=a["b_ih"][:4]),
     "do not fit"),
    ("b_ih as b_hh's shape", lambda a: a.update(b_ih=a["b_ih"].view(2, -1)),
     "do not fit"),
    ("b_ih in float64", lambda a: a.update(b_ih=a["b_ih"].double()),
     "b_ih is torch.float64"),
    ("b_hh in bfloat16", lambda a: a.update(b_hh=a["b_hh"].bfloat16()),
     "b_hh is torch.bfloat16"),
    ("xm in float64", lambda a: a.update(
        **{k: a[k].double() for k in ("xm", "w_hh", "b_ih", "b_hh")}),
     "float32 or bfloat16"),
]


@pytest.mark.parametrize("what,change,pattern", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_kernel_wrappers_refuse_bad_biases_and_dtypes(what, change, pattern):
    """Both kernel wrappers refuse a b_ih or b_hh of another shape or dtype
    (and an input outside f32 and bf16) before anything else."""
    xm, w_hh, b_ih, b_hh, dy = recurrence_inputs((2, 3, 0, 4),
                                                 torch.float32)
    args = dict(xm=xm, w_hh=w_hh, b_ih=b_ih, b_hh=b_hh)
    change(args)
    with pytest.raises((ValueError, TypeError), match=pattern):
        lstm.launch_forward(**args)
    with pytest.raises((ValueError, TypeError), match=pattern):
        lstm.launch_backward(dy, dy, dy, **args)


def exact_fma(a: float, b: float, c: float) -> np.float32:
    """fmaf(a, b, c) rounded once to f32 (nearest, ties to even), from
    the exact rational value."""
    from fractions import Fraction
    exact = Fraction(a) * Fraction(b) + Fraction(c)
    x = np.float32(float(exact))
    cands = [np.nextafter(x, np.float32(-np.inf)), x,
             np.nextafter(x, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.float32(v).view(np.int32)) & 1))


def test_fma_f32_rounds_once():
    """``lstm.fma_f32`` (float64 with the sum's error kept) against the
    exact rational fmaf on values of spread exponents, and on sums that
    lie halfway between two f32 values in float64 while the exact value
    does not (where rounding the float64 sum again would be wrong)."""
    rng = np.random.default_rng(0)
    n = 3000
    a = (rng.normal(size=n) * 2.0 ** rng.integers(-20, 20, n)).astype(
        np.float32)
    b = rng.normal(size=n).astype(np.float32)
    c = (rng.normal(size=n) * 2.0 ** rng.integers(-20, 20, n)).astype(
        np.float32)
    # ties: a * b = 2^-24 (1 + 4688 * 2^-46), half an ulp of c = 1 and a
    # little more, whose float64 sum with c rounds to 1 + 2^-24, a tie
    # that rounding again breaks to 1 and the exact value to 1 + 2^-23;
    # and the same negated
    a[:2] = np.float32(1 + 2896 * 2.0 ** -23) * np.float32([1, -1])
    b[:2] = np.float32(2.0 ** -24 * (1 - 2895 * 2.0 ** -23))
    c[:2] = np.float32([1.0, -1.0])
    naive = (a[:2].astype(np.float64) * b[:2] + c[:2]).astype(np.float32)
    assert list(naive) == [1.0, -1.0]
    got = lstm.fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([exact_fma(float(x), float(y), float(z))
                     for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got, want)


class OrderedDh(torch.autograd.Function):
    """``torch.bmm(h, w_t)`` whose input gradient is summed as the card's
    cuBLAS sums autograd's product (``lstm.dh_product``); the weight
    gradient as autograd's."""

    @staticmethod
    def forward(ctx, h, w_t):
        ctx.save_for_backward(h, w_t)
        return BMM(h, w_t)

    @staticmethod
    def backward(ctx, g):
        h, w_t = ctx.saved_tensors
        return (lstm.dh_product(g.contiguous(), w_t.transpose(1, 2)),
                BMM(h.transpose(1, 2), g))


BMM = torch.bmm


@pytest.mark.parametrize("shape", SHAPES + [(5, 7, 6, 1)])
def test_backward_reference_sums_dh_as_the_card(monkeypatch, shape):
    """f32: the written-out backward (the backward kernel's algorithm) sums
    dh = dz @ W_hh in the kernel's order, one fmaf chain over the 4H rows
    ascending (at H = 1 two chains of two rows, added), and its dxm is
    then bit for bit the plain version's autograd on the card, whose
    cuBLAS product sums in that order at B > 1
    (``scripts/lstm_db_spread.py --dh_order``): here autograd of the
    plain cell with that product's input gradient summed so."""
    xm, w_hh, b_ih, b_hh, dy = recurrence_inputs(shape, torch.float32)
    dz = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, shape[1], 4 * shape[3])).astype(np.float32))
    rows = [(dz[:, :, r:r + 1], w_hh[:, None, r]) for r in range(dz.shape[2])]
    if shape[3] == 1:
        want = (lstm.fma_f32(*rows[1], rows[0][0] * rows[0][1])
                + lstm.fma_f32(*rows[3], rows[2][0] * rows[2][1]))
    else:
        want = rows[0][0] * rows[0][1]
        for a, b in rows[1:]:
            want = lstm.fma_f32(a, b, want)
    assert torch.equal(lstm.dh_product(dz, w_hh), want)
    leaves = [t.clone().requires_grad_() for t in (xm, w_hh, b_ih, b_hh)]
    monkeypatch.setattr(torch, "bmm", OrderedDh.apply)
    y = lstm.recurrence_reference(*leaves)
    monkeypatch.undo()
    y.backward(dy)
    dxm = lstm.bilstm_backward_reference(xm, w_hh, b_ih, b_hh, dy)[0]
    assert torch.equal(dxm, leaves[0].grad)
