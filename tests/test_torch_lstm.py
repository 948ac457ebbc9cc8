"""The BiLSTM's plain version (ops/lstm.py) on the CPU: against the JAX
``BiLSTM`` (forward, and every gradient through ``jax.vjp``), its
written-out backward through time (the backward kernel's algorithm)
against autograd, and the cuDNN-form call the port used before
(``torch._VF.lstm``, ATen's CPU LSTM here).

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


def recurrence_inputs(shape, dtype, seed=1):
    T, B, _, H = shape
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(H)
    return [torch.from_numpy(a).to(dtype) for a in (
        rng.normal(size=(T, B, 8 * H)),
        rng.uniform(-bound, bound, size=(2, 4 * H, H)),
        rng.uniform(-bound, bound, size=(2, 4 * H)),
        rng.normal(size=(T, B, 2 * H)))]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_reference_against_autograd(shape, dtype):
    xg, w_hh, b_hh, dy = recurrence_inputs(shape, dtype)
    leaves = [t.clone().requires_grad_() for t in (xg, w_hh, b_hh)]
    lstm.recurrence_reference(*leaves).backward(dy)
    got = lstm.bilstm_backward_reference(xg, w_hh, b_hh, dy)
    for name, g, leaf in zip(("dxg", "dw_hh", "db_hh"), got, leaves):
        want = leaf.grad
        if dtype == torch.float64:
            tol = dict(atol=1e-12, rtol=1e-12)
        else:
            tol = dict(atol=1e-5 * float(want.abs().max()), rtol=1e-4)
        torch.testing.assert_close(g, want, **tol, msg=lambda m: f"{name}: "
                                   f"{m}")


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
    xg, w_hh, b_hh, _ = recurrence_inputs((2, 3, 0, H), torch.float32)
    with pytest.raises(ValueError, match="hidden sizes 1 to 16"):
        lstm.launch_forward(xg, w_hh, b_hh, save=False)
    xg, w_hh, b_hh, _ = recurrence_inputs((2, 3, 0, 4), torch.float32)
    with pytest.raises(ValueError, match="do not fit"):
        lstm.launch_forward(xg[..., :-1], w_hh, b_hh, save=False)
    with pytest.raises(ValueError, match="w_hh is torch.float64"):
        lstm.launch_forward(xg, w_hh.double(), b_hh, save=False)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        lstm.launch_forward(xg, w_hh, b_hh, save=False)
    torch.testing.assert_close(lstm.recurrence(xg, w_hh, b_hh),
                               lstm.recurrence_reference(xg, w_hh, b_hh),
                               rtol=0, atol=0)
