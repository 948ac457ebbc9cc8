"""Bidirectional LSTM over a short axis (counterpart of
kpgnn_tpu/ops/lstm.py), on a hand-written recurrence kernel on the card.

The JAX module's structure, kept here: both directions' input
projections in ONE matmul (``input_projection``: ``xg = x @ W_ih_cat.T +
b_ih_cat``, (T, B, 8H)), then a recurrence that steps both directions at
once, ``gates = xg_t + h @ W_hh.T + b_hh`` in the gate order input,
forget, cell, output; the backward direction reads xg at T-1-t, with no
reversed copy of x.  Parameters initialize U(-1/sqrt(H), 1/sqrt(H)) from
an explicit generator and live in a ``torch.nn.LSTM`` used only as their
holder: its names (``lstm.weight_ih_l0``, ``..._reverse``) are the ones
``utils/convert``, checkpoints and the golden bundles know.

The recurrence: on a CPU tensor, the plain version
(``recurrence_reference``, under autograd); on a CUDA tensor, the kernel
of ``csrc/bilstm.cu`` (``recurrence``), forward and backward through
``_BiLSTMFn``, or a raise: nothing falls back to cuDNN or to the plain
version on the card.  The kernel replaces no TPU kernel: it replaces the
JAX package's unrolled ``lax.scan`` (kpgnn_tpu/ops/lstm.py:100), which
XLA fuses, and cuDNN's LSTM, which launches per time step and whose
error on the card was 1.3-2.6x the CPU's (PERF.md).  What bounds it on
the card, its design, the shapes it takes and where it rounds are in
the source's note.

Precision: the parameters stay f32.  The recurrence runs in the input's
dtype (bf16 under ``--bf16``), as the JAX module does: the weights and
the zero initial state are cast to it, and every op of the plain cell
rounds to it; the kernel's bf16 variant rounds at the same points.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import Tuple

import torch
from torch import nn

from . import cuda_lib

KERNEL_SOURCE = "bilstm.cu"
# hidden sizes the kernel takes (the source's kMaxH): the attention
# combine's H = K (16 at most, KPGINPrime K=16) and JK attention's H = L
MAX_HIDDEN = 16

# kernel launches by (variant_name, T, H); reset_launch_counts() zeroes it
launches: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launches.clear()


def _suffix(dtype: torch.dtype) -> str:
    return "f32" if dtype == torch.float32 else "bf16"


def variant_name(kind: str, dtype: torch.dtype) -> str:
    """``bilstm_fwd[f32]``, ``bilstm_bwd[bf16]``, ...: a launch's variant,
    as chip_smoke.py reports it."""
    return f"bilstm_{kind}[{_suffix(dtype)}]"


def input_projection(x: torch.Tensor, w_ih: torch.Tensor,
                     b_ih: torch.Tensor) -> torch.Tensor:
    """(T, B, F) -> (T, B, 8H): both directions' input gates in one
    matmul (forward direction's 4H columns first)."""
    return x @ w_ih.T + b_ih


def _run_reference(xg: torch.Tensor, w_hh: torch.Tensor,
                   b_hh: torch.Tensor):
    """The plain cell over xg, both directions a step: per processing step
    s the (2, B, 4H) activations (i, f, g, o), the (2, B, H) cell and
    hidden states."""
    T, B, _ = xg.shape
    H = w_hh.shape[2]
    G = 4 * H
    h = c = xg.new_zeros(2, B, H)
    acts, cs, hs = [], [], []
    for s in range(T):
        xs = torch.stack([xg[s, :, :G], xg[T - 1 - s, :, G:]])
        gates = xs + torch.bmm(h, w_hh.transpose(1, 2)) + b_hh[:, None]
        i, f, g, o = gates.chunk(4, -1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c = f * c + i * g
        h = o * torch.tanh(c)
        acts.append((i, f, g, o))
        cs.append(c)
        hs.append(h)
    return acts, cs, hs


def _time_order(per_step) -> torch.Tensor:
    """Processing-order (2, B, n) steps -> (T, B, 2n) in time order: the
    backward direction's step s is time T-1-s."""
    steps = torch.stack(per_step)                     # (T, 2, B, n)
    return torch.cat([steps[:, 0], steps.flip(0)[:, 1]], -1)


def recurrence_reference(xg: torch.Tensor, w_hh: torch.Tensor,
                         b_hh: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernel's forward: xg (T, B, 8H), w_hh (2,
    4H, H), b_hh (2, 4H) -> y (T, B, 2H), the forward direction's h
    first, in xg's dtype; differentiable."""
    return _time_order(_run_reference(xg, w_hh, b_hh)[2])


def bilstm_reference(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                     b_ih: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """The BiLSTM in plain torch ops, the JAX module's structure: x (T, B,
    F), w_ih (8H, F) and b_ih (8H,) both directions' input weights (the
    forward's first), w_hh (2, 4H, H), b_hh (2, 4H) -> (T, B, 2H)."""
    return recurrence_reference(input_projection(x, w_ih, b_ih), w_hh, b_hh)


def bilstm_backward_reference(xg: torch.Tensor, w_hh: torch.Tensor,
                              b_hh: torch.Tensor, dy: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Backpropagation through time of ``recurrence_reference`` written out
    in torch ops, the algorithm of the kernel's backward: the forward
    again, keeping each step's activations and cell state, then the steps
    in reverse processing order.  Returns (dxg (T, B, 8H), dw_hh (2, 4H,
    H), db_hh (2, 4H)) for the output gradient dy (T, B, 2H)."""
    H = w_hh.shape[2]
    with torch.no_grad():
        acts, cs, hs = _run_reference(xg, w_hh, b_hh)
        dys = torch.stack([dy[:, :, :H], dy.flip(0)[:, :, H:]], 1)
        zero = xg.new_zeros(hs[0].shape)
        dh = dc = zero
        dw, db = torch.zeros_like(w_hh), torch.zeros_like(b_hh)
        dzs = [None] * len(hs)
        for s in reversed(range(len(hs))):
            i, f, g, o = acts[s]
            c_prev, h_prev = (cs[s - 1], hs[s - 1]) if s else (zero, zero)
            dh_s = dys[s] + dh
            tc = torch.tanh(cs[s])
            dc_s = dc + dh_s * o * (1 - tc * tc)
            dz = torch.cat([dc_s * g * i * (1 - i),
                            dc_s * c_prev * f * (1 - f),
                            dc_s * i * (1 - g * g),
                            dh_s * tc * o * (1 - o)], -1)   # (2, B, 4H)
            dc = dc_s * f
            dh = torch.bmm(dz, w_hh)
            dw += torch.bmm(dz.transpose(1, 2), h_prev)
            db += dz.sum(1)
            dzs[s] = dz
    return _time_order(dzs), dw, db


def _check(xg: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> int:
    """The hidden size H of a valid (xg, w_hh, b_hh); raises on what the
    kernel does not take."""
    if xg.dim() != 3 or w_hh.dim() != 3 or w_hh.shape[0] != 2:
        raise ValueError(f"xg must be (T, B, 8H) and w_hh (2, 4H, H), got "
                         f"{tuple(xg.shape)} and {tuple(w_hh.shape)}")
    H = w_hh.shape[2]
    if (w_hh.shape[1] != 4 * H or xg.shape[2] != 8 * H
            or tuple(b_hh.shape) != (2, 4 * H)):
        raise ValueError(f"shapes xg {tuple(xg.shape)}, w_hh "
                         f"{tuple(w_hh.shape)}, b_hh {tuple(b_hh.shape)} do "
                         f"not fit one hidden size")
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"the BiLSTM kernel takes hidden sizes 1 to "
                         f"{MAX_HIDDEN}, got {H}")
    if xg.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"xg must be float32 or bfloat16, got {xg.dtype}")
    for name, t in (("w_hh", w_hh), ("b_hh", b_hh)):
        if t.dtype != xg.dtype or t.device != xg.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, xg "
                             f"{xg.dtype} on {xg.device}")
    if xg.numel() >= 2 ** 31:
        raise ValueError("the kernel indexes xg with 32-bit ints")
    return H


def _fn(name: str, n_ptr: int):
    fn = getattr(cuda_lib.load(KERNEL_SOURCE), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, kind: str) -> None:
    if err != 0:
        raise RuntimeError(f"bilstm {kind} kernel launch failed: cudaError "
                           f"{err}")


def launch_forward(xg: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                   save: bool):
    """One launch of the forward kernel on contiguous CUDA tensors: (y
    (T, B, 2H), and with ``save`` the activations (T, B, 8H) and cell
    states (T, B, 2H) the backward reads, else None, None), all in xg's
    dtype.  Counts the launch."""
    H = _check(xg, w_hh, b_hh)
    if xg.device.type != "cuda":
        raise ValueError(f"no kernel for device {xg.device}")
    T, B, _ = xg.shape
    y = xg.new_empty(T, B, 2 * H)
    act = xg.new_empty(xg.shape) if save else None
    cst = xg.new_empty(y.shape) if save else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _fn(f"kpgnn_bilstm_fwd_{_suffix(xg.dtype)}", 6)(
        xg.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), y.data_ptr(),
        ptr(act), ptr(cst), T, B, H, _stream(xg))
    _raise_on(err, "forward")
    launches[variant_name("fwd", xg.dtype), T, H] += 1
    return y, act, cst


def launch_backward(dy: torch.Tensor, y: torch.Tensor, act: torch.Tensor,
                    cst: torch.Tensor, w_hh: torch.Tensor):
    """One launch of the backward kernel: (dxg (T, B, 8H) in the forward's
    dtype, dw_hh (2, 4H, H) and db_hh (2, 4H) in w_hh's dtype).  The
    kernel writes one f32 partial of dw_hh and db_hh a block (the
    library's ``kpgnn_bilstm_partials`` of them), with no atomics; their
    sum over blocks is one ``torch.sum`` in a fixed order, so the
    gradients repeat bit for bit.  Counts the launch."""
    T, B, H2 = y.shape
    H = H2 // 2
    dy = dy.to(y.dtype).contiguous()
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    dxg = torch.empty_like(act)
    G = 4 * H
    lib = cuda_lib.load(KERNEL_SOURCE)
    lib.kpgnn_bilstm_partials.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.kpgnn_bilstm_partials.restype = ctypes.c_int
    part = torch.empty(lib.kpgnn_bilstm_partials(B, H), 2, G * H + G,
                       dtype=torch.float32, device=y.device)
    err = _fn(f"kpgnn_bilstm_bwd_{_suffix(y.dtype)}", 7)(
        dy.data_ptr(), y.data_ptr(), act.data_ptr(), cst.data_ptr(),
        w_hh.data_ptr(), dxg.data_ptr(), part.data_ptr(), T, B, H,
        _stream(y))
    _raise_on(err, "backward")
    launches[variant_name("bwd", y.dtype), T, H] += 1
    total = part.sum(0)
    dw = total[:, :G * H].reshape(2, G, H).to(w_hh.dtype)
    return dxg, dw, total[:, G * H:].to(w_hh.dtype)


class _BiLSTMFn(torch.autograd.Function):
    """The recurrence on the kernel, forward and backward (csrc/bilstm.cu):
    (xg, w_hh, b_hh) -> y."""

    @staticmethod
    def forward(ctx, xg, w_hh, b_hh):
        y, act, cst = launch_forward(xg, w_hh, b_hh, save=True)
        ctx.save_for_backward(y, act, cst, w_hh)
        return y

    @staticmethod
    def backward(ctx, dy):
        y, act, cst, w_hh = ctx.saved_tensors
        return launch_backward(dy, y, act, cst, w_hh)


def recurrence(xg: torch.Tensor, w_hh: torch.Tensor,
               b_hh: torch.Tensor) -> torch.Tensor:
    """xg (T, B, 8H), w_hh (2, 4H, H), b_hh (2, 4H) -> y (T, B, 2H) in xg's
    dtype.  On a CUDA tensor the kernel (its backward through
    ``_BiLSTMFn`` where a gradient is wanted, else a forward that saves
    nothing), or a raise; only a CPU tensor takes the plain version."""
    if xg.device.type == "cpu":
        return recurrence_reference(xg, w_hh, b_hh)
    xg, w_hh, b_hh = (t.contiguous() for t in (xg, w_hh, b_hh))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xg, w_hh, b_hh)):
        return _BiLSTMFn.apply(xg, w_hh, b_hh)
    return launch_forward(xg, w_hh, b_hh, save=False)[0]


class BiLSTM(nn.Module):
    """One-layer bidirectional LSTM: (B, T, F) -> (B, T, 2H); a call
    with ``time_major=True`` takes (T, B, F) -> (T, B, 2H)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.lstm = nn.LSTM(input_size, hidden_size, num_layers=1,
                            bidirectional=True)

    def init_params(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.lstm.parameters():
                p.copy_(torch.empty_like(p).uniform_(
                    -bound, bound, generator=generator))

    def weights(self, dtype: torch.dtype):
        """(w_ih (8H, F), w_hh (2, 4H, H), b_ih (8H,), b_hh (2, 4H)) in
        ``dtype``, the forward direction's first."""
        p = self.lstm
        return (torch.cat([p.weight_ih_l0, p.weight_ih_l0_reverse]).to(dtype),
                torch.stack([p.weight_hh_l0, p.weight_hh_l0_reverse]
                            ).to(dtype),
                torch.cat([p.bias_ih_l0, p.bias_ih_l0_reverse]).to(dtype),
                torch.stack([p.bias_hh_l0, p.bias_hh_l0_reverse]).to(dtype))

    def forward(self, x: torch.Tensor,
                time_major: bool = False) -> torch.Tensor:
        seq = x if time_major else x.transpose(0, 1)
        w_ih, w_hh, b_ih, b_hh = self.weights(x.dtype)
        out = recurrence(input_projection(seq, w_ih, b_ih), w_hh, b_hh)
        return out if time_major else out.transpose(0, 1)


def plain_bilstm(module: BiLSTM, x: torch.Tensor,
                 time_major: bool = False) -> torch.Tensor:
    """``module``'s output by the plain version (``bilstm_reference``) on
    any device: on the card, the kernel's yardstick."""
    seq = x if time_major else x.transpose(0, 1)
    out = bilstm_reference(seq, *module.weights(x.dtype))
    return out if time_major else out.transpose(0, 1)
