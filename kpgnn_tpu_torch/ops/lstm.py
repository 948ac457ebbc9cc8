"""Bidirectional LSTM over a short axis (counterpart of
kpgnn_tpu/ops/lstm.py), on hand-written recurrence kernels on the card.

The JAX module's structure, kept here: both directions' input products
in ONE matmul (``input_projection``: ``xm = x @ W_ih_cat.T``, (T, B,
8H)), then a recurrence that steps both directions at once, ``gates =
(xm_t + b_ih) + h @ W_hh.T + b_hh`` in the gate order input, forget,
cell, output; the backward direction reads xm at T-1-t, with no reversed
copy of x.  The recurrence adds b_ih (the JAX module's ``tm @ w_ih.T +
b_ih``, rounded alike), so ``recurrence(xm, w_hh, b_ih, b_hh)`` and its
plain version ``recurrence_reference`` take the same arguments and no
pass over xm adds the bias.  Parameters initialize U(-1/sqrt(H),
1/sqrt(H)) from an explicit generator and live in a ``torch.nn.LSTM``
used only as their holder: its names (``lstm.weight_ih_l0``,
``..._reverse``) are the ones ``utils/convert``, checkpoints and the
golden bundles know.

The recurrence: on a CPU tensor, the plain version
(``recurrence_reference``, under autograd); on a CUDA tensor, the kernels
of ``csrc/bilstm.cu`` (``recurrence``): ``launch_forward`` (y and the
cell states c, nothing else saved, for training and eval alike) and,
through ``_BiLSTMFn``, ``launch_backward`` (dxm, dW_hh and the one bias
gradient, which serves b_ih and b_hh, all summed inside the kernel), or
a raise: nothing falls back to cuDNN or to the plain version on the
card.  ``bilstm_backward_reference`` writes the backward kernel's
algorithm out in torch ops.  The kernels replace no TPU kernel: they
replace the JAX package's unrolled ``lax.scan``
(kpgnn_tpu/ops/lstm.py:100), which XLA fuses, and cuDNN's LSTM, which
launches per time step and whose error on the card was 1.3-2.6x the
CPU's (PERF.md).  What bounds them on the card, their design, the
shapes they take and where they round are in the source's note.

Precision: the parameters stay f32.  The recurrence runs in the input's
dtype (bf16 under ``--bf16``), as the JAX module does: the weights and
the zero initial state are cast to it, and every op of the plain cell
rounds to it; the kernels' bf16 variants round at the same points.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..utils.profiling import count_launch
from . import cuda_lib

KERNEL_SOURCE = "bilstm.cu"
# hidden sizes the kernel takes (the source's kMaxH): the attention
# combine's H = K (16 at most, KPGINPrime K=16) and JK attention's H = L
MAX_HIDDEN = 16

def _suffix(dtype: torch.dtype) -> str:
    return "f32" if dtype == torch.float32 else "bf16"


def variant_name(kind: str, dtype: torch.dtype) -> str:
    """``bilstm_fwd[f32]``, ``bilstm_bwd[bf16]``, ...: a launch's variant,
    as chip_smoke.py reports it."""
    return f"bilstm_{kind}[{_suffix(dtype)}]"


def input_projection(x: torch.Tensor, w_ih: torch.Tensor) -> torch.Tensor:
    """(T, B, F) -> (T, B, 8H): both directions' input products in one
    matmul (forward direction's 4H columns first), without b_ih, which
    the recurrence adds."""
    return x @ w_ih.T


def _run_reference(xm: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                   b_hh: torch.Tensor):
    """The plain cell over xm + b_ih, both directions a step: per
    processing step s the (2, B, 4H) activations (i, f, g, o), the (2, B,
    H) cell and hidden states."""
    xg = xm + b_ih
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


def recurrence_reference(xm: torch.Tensor, w_hh: torch.Tensor,
                         b_ih: torch.Tensor, b_hh: torch.Tensor
                         ) -> torch.Tensor:
    """The plain version of the kernels: xm (T, B, 8H), w_hh (2, 4H, H),
    b_ih (8H,), b_hh (2, 4H) -> y (T, B, 2H), the forward direction's h
    first, in xm's dtype; differentiable."""
    return _time_order(_run_reference(xm, w_hh, b_ih, b_hh)[2])


def bilstm_reference(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                     b_ih: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """The BiLSTM in plain torch ops, the JAX module's structure: x (T, B,
    F), w_ih (8H, F) and b_ih (8H,) both directions' input weights (the
    forward's first), w_hh (2, 4H, H), b_hh (2, 4H) -> (T, B, 2H)."""
    return recurrence_reference(input_projection(x, w_ih), w_hh, b_ih, b_hh)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """fmaf(a, b, c) of f32 tensors, rounded once, computed in float64 on
    any device: a * b is exact there, the sum's rounding error is kept
    (TwoSum), and a float64 sum that lies halfway between two f32 values
    rounds to the side of that error."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.float()
    inf = torch.full_like(r, math.inf)
    other = torch.nextafter(r, torch.where(s > r.double(), inf, -inf))
    tie = (s != r.double()) & ((r.double() + other.double()) / 2 == s)
    toward = torch.sign(other.double() - r.double()) == torch.sign(err)
    return torch.where(tie & (err != 0) & toward, other, r)


def dh_chain(H: int) -> int:
    """The rows of W_hh one fmaf chain of f32 dh = dz @ W_hh sums, at
    hidden size H: the backward kernel (``dh_sum`` in csrc/bilstm.cu)
    runs chains of this many rows ascending from row 0, each from 0, and
    adds them in order: one chain over all 4H rows, two chains of two at
    H = 1.  Those are the orders of the card's cuBLAS for the plain
    cell's product at B > 1 (scripts/lstm_db_spread.py --dh_order)."""
    return 2 if H == 1 else 4 * H


def dh_product(dz: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """dh = dz @ W_hh, (2, B, 4H) x (2, 4H, H), the gradient a step hands
    to h_{t-1}, summed as the backward kernel sums it in f32
    (``dh_chain``).  That is the card's cuBLAS's order, so on a CUDA
    tensor, and in another dtype, this is ``torch.bmm``; on a CPU f32
    tensor the chains are written out (``fma_f32``)."""
    if dz.dtype != torch.float32 or dz.is_cuda:
        return torch.bmm(dz, w_hh)
    step = dh_chain(w_hh.shape[2])
    out = None
    for lo in range(0, dz.shape[2], step):
        acc = dz[:, :, lo:lo + 1] * w_hh[:, None, lo]
        for r in range(lo + 1, lo + step):
            acc = fma_f32(dz[:, :, r:r + 1], w_hh[:, None, r], acc)
        out = acc if out is None else out + acc
    return out


def bilstm_backward_reference(xm: torch.Tensor, w_hh: torch.Tensor,
                              b_ih: torch.Tensor, b_hh: torch.Tensor,
                              dy: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Backpropagation through time of ``recurrence_reference`` written out
    in torch ops, the algorithm of the backward kernel: the forward again
    (the kernel recomputes each step's activations from xm, y and c),
    then the steps in reverse processing order, each op the one autograd
    runs for the plain cell (ATen's sigmoid_backward and tanh_backward),
    so the values round as autograd's do, and dh summed as the card's
    cuBLAS sums autograd's product (``dh_product``).  Returns (dxm (T, B, 8H),
    dw_hh (2, 4H, H), db (2, 4H)) for the output gradient dy (T, B, 2H);
    db is the gradient of b_hh and, laid out as (8H,), of b_ih."""
    H = w_hh.shape[2]
    sigmoid_bw = torch.ops.aten.sigmoid_backward
    tanh_bw = torch.ops.aten.tanh_backward
    with torch.no_grad():
        acts, cs, hs = _run_reference(xm, w_hh, b_ih, b_hh)
        dys = torch.stack([dy[:, :, :H], dy.flip(0)[:, :, H:]], 1)
        zero = xm.new_zeros(hs[0].shape)
        dh = dc = zero
        dw, db = torch.zeros_like(w_hh), torch.zeros_like(b_hh)
        dzs = [None] * len(hs)
        for s in reversed(range(len(hs))):
            i, f, g, o = acts[s]
            c_prev, h_prev = (cs[s - 1], hs[s - 1]) if s else (zero, zero)
            dh_s = dys[s] + dh
            tc = torch.tanh(cs[s])
            dc_s = tanh_bw(dh_s * o, tc) + dc
            dz = torch.cat([sigmoid_bw(dc_s * g, i),
                            sigmoid_bw(dc_s * c_prev, f),
                            tanh_bw(dc_s * i, g),
                            sigmoid_bw(dh_s * tc, o)], -1)   # (2, B, 4H)
            dc = dc_s * f
            dh = dh_product(dz, w_hh)
            dw += torch.bmm(dz.transpose(1, 2), h_prev)
            db += dz.sum(1)
            dzs[s] = dz
    return _time_order(dzs), dw, db


def step_sums(dxm: torch.Tensor) -> torch.Tensor:
    """dxm (T, B, 8H) summed over the sequences at each processing step s
    (direction 0's rows at time s, direction 1's at T-1-s), in float64:
    (T, 2, 4H)."""
    G = dxm.shape[2] // 2
    x = dxm.double()
    return torch.stack([x[:, :, :G].sum(1), x.flip(0)[:, :, G:].sum(1)], 1)


def bias_gradient(dxm: torch.Tensor) -> torch.Tensor:
    """The bias gradient (2, 4H) as the backward kernel forms it from dxm
    (T, B, 8H): the ``step_sums`` rounded to dxm's dtype (through f32),
    folded in that dtype from the last step to the first.  That is how
    autograd sums the plain cell's b_hh gradient: one sum over B a step,
    added up in the order the backward reaches the steps."""
    per = step_sums(dxm)
    T = per.shape[0]
    db = per[T - 1].float().to(dxm.dtype)
    for s in range(T - 2, -1, -1):
        db = db + per[s].float().to(dxm.dtype)
    return db


def _check(xm: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
           b_hh: torch.Tensor) -> int:
    """The hidden size H of a valid (xm, w_hh, b_ih, b_hh); raises on what
    the kernels do not take."""
    if xm.dim() != 3 or w_hh.dim() != 3 or w_hh.shape[0] != 2:
        raise ValueError(f"xm must be (T, B, 8H) and w_hh (2, 4H, H), got "
                         f"{tuple(xm.shape)} and {tuple(w_hh.shape)}")
    H = w_hh.shape[2]
    if (w_hh.shape[1] != 4 * H or xm.shape[2] != 8 * H
            or tuple(b_ih.shape) != (8 * H,)
            or tuple(b_hh.shape) != (2, 4 * H)):
        raise ValueError(f"shapes xm {tuple(xm.shape)}, w_hh "
                         f"{tuple(w_hh.shape)}, b_ih {tuple(b_ih.shape)}, "
                         f"b_hh {tuple(b_hh.shape)} do not fit one hidden "
                         f"size")
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"the BiLSTM kernel takes hidden sizes 1 to "
                         f"{MAX_HIDDEN}, got {H}")
    if xm.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"xm must be float32 or bfloat16, got {xm.dtype}")
    for name, t in (("w_hh", w_hh), ("b_ih", b_ih), ("b_hh", b_hh)):
        if t.dtype != xm.dtype or t.device != xm.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, xm "
                             f"{xm.dtype} on {xm.device}")
    if xm.numel() >= 2 ** 31:
        raise ValueError("the kernel indexes xm with 32-bit ints")
    return H


def _fn(name: str, n_ptr: int):
    fn = getattr(cuda_lib.load(KERNEL_SOURCE), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, kind: str) -> None:
    if err != 0:
        raise RuntimeError(f"bilstm {kind} kernel launch failed: cudaError "
                           f"{err}")


def _rows_apart(B: int, H: int, dtype: torch.dtype) -> int:
    """Rows between two time steps of a (T, B, 2H) tensor the kernels
    take: B, or B rounded up to 8 where a step's bytes are not a multiple
    of 16 (the kernels' TMA maps need 16-byte strides)."""
    size = torch.empty(0, dtype=dtype).element_size()
    return B if B * 2 * H * size % 16 == 0 else -(-B // 8) * 8


def _narrow_strides(B: int, H: int, dtype: torch.dtype):
    """The strides of a (T, B, 2H) tensor as the kernels take it."""
    return (_rows_apart(B, H, dtype) * 2 * H, 2 * H, 1)


def _narrow_empty(T: int, B: int, H: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """An uninitialized (T, B, 2H) tensor laid out as the kernels take it
    (``_rows_apart`` rows a step; not a view)."""
    storage = torch.empty(T * _rows_apart(B, H, dtype) * 2 * H, dtype=dtype,
                          device=device).untyped_storage()
    return torch.empty(0, dtype=dtype, device=device).set_(
        storage, 0, (T, B, 2 * H), _narrow_strides(B, H, dtype))


def _conform(t: torch.Tensor, dtype: torch.dtype, strides) -> torch.Tensor:
    """t in ``dtype`` with ``strides`` at a 16-byte aligned address, as
    the kernels' TMA maps read it; a copy where it is not."""
    t = t.to(dtype)
    if t.stride() == tuple(strides) and t.data_ptr() % 16 == 0:
        return t
    out = torch.empty_strided(t.shape, strides, dtype=dtype, device=t.device)
    out.copy_(t)
    return out


def _scratch(T: int, B: int, H: int, dtype: torch.dtype) -> int:
    """Doubles of the backward's scratch (one partial a block of its
    grid), from the library."""
    fn = getattr(cuda_lib.load(KERNEL_SOURCE),
                 f"kpgnn_bilstm_scratch_{_suffix(dtype)}")
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    n = fn(T, B, H)
    if n < 0:
        raise RuntimeError(f"bilstm backward: no grid for T={T}, B={B}, "
                           f"H={H}")
    return n


# the backward's grid-barrier counters by (device, stream): zero at a
# launch, and each launch leaves them zero, so launches in one stream
# share them
_tickets: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _ticket_counters(device: torch.device, stream: int) -> torch.Tensor:
    buf = _tickets.get((device, stream))
    if buf is None:
        buf = _tickets[device, stream] = torch.zeros(2, dtype=torch.int32,
                                                     device=device)
    return buf


def launch_forward(xm: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                   b_hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel on CUDA tensors: (y, c), each (T,
    B, 2H) in xm's dtype, c the cell states the backward reads; their
    time steps lie ``_rows_apart`` rows apart.  Counts the launch."""
    H = _check(xm, w_hh, b_ih, b_hh)
    if xm.device.type != "cuda":
        raise ValueError(f"no kernel for device {xm.device}")
    T, B, _ = xm.shape
    xm = _conform(xm, xm.dtype, (B * 8 * H, 8 * H, 1))
    w_hh, b_ih, b_hh = (t.contiguous() for t in (w_hh, b_ih, b_hh))
    y, c = (_narrow_empty(T, B, H, xm.dtype, xm.device) for _ in range(2))
    err = _fn(f"kpgnn_bilstm_fwd_{_suffix(xm.dtype)}", 6)(
        xm.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(), b_hh.data_ptr(),
        y.data_ptr(), c.data_ptr(), T, B, H, _rows_apart(B, H, xm.dtype),
        _stream(xm))
    _raise_on(err, "forward")
    count_launch("bilstm", variant_name("fwd", xm.dtype), (T, H))
    return y, c


def launch_backward(dy: torch.Tensor, y: torch.Tensor, c: torch.Tensor,
                    xm: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                    b_hh: torch.Tensor):
    """One launch of the backward kernel: (dxm (T, B, 8H) in the forward's
    dtype, dw_hh (2, 4H, H), db_hh (2, 4H) and db_ih (8H,) in w_hh's
    dtype).  The kernel recomputes the gates from xm, y and c, and sums
    dw_hh and the bias gradient itself, in a fixed order and with no
    atomics, so the gradients repeat bit for bit; db_ih is a copy of that
    one sum, laid out as b_ih.  Counts the launch."""
    H = _check(xm, w_hh, b_ih, b_hh)
    if xm.device.type != "cuda":
        raise ValueError(f"no kernel for device {xm.device}")
    T, B, _ = xm.shape
    xm = _conform(xm, xm.dtype, (B * 8 * H, 8 * H, 1))
    dy, y, c = (_conform(t, xm.dtype, _narrow_strides(B, H, xm.dtype))
                for t in (dy, y, c))
    w_hh, b_ih, b_hh = (t.contiguous() for t in (w_hh, b_ih, b_hh))
    G = 4 * H
    f32 = dict(dtype=torch.float32, device=xm.device)
    dxm = torch.empty_like(xm)
    make = torch.zeros if B == 0 else torch.empty
    dw, db = make(2, G, H, **f32), make(2, G, **f32)
    stream = _stream(xm)
    scratch = torch.empty(_scratch(T, B, H, xm.dtype), dtype=torch.float64,
                          device=xm.device)
    err = _fn(f"kpgnn_bilstm_bwd_{_suffix(xm.dtype)}", 12)(
        dy.data_ptr(), y.data_ptr(), c.data_ptr(), xm.data_ptr(),
        w_hh.data_ptr(), b_ih.data_ptr(), b_hh.data_ptr(), dxm.data_ptr(),
        dw.data_ptr(), db.data_ptr(), scratch.data_ptr(),
        _ticket_counters(xm.device, stream).data_ptr(), T, B, H,
        _rows_apart(B, H, xm.dtype), stream)
    _raise_on(err, "backward")
    count_launch("bilstm", variant_name("bwd", xm.dtype), (T, H))
    dt = w_hh.dtype
    db = db.to(dt)
    return dxm, dw.to(dt), db, db.reshape(-1).clone()


class _BiLSTMFn(torch.autograd.Function):
    """The recurrence on the kernels, forward and backward
    (csrc/bilstm.cu): (xm, w_hh, b_ih, b_hh) -> y."""

    @staticmethod
    def forward(ctx, xm, w_hh, b_ih, b_hh):
        y, c = launch_forward(xm, w_hh, b_ih, b_hh)
        ctx.save_for_backward(xm, y, c, w_hh, b_ih, b_hh)
        return y

    @staticmethod
    def backward(ctx, dy):
        xm, y, c, w_hh, b_ih, b_hh = ctx.saved_tensors
        dxm, dw, db, db_ih = launch_backward(dy, y, c, xm, w_hh, b_ih, b_hh)
        return dxm, dw, db_ih, db


def recurrence(xm: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
               b_hh: torch.Tensor) -> torch.Tensor:
    """xm (T, B, 8H), w_hh (2, 4H, H), b_ih (8H,), b_hh (2, 4H) -> y (T,
    B, 2H) in xm's dtype.  On a CUDA tensor the kernels (the backward
    through ``_BiLSTMFn`` where a gradient is wanted; the forward is one
    launch either way), or a raise; only a CPU tensor takes the plain
    version."""
    if xm.device.type == "cpu":
        return recurrence_reference(xm, w_hh, b_ih, b_hh)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xm, w_hh, b_ih, b_hh)):
        return _BiLSTMFn.apply(xm, w_hh, b_ih, b_hh)
    return launch_forward(xm, w_hh, b_ih, b_hh)[0]


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
        out = recurrence(input_projection(seq, w_ih), w_hh, b_ih, b_hh)
        return out if time_major else out.transpose(0, 1)


def plain_bilstm(module: BiLSTM, x: torch.Tensor,
                 time_major: bool = False) -> torch.Tensor:
    """``module``'s output by the plain version (``bilstm_reference``) on
    any device: on the card, the kernel's yardstick."""
    seq = x if time_major else x.transpose(0, 1)
    out = bilstm_reference(seq, *module.weights(x.dtype))
    return out if time_major else out.transpose(0, 1)
