"""The least time of one kernel launch on the card, from the shapes and
indices it was given (copied from the port's ``chip_smoke.py``:
``kernel_bound_ms``, ``sorted_sum_bound_ms`` and ``lstm_bound_ms``, so
that a change to the program cannot move the yardstick).  Each returns
(ms, "bytes" or "operations", whichever bounds it)."""
from __future__ import annotations

from .peaks import F32_FLOPS, HBM_BYTES_PER_S


def _bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_bound_ms(indptr, senders, n_rows: int, n_cols: int, D: int,
                    x_bytes: int, codes=None, rows_per_hop: int = 0):
    """One gather/segment-sum launch over a CSR: the rows of x that some
    edge gathers read once, indptr and senders read once (and, fused, the
    codes and the table rows some edge reads), the f32 output written
    once, over the HBM rate; the adds (one per gathered element, two
    fused) over the f32 rate."""
    import torch

    n_edges = senders.shape[0]
    s = senders
    n_read = int(torch.unique(s[(s >= 0) & (s < n_cols)]).numel())
    nbytes = n_read * D * x_bytes + (n_rows + 1) * 4 + n_edges * 4 \
        + n_rows * D * 4
    adds = n_edges * D
    if codes is not None:
        rows = torch.repeat_interleave(
            torch.arange(n_rows, device=s.device),
            (indptr[1:] - indptr[:-1]).long(), output_size=n_edges)
        c = codes.long()
        hop_k = (rows >= rows_per_hop).long()
        n_tab = int(torch.unique((c * 2 + hop_k)[c > 0]).numel())
        nbytes += n_edges * 4 + n_tab * D * 4
        adds *= 2
    return _bound(nbytes, adds)


def sorted_sum_bound_ms(n: int, rows: int, D: int, x_bytes: int):
    """One sorted segment sum of ``rows`` rows of width D into n
    segments: the rows read once, the (n + 1) int32 indptr read once and
    the f32 (n, D) sums written once; one add per element."""
    return _bound(rows * D * x_bytes + (n + 1) * 4 + n * D * 4, rows * D)


def lstm_bound_ms(T: int, B: int, H: int, nbytes: int, kind: str):
    """One BiLSTM recurrence launch.  Forward ("fwd"): reads xm (T, B,
    8H), W_hh, b_ih and b_hh, writes y and c (T, B, 2H each); 8H^2 + 25H
    operations a sequence, direction and step.  Backward ("bwd"): reads
    dy, y and c, xm, W_hh, b_ih and b_hh, writes dxm (T, B, 8H) and the
    f32 weight and bias gradients; 16H^2 + 24H operations."""
    tb = T * B
    weights = 8 * H * H + 16 * H
    if kind == "fwd":
        moved = (tb * 8 * H + 2 * tb * 2 * H + weights) * nbytes
        ops = 2 * tb * (8 * H * H + 25 * H)
    else:
        moved = ((3 * tb * 2 * H + 2 * tb * 8 * H + weights) * nbytes
                 + weights * 4)
        ops = 2 * tb * (16 * H * H + 24 * H)
    return _bound(moved, ops)
