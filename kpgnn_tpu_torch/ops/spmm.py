"""Fused hop-major k-hop aggregation on a hand-written CUDA kernel.

Counterpart of kpgnn_tpu/ops/pallas_spmm.py.  The k-hop aggregate

    out[i, k, :] = sum_e live(attr[e,k]) * x[sender(e), k, :]
                 + sum_e emb_k(attr[e,k])          (receiver(e) == i)

splits into a data part and an embedding part.  The embedding part only
depends on how many edges of each attr code enter a node, so it is the
histogram matmul ``counts @ table``, computed in full f32.  The data part
is a pure gather + segment-sum over a hop-major virtual row space (row
k*N + i is node i at hop k), so all K hops of a layer run in one kernel
launch forward and one backward (the transpose CSR).

The plan is a plain CSR per direction.  The TPU plan's 128-edge null
padding (TILE_E), sender windows (win_lo / win_blk / WBLOCK), EGROUP,
VMEM caps, hub spill list and its VMEM-overflow fallback exist only
because a TPU has no fast row gather; Hopper has one, so they are gone.
Hop slicing is a prefix cut of the CSR.

Precision: the port never copies the JAX wrapper's bf16 down-cast of the
node table (a TPU MXU artifact): an f32 model stays f32 through the
kernel.  Matmuls here run in full f32 as long as
``torch.backends.cuda.matmul.allow_tf32`` is False (the entry points set
it, and ``torch.backends.cudnn.allow_tf32``, to False).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import cuda_lib

KERNEL_SOURCE = "gather_segment_sum.cu"


@dataclasses.dataclass
class HopCSR:
    """Fused-hop live edges, receiver-sorted.

    Row r of the receiver space [0, n_rows) owns the edges
    [indptr[r], indptr[r+1]); their sender ids index a table of n_cols
    rows (n_rows != n_cols for rectangular plans).  ``hop_ends[k]`` is the
    edge offset where hop k's rows end (indptr[(k+1) * rows_per_hop]),
    kept on the host so hop slicing needs no device sync."""

    indptr: torch.Tensor        # (n_rows + 1,) int32
    senders: torch.Tensor       # (E,) int32
    n_rows: int
    n_cols: int
    hop_ends: Tuple[int, ...] = ()

    def to(self, device) -> "HopCSR":
        return dataclasses.replace(self, indptr=self.indptr.to(device),
                                   senders=self.senders.to(device))

    def cut(self, k: int, rows_per_hop: int, cols_per_hop: int) -> "HopCSR":
        """The first k hops: a prefix of rows and of edges."""
        e = self.hop_ends[k - 1]
        return HopCSR(indptr=self.indptr[:k * rows_per_hop + 1],
                      senders=self.senders[:e],
                      n_rows=k * rows_per_hop, n_cols=k * cols_per_hop,
                      hop_ends=self.hop_ends[:k])


@dataclasses.dataclass
class KHopPlan:
    """Forward/backward CSRs plus embedding count histograms; the
    adjacency of a batch collated in "pallas" mode."""

    fwd: HopCSR                     # fused hops, receiver-sorted
    bwd: HopCSR                     # fused transpose (sender-sorted)
    counts1: torch.Tensor           # (N, V1) hop-1 attr histogram
    countsk: Optional[torch.Tensor]  # (N, K-1, Vk) | None
    # aligned with fwd.senders: hop-major receiver row and attr code of
    # every edge (only needed for sender-scaled embeddings, GCN norm)
    edge_recv: torch.Tensor         # (E,) int64
    edge_code: torch.Tensor         # (E,) int64
    # (N,) union in-degree over real edges regardless of hop mask (the
    # mean denominator); hop slicing keeps it whole
    union_deg: torch.Tensor
    hop_deg: torch.Tensor           # (N, K) per-hop live in-degree
    n_hops: int = 1

    @property
    def K(self) -> int:
        return self.n_hops

    def to(self, device) -> "KHopPlan":
        move = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(
            self, fwd=self.fwd.to(device), bwd=self.bwd.to(device),
            counts1=move(self.counts1), countsk=move(self.countsk),
            edge_recv=move(self.edge_recv), edge_code=move(self.edge_code),
            union_deg=move(self.union_deg), hop_deg=move(self.hop_deg))

    def slice_hops(self, k: int) -> "KHopPlan":
        n = self.counts1.shape[0]
        cn = self.fwd.n_cols // self.n_hops     # sender rows per hop
        fwd = self.fwd.cut(k, n, cn)
        e = fwd.senders.shape[0]
        return KHopPlan(
            fwd=fwd, bwd=self.bwd.cut(k, cn, n),
            counts1=self.counts1,
            countsk=self.countsk[:, :k - 1] if k > 1 else None,
            edge_recv=self.edge_recv[:e], edge_code=self.edge_code[:e],
            union_deg=self.union_deg, hop_deg=self.hop_deg[:, :k],
            n_hops=k)

    def degree(self) -> torch.Tensor:
        return self.hop_deg


def build_csr(receivers, senders, n_rows: int, n_cols: int,
              rows_per_hop: Optional[int] = None, aux=()):
    """Receiver-sorted (stable) CSR of the edges senders -> receivers,
    with ``rows_per_hop`` receiver rows per hop (default: one hop);
    ``aux`` per-edge arrays are sorted alongside and returned with it."""
    rows_per_hop = rows_per_hop or n_rows
    receivers, senders = np.asarray(receivers), np.asarray(senders)
    order = np.argsort(receivers, kind="stable")
    receivers = receivers[order]
    indptr = np.searchsorted(receivers, np.arange(n_rows + 1))
    n_hops = n_rows // rows_per_hop if rows_per_hop else 0
    csr = HopCSR(
        indptr=torch.from_numpy(indptr.astype(np.int32)),
        senders=torch.from_numpy(senders[order].astype(np.int32)),
        n_rows=n_rows, n_cols=n_cols,
        hop_ends=tuple(int(indptr[(k + 1) * rows_per_hop])
                       for k in range(n_hops)))
    return csr, [a[order] for a in aux]


def build_plan(receivers, senders, attr, n_nodes: int, v1: int, vk: int,
               n_cols_nodes: Optional[int] = None) -> KHopPlan:
    """Host-side plan: filter live edges per hop, fuse them into one
    hop-major CSR per direction, histogram attr codes per receiver
    (kpgnn_tpu/ops/pallas_spmm.py:687 build_plan, without the TPU tile
    geometry)."""
    receivers = np.asarray(receivers).astype(np.int64)
    senders = np.asarray(senders).astype(np.int64)
    attr = np.asarray(attr)
    K = attr.shape[1]
    cn = n_cols_nodes if n_cols_nodes is not None else n_nodes
    R, C = K * n_nodes, K * cn
    rs, ss, cs = [], [], []
    for k in range(K):
        live = attr[:, k] > 0
        rs.append(receivers[live] + k * n_nodes)
        ss.append(senders[live] + k * cn)
        cs.append(np.clip(attr[live, k], 0, (v1 if k == 0 else vk) - 1)
                  .astype(np.int64))
    r_all, s_all, c_all = (np.concatenate(a) for a in (rs, ss, cs))
    fwd, (recv_f, code_f) = build_csr(r_all, s_all, R, C, n_nodes,
                                      aux=(r_all, c_all))
    bwd, _ = build_csr(s_all, r_all, C, R, cn)
    counts1 = np.zeros((n_nodes, v1), np.float32)
    np.add.at(counts1, (receivers, np.clip(attr[:, 0], 0, v1 - 1)), 1.0)
    counts1[:, 0] = 0.0
    countsk = None
    if K > 1:
        countsk = np.zeros((n_nodes, K - 1, vk), np.float32)
        for k in range(1, K):
            np.add.at(countsk[:, k - 1],
                      (receivers, np.clip(attr[:, k], 0, vk - 1)), 1.0)
        countsk[:, :, 0] = 0.0
    union_deg = np.bincount(receivers, minlength=n_nodes).astype(np.float32)
    hop_deg = np.stack(
        [np.bincount(receivers[attr[:, k] > 0], minlength=n_nodes)
         for k in range(K)], axis=1).astype(np.float32)
    return KHopPlan(
        fwd=fwd, bwd=bwd,
        counts1=torch.from_numpy(counts1),
        countsk=torch.from_numpy(countsk) if countsk is not None else None,
        edge_recv=torch.from_numpy(recv_f),
        edge_code=torch.from_numpy(code_f),
        union_deg=torch.from_numpy(union_deg),
        hop_deg=torch.from_numpy(hop_deg),
        n_hops=K)


def gather_segment_sum_reference(x: torch.Tensor, indptr: torch.Tensor,
                                 senders: torch.Tensor,
                                 n_rows: int) -> torch.Tensor:
    """Plain PyTorch semantics of the kernel: row ids from ``indptr``,
    null senders (outside [0, x.shape[0])) masked out, then
    ``index_add_``.  ``senders`` holds exactly indptr[n_rows] edges.
    Accumulates and returns f32; nothing here waits for the device.  The
    wrapper uses it for CPU tensors; on the card it is the kernel's
    yardstick in chip_smoke.py."""
    counts = (indptr[1:] - indptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), counts,
        output_size=senders.shape[0])
    s = senders.long()
    valid = (s >= 0) & (s < x.shape[0])
    gathered = x[s.clamp(0, x.shape[0] - 1)].float() * valid[:, None]
    out = torch.zeros((n_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, rows, gathered)


def _check(x: torch.Tensor, indptr: torch.Tensor, senders: torch.Tensor,
           n_rows: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (n_cols, D), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("indptr", indptr), ("senders", senders)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if indptr.shape[0] != n_rows + 1:
        raise ValueError(f"indptr has {indptr.shape[0]} entries for "
                         f"{n_rows} rows")


def gather_segment_sum(x: torch.Tensor, indptr: torch.Tensor,
                       senders: torch.Tensor, n_rows: int) -> torch.Tensor:
    """out[r, :] = sum of x[senders[e], :] for e in [indptr[r],
    indptr[r+1]), as (n_rows, D) float32; a sender >= x.shape[0] adds
    nothing.

    On a CUDA tensor this launches the hand-written kernel
    (csrc/gather_segment_sum.cu) on the current stream, or raises.  Only a
    CPU tensor takes the plain version."""
    _check(x, indptr, senders, n_rows)
    if x.device.type == "cpu":
        return gather_segment_sum_reference(x, indptr, senders, n_rows)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    for name, t in (("x", x), ("indptr", indptr), ("senders", senders)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_cols, D = x.shape
    if max(n_rows * D, n_cols * D, senders.shape[0]) >= 2 ** 31:
        raise ValueError("kernel indexes rows and edges with 32-bit ints")
    lib = cuda_lib.load(KERNEL_SOURCE)
    fn = (lib.kpgnn_gather_segment_sum_f32 if x.dtype == torch.float32
          else lib.kpgnn_gather_segment_sum_bf16)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((n_rows, D), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), indptr.data_ptr(), senders.data_ptr(),
             out.data_ptr(), n_rows, n_cols, D,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_segment_sum kernel launch failed: "
                           f"cudaError {err}")
    gather_segment_sum.launches += 1
    return out


gather_segment_sum.launches = 0


class _GatherSegment(torch.autograd.Function):
    """The kernel over ``fwd``; its gradient is the same kernel over the
    transposed CSR ``bwd``, cast back to x's dtype
    (kpgnn_tpu/ops/pallas_spmm.py:766-793)."""

    @staticmethod
    def forward(ctx, x, fwd: HopCSR, bwd: HopCSR):
        ctx.bwd = bwd
        ctx.x_dtype = x.dtype
        return gather_segment_sum(x, fwd.indptr, fwd.senders, fwd.n_rows)

    @staticmethod
    def backward(ctx, g):
        bwd = ctx.bwd
        dx = gather_segment_sum(g.contiguous(), bwd.indptr, bwd.senders,
                                bwd.n_rows)
        return dx.to(ctx.x_dtype), None, None


def _weighted_hists(plan: KHopPlan, sender_scale: torch.Tensor,
                    V: int) -> torch.Tensor:
    """(K, N, V) histograms of per-hop attr codes weighted by the sender
    scale: W[k, i, v] = sum over live hop-k edges e -> i with code v of
    s[sender(e), k]."""
    K = sender_scale.shape[1]
    n = plan.counts1.shape[0]
    s_flat = sender_scale.t().reshape(-1)                 # (K * cn,)
    s_e = s_flat[plan.fwd.senders.long()]
    idx = plan.edge_recv * V + plan.edge_code
    out = torch.zeros(K * n * V, dtype=s_e.dtype, device=s_e.device)
    return out.index_add_(0, idx, s_e).reshape(K, n, V)


def _zero_row0(table: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(table[:1]), table[1:]], dim=0)


def khop_spmm(x: torch.Tensor, table1: torch.Tensor,
              tablek: Optional[torch.Tensor], plan: KHopPlan, *,
              scale: Optional[torch.Tensor] = None,          # (N, K) s_i
              sender_scale: Optional[torch.Tensor] = None,   # (N, K) s_j
              aggr: str = "add",
              hop_major: bool = False) -> torch.Tensor:
    """Differentiable k-hop aggregation through the kernel.

    x: (N, K, D), or (K, N, D) with ``hop_major=True``; the result has the
    same layout.  Matches the COO aggregation including GCN's factored
    s_i * s_j norm (sender side pre-scales the gathered table, receiver
    side post-scales the output) and the union-denominator mean.  ``max``
    does not factor through a sum kernel and raises.
    """
    if aggr not in ("add", "mean"):
        raise ValueError(f"the kernel backend does not support "
                         f"aggr={aggr!r}: it is sum-only")
    if hop_major:
        K, cn, D = x.shape
    else:
        cn, K, D = x.shape
    n = plan.counts1.shape[0]
    if K * cn != plan.fwd.n_cols:
        raise ValueError(f"x {tuple(x.shape)} does not match a plan with "
                         f"{plan.fwd.n_cols} sender rows")
    out_dtype = x.dtype
    if sender_scale is not None:
        ss = sender_scale.t()[..., None] if hop_major \
            else sender_scale[..., None]
        x = x * ss.to(x.dtype)
    xs = (x.reshape(K * cn, D) if hop_major
          else x.transpose(0, 1).reshape(K * cn, D)).contiguous()
    outf = _GatherSegment.apply(xs, plan.fwd, plan.bwd)    # (K*n, D) f32
    out = (outf.reshape(K, n, D) if hop_major
           else outf.reshape(K, n, D).transpose(0, 1))
    t1 = _zero_row0(table1)
    tk = _zero_row0(tablek) if tablek is not None and K > 1 else None
    if sender_scale is None:
        parts = [plan.counts1 @ t1]                        # (N, D)
        if tk is not None:
            parts += [plan.countsk[:, k - 1] @ tk for k in range(1, K)]
    else:
        # counts were built unweighted; rebuild per hop weighted by s_j
        V = max(t1.shape[0], tk.shape[0] if tk is not None else 0)
        hists = _weighted_hists(plan, sender_scale, V)
        parts = [hists[0, :, :t1.shape[0]] @ t1]
        if tk is not None:
            parts += [hists[k, :, :tk.shape[0]] @ tk for k in range(1, K)]
    emb_all = torch.stack(parts, dim=0 if hop_major else 1)
    out = out + emb_all.to(out.dtype)
    if scale is not None:
        sc = scale.t()[..., None] if hop_major else scale[..., None]
        out = out * sc.to(out.dtype)
    if aggr == "mean":
        deg = torch.clamp(plan.union_deg, min=1.0)
        deg = deg[None, :, None] if hop_major else deg[:, None, None]
        out = out / deg.to(out.dtype)
    return out.to(out_dtype)
