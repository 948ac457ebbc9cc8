"""Fused hop-major k-hop aggregation on a hand-written CUDA kernel.

Counterpart of kpgnn_tpu/ops/pallas_spmm.py.  The k-hop aggregate

    out[i, k, :] = sum_e live(attr[e,k]) * x[sender(e), k, :]
                 + sum_e emb_k(attr[e,k])          (receiver(e) == i)

is a gather + segment-sum over a hop-major virtual row space (row k*N + i
is node i at hop k), so all K hops of a layer run in one kernel launch
forward and one backward (the transpose CSR).  The forward kernel also
adds each edge's embedding row (tables indexed by the edge's attr code,
carried in the plan beside its sender), so the embedding term costs no
launch of its own.  Its gradient only depends on how many edges of each
code enter a node: ``counts.T @ g``, one full-f32 matmul per table.  The
GCN path (sender-scaled embeddings) keeps the JAX package's form, the
gather plus weighted-histogram matmuls ``hists @ table``.

The plan is a plain CSR per direction.  The TPU plan's 128-edge null
padding (TILE_E), sender windows (win_lo / win_blk / WBLOCK), EGROUP,
VMEM caps, hub spill list and its VMEM-overflow fallback exist only
because a TPU has no fast row gather; Hopper has one, so they are gone.
Hop slicing is a prefix cut of the CSR.

Precision: the port never copies the JAX wrapper's bf16 down-cast of the
node table (a TPU MXU artifact): an f32 model stays f32 through the
kernel.  Matmuls here run in full f32 as long as
``torch.backends.cuda.matmul.allow_tf32`` is False (the entry points set
it, and ``torch.backends.cudnn.allow_tf32``, to False).  A bf16 model
(``--bf16``) feeds the kernel's bf16 variants: x and the gradient enter
as bf16, the edge tables stay f32 parameters, the kernel sums in f32 and
the result is cast back to bf16 (kpgnn_tpu/ops/pallas_spmm.py:854-873);
the table gradients ``counts.T @ g`` are taken in f32.
"""
from __future__ import annotations

import collections
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
    edge offset where hop k's rows end (indptr[(k+1) * rows_per_hop]), and
    ``hop_live[k]`` the number of leading rows of hop k up to its last row
    with an edge (the rest is the loader's padding, which the kernel writes
    as zeros without reading the CSR); both are kept on the host so hop
    slicing and launches need no device sync."""

    indptr: torch.Tensor        # (n_rows + 1,) int32
    senders: torch.Tensor       # (E,) int32
    n_rows: int
    n_cols: int
    hop_ends: Tuple[int, ...] = ()
    rows_per_hop: int = 0
    hop_live: Tuple[int, ...] = ()
    # (E,) int32 attr code of every edge, aligned with senders (the
    # forward CSR only: the fused kernel's edge-embedding rows)
    codes: Optional[torch.Tensor] = None

    def to(self, device) -> "HopCSR":
        return dataclasses.replace(
            self, indptr=self.indptr.to(device),
            senders=self.senders.to(device),
            codes=None if self.codes is None else self.codes.to(device))

    def cut(self, k: int, rows_per_hop: int, cols_per_hop: int) -> "HopCSR":
        """The first k hops: a prefix of rows and of edges."""
        e = self.hop_ends[k - 1]
        return HopCSR(indptr=self.indptr[:k * rows_per_hop + 1],
                      senders=self.senders[:e],
                      n_rows=k * rows_per_hop, n_cols=k * cols_per_hop,
                      hop_ends=self.hop_ends[:k], rows_per_hop=rows_per_hop,
                      hop_live=self.hop_live[:k],
                      codes=None if self.codes is None else self.codes[:e])

    def gather(self, x: torch.Tensor, **tables) -> torch.Tensor:
        """``gather_segment_sum`` over this CSR (``tables``: codes,
        table1, tablek for the fused form)."""
        return gather_segment_sum(x, self.indptr, self.senders, self.n_rows,
                                  rows_per_hop=self.rows_per_hop,
                                  hop_live=self.hop_live, **tables)


@dataclasses.dataclass
class HistBins:
    """The forward CSR's live edges grouped into their (receiver row, attr
    code) bins, for the weighted histograms of a sender scale (GCN's
    norm; ``KHopPlan.hist_bins``): ``order`` sorts the edges by (row,
    code), stably; sorted edge j lies in bin ``seg[j]``; bin b holds the
    sorted edges [indptr[b], indptr[b+1]) and is (row[b], code[b]).
    Rows are hop-major, so a hop prefix of the edges is a prefix of the
    bins: the first k hops end at bin ``hop_ends[k-1]``, edge
    ``hop_edges[k-1]``."""

    order: torch.Tensor         # (E,) int64
    seg: torch.Tensor           # (E,) int32
    indptr: torch.Tensor        # (U + 1,) int32
    row: torch.Tensor           # (U,) int64 hop-major receiver row
    code: torch.Tensor          # (U,) int64
    hop_ends: Tuple[int, ...] = ()
    hop_edges: Tuple[int, ...] = ()

    @classmethod
    def build(cls, rows: np.ndarray, codes: np.ndarray, n_nodes: int,
              K: int) -> "HistBins":
        order = np.lexsort((codes, rows))
        r, c = rows[order], codes[order]
        new = np.ones(len(order), bool)
        new[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        starts = np.flatnonzero(new)
        t = lambda a, dt: torch.from_numpy(a.astype(dt))   # noqa: E731
        return cls(order=t(order, np.int64),
                   seg=t(np.cumsum(new) - 1, np.int32),
                   indptr=t(np.append(starts, len(order)), np.int32),
                   row=t(r[starts], np.int64), code=t(c[starts], np.int64),
                   hop_ends=tuple(int(np.searchsorted(r[starts],
                                                      (k + 1) * n_nodes))
                                  for k in range(K)),
                   hop_edges=tuple(int(np.searchsorted(r, (k + 1) * n_nodes))
                                   for k in range(K)))

    def cut(self, k: int) -> "HistBins":
        """The first k hops."""
        u, e = self.hop_ends[k - 1], self.hop_edges[k - 1]
        return HistBins(order=self.order[:e], seg=self.seg[:e],
                        indptr=self.indptr[:u + 1], row=self.row[:u],
                        code=self.code[:u], hop_ends=self.hop_ends[:k],
                        hop_edges=self.hop_edges[:k])

    def to(self, device) -> "HistBins":
        return dataclasses.replace(
            self, order=self.order.to(device), seg=self.seg.to(device),
            indptr=self.indptr.to(device), row=self.row.to(device),
            code=self.code.to(device))


@dataclasses.dataclass
class KHopPlan:
    """Forward/backward CSRs plus embedding count histograms; the
    adjacency of a batch collated in "pallas" mode."""

    fwd: HopCSR                     # fused hops, receiver-sorted, codes
    bwd: HopCSR                     # fused transpose (sender-sorted)
    counts1: torch.Tensor           # (N, V1) hop-1 attr histogram
    # (K-1, N, Vk) | None hop-k attr histograms, hop-major so that a hop
    # prefix is one contiguous (k-1)*N-row matmul operand
    countsk_hm: Optional[torch.Tensor]
    # aligned with fwd.senders: hop-major receiver row of every edge (only
    # needed for sender-scaled embeddings, GCN norm)
    edge_recv: torch.Tensor         # (E,) int64
    # (N,) union in-degree over real edges regardless of hop mask (the
    # mean denominator); hop slicing keeps it whole
    union_deg: torch.Tensor
    hop_deg: torch.Tensor           # (N, K) per-hop live in-degree
    n_hops: int = 1
    # the host arrays the weighted histograms' bins are built from, on
    # first use (``hist_bins``): fwd's hop-major receiver rows and codes,
    # and the plan's node count and hops
    hist_src: Optional[tuple] = None
    # {device: the whole plan's HistBins}, shared with its hop slices
    hist_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def K(self) -> int:
        return self.n_hops

    @property
    def countsk(self) -> Optional[torch.Tensor]:
        """(N, K-1, Vk) node-major view of ``countsk_hm`` (the JAX plan's
        layout)."""
        return None if self.countsk_hm is None \
            else self.countsk_hm.transpose(0, 1)

    def to(self, device) -> "KHopPlan":
        move = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(
            self, fwd=self.fwd.to(device), bwd=self.bwd.to(device),
            counts1=move(self.counts1), countsk_hm=move(self.countsk_hm),
            edge_recv=move(self.edge_recv),
            union_deg=move(self.union_deg), hop_deg=move(self.hop_deg))

    def slice_hops(self, k: int) -> "KHopPlan":
        n = self.counts1.shape[0]
        cn = self.fwd.n_cols // self.n_hops     # sender rows per hop
        fwd = self.fwd.cut(k, n, cn)
        e = fwd.senders.shape[0]
        return KHopPlan(
            fwd=fwd, bwd=self.bwd.cut(k, cn, n),
            counts1=self.counts1,
            countsk_hm=self.countsk_hm[:k - 1] if k > 1 else None,
            edge_recv=self.edge_recv[:e],
            union_deg=self.union_deg, hop_deg=self.hop_deg[:, :k],
            n_hops=k, hist_src=self.hist_src, hist_cache=self.hist_cache)

    def degree(self) -> torch.Tensor:
        return self.hop_deg

    def hist_bins(self) -> HistBins:
        """fwd's edges by (receiver row, attr code), for the weighted
        histograms: built on the host on first use, since only
        sender-scaled models (GCN, SAGE) read them, and kept for the plan,
        its device copies and its hop slices."""
        dev = self.edge_recv.device
        full = self.hist_cache.get(dev)
        if full is None:
            full = self.hist_cache[dev] = HistBins.build(
                *self.hist_src).to(dev)
        return full if self.n_hops == len(full.hop_ends) \
            else full.cut(self.n_hops)


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
    has_edge = (np.diff(indptr)[:n_hops * rows_per_hop]
                .reshape(n_hops, rows_per_hop) > 0)
    csr = HopCSR(
        indptr=torch.from_numpy(indptr.astype(np.int32)),
        senders=torch.from_numpy(senders[order].astype(np.int32)),
        n_rows=n_rows, n_cols=n_cols,
        hop_ends=tuple(int(indptr[(k + 1) * rows_per_hop])
                       for k in range(n_hops)),
        rows_per_hop=rows_per_hop if n_hops else 0,
        hop_live=tuple(int(np.flatnonzero(h)[-1]) + 1 if h.any() else 0
                       for h in has_edge))
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
    fwd.codes = torch.from_numpy(code_f.astype(np.int32))
    bwd, _ = build_csr(s_all, r_all, C, R, cn)
    counts1 = np.zeros((n_nodes, v1), np.float32)
    np.add.at(counts1, (receivers, np.clip(attr[:, 0], 0, v1 - 1)), 1.0)
    counts1[:, 0] = 0.0
    countsk_hm = None
    if K > 1:
        countsk_hm = np.zeros((K - 1, n_nodes, vk), np.float32)
        for k in range(1, K):
            np.add.at(countsk_hm[k - 1],
                      (receivers, np.clip(attr[:, k], 0, vk - 1)), 1.0)
        countsk_hm[:, :, 0] = 0.0
    union_deg = np.bincount(receivers, minlength=n_nodes).astype(np.float32)
    hop_deg = np.stack(
        [np.bincount(receivers[attr[:, k] > 0], minlength=n_nodes)
         for k in range(K)], axis=1).astype(np.float32)
    return KHopPlan(
        fwd=fwd, bwd=bwd,
        counts1=torch.from_numpy(counts1),
        countsk_hm=(torch.from_numpy(countsk_hm) if countsk_hm is not None
                    else None),
        edge_recv=torch.from_numpy(recv_f),
        union_deg=torch.from_numpy(union_deg),
        hop_deg=torch.from_numpy(hop_deg), n_hops=K,
        hist_src=(recv_f, code_f, n_nodes, K))


# hops one launch can take (the kernel's kMaxHops; the repo's deepest
# configuration, KPGINPrime, has K = 16)
MAX_HOPS = 16


def gather_segment_sum_reference(x: torch.Tensor, indptr: torch.Tensor,
                                 senders: torch.Tensor, n_rows: int,
                                 codes: Optional[torch.Tensor] = None,
                                 table1: Optional[torch.Tensor] = None,
                                 tablek: Optional[torch.Tensor] = None,
                                 rows_per_hop: int = 0) -> torch.Tensor:
    """Plain PyTorch semantics of the kernel: row ids from ``indptr``,
    null senders (outside [0, x.shape[0])) masked out; with ``codes``,
    each edge adds its table row too (``table1`` for rows below
    ``rows_per_hop``, ``tablek`` above; code 0, or a code outside its
    table, adds nothing, whatever the sender); then ``index_add_``.
    ``senders`` holds exactly indptr[n_rows] edges.  Accumulates and
    returns f32, differentiable in x and the tables; nothing here waits
    for the device.  The wrapper uses it for CPU tensors; on the card it
    is the kernel's yardstick in chip_smoke.py."""
    counts = (indptr[1:] - indptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), counts,
        output_size=senders.shape[0])
    s = senders.long()
    valid = (s >= 0) & (s < x.shape[0])
    gathered = x[s.clamp(0, x.shape[0] - 1)].float() * valid[:, None]
    if codes is not None:
        c = codes.long()
        hk = (rows >= rows_per_hop).long()
        v1 = table1.shape[0]
        vk = tablek.shape[0] if tablek is not None else 0
        tab = table1 if tablek is None else torch.cat([table1, tablek])
        live = (c > 0) & (c < v1 + (vk - v1) * hk)
        idx = (c + v1 * hk).clamp(0, tab.shape[0] - 1)
        gathered = gathered + tab.float()[idx] * live[:, None]
    out = torch.zeros((n_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, rows, gathered)


def _check(x, indptr, senders, n_rows, codes, table1, tablek, rows_per_hop,
           hop_live) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (n_cols, D), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    ints = [("indptr", indptr), ("senders", senders)]
    if codes is not None:
        ints.append(("codes", codes))
    for name, t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if indptr.shape[0] != n_rows + 1:
        raise ValueError(f"indptr has {indptr.shape[0]} entries for "
                         f"{n_rows} rows")
    if rows_per_hop > 0 and n_rows % rows_per_hop:
        raise ValueError(f"{n_rows} rows are not whole hops of "
                         f"{rows_per_hop} rows")
    if hop_live and (rows_per_hop <= 0
                     or len(hop_live) != n_rows // rows_per_hop
                     or not all(0 <= h <= rows_per_hop for h in hop_live)):
        raise ValueError(f"hop_live {hop_live} does not fit {n_rows} rows "
                         f"of {rows_per_hop} per hop")
    if codes is None:
        return
    if codes.shape[0] != senders.shape[0]:
        raise ValueError(f"{codes.shape[0]} codes for "
                         f"{senders.shape[0]} senders")
    if table1 is None:
        raise ValueError("codes need table1")
    for name, t in (("table1", table1), ("tablek", tablek)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != x.shape[1]:
            raise ValueError(f"{name} must be (V, {x.shape[1]}), got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if rows_per_hop <= 0:
        raise ValueError("codes need rows_per_hop > 0")


def hop_layout(n_rows: int, rows_per_hop: int,
               hop_live: Tuple[int, ...]) -> Tuple[int, Tuple[int, ...]]:
    """(rows_per_hop, hop_live) as the kernel takes them: rows without a
    hop structure are one hop, and a hop without ``hop_live`` is live to
    its end.  Raises beyond MAX_HOPS hops."""
    if rows_per_hop <= 0:
        return n_rows, (n_rows,)
    n_hops = n_rows // rows_per_hop
    if n_hops > MAX_HOPS:
        raise ValueError(f"the kernel takes at most {MAX_HOPS} hops a "
                         f"launch, got {n_hops}")
    return rows_per_hop, tuple(hop_live) or (rows_per_hop,) * n_hops


def gather_segment_sum(x: torch.Tensor, indptr: torch.Tensor,
                       senders: torch.Tensor, n_rows: int,
                       codes: Optional[torch.Tensor] = None,
                       table1: Optional[torch.Tensor] = None,
                       tablek: Optional[torch.Tensor] = None,
                       rows_per_hop: int = 0,
                       hop_live: Tuple[int, ...] = ()) -> torch.Tensor:
    """out[r, :] = sum of x[senders[e], :] for e in [indptr[r],
    indptr[r+1]), as (n_rows, D) float32; a sender >= x.shape[0] adds
    nothing.  With ``codes`` (int32, one per edge) each edge also adds row
    codes[e] of ``table1`` (rows r < rows_per_hop) or ``tablek`` (hop >= 1
    rows), code 0 adding nothing: the k-hop aggregate's edge-embedding
    term.  ``hop_live`` (``HopCSR.hop_live``) promises that rows at or past
    hop_live[k] within hop k have no edge; the kernel writes them as zeros
    without reading the CSR.  ``rows_per_hop``, where given, divides
    ``n_rows``.

    On a CUDA tensor this launches the hand-written kernel
    (csrc/gather_segment_sum.cu) on the current stream, or raises: its
    16-byte variant where D*sizeof(x) is a multiple of 16 and x and the
    tables are 16-byte aligned, else its scalar variant.  Only a CPU
    tensor takes the plain version."""
    _check(x, indptr, senders, n_rows, codes, table1, tablek, rows_per_hop,
           hop_live)
    if x.device.type == "cpu":
        return gather_segment_sum_reference(x, indptr, senders, n_rows, codes,
                                            table1, tablek, rows_per_hop)
    out, variant = launch_kernel(x, indptr, senders, n_rows, codes, table1,
                                 tablek, rows_per_hop, hop_live)
    gather_segment_sum.variant_launches[variant] += 1
    gather_segment_sum.width_launches[variant, x.shape[1]] += 1
    return out


def launch_kernel(x: torch.Tensor, indptr: torch.Tensor,
                  senders: torch.Tensor, n_rows: int,
                  codes: Optional[torch.Tensor] = None,
                  table1: Optional[torch.Tensor] = None,
                  tablek: Optional[torch.Tensor] = None,
                  rows_per_hop: int = 0,
                  hop_live: Tuple[int, ...] = ()
                  ) -> Tuple[torch.Tensor, str]:
    """One launch of the kernel on CUDA tensors that passed ``_check``:
    (the (n_rows, D) float32 sums, the variant it took).  It counts
    nothing; each wrapper that calls it counts its own launches
    (``gather_segment_sum`` here, ``segment.sorted_segment_sum``)."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    fused = codes is not None
    t1, tk = (table1, tablek) if fused else (None, None)
    for name, t in (("x", x), ("indptr", indptr), ("senders", senders),
                    ("codes", codes), ("table1", t1), ("tablek", tk)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_cols, D = x.shape
    if max(n_rows * D, n_cols * D, senders.shape[0]) >= 2 ** 31:
        raise ValueError("kernel indexes rows and edges with 32-bit ints")
    vec = (D * x.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, t1, tk) if t is not None)
    rph, live = hop_layout(n_rows, rows_per_hop, hop_live)
    lib = cuda_lib.load(KERNEL_SOURCE)
    fn = (lib.kpgnn_gather_segment_sum_f32 if x.dtype == torch.float32
          else lib.kpgnn_gather_segment_sum_bf16)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((n_rows, D), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rows = lambda t: 0 if t is None else t.shape[0]     # noqa: E731
    err = fn(x.data_ptr(), indptr.data_ptr(), senders.data_ptr(), ptr(codes),
             ptr(t1), ptr(tk), out.data_ptr(), n_rows, n_cols, D, rph,
             rows(t1), rows(tk), int(vec), (ctypes.c_int * len(live))(*live),
             len(live), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_segment_sum kernel launch failed: "
                           f"cudaError {err}")
    return out, variant_name(x.dtype, vec, fused)


def variant_name(dtype: torch.dtype, vec: bool, fused: bool) -> str:
    """The kernel variant a launch takes, as chip_smoke.py reports it."""
    return (f"gather_segment_sum{'_fused' if fused else ''}"
            f"[{'f32' if dtype == torch.float32 else 'bf16'},"
            f"{'vec' if vec else 'scalar'}]")


def reset_launch_counts() -> None:
    gather_segment_sum.variant_launches.clear()
    gather_segment_sum.width_launches.clear()


# every kernel launch, by variant_name and by (variant_name, row width D)
gather_segment_sum.variant_launches = collections.Counter()
gather_segment_sum.width_launches = collections.Counter()


def _grad_gather(csr: HopCSR, g: torch.Tensor, dtype) -> torch.Tensor:
    """dx: the kernel over the transposed CSR on the gradient in x's
    dtype (a bf16 x takes the bf16 variant, as the TPU kernel stores its
    input in bf16), cast back to that dtype."""
    return csr.gather(g.to(dtype).contiguous()).to(dtype)


class _GatherSegment(torch.autograd.Function):
    """The kernel over ``fwd``; its gradient is the same kernel over the
    transposed CSR ``bwd`` in x's dtype, cast back to it
    (kpgnn_tpu/ops/pallas_spmm.py:766-793)."""

    @staticmethod
    def forward(ctx, x, fwd: HopCSR, bwd: HopCSR):
        ctx.bwd = bwd
        ctx.x_dtype = x.dtype
        return fwd.gather(x)

    @staticmethod
    def backward(ctx, g):
        return _grad_gather(ctx.bwd, g, ctx.x_dtype), None, None


class _FusedKHop(torch.autograd.Function):
    """Gather plus edge-embedding term in one kernel launch over
    ``plan.fwd``.  dx is the plain kernel over ``plan.bwd`` in x's dtype;
    the term is ``counts @ table`` per hop, so the table gradients are
    ``counts1.T @ g[hop 0]`` and ``countsk_hm.T @ g[hops 1..]``, one
    full-f32 matmul each on the f32 gradient (row 0 is exactly 0: column
    0 of the counts is)."""

    @staticmethod
    def forward(ctx, x, table1, tablek, plan: KHopPlan):
        ctx.plan = plan
        ctx.x_dtype = x.dtype
        ctx.has_k = tablek is not None and plan.K > 1
        return plan.fwd.gather(x, codes=plan.fwd.codes, table1=table1,
                               tablek=tablek if ctx.has_k else None)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        n = plan.counts1.shape[0]
        g = g.float().contiguous()
        dx = dt1 = dtk = None
        if ctx.needs_input_grad[0]:
            dx = _grad_gather(plan.bwd, g, ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            dt1 = plan.counts1.t() @ g[:n]
        if ctx.has_k and ctx.needs_input_grad[2]:
            ck = plan.countsk_hm
            dtk = ck.reshape(-1, ck.shape[-1]).t() @ g[n:]
        return dx, dt1, dtk, None


def _weighted_hists(plan: KHopPlan, sender_scale: torch.Tensor,
                    V: int) -> torch.Tensor:
    """(K, N, V) histograms of per-hop attr codes weighted by the sender
    scale: W[k, i, v] = sum over live hop-k edges e -> i with code v of
    s[sender(e), k]: a sorted segment sum over the plan's bins
    (``KHopPlan.hist_bins``: each bin's edges in one order), written into
    the zeroed histograms (each bin once)."""
    from .segment import sorted_segment_sum     # segment imports spmm

    K = sender_scale.shape[1]
    n = plan.counts1.shape[0]
    h = plan.hist_bins()
    s_flat = sender_scale.t().reshape(-1)                 # (K * cn,)
    s_e = s_flat[plan.fwd.senders[h.order].long()]
    sums = sorted_segment_sum(s_e, h.seg, h.row.shape[0], h.indptr)
    out = torch.zeros(K * n * V, dtype=sums.dtype, device=sums.device)
    out[h.row * V + h.code] = sums
    return out.reshape(K, n, V)


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
    if sender_scale is None:
        # the edge-embedding term rides in the kernel launch
        if table1.shape[0] != plan.counts1.shape[1] or (
                tablek is not None and K > 1
                and tablek.shape[0] != plan.countsk_hm.shape[2]):
            raise ValueError("edge tables do not match the plan's attr "
                             "vocabularies")
        outf = _FusedKHop.apply(xs, table1, tablek, plan)  # (K*n, D) f32
    else:
        outf = _GatherSegment.apply(xs, plan.fwd, plan.bwd)
    out = (outf.reshape(K, n, D) if hop_major
           else outf.reshape(K, n, D).transpose(0, 1))
    if sender_scale is not None:
        # counts were built unweighted; rebuild per hop weighted by s_j
        t1 = _zero_row0(table1)
        tk = _zero_row0(tablek) if tablek is not None and K > 1 else None
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
