"""Banded backend: k-hop aggregation for large, locally ordered graphs
(counterpart of kpgnn_tpu/ops/banded.py).

Graphs with a narrow bandwidth under their node order (polymer chains,
meshes, road networks, anything BFS/RCM-ordered) admit a formulation
without any gather over the band: tile the receiver axis and contract
each tile against a static halo window of the node table,

    out[k, t·tile+i] = Σ_w live[k, t, i, w] · x[k, t·tile − halo + w]

one batched ``(tile, win) @ (win, D)`` masked matmul per (hop, tile),
all K·T of them in one ``torch.bmm`` on cuBLAS.  The windows are built
from three views of the table (pad-front, core, pad-back), so the
aggregation has no gather or scatter over the band and differentiates
through the matmul.

Edges outside the halo (long-range chords, cross-graph noise) spill to
a row-sorted COO side list: one ``F.embedding`` gather and one sorted
segment sum (``segment.sorted_segment_sum``: on the card the gather
kernel, adding each row's spill in list order), as the COO backend
does, so the backend degrades per edge, never per batch.

Semantics are every other backend's: per hop k, out[i,k] = aggr_j
live(attr[k,i,j]) · s_i (x[j,k] + emb_k(attr)), with the embedding part
collapsed into ``counts @ table`` matmuls over per-node code histograms.
A sender-side scale is supported when it is structural: KPGCN's
deg^-0.5 is a function of the adjacency alone, so it folds into the live
mask, the histograms and the spill weights when the plan is built
(``sender_weights`` / ``collate_banded(gcn_norm=True)``); a dynamic
sender scale belongs on the pallas or coo backend.

Precision: an f32 model stays f32 (the window product runs in full f32
while ``torch.backends.cuda.matmul.allow_tf32`` is False; the entry
points set it).  A bf16 model (``--bf16``) multiplies bf16 windows by
the mask in bf16 (cuBLAS accumulates in f32; the product is rounded to
bf16 once); the spill, the histogram matmuls and the epilogue run in f32
and the result is cast to bf16.  The mask is cast to the product's dtype
once per plan (``BandedAdj.mask``), and every hop slice of the plan
reads a view of that one cast.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .segment import sorted_segment_sum

BANDED_TILE = 256          # receiver rows per tile
HALO_ALIGN = 64            # the halo rounds up to a multiple of this
DEFAULT_HALO_CAP = 512     # edges reaching further than this spill to COO


@dataclasses.dataclass
class BandedAdj:
    """Banded k-hop adjacency plan (built on the host, used on the
    device).

    ``live[k, t, i, w]`` is the number of union edges from sender
    ``t·tile − halo + w`` into receiver ``t·tile + i`` live at hop k and
    in band (times the sender's weight on a sender-scaled plan).
    counts1/countsk histogram the attr codes of all edges (spill
    included), so the embedding sum never depends on the band.
    """

    live: torch.Tensor                      # (K, T, tile, win) int8 | f32
    counts1: torch.Tensor                   # (N, V1) f32
    countsk: Optional[torch.Tensor]         # (N, K-1, Vk) f32 | None
    union_deg: torch.Tensor                 # (N,) f32
    hop_deg: torch.Tensor                   # (N, K) f32
    # out-of-band edges, hop-major (row = k·N + receiver), row-sorted
    spill_senders: Optional[torch.Tensor] = None   # (S,) int32, k·N + sender
    spill_rows: Optional[torch.Tensor] = None      # (S,) int32
    # per-spill-edge sender weight (sender-scaled plans only)
    spill_weights: Optional[torch.Tensor] = None   # (S,) f32
    spill_hop_ends: Tuple[int, ...] = ()
    # True when a structural sender scale s_j (GCN's deg^-0.5) was
    # folded into live, the histograms and spill_weights: callers must
    # then not pass sender_scale (KPGCNConv passes only the receiver's)
    sender_scaled: bool = False
    # (K·N + 1,) int32 CSR of the sorted spill rows over the output rows
    # (sentinel rows lie past its end); a hop slice takes its prefix
    spill_indptr: Optional[torch.Tensor] = None
    # spill lists are row-sorted: build_banded emits them so, and the
    # resident gather sorts each batch's list once
    spill_sorted: bool = True
    tile: int = BANDED_TILE
    halo: int = 0
    n_hops: int = 1
    # sender-table rows when different from the receiver space; 0 means
    # square.  Windows only cover the leading [0, n_nodes) block
    n_cols_static: int = 0
    # {"live": the unsliced plan's mask, dtype: its cast}, shared by the
    # plan and its hop slices so that the mask is cast once per plan
    mask_cache: Optional[dict] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.mask_cache is None:
            self.mask_cache = {"live": self.live}

    @property
    def K(self) -> int:
        return self.n_hops

    @property
    def n_nodes(self) -> int:
        return self.live.shape[1] * self.tile

    @property
    def n_cols(self) -> int:
        return self.n_cols_static or self.n_nodes

    def degree(self) -> torch.Tensor:
        return self.hop_deg

    def mask(self, dtype: torch.dtype) -> torch.Tensor:
        """(K, T, tile, win) live mask in ``dtype``: the unsliced plan's
        mask cast once and kept, this plan's hops a view of it."""
        cast = self.mask_cache.get(dtype)
        if cast is None:
            cast = self.mask_cache[dtype] = self.mask_cache["live"].to(dtype)
        return cast[:self.n_hops]

    def to(self, device) -> "BandedAdj":
        def move(t):
            return None if t is None else t.to(device)
        return dataclasses.replace(
            self, live=move(self.live), counts1=move(self.counts1),
            countsk=move(self.countsk), union_deg=move(self.union_deg),
            hop_deg=move(self.hop_deg),
            spill_senders=move(self.spill_senders),
            spill_rows=move(self.spill_rows),
            spill_weights=move(self.spill_weights),
            spill_indptr=move(self.spill_indptr), mask_cache=None)

    def slice_hops(self, k: int) -> "BandedAdj":
        return self._slice(k, lead=0)

    def _slice(self, k: int, lead: int) -> "BandedAdj":
        """Hop slice with ``lead`` extra leading axes on every array field
        (lead=1 for plans stacked per shard).  The first k hops; the mask
        cache is shared with an unstacked plan."""
        if k == self.n_hops:
            return self
        ix = (slice(None),) * lead
        if self.spill_senders is not None and not self.spill_hop_ends:
            # padded lists have no hop cut points: keep the whole list;
            # rows of hops >= k lie outside [0, k·N) and are dropped
            sp_s, sp_r, sp_w = (self.spill_senders, self.spill_rows,
                                self.spill_weights)
        else:
            sp_end = self.spill_hop_ends[k - 1] if self.spill_hop_ends else 0
            cut = ix + (slice(None, sp_end),)
            dead = self.spill_senders is None or sp_end == 0
            sp_s = None if dead else self.spill_senders[cut]
            sp_r = None if dead else self.spill_rows[cut]
            sp_w = (None if dead or self.spill_weights is None
                    else self.spill_weights[cut])
        # rows are hop-major: the first k hops' CSR is a prefix
        sp_i = (None if sp_s is None or self.spill_indptr is None
                else self.spill_indptr[ix + (slice(
                    None, k * self.live.shape[lead + 1] * self.tile + 1),)])
        return dataclasses.replace(
            self, live=self.live[ix + (slice(None, k),)],
            countsk=(self.countsk[ix + (slice(None), slice(None, k - 1))]
                     if k > 1 else None),
            hop_deg=self.hop_deg[ix + (slice(None), slice(None, k))],
            spill_senders=sp_s, spill_rows=sp_r, spill_weights=sp_w,
            spill_indptr=sp_i, spill_hop_ends=self.spill_hop_ends[:k],
            n_hops=k,
            mask_cache=self.mask_cache if lead == 0 else None)


def build_banded(receivers, senders, attr, n_nodes: int, v1: int, vk: int,
                 tile: int = BANDED_TILE, halo: Optional[int] = None,
                 halo_cap: int = DEFAULT_HALO_CAP,
                 n_cols: Optional[int] = None,
                 spill_pad: Optional[int] = None,
                 sender_weights=None,
                 as_numpy: bool = False) -> BandedAdj:
    """Host-side plan: per-hop live masks over static halo windows,
    attr-code histograms, out-of-band spill.

    ``halo`` is auto-sized to the edges' reach (rounded up to HALO_ALIGN,
    capped at ``halo_cap`` and at ``tile``); edges reaching further
    spill.  n_nodes must divide by ``tile``.

    ``n_cols``: sender-table rows when larger than the receiver space;
    senders at rows >= n_nodes lie outside every window and spill.

    ``spill_pad``: pad the spill list to this length with dropped
    entries (row K·n_nodes, one past the output; sender 0), so that
    every batch of a loader has one shape.  A padded list keeps no hop
    cut points: hop slices drop rows out of range instead.

    ``sender_weights``: optional (n_cols, K) structural sender scale s_j
    (GCN's deg^-0.5): the live mask becomes f32 (mask · s_j), the
    histograms weight each code by s_j and spill edges carry their
    weight.  The aggregate must then be called without sender_scale.

    ``as_numpy``: numpy arrays in the plan (the resident store stacks
    many plans into one copy to the device)."""
    receivers = np.asarray(receivers)
    senders = np.asarray(senders)
    attr = np.asarray(attr)
    K = attr.shape[1]
    if n_nodes % tile:
        raise ValueError(f"n_nodes={n_nodes} is not a multiple of "
                         f"tile={tile}")
    T = n_nodes // tile
    cn = n_cols if n_cols is not None else n_nodes

    t_of = receivers // tile
    # reach beyond the receiver's own tile, per edge (0 when the sender
    # lies inside [t·tile, (t+1)·tile))
    reach = np.maximum(t_of * tile - senders,
                       senders - ((t_of + 1) * tile - 1))
    reach = np.maximum(reach, 0)
    live_any = (attr > 0).any(axis=1)
    cap = min(halo_cap, tile)
    if halo is None:
        windowable = live_any & (senders < n_nodes)
        need = int(reach[windowable].max()) if windowable.any() else 0
        halo = min(-(-need // HALO_ALIGN) * HALO_ALIGN, cap)
    if halo > tile:
        raise ValueError(
            f"halo={halo} exceeds tile={tile}: the window views overlap "
            "adjacent tiles only — raise tile (collate with node_multiple "
            ">= tile) or lower halo; edges reaching further spill anyway")
    win = tile + 2 * halo

    if sender_weights is not None:
        sender_weights = np.asarray(sender_weights, np.float32)
        if sender_weights.shape != (cn, K):
            raise ValueError(f"sender_weights {sender_weights.shape} != "
                             f"{(cn, K)}")
    in_band = (reach <= halo) & (senders < n_nodes)
    live = np.zeros((K, T, tile, win),
                    dtype=np.float32 if sender_weights is not None
                    else np.int8)
    sp_r, sp_s, sp_w = [], [], []
    for k in range(K):
        lk = attr[:, k] > 0
        kb = lk & in_band
        i, j = receivers[kb], senders[kb]
        # add, not assign: duplicate (i, j) pairs keep their multiplicity
        w = 1 if sender_weights is None else sender_weights[j, k]
        np.add.at(live, (k, i // tile, i % tile,
                         j - (i // tile) * tile + halo), w)
        out = lk & ~in_band
        if out.any():
            sp_r.append(k * n_nodes + receivers[out])
            sp_s.append(k * cn + senders[out])
            if sender_weights is not None:
                sp_w.append(sender_weights[senders[out], k])

    wrap = (lambda a: a) if as_numpy else torch.from_numpy
    spill_senders = spill_rows = spill_weights = spill_indptr = None
    spill_hop_ends: Tuple[int, ...] = ()
    if sp_r or spill_pad:
        rows = (np.concatenate(sp_r).astype(np.int64) if sp_r
                else np.zeros(0, np.int64))
        cols = (np.concatenate(sp_s).astype(np.int64) if sp_r
                else np.zeros(0, np.int64))
        wts = None
        if sender_weights is not None:
            wts = (np.concatenate(sp_w).astype(np.float32) if sp_w
                   else np.zeros(0, np.float32))
        order = np.argsort(rows, kind="stable")
        rows, cols = rows[order], cols[order]
        wts = wts[order] if wts is not None else None
        if spill_pad is not None:
            if len(rows) > spill_pad:
                raise ValueError(
                    f"spill_pad={spill_pad} < actual spill {len(rows)}; "
                    "raise the pad (loaders size it from the worst-case "
                    "batch)")
            pad = spill_pad - len(rows)
            # dropped entries: row one past the output, harmless sender
            rows = np.concatenate([rows, np.full(pad, K * n_nodes)])
            cols = np.concatenate([cols, np.zeros(pad, np.int64)])
            if wts is not None:
                wts = np.concatenate([wts, np.zeros(pad, np.float32)])
        spill_rows = wrap(rows.astype(np.int32))
        spill_senders = wrap(cols.astype(np.int32))
        spill_indptr = wrap(np.searchsorted(
            rows, np.arange(K * n_nodes + 1)).astype(np.int32))
        spill_weights = wrap(wts) if wts is not None else None
        if spill_pad is None:
            spill_hop_ends = tuple(
                int(np.searchsorted(rows, (k + 1) * n_nodes))
                for k in range(K))

    def hop_w(k):
        return (1.0 if sender_weights is None
                else sender_weights[senders, k])

    counts1 = np.zeros((n_nodes, v1), np.float32)
    np.add.at(counts1, (receivers, np.clip(attr[:, 0], 0, v1 - 1)),
              hop_w(0))
    counts1[:, 0] = 0.0
    countsk = None
    if K > 1:
        countsk = np.zeros((n_nodes, K - 1, vk), np.float32)
        for k in range(1, K):
            np.add.at(countsk[:, k - 1],
                      (receivers, np.clip(attr[:, k], 0, vk - 1)),
                      hop_w(k))
        countsk[:, :, 0] = 0.0
    union_deg = np.bincount(receivers, minlength=n_nodes).astype(np.float32)
    hop_deg = np.stack(
        [np.bincount(receivers[attr[:, k] > 0], minlength=n_nodes)
         for k in range(K)], axis=1).astype(np.float32)

    return BandedAdj(
        live=wrap(live), counts1=wrap(counts1),
        countsk=wrap(countsk) if countsk is not None else None,
        union_deg=wrap(union_deg), hop_deg=wrap(hop_deg),
        spill_senders=spill_senders, spill_rows=spill_rows,
        spill_weights=spill_weights, spill_indptr=spill_indptr,
        spill_hop_ends=spill_hop_ends, tile=tile, halo=halo, n_hops=K,
        n_cols_static=(0 if cn == n_nodes else cn),
        sender_scaled=sender_weights is not None)


def _windows(xs: torch.Tensor, tile: int, halo: int) -> torch.Tensor:
    """(K, N, D) -> (K, T, tile + 2·halo, D) overlapping halo windows,
    built from three reshaped views (no gather): window row w of tile t
    is node row t·tile − halo + w, zero outside [0, N)."""
    K, N, D = xs.shape
    T = N // tile
    core = xs.reshape(K, T, tile, D)
    if halo == 0:
        return core
    left = F.pad(xs, (0, 0, halo, 0))[:, :N].reshape(K, T, tile, D)
    right = F.pad(xs, (0, 0, 0, tile))[:, tile:tile + N].reshape(
        K, T, tile, D)
    return torch.cat([left[:, :, :halo], core, right[:, :, :halo]], dim=2)


def banded_khop_aggregate(
    x: torch.Tensor,                    # (N, K, D) | (K, N, D) hop-major
    table1: torch.Tensor,
    tablek: Optional[torch.Tensor],
    adj: BandedAdj,
    *,
    scale: Optional[torch.Tensor] = None,         # (N, K) receiver-side
    sender_scale: Optional[torch.Tensor] = None,
    aggr: str = "add",
    hop_major: bool = False,
) -> torch.Tensor:
    """``ops.adjacency.khop_aggregate_adj``'s contract on the banded plan.
    Natively hop-major: (K, N, D) in and out runs without a layout copy;
    node-major callers pay one transpose each way.

    Sender-side scales are structural and folded into the plan when it
    is built (``sender_weights``); a dynamic ``sender_scale`` is rejected
    either way, as is ``aggr="max"``."""
    from ..nn.embed import zero_row      # nn imports ops

    if sender_scale is not None:
        raise ValueError(
            "banded backend takes no dynamic sender_scale: GCN's "
            "structural deg^-0.5 folds into the plan — collate with "
            "gcn_norm=True (KPGCNConv then passes only the receiver "
            "scale); other sender scales need the pallas or coo backend")
    if aggr not in ("add", "mean"):
        # max needs per-pair attr codes to build each message; the plan
        # keeps only attr histograms (the counts @ table fold)
        raise ValueError(f"banded backend does not support aggr={aggr!r}:"
                         " the plan keeps attr histograms, not per-edge "
                         "codes; use the coo or dense backend for max")
    if not hop_major:
        out = banded_khop_aggregate(
            x.transpose(0, 1), table1, tablek, adj, scale=scale, aggr=aggr,
            hop_major=True)
        return out.transpose(0, 1)

    K, cn, D = x.shape                 # cn >= N on halo-extended tables
    N = adj.n_nodes
    if K != adj.n_hops or cn != adj.n_cols:
        raise ValueError(f"x {tuple(x.shape)} does not fit a plan of "
                         f"{adj.n_hops} hops and {adj.n_cols} columns")
    out_dtype = x.dtype
    T = N // adj.tile
    win = adj.tile + 2 * adj.halo
    xw = _windows(x[:, :N], adj.tile, adj.halo)       # (K, T, win, D)
    out = torch.bmm(adj.mask(x.dtype).reshape(K * T, adj.tile, win),
                    xw.reshape(K * T, win, D)).reshape(K * N, D).float()

    if adj.spill_senders is not None:
        gathered = F.embedding(
            adj.spill_senders.long().clamp(max=K * cn - 1),
            x.reshape(K * cn, D)).float()
        if adj.spill_weights is not None:
            gathered = gathered * adj.spill_weights[:, None]
        # rows >= K·N (the pads' sentinel, hops past a slice) lie past
        # the CSR's end and add nothing
        out = out + sorted_segment_sum(gathered, adj.spill_rows, K * N,
                                       adj.spill_indptr)

    # the histogram matmuls in f32 (exact integer counts; exact f32
    # weighted sums on sender-scaled plans): hop 1, then hops 2..K as one
    # batched matmul over the hop-major view of countsk
    emb = (adj.counts1 @ zero_row(table1).float())[None]
    if tablek is not None and K > 1:
        emb = torch.cat([emb, torch.matmul(adj.countsk.transpose(0, 1),
                                           zero_row(tablek).float())])
    out = out.reshape(K, N, D) + emb

    if scale is not None:
        out = out * scale.t()[..., None].float()
    if aggr == "mean":
        out = out / torch.clamp(adj.union_deg, min=1.0)[None, :, None]
    return out.to(out_dtype)
