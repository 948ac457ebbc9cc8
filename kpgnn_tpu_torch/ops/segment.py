"""Segment reductions and the COO k-hop aggregation (counterpart of
kpgnn_tpu/ops/segment.py).

Pooling, per-graph statistics and virtual-node updates reduce node rows
into graph slots by id.  ``khop_aggregate`` is the COO backend's
gather -> mask -> segment reduction (``--backend coo``), on
``segment_sum`` and ``scatter_reduce``.

Every float sum on the card adds in one fixed order, as the JAX package's
sums repeat on a TPU: ``index_add_`` there adds with atomics, in an order
that varies from run to run.  A float ``segment_sum`` into at most
ONEHOT_SEGMENTS_MAX segments (the graph-level reductions) is the JAX
package's one-hot contraction, a cuBLAS product.  Above that bound (edge
-> node), ``sorted=True`` (the default, as in JAX: the ids are sorted)
takes ``sorted_segment_sum``, the gather kernel of ops/spmm.py over the
ids' CSR with identity senders, which adds each row's entries in index
order without atomics; ``sorted=False`` keeps ``index_add_``.  On the
CPU every sum is ``index_add_``, which adds in index order.

The sorted sum reads the ids' CSR.  A caller that carries one passes it
(``indptr``): a COO batch's ``COOAdj.indptr`` for its edge sums, a
packed batch's ``GraphBatch.graph_indptr`` for its graph-level sums,
each ending at the last real entry so the padding adds nothing;
otherwise each sum builds it on the device (two launches).  The launch
registry's family ``segment_csr`` counts which (``sorted_segment_sum``).

The card's sorted sum trusts the caller: ids that are not sorted give a
meaningless CSR and wrong sums on the card, where the CPU's sum is
right.  ``CHECK_SORTED = True`` makes every sorted sum check its ids
first (one host sync a call) and raise; the card tests turn it on.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.profiling import count_launch
from . import spmm

# the JAX package's bound for its one-hot segment sums
# (kpgnn_tpu/ops/segment.py:_ONEHOT_SEGMENTS_MAX)
ONEHOT_SEGMENTS_MAX = 1024

# debug: sorted_segment_sum raises on ids that are not sorted (a sync a
# call)
CHECK_SORTED = False


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, sorted: bool = True,
                indptr: Optional[torch.Tensor] = None,
                grad_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sums of rows by segment id, in data's dtype.  Floats narrower than
    f32 (bf16) accumulate in f32 and are cast back once, as the JAX
    package's one-hot segment sums do.  On the card a one-hot product
    for few segments, else, for sorted f32 or bf16 rows,
    ``sorted_segment_sum`` (``indptr`` and ``grad_rows`` as there, if the
    caller has them; the module docstring).  The other sums add every
    row, so the rows outside a caller's [indptr[0], indptr[-1]) must be
    zeros (masked padding).  ``sorted=True`` promises
    sorted ids, as in JAX: on the card, above ONEHOT_SEGMENTS_MAX
    segments, ids that are not sorted give wrong sums (``CHECK_SORTED``
    catches them)."""
    if _on_card(data) and data.is_floating_point():
        if num_segments <= ONEHOT_SEGMENTS_MAX:
            return onehot_segment_sum(data, segment_ids, num_segments)
        if sorted and data.dtype in (torch.float32, torch.bfloat16):
            return sorted_segment_sum(data, segment_ids, num_segments,
                                      indptr, grad_rows)
    acc = (torch.float32 if data.is_floating_point()
           and data.element_size() < 4 else data.dtype)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=acc, device=data.device)
    return out.index_add_(0, segment_ids.long(), data.to(acc)).to(data.dtype)


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's sums.  The CPU tests of those
    paths patch it, with ``spmm.launch_kernel``, to run them there."""
    return t.is_cuda


def segment_indptr(segment_ids: torch.Tensor, num_segments: int
                   ) -> torch.Tensor:
    """(num_segments + 1,) int32 CSR of sorted ids, on their device and
    without a host sync: segment s owns the entries [indptr[s],
    indptr[s+1]).  Ids below 0 or at or past num_segments lie outside
    every segment's range."""
    ids = segment_ids.contiguous()
    bounds = torch.arange(num_segments + 1, device=ids.device,
                          dtype=ids.dtype)
    return torch.searchsorted(ids, bounds, out_int32=True)


def sorted_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int,
                       indptr: Optional[torch.Tensor] = None,
                       grad_rows: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Sums of rows by sorted segment id, every row's entries added in
    index order; in data's dtype, accumulated in f32.

    ``segment_ids`` must be sorted: on the card, ids that are not give a
    meaningless CSR and wrong sums (``CHECK_SORTED`` raises on them).
    ``indptr`` ((num_segments + 1,) int32, default ``segment_indptr``)
    is the ids' CSR: only the entries [indptr[0], indptr[-1]) add, each
    to its segment.  A caller may end the last segment before the ids
    do, to keep a padded tail out of every segment (a COO batch's pad
    edges, a banded spill's sentinel rows).  On a CUDA tensor (f32 or
    bf16) one launch of the gather kernel with identity senders, counted
    under the family ``sorted_segment_sum`` in ``utils.profiling``'s
    launch counts (not under the kernel plan's ``gather_segment_sum``);
    its backward gathers the gradient rows by ``grad_rows`` (default
    ``segment_grad_rows``, a caller may keep it with the batch).  On the
    CPU the plain version, ``index_add_`` over the same entries in the
    same order.

    On the card each call also counts under the family ``segment_csr``,
    by (variant, num_segments): ``batch`` where the caller passed the
    CSR, ``ids`` where the call built it from the ids."""
    if CHECK_SORTED and not bool((segment_ids[1:] >= segment_ids[:-1]).all()):
        raise ValueError("sorted_segment_sum: the segment ids are not "
                         "sorted")
    csr = "batch" if indptr is not None else "ids"
    if indptr is None:
        indptr = segment_indptr(segment_ids, num_segments)
    if not _on_card(data):
        return sorted_segment_sum_reference(data, segment_ids, num_segments,
                                            indptr)
    count_launch("segment_csr", csr, num_segments)
    return _SortedSegmentSum.apply(data, segment_ids, indptr, num_segments,
                                   grad_rows)


def sorted_segment_sum_reference(data: torch.Tensor,
                                 segment_ids: torch.Tensor,
                                 num_segments: int,
                                 indptr: torch.Tensor) -> torch.Tensor:
    """``sorted_segment_sum``'s plain version: ``index_add_`` of the
    entries [indptr[0], indptr[-1]) in index order (it reads the two
    bounds on the host)."""
    lo, hi = int(indptr[0]), int(indptr[-1])
    acc = torch.float32 if data.element_size() < 4 else data.dtype
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=acc,
                      device=data.device)
    return out.index_add_(0, segment_ids[lo:hi].long(),
                          data[lo:hi].to(acc)).to(data.dtype)


def segment_grad_rows(segment_ids: torch.Tensor, indptr: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """(E,) in the ids' dtype: each entry's segment, ``num_segments`` for
    the entries outside [indptr[0], indptr[-1]): the gradient row of
    every entry of a sorted sum, where row num_segments reads 0."""
    e = identity(segment_ids.shape[0], segment_ids.device)
    live = (e >= indptr[0]) & (e < indptr[-1])
    return torch.where(live, segment_ids, num_segments)


_IDENTITY = {}


def identity(n: int, device) -> torch.Tensor:
    """arange(n) int32 on ``device``, a view of one tensor kept per
    device and grown as needed: the sorted sums' senders, with no launch
    a call."""
    t = _IDENTITY.get(torch.device(device))
    if t is None or t.shape[0] < n:
        t = torch.arange(max(n, 2 * (0 if t is None else t.shape[0])),
                         dtype=torch.int32, device=device)
        _IDENTITY[torch.device(device)] = t
    return t[:n]


class _SortedSegmentSum(torch.autograd.Function):
    """The gather kernel over (indptr, arange(E)) on the rows flattened to
    (E, D); the gradient of entry e is the gradient row of its segment,
    0 outside [indptr[0], indptr[-1]) (``segment_grad_rows``)."""

    @staticmethod
    def forward(ctx, data, segment_ids, indptr, num_segments, grad_rows):
        if grad_rows is None:
            ctx.save_for_backward(segment_ids, indptr)
        else:
            ctx.save_for_backward(grad_rows)
        ctx.num_segments = num_segments
        E = data.shape[0]
        if num_segments == 0:
            return data.new_zeros((0,) + tuple(data.shape[1:]))
        x = data.reshape(E, -1).contiguous()
        senders = identity(E, data.device)
        spmm._check(x, indptr, senders, num_segments, None, None, None, 0,
                    ())
        out, variant = spmm.launch_kernel(x, indptr, senders, num_segments)
        count_launch("sorted_segment_sum", variant, x.shape[1])
        return out.reshape((num_segments,) + tuple(data.shape[1:])).to(
            data.dtype)

    @staticmethod
    def backward(ctx, g):
        n = ctx.num_segments
        if len(ctx.saved_tensors) == 2:
            rows = segment_grad_rows(*ctx.saved_tensors, n)
        else:
            rows, = ctx.saved_tensors
        g2 = F.pad(g.reshape(n, -1), (0, 0, 0, 1))     # row n reads 0
        return (g2.index_select(0, rows).reshape(
            (rows.shape[0],) + tuple(g.shape[1:])), None, None, None, None)


def onehot_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """``segment_sum`` of float rows as the JAX package's one-hot
    contraction (kpgnn_tpu/ops/segment.py:_onehot_segment_sum): a
    (segments, rows) 0/1 matrix times the rows, accumulated in f32 and
    cast back to data's dtype; ids outside [0, num_segments) add
    nothing."""
    acc = torch.float32 if data.element_size() < 4 else data.dtype
    oh = (torch.arange(num_segments, device=data.device)[:, None]
          == segment_ids[None, :]).to(acc)
    out = oh @ data.reshape(data.shape[0], -1).to(acc)
    return out.reshape((num_segments,) + tuple(data.shape[1:])).to(
        data.dtype)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 weights: Optional[torch.Tensor] = None,
                 sorted: bool = True,
                 indptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over segments; ``weights`` masks entries out of both the
    numerator and the denominator.  ``indptr`` as in ``segment_sum``:
    only with ``weights`` that mask the entries past its end."""
    if weights is not None:
        w = weights.to(data.dtype)
        while w.dim() < data.dim():
            w = w[..., None]
        data = data * w
        counts = segment_sum(torch.broadcast_to(w, data.shape).contiguous(),
                             segment_ids, num_segments, sorted, indptr)
    else:
        counts = segment_sum(torch.ones_like(data), segment_ids,
                             num_segments, sorted, indptr)
    total = segment_sum(data, segment_ids, num_segments, sorted, indptr)
    return total / torch.clamp(counts, min=1.0)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, sorted: bool = True) -> torch.Tensor:
    """Max over segments; an empty segment reads -inf.  A max is exact in
    any order, so ``sorted`` (the JAX signature's) changes nothing."""
    out = torch.full((num_segments,) + tuple(data.shape[1:]), -torch.inf,
                     dtype=data.dtype, device=data.device)
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(data), data, reduce="amax",
                              include_self=False)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None,
                    sorted: bool = True,
                    indptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable softmax within segments; ``mask`` excludes
    padded entries.  ``indptr`` (the denominator's sum) as in
    ``segment_sum``: a CSR that ends before the masked entries."""
    if mask is not None:
        logits = torch.where(mask, logits, -torch.inf)
    seg_max = segment_max(logits.detach(), segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.exp(logits - seg_max[segment_ids.long()])
    if mask is not None:
        ex = torch.where(mask, ex, 0.0)
    denom = segment_sum(ex, segment_ids, num_segments, sorted, indptr)
    return ex / torch.clamp(denom[segment_ids.long()], min=1e-16)


def multi_hop_degree(edge_attr: torch.Tensor, receivers: torch.Tensor,
                     num_nodes: int, add_self_loop: bool = False,
                     indptr: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """(N, K) per-hop in-degree: the edges with a live hop entry per
    receiver (sorted; ``indptr`` their CSR, if the caller has it);
    ``add_self_loop`` adds GCN's analytic self-loop."""
    deg = segment_sum((edge_attr > 0).float(), receivers, num_nodes,
                      indptr=indptr)
    return deg + 1.0 if add_self_loop else deg


def khop_aggregate(x: torch.Tensor,             # (N, K, D)
                   senders: torch.Tensor,       # (E,)
                   receivers: torch.Tensor,     # (E,)
                   edge_emb: torch.Tensor,      # (E, K, D)
                   edge_attr: torch.Tensor,     # (E, K) int, 0 = absent
                   edge_mask: torch.Tensor,     # (E,) real edges
                   *,
                   scale: Optional[torch.Tensor] = None,      # (E, K)
                   aggr: str = "add",
                   num_segments: Optional[int] = None,
                   indptr: Optional[torch.Tensor] = None,
                   grad_rows: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """out[i, k] = aggr over edges e into i of
    live[e, k] * scale[e, k] * (x[senders[e], k] + edge_emb[e, k]).

    ``mean`` divides by the receiver's union in-degree over real edges
    (``edge_mask``), whatever the hop mask.  ``max`` takes the masked
    messages: a union edge dead at hop k gives a literal 0.0, padded
    edges are left out, and a receiver without a union edge reads 0.
    The sender rows are gathered with ``F.embedding``, not ``x[senders]``:
    a batch's padded edges all start at one node, and the indexing
    gather's backward serialises on a repeated id on the card (545 of
    584 device ms per flagship coo step, PERF.md §5).  The output has
    ``num_segments`` rows (default: x's; a node shard reads senders from
    a halo-extended table longer than its own rows).  ``receivers`` are
    sorted; ``indptr`` is their CSR over the output rows (``COOAdj.indptr``,
    built once a batch, ending before the padded edges), else each sum
    builds it on the device; ``grad_rows`` likewise the sums' backward
    rows (``COOAdj.grad_rows``, ``segment_grad_rows``)."""
    n = x.shape[0] if num_segments is None else num_segments
    msg = F.embedding(senders.long(), x.reshape(x.shape[0], -1)).reshape(
        (-1,) + tuple(x.shape[1:])) + edge_emb
    if scale is not None:
        msg = msg * scale[..., None]
    msg = torch.where((edge_attr > 0)[..., None], msg,
                      torch.zeros((), dtype=msg.dtype, device=msg.device))
    if aggr == "add":
        return segment_sum(msg, receivers, n, indptr=indptr,
                           grad_rows=grad_rows)
    if aggr == "mean":
        cnt = segment_sum(edge_mask.float(), receivers, n, indptr=indptr)
        total = segment_sum(msg, receivers, n, indptr=indptr,
                            grad_rows=grad_rows)
        return total / torch.clamp(cnt, min=1.0)[:, None, None]
    if aggr == "max":
        msg = torch.where(edge_mask[:, None, None], msg,
                          torch.full((), -torch.inf, dtype=msg.dtype,
                                     device=msg.device))
        out = segment_max(msg, receivers, n)
        return torch.where(torch.isfinite(out), out,
                           torch.zeros((), dtype=out.dtype, device=out.device))
    raise ValueError(f"unknown aggr {aggr!r}")
