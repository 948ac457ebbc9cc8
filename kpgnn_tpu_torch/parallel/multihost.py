"""Multi-host input sharding for data-parallel training (counterpart of
kpgnn_tpu/parallel/multihost.py).

A cluster is two levels of network: the cards of one host (NVLink) and
the hosts (the data-centre network).  Every rank runs the same program;
ranks are numbered host by host, so a host's ranks are consecutive
(torchrun's RANK with LOCAL_WORLD_SIZE ranks a node).  The input
pipeline is sharded over hosts: host h loads only ``host_shard(items,
h, H)``, a strided 1/H slice of the dataset, and each of its ranks takes
its own member of each group of LOCAL_WORLD_SIZE batches.  No training
bytes cross hosts; only gradient sums do, and ``dcn_mesh`` makes them
hierarchical: a (dcn, data) mesh whose "data" groups are the ranks of
one host and whose "dcn" groups are the ranks with one local index, so
the data-parallel step (parallel/dp.py) sums inside each host first and
then across hosts.  The JAX package assembles global arrays from
per-host data (``make_array_from_process_local_data``); a process per
rank holds its own batch and needs no counterpart.
"""
from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Optional, Sequence

import torch.distributed as dist

from ..graph.batch import GraphBatch
from .dp import mask_empty_batch
from .mesh import Mesh, make_mesh

DCN_AXIS = "dcn"
ICI_AXIS = "data"


def host_count() -> int:
    """Hosts of the job: WORLD_SIZE // LOCAL_WORLD_SIZE (1 without a
    launcher's environment)."""
    return max(int(os.environ.get("WORLD_SIZE", 1))
               // int(os.environ.get("LOCAL_WORLD_SIZE", 1)), 1)


def host_index() -> int:
    """This process's host: RANK // LOCAL_WORLD_SIZE (0 without a
    launcher's environment)."""
    return (int(os.environ.get("RANK", 0))
            // int(os.environ.get("LOCAL_WORLD_SIZE", 1)))


def host_shard(items: Sequence, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> List:
    """The strided 1/H slice of the dataset this host loads.  Strided,
    not contiguous, so a label ordering spreads evenly over the hosts;
    the union over hosts is exactly the dataset (the last shards may be
    one item shorter)."""
    pi = host_index() if process_index is None else process_index
    pc = host_count() if process_count is None else process_count
    return list(items[pi::pc])


def dcn_mesh(n_hosts: Optional[int] = None, device=None) -> Mesh:
    """Host-major two-axis mesh (DCN_AXIS, ICI_AXIS) over the default
    group: axis 0 strides across hosts, axis 1 stays inside one."""
    world = dist.get_world_size()
    n_hosts = host_count() if n_hosts is None else n_hosts
    if world % n_hosts:
        raise ValueError(f"{world} ranks do not divide over {n_hosts} "
                         "hosts")
    return make_mesh((DCN_AXIS, ICI_AXIS), (n_hosts, world // n_hosts),
                     device=device)


def lockstep_group_count(n_items_global: int, batch_size: int,
                         mesh: Mesh) -> int:
    """The number of groups EVERY host must step through, so that the
    collective step loop stays in lockstep: host 0 has the largest shard
    (ceil(n / H)); shorter hosts pad whole masked groups up to its
    count."""
    n_hosts = mesh.axis_size(DCN_AXIS)
    n_local = mesh.axis_size(ICI_AXIS)
    largest_shard = -(-n_items_global // n_hosts)
    n_batches = -(-largest_shard // batch_size)
    return -(-n_batches // n_local)


def host_shard_loader(loader: Iterable[GraphBatch], mesh: Mesh,
                      n_groups: Optional[int] = None
                      ) -> Iterator[GraphBatch]:
    """This rank's member of each group of the host's batch stream (the
    host's ``host_shard``-split loader), one group per host rank; a
    trailing partial group pads with masked-empty batches.  Pass
    ``n_groups = lockstep_group_count(...)`` on a multi-host run: a host
    whose shard is one item shorter then pads whole masked groups until
    it has yielded as many groups as host 0, instead of leaving host 0
    blocked in a collective it never joins.  Producing more groups than
    ``n_groups`` raises before the extra group is yielded."""
    n_local = mesh.axis_size(ICI_AXIS)
    me = mesh.axis_index(ICI_AXIS)
    buf: List[GraphBatch] = []
    last: Optional[GraphBatch] = None
    yielded = 0

    def check(yielded):
        if n_groups is not None and yielded >= n_groups:
            raise ValueError(
                f"host produced more than lockstep n_groups={n_groups} "
                "groups; recompute lockstep_group_count from the global "
                "dataset size")

    for b in loader:
        last = b
        buf.append(b)
        if len(buf) == n_local:
            check(yielded)
            yield buf[me]
            yielded += 1
            buf = []
    if buf:
        check(yielded)
        yield buf[me] if me < len(buf) else mask_empty_batch(buf[-1])
        yielded += 1
    if n_groups is not None:
        if yielded < n_groups and last is None:
            raise ValueError("empty host shard: cannot build masked "
                             "padding groups without a template batch")
        while yielded < n_groups:
            yield mask_empty_batch(last)
            yielded += 1


class MultiHostShardStream:
    """Re-iterable view for the Trainer's evaluations (dp.ShardStream's
    multi-host twin)."""

    def __init__(self, loader, mesh: Mesh, n_groups: Optional[int] = None):
        self.loader, self.mesh, self.n_groups = loader, mesh, n_groups

    def __iter__(self):
        return host_shard_loader(self.loader, self.mesh, self.n_groups)
