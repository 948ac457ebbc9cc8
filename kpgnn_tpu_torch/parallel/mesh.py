"""Process groups for multi-device training (counterpart of
kpgnn_tpu/parallel/mesh.py).

Where the JAX package names a ``jax.sharding.Mesh`` of devices, the port
runs one process per rank and a ``Mesh`` holds its process group: the
axis names, the shape, this rank's coordinate on each axis, one
``torch.distributed`` group per axis and the device the rank computes
on.  Ranks are laid out row-major over the shape, so on a (dcn, data)
mesh the ranks of one host are consecutive.

Joining a group is explicit: ``init_process_group`` takes the backend
(``nccl`` on the card, ``gloo`` on the CPU or for several ranks on one
card), the world size and the rank as arguments; ``from_env`` joins the
group torchrun describes (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT); ``local_group`` forms a group of one in this process;
``spawn`` starts one process per rank, rendezvousing
through a file, and returns each rank's result.  Nothing here picks a
backend or a size by catching a failure.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import shutil
import tempfile
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# collectives of a rank that another rank never joins fail after this long
GROUP_TIMEOUT = datetime.timedelta(minutes=10)

Axes = Union[str, Sequence[str]]


@dataclasses.dataclass
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]         # this rank's index along each axis
    groups: Dict[str, object]       # axis name -> its ProcessGroup
    device: torch.device
    backend: str

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def rank(self) -> int:
        """This rank's index in the flattened (row-major) mesh."""
        return self.axis_index(self.axis_names)

    def _axes(self, axes: Optional[Axes]) -> Tuple[str, ...]:
        if axes is None:
            return self.axis_names
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def axis_size(self, axes: Optional[Axes] = None) -> int:
        return math.prod(self.shape[self.axis_names.index(a)]
                         for a in self._axes(axes))

    def axis_index(self, axes: Optional[Axes] = None) -> int:
        """This rank's row-major index over ``axes``."""
        idx = 0
        for a in self._axes(axes):
            i = self.axis_names.index(a)
            idx = idx * self.shape[i] + self.coords[i]
        return idx

    def group(self, axis: str):
        return self.groups[axis]

    def all_reduce(self, t: torch.Tensor, axes: Optional[Axes] = None
                   ) -> torch.Tensor:
        """SUM of ``t`` over ``axes`` in place, one axis after another from
        the innermost (on a (dcn, data) mesh: inside a host first, then
        across hosts).  Returns ``t``."""
        for a in reversed(self._axes(axes)):
            if self.shape[self.axis_names.index(a)] > 1:
                dist.all_reduce(t, group=self.groups[a])
        return t


def default_device(backend: str) -> torch.device:
    """NCCL: the card of this rank's local index; gloo: the CPU."""
    if backend == "nccl":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def init_process_group(backend: str, world_size: int, rank: int,
                       init_method: str,
                       device: Optional[torch.device] = None) -> None:
    """Join (or, at world size 1, form) the default process group.  An
    NCCL rank binds its card first."""
    if backend == "nccl":
        torch.cuda.set_device(device if device is not None
                              else default_device(backend))
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=GROUP_TIMEOUT)


def local_group(backend: str) -> None:
    """A group of one rank, in this process (an in-memory store)."""
    if backend == "nccl":
        torch.cuda.set_device(default_device(backend))
    dist.init_process_group(backend=backend, store=dist.HashStore(),
                            world_size=1, rank=0, timeout=GROUP_TIMEOUT)


def from_env(backend: str) -> None:
    """Join the group torchrun describes in the environment."""
    init_process_group(backend, int(os.environ["WORLD_SIZE"]),
                       int(os.environ["RANK"]), "env://")


def make_mesh(axis_names: Tuple[str, ...] = ("data",),
              shape: Optional[Sequence[int]] = None,
              device: Optional[torch.device] = None) -> Mesh:
    """A mesh over the initialized default group: ``shape`` (default: the
    world on the first axis) row-major over the ranks.  Every rank must
    call it with the same arguments, since each axis's subgroups are
    created collectively; a one-axis mesh uses the default group."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does "
                         f"not hold the {world} ranks")
    coords = []
    r = rank
    for s in reversed(shape):
        coords.append(r % s)
        r //= s
    coords = tuple(reversed(coords))
    groups = {}
    for i, a in enumerate(axis_names):
        if shape[i] == world:
            groups[a] = dist.group.WORLD
            continue
        # every line of ranks along axis i, in one order on every rank
        others = [range(s) for j, s in enumerate(shape) if j != i]
        for rest in itertools.product(*others):
            ranks = []
            for c in range(shape[i]):
                full = list(rest[:i]) + [c] + list(rest[i:])
                ranks.append(_flat(full, shape))
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[a] = g
    backend = dist.get_backend()
    return Mesh(tuple(axis_names), shape, coords, groups,
                device if device is not None else default_device(backend),
                backend)


def _flat(coords: Sequence[int], shape: Sequence[int]) -> int:
    idx = 0
    for c, s in zip(coords, shape):
        idx = idx * s + c
    return idx


def _rank_main(fn, rank, world_size, backend, init_method, device, args,
               out_dir):
    """One spawned rank: join the group, run fn(rank, world_size, *args)
    on ``device``, write its result (or its traceback) for the parent."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world_size))
    try:
        init_process_group(backend, world_size, rank, init_method, device)
        try:
            result = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(out_dir, f"result_{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, world_size: int, backend: str, args: tuple = (),
          devices: Optional[Sequence] = None,
          timeout: Optional[float] = None) -> List[object]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    (the spawn start method, so a parent that holds CUDA may spawn), each
    a rank of one process group of ``backend`` that rendezvouses through
    a file in a fresh temporary directory.  ``devices[r]`` is rank r's
    device (default: each rank's card under NCCL, else the CPU).  ``fn``
    must be importable by name and its result picklable by
    ``torch.save``.  Returns the ranks' results in rank order; if any
    rank fails or the run outlasts ``timeout`` seconds (None: no limit),
    every rank is stopped and the first failure's traceback raised."""
    ctx = mp.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="kpgnn_ranks_")
    init = "file://" + os.path.join(out_dir, "rendezvous")
    procs = []
    try:
        for rank in range(world_size):
            dev = (devices[rank] if devices is not None
                   else torch.device("cuda", rank) if backend == "nccl"
                   else torch.device("cpu"))
            p = ctx.Process(target=_rank_main,
                            args=(fn, rank, world_size, backend, init, dev,
                                  args, out_dir))
            p.start()
            procs.append(p)
        deadline = None if timeout is None else time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [p for p in procs
                      if not p.is_alive() and p.exitcode != 0]
            if failed or (deadline is not None
                          and time.monotonic() > deadline):
                break
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        errors = sorted(f for f in os.listdir(out_dir)
                        if f.startswith("error_"))
        if errors:
            with open(os.path.join(out_dir, errors[0])) as f:
                raise RuntimeError(f"rank {errors[0][6:-4]} failed:\n"
                                   + f.read())
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks stopped without a result (rank, "
                               f"exit code): {bad}")
        return [torch.load(os.path.join(out_dir, f"result_{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(out_dir, ignore_errors=True)
