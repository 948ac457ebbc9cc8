"""Preprocessing with an on-disk cache and a worker pool
(counterpart of kpgnn_tpu/prep/runner.py).

Extraction is a pure function of one raw graph, so a large dataset fans
out over a process pool, and the prepped list is pickled under a key of
(name, config).  The port's cache files end in ``.torch.pkl``; the JAX
package names its files ``<name>_<K>_<kernel>_<16 hex digits>.pkl`` in
the same default directory, so no JAX file is ever read here (unpickling
one would import the JAX package).
"""
from __future__ import annotations

import dataclasses
import hashlib
import multiprocessing
import os
import pickle
import tempfile
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional, Sequence

from ..graph.data import Graph
from . import native
from .khop import KHopConfig, extract_khop

# graphs above which num_workers > 1 engages the pool, as in the JAX
# package; the pool hands out chunks of this many
POOL_MIN_GRAPHS = 64
CACHE_SUFFIX = ".torch.pkl"


def _cache_key(name: str, cfg: KHopConfig) -> str:
    payload = f"{name}|{dataclasses.asdict(cfg)}"
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


def cache_path(cache_dir: str, name: str, cfg: KHopConfig) -> str:
    """Where ``preprocess_graphs`` keeps (name, cfg)'s prepped graphs."""
    return os.path.join(cache_dir, f"{name}_{cfg.K}_{cfg.kernel}_"
                                   f"{_cache_key(name, cfg)}{CACHE_SUFFIX}")


def _extract_one(args):
    raw, cfg = args
    return extract_khop(
        num_nodes=raw["num_nodes"],
        edge_index=raw["edge_index"],
        edge_attr=raw.get("edge_attr"),
        cfg=cfg,
        x=raw.get("x"),
        y=raw.get("y"),
        z=raw.get("z"),
        pos=raw.get("pos"),
    )


def preprocess_graphs(
    raw_graphs: Sequence[dict],
    cfg: KHopConfig,
    cache_dir: Optional[str] = None,
    name: str = "dataset",
    num_workers: int = 0,
    reprocess: bool = False,
) -> List[Graph]:
    """Extract k-hop attributes for a list of raw graphs.

    Each raw graph is a dict with keys num_nodes / edge_index and optional
    edge_attr / x / y / z / pos.  With ``cache_dir`` set, results
    round-trip through a pickle cache keyed by (name, cfg); ``reprocess``
    ignores an existing file, and a file whose length differs from the
    dataset's is stale and rebuilt.

    The cache is structural only: labels (``y``) are re-attached from the
    raw dicts on every hit, since scripts rewrite ``raw["y"]`` per task
    or target before calling (counting's five tasks share one structural
    prep).

    Above ``POOL_MIN_GRAPHS`` graphs, ``num_workers > 1`` extracts on a
    pool of spawned processes: a forked child of a process that has
    initialised CUDA is unsafe, and spawned ones start from a fresh
    import."""
    path = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        path = cache_path(cache_dir, name, cfg)
        if os.path.exists(path) and not reprocess:
            with open(path, "rb") as f:
                cached = pickle.load(f)
            if len(cached) == len(raw_graphs):
                return [g.replace(y=raw.get("y"))
                        for g, raw in zip(cached, raw_graphs)]

    jobs = [(raw, cfg) for raw in raw_graphs]
    if num_workers and num_workers > 1 and len(jobs) > POOL_MIN_GRAPHS:
        native.available()          # build once, before the workers load it
        with ProcessPoolExecutor(
                max_workers=num_workers,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            graphs = list(ex.map(_extract_one, jobs,
                                 chunksize=POOL_MIN_GRAPHS))
    else:
        graphs = [_extract_one(j) for j in jobs]

    if path is not None:
        fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=cache_dir)
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(graphs, f)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return graphs
