"""Tiny versions of the benchmark's cells for CPU tests: the cell's
configuration at hidden 16, 3 layers, K=3, over a few dozen
molecules."""
import copy

from benchmark import manifest

DOC = manifest.load()
SEED = 2 ** 31 + 11


def cell(name: str, **traffic):
    """(cell, config, traffic, limits, end-to-end metrics) of a tiny
    version of the cell ``name``."""
    c = manifest.cell(DOC, name)
    cfg = copy.deepcopy(manifest.config(DOC, c["config"]))
    cfg["model"].update(hidden_size=16, num_layer=3, K=3)
    tr = dict(manifest.traffic(c["traffic"]))
    tr.update(library=48 if tr["kind"] == "train" else 32, batch_size=16)
    tr.update(traffic)
    return (c, cfg, tr, manifest.limits(name),
            manifest.metrics_of(DOC, name, False))
