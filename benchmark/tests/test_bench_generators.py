"""The traffic generators: deterministic per seed, in range, for any
seed a run may be given."""
import numpy as np
import pytest

from benchmark import molecules


def _same(a, b):
    return all(x["num_nodes"] == y["num_nodes"]
               and all(np.array_equal(x[k], y[k]) for k in x
                       if k != "num_nodes") for x, y in zip(a, b))


@pytest.mark.parametrize("kind", ["zinc", "qm9"])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, -7, 2 ** 70])
def test_deterministic_per_seed(kind, seed):
    a = molecules.generate(kind, 20, seed)
    b = molecules.generate(kind, 20, seed)
    c = molecules.generate(kind, 20, seed + 1)
    assert _same(a, b)
    assert not _same(a, c)


@pytest.mark.parametrize("kind,lo,hi,codes", [("zinc", 9, 37, (2, 4)),
                                              ("qm9", 3, 29, (2, 5))])
def test_shapes(kind, lo, hi, codes):
    for m in molecules.generate(kind, 200, 3):
        n = m["num_nodes"]
        assert lo <= n <= hi
        ei, ea = m["edge_index"], m["edge_attr"]
        assert ei.shape == (2, ea.shape[0]) and ei.min() >= 0 \
            and ei.max() < n
        assert codes[0] <= ea.min() and ea.max() <= codes[1]
        pairs = set(zip(ei[0].tolist(), ei[1].tolist()))
        assert all((v, u) in pairs for u, v in pairs)    # both directions
        assert m["x"].shape[0] == n and m["y"].shape == (1,)
        if kind == "qm9":
            assert m["x"].shape == (n, 11) and m["z"].shape == (n,)
            assert set(m["z"].tolist()) <= {1, 6, 7, 8, 9}


@pytest.mark.parametrize("kind,seed", [("zinc", 1), ("zinc", 4), ("qm9", 3),
                                       ("qm9", 4)])
def test_targets_are_distinct(kind, seed):
    # these seeds draw repeated targets at 8,192 molecules before the
    # generator moves them apart
    raw = molecules.GENERATORS[kind](8192, molecules.rng_for(seed, 0))
    ys = [float(m["y"][0]) for m in raw]
    assert len(set(ys)) < len(ys)
    ys = [float(m["y"][0]) for m in molecules.generate(kind, 8192, seed)]
    assert len(set(ys)) == len(ys)
