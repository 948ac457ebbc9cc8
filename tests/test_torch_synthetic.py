"""The port's synthetic generators (``data/synthetic.py``) draw the JAX
package's graphs: same seed, array-equal fields and dtypes."""
import dataclasses

import numpy as np
import pytest

from kpgnn_tpu.data import synthetic as jsyn
from kpgnn_tpu.prep.khop import KHopConfig as JKHopConfig
from kpgnn_tpu_torch.data import synthetic as tsyn
from kpgnn_tpu_torch.prep.khop import KHopConfig

FIELDS = ("num_nodes", "edge_index", "edge_attr", "x", "y", "pe_attr",
          "peripheral_edge_attr", "peripheral_config_attr", "rd")


def assert_graphs_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f)
                assert np.asarray(x).dtype == np.asarray(y).dtype, f


@pytest.mark.parametrize("seed,node_level_y", [(0, False), (7, True)])
def test_synthetic_molecules_equal_jax(seed, node_level_y):
    cfg = dict(K=3, kernel="spd", max_edge_attr_num=5, max_hop_num=2,
               max_edge_type=2, max_edge_count=5, max_distance_count=5)
    ours = tsyn.synthetic_molecules(6, KHopConfig(**cfg), seed=seed,
                                    node_level_y=node_level_y)
    theirs = jsyn.synthetic_molecules(6, JKHopConfig(**cfg), seed=seed,
                                      node_level_y=node_level_y)
    assert_graphs_equal(ours, theirs)


def test_synthetic_khop_graphs_equal_jax():
    assert_graphs_equal(tsyn.synthetic_khop_graphs(4, K=4, seed=3),
                        jsyn.synthetic_khop_graphs(4, K=4, seed=3))


@pytest.mark.parametrize("K", [1, 3])
def test_synthetic_polymers_equal_jax(K):
    ours = tsyn.synthetic_polymers(2, 200, K, seed=11)
    theirs = jsyn.synthetic_polymers(2, 200, K, seed=11)
    assert_graphs_equal(ours, theirs)
    assert all(g.edge_attr.shape == (g.num_edges, K) for g in ours)


def test_khop_config_fields_match():
    """The generators' config is the JAX package's field for field."""
    assert ([f.name for f in dataclasses.fields(KHopConfig)]
            == [f.name for f in dataclasses.fields(JKHopConfig)])
