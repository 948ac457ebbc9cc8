"""``ops.segment.segment_sum`` and its one-hot form against the JAX
package's, on the CPU.

The card takes ``onehot_segment_sum`` (the JAX package's
``_onehot_segment_sum``) for a float sum into at most
``ONEHOT_SEGMENTS_MAX`` segments; the CPU, and the card above that
bound, ``index_add_``.  Both forms, on the same rows (ids as pooling
lays them out: sorted by graph, the pad segment holding the padded
rows, and shuffled), match the JAX one-hot contraction and
``jax.ops.segment_sum``.  Tolerance: f32 1e-6 of the segment's sum of
|terms| (the sums of up to 512 terms run in other orders); bf16 that
plus one bf16 ulp of the result (one rounding of an f32 sum to bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpgnn_tpu.ops import segment as jseg
from kpgnn_tpu_torch.ops.segment import (ONEHOT_SEGMENTS_MAX,
                                         onehot_segment_sum, segment_sum)

ROWS, SEGMENTS = 1024, 65


def rows(tail, shuffled):
    rng = np.random.default_rng(5)
    ids = np.sort(np.concatenate([rng.integers(0, SEGMENTS - 1, ROWS // 2),
                                  np.full(ROWS // 2, SEGMENTS - 1)]))
    if shuffled:
        ids = rng.permutation(ids)
    return rng.standard_normal((ROWS,) + tail).astype(np.float32), ids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("tail", [(), (104,), (8, 13)])
def test_segment_sum_forms_match_jax(tail, shuffled, dtype):
    x, ids = rows(tail, shuffled)
    want = np.asarray(jseg._onehot_segment_sum(
        jnp.asarray(x, dtype), jnp.asarray(ids, jnp.int32), SEGMENTS
    ).astype(jnp.float32))
    scatter = np.asarray(jseg.jax.ops.segment_sum(
        jnp.asarray(x), jnp.asarray(ids, jnp.int32), SEGMENTS))
    xt = torch.tensor(x).to(getattr(torch, dtype))
    it = torch.tensor(ids, dtype=torch.int32)
    bound = 1e-6 * np.asarray(jseg.jax.ops.segment_sum(
        jnp.abs(jnp.asarray(x)), jnp.asarray(ids, jnp.int32), SEGMENTS))
    if dtype == "bfloat16":
        bound = bound + 2.0 ** -7 * np.abs(want)
    for got in (onehot_segment_sum(xt, it, SEGMENTS),
                segment_sum(xt, it, SEGMENTS)):
        assert got.dtype == xt.dtype
        assert got.shape == (SEGMENTS,) + tail
        assert (np.abs(got.float().numpy() - want) <= bound).all()
        if dtype == "float32":
            assert (np.abs(got.numpy() - scatter) <= bound).all()


def test_onehot_segment_sum_gradient_and_bound():
    x, ids = rows((104,), True)
    xt = torch.tensor(x, requires_grad=True)
    w = torch.randn(SEGMENTS, 104, generator=torch.Generator().manual_seed(1))
    (onehot_segment_sum(xt, torch.tensor(ids), SEGMENTS) * w).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), w.numpy()[ids])
    assert ONEHOT_SEGMENTS_MAX == jseg._ONEHOT_SEGMENTS_MAX
