"""The copied FLOP and byte counters against counts by hand on a tiny
plan."""
import pytest
import torch

from benchmark.counts import bounds, flops
from benchmark.counts.peaks import F32_FLOPS, HBM_BYTES_PER_S


def test_kernel_bound_by_hand():
    # 3 rows, 4 edges from senders {0, 2, 2, 5}; n_cols 4, so sender 5
    # reads nothing; D 8 f32
    indptr = torch.tensor([0, 1, 3, 4], dtype=torch.int32)
    senders = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    ms, by = bounds.kernel_bound_ms(indptr, senders, 3, 4, 8, 4)
    nbytes = 2 * 8 * 4 + 4 * 4 + 4 * 4 + 3 * 8 * 4
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / HBM_BYTES_PER_S * 1e3)
    # fused, rows_per_hop 2: codes (1, 0, 3, 3); rows 0, 1, 1, 2 so the
    # code-3 edges lie in hop 0 (row 1) and hop 1 (row 2): 3 table rows
    codes = torch.tensor([1, 0, 3, 3], dtype=torch.int32)
    ms, _ = bounds.kernel_bound_ms(indptr, senders, 3, 4, 8, 4, codes, 2)
    fused = nbytes + 4 * 4 + 3 * 8 * 4
    assert ms == pytest.approx(fused / HBM_BYTES_PER_S * 1e3)


def test_sorted_sum_and_lstm_bounds_by_hand():
    ms, by = bounds.sorted_sum_bound_ms(10, 40, 16, 4)
    assert by == "bytes"
    assert ms == pytest.approx((40 * 16 * 4 + 11 * 4 + 10 * 16 * 4)
                               / HBM_BYTES_PER_S * 1e3)
    T, B, H = 3, 5, 2
    ms, _ = bounds.lstm_bound_ms(T, B, H, 4, "fwd")
    moved = (T * B * 8 * H + 2 * T * B * 2 * H + 8 * H * H + 16 * H) * 4
    ops = 2 * T * B * (8 * H * H + 25 * H)
    assert ms == pytest.approx(max(moved / HBM_BYTES_PER_S,
                                   ops / F32_FLOPS) * 1e3)
    ms, _ = bounds.lstm_bound_ms(T, B, H, 4, "bwd")
    moved = (3 * T * B * 2 * H + 2 * T * B * 8 * H + 8 * H * H + 16 * H) \
        * 4 + (8 * H * H + 16 * H) * 4
    ops = 2 * T * B * (16 * H * H + 24 * H)
    assert ms == pytest.approx(max(moved / HBM_BYTES_PER_S,
                                   ops / F32_FLOPS) * 1e3)


def test_flops_by_hand():
    m = dict(model_name="KPGINPlus", hidden_size=4, num_layer=2, K=2, input_encoder=["embedding",
                                                             5],
             use_rd=False, max_edge_type=1, max_hop_num=1, JK="last",
             virtual_node=False, pooling_method="sum")
    n, g, e = 3, 1, [4, 2]
    H = 4
    periph = 2 * n * 2 * 1 * 2 * H * H + 2 * n * 2 * 2 * H * H
    layer0 = 2 * 4 * H + 2 * 2 * n * H * H
    layer1 = 2 * 4 * H + 2 * 2 * H + 2 * 2 * (2 * n) * H * 8 \
        + 2 * 2 * 2 * n * 4 * 2 * 2 + 2 * 2 * n * H * H
    head = 2 * n * H * H + 2 * g * H
    want = periph + layer0 + layer1 + head
    assert flops.forward_flops(m, n, g, e) == want
    assert flops.step_flops(m, n, g, e, True) == 3 * want
