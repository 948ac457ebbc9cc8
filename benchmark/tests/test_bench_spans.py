"""``spans.summarize`` on a chrome trace built by hand: two training
steps on the dispatching thread (1), the loader's collates and the
prefetch thread's copies on thread 2, a launch by the autograd engine's
thread (3), kernels, a copy and sets with known gaps between them; and a
scoring trace, which has no backward, no optimizer and no collate."""
import pytest

from benchmark import spans

APPROX = dict(rel=1e-12, abs=1e-15)


def x(cat, tid, ts, end, name, **args):
    return {"ph": "X", "cat": cat, "pid": 1, "tid": tid, "ts": ts,
            "dur": end - ts, "name": name, "args": args}


def span(tid, ts, end, name):
    return x("user_annotation", tid, ts, end, name)


def launch(tid, ts, corr):
    return x("cuda_runtime", tid, ts, ts + 1, "cudaLaunchKernel",
             correlation=corr)


def kernel(ts, end, corr=None, cat="kernel"):
    return x(cat, 0, ts, end, "k", **({} if corr is None
                                      else {"correlation": corr}))


TRAIN = [
    span(1, 0, 10, "loop.wait"),
    span(1, 10, 110, "loop.step"),
    span(1, 10, 50, "step.forward"),
    span(1, 12, 30, "model.layer"),
    span(1, 35, 45, "model.pool"),
    span(1, 50, 90, "step.backward"),
    span(1, 90, 110, "step.optimizer"),
    span(1, 92, 108, "Optimizer.step#Adam.step"),    # not the program's
    span(1, 110, 120, "loop.wait"),
    span(1, 120, 220, "loop.step"),
    span(1, 120, 160, "step.forward"),
    span(1, 145, 155, "model.pool"),
    span(1, 160, 200, "step.backward"),
    span(1, 200, 220, "step.optimizer"),
    span(2, 0, 30, "loader.collate"),
    span(2, 40, 44, "prefetch.copy"),
    span(2, 100, 140, "loader.collate"),
    span(2, 130, 136, "prefetch.copy"),
    launch(1, 20, 2), launch(1, 36, 1), launch(3, 36, 3),
    launch(1, 95, 5), launch(1, 150, 4), launch(1, 205, 8),
    x("cuda_runtime", 2, 41, 42, "cudaMemcpyAsync", correlation=6),
    kernel(25, 35, 2), kernel(40, 48, 1), kernel(48, 52, 6, "gpu_memcpy"),
    kernel(70, 85, 3), kernel(100, 105, 5), kernel(155, 165, 4),
    kernel(165, 170, cat="gpu_memset"), kernel(210, 221, 8),
    kernel(225, 230, cat="gpu_memset"),
]
# busy [25, 35] [40, 52] [70, 85] [100, 105] [155, 170] [210, 221]
# [225, 230]: 73 us of 230; idle gaps (midpoint: the loop thread's
# innermost span): [0, 25] (12.5: model.layer, beside loader.collate),
# [35, 40] (model.pool), [52, 70] and [170, 210] (step.backward),
# [85, 100] (step.optimizer), [105, 155] (130: step.forward, beside
# prefetch.copy), [221, 225] (no span)


def test_training_trace_by_hand():
    got = spans.summarize(TRAIN)
    assert got["steps"] == 2
    assert got["spans"]["loader.collate"] == [2, pytest.approx(70e-6,
                                                              **APPROX)]
    assert "Optimizer.step#Adam.step" not in got["spans"]
    m = got["metrics"]
    want = {"input.collate_ms": 0.035, "input.copy_ms": 0.005,
            "step.forward_ms": 0.04, "step.backward_ms": 0.04,
            "step.optimizer_ms": 0.02,
            # in the steps: 15 + 5 + 18 + 15 + (5 + 35) + 40 us, 2 steps
            "device.idle_in_step_ms": 0.0665,
            # launched inside model.pool on its thread: 8 + 10 us of 73;
            # thread 3's launch at 36 lies in no span of its own
            "model.pool_device_share": 100.0 * 18 / 73}
    assert m == {k: pytest.approx(v, **APPROX) for k, v in want.items()}
    idle = {k: (pytest.approx(s, **APPROX),
                {o: pytest.approx(t, **APPROX) for o, t in b.items()})
            for k, (s, b) in got["idle_by_span"].items()}
    assert idle == {
        "model.layer": (25e-6, {"loader.collate": 25e-6}),
        "model.pool": (5e-6, {}),
        "step.backward": (58e-6, {}),
        "step.optimizer": (15e-6, {}),
        "step.forward": (50e-6, {"prefetch.copy": 50e-6}),
        spans.NO_SPAN: (4e-6, {})}
    assert sum(s for s, _ in got["idle_by_span"].values()) == \
        pytest.approx(157e-6, **APPROX)


def test_scoring_trace_has_no_backward_optimizer_or_collate():
    score = [e for e in TRAIN
             if e["name"] not in ("step.backward", "step.optimizer",
                                  "loader.collate", "prefetch.copy")]
    m = spans.summarize(score)["metrics"]
    for name in ("step.backward_ms", "step.optimizer_ms",
                 "input.collate_ms", "input.copy_ms"):
        assert m[name] is None, name
    assert m["step.forward_ms"] == pytest.approx(0.04, **APPROX)
    assert m["model.pool_device_share"] == pytest.approx(100.0 * 18 / 73,
                                                         **APPROX)


def test_a_trace_without_spans_reads_nothing():
    """The parent's trace, whose program has no spans: every metric
    None, every gap unattributed."""
    bare = [e for e in TRAIN if e["cat"] != "user_annotation"]
    got = spans.summarize(bare)
    assert got["steps"] == 0 and got["spans"] == {}
    assert set(got["metrics"].values()) == {None}
    assert list(got["idle_by_span"]) == [spans.NO_SPAN]
    assert spans.summarize([])["metrics"]["step.forward_ms"] is None
