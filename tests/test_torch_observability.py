"""The port's observability against the JAX package: ``trace_summary`` on
the JAX test's synthetic trace (the same ranking and report as
``kpgnn_tpu.utils.trace_summary``) and on a torch.profiler-format one; a
real CPU trace through ``utils.profiling.trace``; a ``--profile_dir``
Trainer run; ``capture_activations`` against the golden bundle's module
outputs; and ``profile_step``'s stages at toy sizes on the CPU."""
import gzip
import json
import math
import os

import numpy as np
import pytest
import torch

from kpgnn_tpu.utils import trace_summary as jts
from kpgnn_tpu_torch.train.config import TrainConfig
from kpgnn_tpu_torch.train.loader import GraphLoader
from kpgnn_tpu_torch.train.loop import Trainer
from kpgnn_tpu_torch.utils import trace_summary as ts
from kpgnn_tpu_torch.utils.parity import (capture_activations,
                                          dump_activations)
from kpgnn_tpu_torch.utils.profiling import trace
from tests.test_torch_model import ACT, golden_model_and_batch

torch.set_num_threads(1)

JAX_TRACE = {"traceEvents": [
    {"ph": "M", "pid": 1, "name": "process_name",
     "args": {"name": "/device:TPU:0"}},
    {"ph": "M", "pid": 2, "name": "process_name",
     "args": {"name": "/host:CPU"}},
    {"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 100, "name": "fusion.1"},
    {"ph": "X", "pid": 1, "tid": 1, "ts": 100, "dur": 300,
     "name": "fusion.2"},
    {"ph": "X", "pid": 1, "tid": 1, "ts": 400, "dur": 50, "name": "copy.3"},
    {"ph": "X", "pid": 2, "tid": 1, "ts": 0, "dur": 9999,
     "name": "python_overhead"},
]}
GATHER = "void gather_segment_sum_kernel<float, true, false, 32>(Args, RunMap)"
FUSED = "void gather_segment_sum_kernel<float, true, true, 32>(Args, RunMap)"
TORCH_TRACE = {"traceEvents": [
    {"ph": "M", "pid": 4242, "name": "process_name",
     "args": {"name": "python3"}},
    {"ph": "X", "cat": "cpu_op", "pid": 4242, "tid": 1, "ts": 0,
     "dur": 5000, "name": "aten::mm"},
    {"ph": "X", "cat": "cuda_runtime", "pid": 4242, "tid": 1, "ts": 10,
     "dur": 8, "name": "cudaLaunchKernel"},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 20, "dur": 10,
     "name": GATHER, "args": {"device": 0, "stream": 7}},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 40, "dur": 12,
     "name": GATHER, "args": {"device": 0, "stream": 7}},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 60, "dur": 30,
     "name": FUSED, "args": {"device": 0, "stream": 7}},
    {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 8, "ts": 100,
     "dur": 4, "name": "Memcpy HtoD (Pageable -> Device)",
     "args": {"device": 0}},
    {"ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 8, "ts": 110,
     "dur": 1, "name": "Memset (Device)", "args": {"device": 0}},
    {"ph": "i", "cat": "kernel", "pid": 0, "ts": 5, "name": "marker"},
]}


def write_trace(path, trace_json, gz):
    path.parent.mkdir(parents=True, exist_ok=True)
    with (gzip.open(path, "wt") if gz else open(path, "w")) as f:
        json.dump(trace_json, f)
    return str(path)


def test_trace_summary_equals_jax_on_the_jax_layout(tmp_path):
    """The JAX test's synthetic trace: the same file found, the same
    tracks, ranking and report as the JAX module's."""
    write_trace(tmp_path / "plugins" / "profile" / "run1" /
                "vm.trace.json.gz", JAX_TRACE, gz=True)
    assert ts.find_trace(str(tmp_path)) == jts.find_trace(str(tmp_path))
    events = ts.load_events(ts.find_trace(str(tmp_path)))
    ours, theirs = ts.summarize(events), jts.summarize(events)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k]["total_us"] == theirs[k]["total_us"]
        assert dict(ours[k]["ops"]) == dict(theirs[k]["ops"])
    for device_only in (True, False):
        assert (ts.top_ops(ours, device_only, 5)
                == jts.top_ops(theirs, device_only, 5))
    assert ts.top_ops(ours, True, 5)[0] == ("fusion", 400.0, 400.0 / 450.0)
    assert ts.report(str(tmp_path), 5) == jts.report(str(tmp_path), 5)
    for name in ("fusion.12", "dynamic-update-slice.5", "copy", "a.b",
                 GATHER):
        assert ts._base_name(name) == jts._base_name(name)


@pytest.mark.parametrize("gz", [False, True])
def test_trace_summary_reads_torch_profiler_traces(tmp_path, gz):
    """Device time is the kernel, memcpy and memset events, on their
    device's track; everything else is the host's."""
    name = "host_1.123.pt.trace.json" + (".gz" if gz else "")
    write_trace(tmp_path / name, TORCH_TRACE, gz)
    assert ts.find_trace(str(tmp_path)).endswith(name)
    tracks = ts.summarize(ts.load_events(ts.find_trace(str(tmp_path))))
    assert set(tracks) == {"/device:GPU:0", "/host:CPU"}
    dev = tracks["/device:GPU:0"]
    assert dev["total_us"] == 57 and dev["count"] == 5
    assert dev["counts"][GATHER] == 2 and dev["counts"][FUSED] == 1
    top = ts.top_ops(tracks, device_only=True, n=3)
    assert [op for op, _, _ in top] == [FUSED, GATHER,
                                        "Memcpy HtoD (Pageable -> Device)"]
    assert top[0][1:] == (30.0, 30.0 / 57.0)
    rep = ts.report(str(tmp_path), 5)
    assert "top ops by device time:" in rep and "aten::mm" not in rep


def span_trace():
    """Spans on the loop's thread (1) and the prefetch thread (3), the
    autograd engine's launch on thread 2, and the device events they
    launched, matched by correlation id; a memset matches no launch."""
    def x(cat, tid, ts, dur, name, **args):
        return {"ph": "X", "cat": cat, "pid": 1, "tid": tid, "ts": ts,
                "dur": dur, "name": name, "args": args}
    return {"traceEvents": [
        x("user_annotation", 1, 0, 100, "loop.step"),
        x("user_annotation", 1, 10, 20, "model.pool"),
        x("cuda_runtime", 1, 12, 2, "cudaLaunchKernel", correlation=1),
        x("cuda_runtime", 1, 50, 2, "cudaLaunchKernel", correlation=2),
        x("cuda_runtime", 2, 60, 2, "cudaLaunchKernel", correlation=3),
        x("user_annotation", 3, 0, 200, "prefetch.copy"),
        x("cuda_runtime", 3, 5, 2, "cudaMemcpyAsync", correlation=4),
        x("kernel", 0, 20, 7, GATHER, correlation=1, device=0),
        x("kernel", 0, 55, 11, FUSED, correlation=2, device=0),
        x("kernel", 0, 70, 13, GATHER, correlation=3, device=0),
        x("gpu_memcpy", 0, 90, 17, "Memcpy HtoD (Pageable -> Device)",
          correlation=4, device=0),
        x("gpu_memset", 0, 120, 3, "Memset (Device)", device=0),
    ]}


def test_trace_summary_lists_spans_with_their_device_time(tmp_path):
    """Each span's count, host time and the device time launched inside
    it on its own thread; the rest is launched outside every span."""
    events = span_trace()["traceEvents"]
    spans, outside = ts.span_summary(events)
    assert spans == {
        "loop.step": {"count": 1, "host_us": 100.0, "device_us": 18.0},
        "model.pool": {"count": 1, "host_us": 20.0, "device_us": 7.0},
        "prefetch.copy": {"count": 1, "host_us": 200.0, "device_us": 17.0}}
    assert outside == 16.0
    assert ts.span_summary(TORCH_TRACE["traceEvents"]) == ({}, 57.0)
    rep = ts.report(write_trace(tmp_path / "s.pt.trace.json", span_trace(),
                                False))
    assert "spans: count, host ms, device ms launched inside:" in rep
    assert "       1      0.100 ms      0.018 ms  loop.step" in rep
    assert "device ms launched outside every span: 0.016" in rep
    assert "spans:" not in ts.report(write_trace(
        tmp_path / "t.pt.trace.json", TORCH_TRACE, False))


def test_trace_summary_cli_and_missing_trace(tmp_path, capsys):
    with pytest.raises(FileNotFoundError):
        ts.find_trace(str(tmp_path))
    with pytest.raises(SystemExit):
        ts.main([])
    path = write_trace(tmp_path / "t.pt.trace.json", TORCH_TRACE, False)
    ts.main([path, "2"])
    out = capsys.readouterr().out
    assert out.count(" ms  ") == 2 and FUSED in out


def test_profiling_trace_writes_a_cpu_trace(tmp_path):
    """A real torch.profiler trace on the CPU: a chrome trace in the
    directory with the block's operators and no device track, so the
    report ranks host time, as the JAX module's does without a device."""
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "prof"), cuda=False):
        (x @ x).sum()
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    tracks = ts.summarize(ts.load_events(ts.find_trace(str(tmp_path))))
    assert set(tracks) == {"/host:CPU"}
    assert "aten::mm" in tracks["/host:CPU"]["ops"]
    assert "host (no device track in trace)" in ts.report(str(tmp_path))


def test_trainer_profile_dir_traces_one_epoch(tmp_path):
    """``cfg.profile_dir`` traces epoch 1 of 2 (epoch 0 of 1): one trace
    file each, holding the epoch's train steps."""
    from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
    from tests.test_torch_train_utils import SMALL, small_csl_graphs

    graphs = small_csl_graphs()
    for epochs in (2, 1):
        prof = tmp_path / f"prof{epochs}"
        cfg = TrainConfig(lr=1e-2, num_epochs=epochs, profile_dir=str(prof))
        logs = []
        trainer = Trainer(make_model(ModelConfig(**SMALL)), cfg,
                          loss="cross_entropy", device="cpu",
                          logger=type("L", (), {"info": logs.append})())
        trainer.fit(GraphLoader(graphs, 5, mode="coo"),
                    GraphLoader(graphs[:5], 5, mode="coo"), seed=0)
        assert len(os.listdir(prof)) == 1
        assert any(f"profiler trace of epoch {min(epochs - 1, 1)}" in m
                   for m in logs)
        ops = ts.summarize(ts.load_events(ts.find_trace(str(prof))))[
            "/host:CPU"]
        assert ops["counts"]["Optimizer.step#Adam.step"] == 4
        spans, _ = ts.span_summary(ts.load_events(ts.find_trace(str(prof))))
        assert spans["loop.step"]["count"] == 4
        assert spans["step.optimizer"]["count"] == 4
        assert "loop.step" in ts.report(str(prof))


def test_capture_activations_equals_the_golden_modules(tmp_path):
    """Every module's output keyed by its path as the JAX package keys
    flax intermediates, against the golden bundle's captures."""
    g, model, batch = golden_model_and_batch()
    acts = capture_activations(model, batch)
    assert "__call__" in acts
    np.testing.assert_allclose(acts["__call__"][:1], g["act/__output__"],
                               **ACT)
    compared = 0
    for key in g.files:
        if not (key.startswith("act/") and key.endswith("/__call__")):
            continue
        ours = acts.get(key[len("act/"):])
        if ours is None:
            continue        # flax-only intermediates (folded encoders)
        if key.endswith("attention_lstm/__call__"):
            ours = ours.transpose(1, 0, 2)      # captured node-major there
        np.testing.assert_allclose(ours, g[key], err_msg=key, **ACT)
        compared += 1
    assert compared >= 40, compared
    assert not any(h for m in model.modules()
                   for h in m._forward_hooks.values())
    shapes = dump_activations(model, batch, str(tmp_path / "acts.npz"))
    with np.load(tmp_path / "acts.npz") as f:
        assert set(f.files) == set(acts) == set(shapes)
        for k in f.files:
            np.testing.assert_array_equal(f[k], acts[k])


@pytest.fixture
def toy_profile_step(monkeypatch):
    from kpgnn_tpu_torch.scripts import profile_step as ps

    for name, value in (("BATCH", 4), ("K", 2), ("L", 2), ("HIDDEN", 16),
                        ("LARGE_NODES", 64), ("LARGE_HIDDEN", 18),
                        ("REPEATS", 1), ("STEP_ITERS", 2),
                        ("LARGE_ITERS", 2), ("TOP_N", 5)):
        monkeypatch.setattr(ps, name, value)
    return ps


def test_profile_step_stages_at_toy_size(toy_profile_step, tmp_path,
                                         capsys):
    """Every ported stage runs on the CPU, prints its time and its
    trace's report, and returns its times."""
    res = toy_profile_step.main([
        "--device", "cpu", "--out_dir", str(tmp_path), "--stages",
        "resident,resident_ab,bf16,large"])
    out = capsys.readouterr().out
    assert set(res) == {"resident", "resident_ab", "bf16", "large"}
    assert math.isfinite(res["resident"]) and res["resident"] > 0
    assert set(res["bf16"]) == set(res["resident_ab"]) == {"float32",
                                                          "bfloat16"}
    assert res["large"]["collate_s"] > 0 and res["large"]["step_s"] > 0
    for line in ("resident epoch steady-state:", "dense float32 step:",
                 "dense bfloat16 step:", "large-graph collate_pallas",
                 "large-graph pallas step:"):
        assert line in out, line
    assert out.count("==== trace summary:") == 6
    assert out.count("top ops by host (no device track in trace)") == 6


def test_profile_step_failing_stage_exits_nonzero(toy_profile_step,
                                                  tmp_path, capsys,
                                                  monkeypatch):
    """A failed stage (here one that raises on purpose) is reported with
    its traceback, the others (banded, large) still run, and the process
    exits with status 1; an unknown stage is a usage error."""
    def broken(out_dir, device):
        raise RuntimeError("this stage fails on purpose")
    monkeypatch.setitem(toy_profile_step.STAGES, "broken", broken)
    with pytest.raises(SystemExit) as e:
        toy_profile_step.main(["--device", "cpu", "--out_dir",
                               str(tmp_path), "--stages",
                               "broken,banded,large"])
    assert e.value.code == 1
    captured = capsys.readouterr()
    assert "this stage fails on purpose" in captured.err
    assert "[stage broken FAILED" in captured.out
    assert "[stage banded done" in captured.out
    assert "[stage large done" in captured.out
    assert "stages failed: broken" in captured.out
    with pytest.raises(SystemExit):
        toy_profile_step.main(["--device", "cpu", "--stages", "nowhere"])
