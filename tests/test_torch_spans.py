"""The port's spans (``utils/profiling.span``): off, one shared null
context; under a profiler, a CPU training epoch over
``device_prefetch(GraphLoader(shuffle=True))`` and an evaluation over a
``DeviceCacheLoader`` leave every span of ``SPANS`` in the chrome trace,
nested as the code nests them, with the collates and copies on threads
of their own, once a batch."""
import contextlib
import json
import os
from collections import defaultdict

import pytest
import torch

from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.nn.inits import init_parameters
from kpgnn_tpu_torch.prep.khop import KHopConfig, extract_graphs
from kpgnn_tpu_torch.train import loop
from kpgnn_tpu_torch.train.loader import GraphLoader
from kpgnn_tpu_torch.train.state import make_optimizer
from kpgnn_tpu_torch.utils import profiling
from tests.test_torch_model import FLAGSHIP_SMALL, PREP_SMALL
from tests.test_torch_prep_batch import raw_molecules

torch.set_num_threads(1)
V1, VK = 5, 11          # num_hop1_edge + 2, max_pe_num + 2 of FLAGSHIP_SMALL
MODEL = dict(FLAGSHIP_SMALL, hidden_size=12, num_layer=3)
BATCH, TRAIN, EVAL = 4, 10, 6       # 3 train batches, 2 eval batches


def test_span_off_is_one_shared_null_context():
    a, b = profiling.span("loop.step"), profiling.span("model.pool")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    with torch.profiler.profile() as prof:
        on = profiling.span("loop.step")
        with on:
            pass
    assert on is not a
    assert [e.name for e in prof.events()].count("loop.step") == 1
    assert profiling.span("loop.step") is a


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The spans of one train epoch and one evaluation under
    ``profiling.trace``: {name: [(tid, start, end)]}."""
    graphs = extract_graphs(raw_molecules(TRAIN + EVAL, seed=7),
                            KHopConfig(**PREP_SMALL))
    model = init_parameters(make_model(ModelConfig(**MODEL)), 0)
    opt = make_optimizer(model.parameters(), 1e-3, 0.0)
    kw = dict(mode="pallas", v1=V1, vk=VK)
    out = str(tmp_path_factory.mktemp("prof"))
    with profiling.trace(out, cuda=False):
        loop.train_epoch(model, opt, loop.device_prefetch(
            GraphLoader(graphs[:TRAIN], BATCH, shuffle=True, seed=1, **kw),
            "cpu"), "l1")
        loop.evaluate(model, loop.DeviceCacheLoader(
            GraphLoader(graphs[TRAIN:], BATCH, **kw), "cpu"), "l1")
    (name,) = os.listdir(out)
    with open(os.path.join(out, name)) as f:
        events = json.load(f)["traceEvents"]
    spans = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            spans[e["name"]].append((e["tid"], e["ts"], e["ts"] + e["dur"]))
    return spans


def inside(outer, span):
    return [o for o in outer if o[0] == span[0] and o[1] <= span[1]
            and span[2] <= o[2]]


def test_every_span_is_in_the_trace(traced):
    assert set(profiling.SPANS) <= set(traced), \
        sorted(set(profiling.SPANS) - set(traced))


def test_spans_nest_as_the_code_nests_them(traced):
    steps = traced["loop.step"]
    n_batches = -(-TRAIN // BATCH) + -(-EVAL // BATCH)
    assert len(steps) == len(traced["step.forward"]) == n_batches
    assert len(traced["step.backward"]) == len(traced["step.optimizer"]) \
        == -(-TRAIN // BATCH)
    for fwd in traced["step.forward"]:
        assert len(inside(steps, fwd)) == 1
        held = [s for s in traced["model.layer"] if inside([fwd], s)]
        assert len(held) == MODEL["num_layer"]
        assert sum(bool(inside([fwd], s)) for s in traced["model.pool"]) == 1
    for name in ("step.backward", "step.optimizer"):
        assert all(len(inside(steps, s)) == 1 for s in traced[name])
    for s in traced["layer.aggregate"] + traced["layer.mlp"]:
        assert len(inside(traced["model.layer"], s)) == 1
    # layer 0 has one hop: no combine
    assert len(traced["layer.combine"]) == \
        (MODEL["num_layer"] - 1) * n_batches
    for s in traced["loader.build_plan"]:
        assert len(inside(traced["loader.collate"], s)) == 1


def test_collates_and_copies_run_off_the_loop_thread_once_a_batch(traced):
    loop_tid = {t for t, _, _ in traced["loop.step"]}
    assert len(loop_tid) == 1
    n_batches = len(traced["loop.step"])
    for name in ("loader.collate", "prefetch.copy", "loader.build_plan"):
        assert len(traced[name]) == n_batches, name
        assert not loop_tid & {t for t, _, _ in traced[name]}, name
    # each stage hands its batches on in order: the i-th copy ends after
    # the i-th collate, and the i-th step starts after the i-th copy
    collate, copy = (sorted(traced[n], key=lambda s: s[1])
                     for n in ("loader.collate", "prefetch.copy"))
    for c, p, s in zip(collate, copy, sorted(traced["loop.step"],
                                             key=lambda s: s[1])):
        assert c[2] <= p[2] <= s[1]
    waits = [s for s in traced["loop.wait"] if s[0] in loop_tid]
    assert len(waits) >= n_batches


def test_a_profiler_stopped_by_the_batches_leaves_no_span_open(tmp_path):
    """A caller that stops its profiler inside the ``next()`` on the
    batches it hands the loop (as the benchmark's feed does) finds every
    program span ended before its trace ends: none stretches the
    trace."""
    graphs = extract_graphs(raw_molecules(TRAIN, seed=7),
                            KHopConfig(**PREP_SMALL))
    model = init_parameters(make_model(ModelConfig(**MODEL)), 0)
    opt = make_optimizer(model.parameters(), 1e-3, 0.0)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU])
    stream = loop.device_prefetch(GraphLoader(
        graphs, BATCH, shuffle=True, mode="pallas", v1=V1, vk=VK), "cpu")

    def feed():
        for i, b in enumerate(stream):
            if i == 1:
                prof.start()
            elif i == 2:
                prof.stop()
            yield b
    loop.train_epoch(model, opt, feed(), "l1")
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        xs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    (whole,) = [e for e in xs if e.get("cat") == "Trace"]
    spans = [e for e in xs if e.get("cat") == "user_annotation"
             and e["name"] in profiling.SPANS]
    assert {e["name"] for e in spans} >= {"loop.wait", "loop.step",
                                          "step.forward"}
    assert max(e["ts"] + e["dur"] for e in spans) <= \
        whole["ts"] + whole["dur"]
