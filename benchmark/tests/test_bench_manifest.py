"""BENCHMARK.json and the files it names."""
import copy
import os

import pytest

from benchmark import manifest

DOC = manifest.load()


def test_manifest_is_clean():
    assert manifest.problems(DOC) == []


def test_every_name_has_its_files():
    for c in DOC["configs"]:
        path = os.path.join(manifest.ROOT, c["file"])
        assert os.path.exists(path)
        assert manifest.config(DOC, c["name"])["reduced"] == c["reduced"]
    for w in DOC["workloads"]:
        manifest.traffic(w["traffic"])
        assert manifest.limits(w["name"])
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_every_cell_reports_the_required_metrics():
    e2e = [m["name"] for m in DOC["end_to_end"]]
    assert "setup_s" in e2e
    for w in DOC["workloads"]:
        names = [m["name"] for m in manifest.metrics_of(DOC, w["name"],
                                                        False)]
        assert "setup_s" in names and len(names) >= 2
        assert manifest.metrics_of(DOC, w["name"], True)


@pytest.mark.parametrize("edit,expect", [
    (lambda d: d["workloads"][0].update(name="bad name"), "bad name"),
    (lambda d: d["end_to_end"][0].update(unit="graphs per s"), "bad unit"),
    (lambda d: d["end_to_end"][0].update(unit="x" * 17), "bad unit"),
    (lambda d: d["per_layer"][0].update(moves="nothing"), "moves"),
    (lambda d: d["end_to_end"][0].update(workloads=["zinc_train_coo"]),
     "does not report"),
    (lambda d: d["per_layer"][0].update(name="prep,seconds"), "bad name"),
])
def test_problems_are_found(edit, expect):
    d = copy.deepcopy(DOC)
    edit(d)
    assert any(expect in p for p in manifest.problems(d))


def test_every_mix_names_a_kind():
    for w in DOC["workloads"]:
        k = manifest.kind(manifest.traffic(w["traffic"]))
        assert callable(k.window) and callable(k.check) \
            and callable(k.control) and k.PROFILE_STEPS > 0


def test_model_flags_are_the_programs():
    import dataclasses

    from kpgnn_tpu_torch.models.factory import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    for c in DOC["configs"]:
        assert set(manifest.config(DOC, c["name"])["model"]) <= fields
