"""A run loads neither JAX nor the JAX package (top-level names compared
whole), and the reference loads nothing of the port."""
import json
import subprocess
import sys

from benchmark import manifest

RUN = r"""
import json, sys
sys.path.insert(0, {root!r})
from benchmark.tests import tiny
from benchmark import run
import benchmark.control, benchmark.compare, benchmark.counts.bounds
for w in tiny.DOC["workloads"]:
    __import__("benchmark.manifest").manifest.kind(
        __import__("benchmark.manifest").manifest.traffic(w["traffic"]))
for m in tiny.DOC["end_to_end"] + tiny.DOC["per_layer"]:
    __import__("benchmark.manifest").manifest.reader(m["name"])
c, cfg, tr, lims, mets = tiny.cell("zinc_score_kernel")
rc, out = run.execute(c, cfg, tr, lims, mets, tiny.SEED, 0.3, False, "cpu",
                      lambda s: None)
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""

REF = r"""
import json, sys
sys.path.insert(0, {root!r})
from benchmark import molecules
from benchmark.reference import common, for_model, prep
from benchmark.weights import make_weights
import benchmark.compare
cfg = {root!r} + "/benchmark/configs/qm9_kpginplus_k8l8h128.json"
m = json.load(open(cfg))["model"]
m.update(hidden_size=8, num_layer=2, K=2)
model = for_model(m["model_name"])
mols = molecules.generate("qm9", 4, 1)
pc = prep.PrepConfig(K=2, max_pe=50, max_hop=5, max_edge_type=4,
                     max_edge_count=20, max_distance_count=15, use_rd=True)
b = common.make_batch(mols, [prep.prep(x, pc) for x in mols], "cpu")
model.forward(make_weights(model.param_spec(m), 1, "cpu"), b, m, False)
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _tops(code):
    out = subprocess.run([sys.executable, "-c",
                          code.format(root=manifest.ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    tops = _tops(RUN)
    assert "kpgnn_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "kpgnn_tpu"}


def test_reference_loads_nothing_of_the_port():
    tops = _tops(REF)
    assert not tops & {"jax", "jaxlib", "flax", "kpgnn_tpu",
                       "kpgnn_tpu_torch"}
