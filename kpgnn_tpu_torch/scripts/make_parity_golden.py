"""Activation-parity bundles written by the port (counterpart of
kpgnn_tpu/scripts/make_parity_golden.py), in the JAX package's bundle
format, so that the JAX package can read them.

Each bundle is one .npz holding (a) the tiny RAW graph of ``tiny_graph``
(edge list, bond codes, atom codes: each framework runs its own k-hop
prep on it), (b) the port's initialized parameters under the flax names
(``utils.convert.params_to_flax``: ``params/...``, ``batch_stats/...``),
and (c) every module's output on that graph in the JAX capture's layout
(``utils.parity.capture_activations(..., jax_layout=True)``) under
``act/``, with ``act/__output__`` (the real graph's row) and
``act/__node_mask__``.  The model is built from ``SEED`` on the CPU
(``nn.inits.init_parameters``) and then moved, so its weights do not
depend on the device; the batch is the COO collation with the JAX
script's pads.  ``replay_bundle`` rebuilds a bundle from its ``meta`` and
asserts that every array reproduces.

One difference of form: the JAX bundles also hold the captures of flax's
``FeatureConcatEncoder`` children (``.../peripheral_edge_embedding/
emb0..1`` and ``proj``, ``.../peripheral_configuration_embedding/
emb0..3`` and ``proj``: ``FLAX_ONLY``), which flax calls on dummy input
only to create their parameters.  The port folds the tables into one
matrix and calls no such module, so its bundles lack those keys; every
other key and shape is the JAX bundle's.

    python -m kpgnn_tpu_torch.scripts.make_parity_golden --all
    python -m kpgnn_tpu_torch.scripts.make_parity_golden --all \\
        --device cpu --out_dir /tmp/golden_cpu

``--device`` defaults to cuda (without CUDA it raises unless ``--device
cpu`` is given); the default ``--out_dir`` is
``kpgnn_tpu_torch/data/parity_golden`` (git-ignored: bundles are made,
not committed).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..graph.batch import collate
from ..models.factory import ModelConfig, make_model
from ..nn.inits import init_parameters
from ..prep.khop import KHopConfig, extract_khop
from ..train.loop import resolve_device
from ..utils.convert import embedding_modules, params_to_flax
from ..utils.parity import capture_activations
from .common import set_full_f32

SEED = 0

# shared vocab/shape arguments both sides rebuild exactly
BASE_ARGS = dict(
    hidden_size=16, num_layer=2, K=2,
    num_hop1_edge=3, max_pe_num=10, max_edge_type=2, max_edge_count=10,
    max_hop_num=3, max_distance_count=10, JK="last", combine="geometric",
    residual=False, norm_type="Batch", pooling_method="sum",
    output_size=2, input_size=21, kernel="spd", max_edge_attr_num=10,
    virtual_node=False, use_rd=False, aggr="add", num_l1_layer=1,
)

CONFIGS = {
    # the KPGIN spd baseline
    "kpgin_spd": dict(model_name="KPGIN"),
    # degree norm + analytic self-loop
    "kpgcn": dict(model_name="KPGCN"),
    # union-denominator mean + L2 normalize
    "kpsage": dict(model_name="KPGraphSAGE", aggr="mean"),
    # sliding window, tanh peripheral gate, attention combine, virtual
    # node, JK concat
    "kpginplus": dict(model_name="KPGINPlus", num_layer=3,
                      combine="attention", JK="concat", residual=True,
                      virtual_node=True),
    # GINE upper stack
    "kpginprime": dict(model_name="KPGINPrime", num_layer=3,
                       num_l1_layer=1),
    # graph-diffusion kernel: hop multiplicity, no SPD masking
    "kpgin_gd": dict(model_name="KPGIN", kernel="gd", K=3,
                     hidden_size=18),
    # attention combine + JK attention + virtual node + resistance
    # distance
    "kpgin_attn": dict(model_name="KPGIN", combine="attention",
                       JK="attention", virtual_node=True, use_rd=True),
}

# captures of the JAX bundles that the port has no module call for
FLAX_ONLY = tuple(
    f"act/embedding_model/peripheral/{table}/{child}/__call__"
    for table, children in (
        ("peripheral_edge_embedding", ("emb0", "emb1", "proj")),
        ("peripheral_configuration_embedding",
         ("emb0", "emb1", "emb2", "emb3", "proj")))
    for child in children)


def tiny_graph(seed: int = 7, input_size: int = 21):
    """Two fused rings + a tail: small, asymmetric, every hop populated."""
    rng = np.random.default_rng(seed)
    n = 11
    und = [(i, (i + 1) % 6) for i in range(6)]            # 6-ring
    und += [(5, 6), (6, 7), (7, 8), (8, 3)]               # fused 5-ring
    und += [(0, 9), (9, 10)]                              # tail
    e = np.array(und + [(v, u) for u, v in und]).T
    half = len(und)
    t = rng.integers(2, 5, size=half)                     # bond codes 2..4
    ea = np.concatenate([t, t])
    x = rng.integers(0, input_size, size=(n, 1))
    return n, e.astype(np.int64), ea.astype(np.int64), x.astype(np.int64)


def build_bundle(a: dict, device="cpu") -> dict:
    """All arrays of one bundle for a fully-resolved arg dict, computed on
    ``device``."""
    device = torch.device(device)
    kcfg = KHopConfig(K=a["K"], kernel=a["kernel"],
                      max_edge_attr_num=a["max_edge_attr_num"],
                      max_hop_num=a["max_hop_num"],
                      max_edge_type=a["max_edge_type"],
                      max_edge_count=a["max_edge_count"],
                      max_distance_count=a["max_distance_count"],
                      use_rd=a["use_rd"])
    n, ei, ea, x = tiny_graph(input_size=a["input_size"])
    g = extract_khop(n, ei, ea, kcfg, x=x, y=np.array([0], dtype=np.int64))
    batch = collate([g], n_pad=n + 1, e_pad=g.num_edges + 8, g_pad=2)

    mcfg = ModelConfig(
        model_name=a["model_name"], hidden_size=a["hidden_size"],
        num_layer=a["num_layer"], K=a["K"], kernel=a["kernel"],
        num_hop1_edge=a["num_hop1_edge"], max_pe_num=a["max_pe_num"],
        max_edge_type=a["max_edge_type"], max_edge_count=a["max_edge_count"],
        max_hop_num=a["max_hop_num"],
        max_distance_count=a["max_distance_count"], JK=a["JK"],
        combine=a["combine"], residual=a["residual"], aggr=a["aggr"],
        virtual_node=a["virtual_node"], use_rd=a["use_rd"],
        num_l1_layer=a["num_l1_layer"],
        input_encoder=("embedding", a["input_size"]),
        task="graph_classification", output_size=a["output_size"],
        pooling_method=a["pooling_method"], norm_type=a["norm_type"])
    model = init_parameters(make_model(mcfg), SEED).to(device).eval()
    batch = batch.to(device)

    out = {"meta": np.frombuffer(json.dumps(a).encode(), dtype=np.uint8)}
    out["raw/n"] = np.array([n])
    out["raw/edge_index"] = ei
    out["raw/edge_attr"] = ea
    out["raw/x"] = x
    out.update(params_to_flax(model.state_dict(), embedding_modules(model)))
    for k, v in capture_activations(model, batch, jax_layout=True).items():
        out["act/" + k] = v
    with torch.no_grad():
        pred = model(batch, train=False)
    out["act/__output__"] = pred.float().cpu().numpy()[:1]
    out["act/__node_mask__"] = batch.node_mask.cpu().numpy()
    return out


def replay_bundle(path: str, atol: float = 1e-6, device="cpu") -> float:
    """Rebuild a bundle from its meta on ``device`` (same seed, same raw
    graph) and assert that every array reproduces: integer arrays
    exactly, floating ones within ``atol``.  Returns the largest
    floating difference."""
    g = np.load(path)
    a = json.loads(bytes(g["meta"]).decode())
    out = build_bundle(a, device)
    assert set(out) == set(g.files), sorted(set(out) ^ set(g.files))
    worst = 0.0
    for k in g.files:
        if k == "meta":
            continue
        ours, theirs = out[k], g[k]
        assert ours.shape == theirs.shape, (k, ours.shape, theirs.shape)
        if np.issubdtype(theirs.dtype, np.floating):
            d = float(np.abs(ours - theirs).max()) if theirs.size else 0.0
            worst = max(worst, d)
        else:
            assert np.array_equal(ours, theirs), k
    if worst > atol:
        raise AssertionError(f"{path}: replay drifted by {worst:.3e}")
    return worst


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="parity_golden.npz",
                   help="single-bundle output path (config via --config)")
    p.add_argument("--config", default="kpgin_spd",
                   choices=sorted(CONFIGS))
    p.add_argument("--all", action="store_true",
                   help="write every config to --out_dir/<name>.npz")
    p.add_argument("--out_dir", default="kpgnn_tpu_torch/data/parity_golden")
    p.add_argument("--device", default="cuda",
                   help="torch device; without CUDA the run raises unless "
                        "--device cpu is given")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    set_full_f32()

    names = sorted(CONFIGS) if args.all else [args.config]
    written = []
    for name in names:
        a = dict(BASE_ARGS, **CONFIGS[name])
        out = build_bundle(a, device)
        path = (os.path.join(args.out_dir, f"{name}.npz") if args.all
                else args.out)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(path, **out)
        print(f"wrote {path}: {len(out)} arrays "
              f"({sum(v.size for v in out.values())} elements)")
        written.append(path)
    return written if args.all else written[0]


if __name__ == "__main__":
    main()
