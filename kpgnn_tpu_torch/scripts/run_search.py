"""Grid-search launcher (counterpart of kpgnn_tpu/scripts/run_search.py;
reference: run_*_search.py).

Runs a port script's ``main()`` in-process over the cartesian product of
a flag grid (``--grid``), or over one of the reference's canonical sweep
presets (``--preset``), collecting the returned headline metric per
config.  The scripts run on the card by default; pass ``--base
"--device cpu"`` to run them on the CPU.

    python -m kpgnn_tpu_torch.scripts.run_search --preset sr_search \
        --base "--backend pallas --dataset_dir <dir>"
"""
from __future__ import annotations

import argparse
import itertools
import json
from typing import Dict, List

SCRIPTS = {
    "exp": "kpgnn_tpu_torch.scripts.train_exp",
    "csl": "kpgnn_tpu_torch.scripts.train_csl",
    "sr": "kpgnn_tpu_torch.scripts.train_sr",
    "tu": "kpgnn_tpu_torch.scripts.train_tu",
    "zinc": "kpgnn_tpu_torch.scripts.train_zinc",
    "qm9": "kpgnn_tpu_torch.scripts.train_qm9",
    "counting": "kpgnn_tpu_torch.scripts.train_counting",
    "graph_property": "kpgnn_tpu_torch.scripts.train_graph_property",
    "node_property": "kpgnn_tpu_torch.scripts.train_node_property",
}


def _expressiveness_preset(script: str):
    """run_EXP_search.py / run_CSL_search.py / run_SR_search.py: kernels x
    K in 1..4, KP-GNN wo_path + the K-GNN ablation (no peripheral info)."""
    runs = []
    for kernel, k in itertools.product(("spd", "gd"), (1, 2, 3, 4)):
        base = ["--kernel", kernel, "--K", str(k), "--num_layer", "2",
                "--wo_path_encoding"]
        runs.append((script, base))
        runs.append((script, base + ["--wo_peripheral_edge",
                                     "--wo_peripheral_configuration"]))
    return runs


def _presets() -> Dict[str, List]:
    """Canonical sweeps from the reference's run_* scripts; each entry is
    a list of (script_key, flags)."""
    presets: Dict[str, List] = {}
    # run_TU_search.py:11-23 — each dataset x model over the train_TU
    # --search grid (train_TU.py:378-384)
    presets["tu_search"] = [
        ("tu", ["--dataset_name", ds, "--model_name", m,
                "--kernel", kern, "--K", str(k),
                "--num_layer", str(nl), "--combine", comb,
                # hidden must divide by K; the reference switches 32 -> 33
                # for K=3 (train_TU.py:395-398)
                "--hidden_size", "33" if k == 3 else "32"])
        for ds in ("MUTAG", "DD", "PROTEINS", "PTC", "IMDBBINARY")
        for m in ("KPGCN", "KPGIN", "KPGraphSAGE")
        for kern, k, nl, comb in itertools.product(
            ("spd", "gd"), (2, 3, 4), (2, 3, 4),
            ("geometric", "attention"))
    ]
    # run_qm9_targets.py:10-26 — 12 targets x {KP-GIN+ vnode+rd,
    # KP-GIN' K=16 L=16 residual+rd}
    presets["qm9_targets"] = [
        ("qm9", ["--task", str(t)] + variant)
        for t in range(12)
        for variant in (["--virtual_node", "--use_rd"],
                        ["--model_name", "KPGINPrime", "--num_layer", "16",
                         "--K", "16", "--residual", "--use_rd"])
    ]
    # run_graph_node_property.py:11-43 — tasks x K 3..6 (L=K) x
    # {path, wo_path} x {graph, node}
    presets["graph_node_property"] = [
        (script, ["--task", str(t), "--K", str(k), "--num_layer", str(k)]
         + wo)
        for t in (0, 1, 2)
        for k in (3, 4, 5, 6)
        for wo in ([], ["--wo_path_encoding"])
        for script in ("graph_property", "node_property")
    ]
    # run_structure_counting.py:12-35 — K 1..4 x tasks 0..3 x
    # {KP-GIN' wo_path, K-GIN' fully ablated}
    presets["structure_counting"] = [
        ("counting", ["--task", str(t), "--K", str(k), "--num_layer", "2",
                      "--model_name", "KPGINPrime", "--wo_path_encoding"]
         + ablate)
        for k in (1, 2, 3, 4)
        for t in (0, 1, 2, 3)
        for ablate in ([], ["--wo_peripheral_edge",
                            "--wo_peripheral_configuration"])
    ]
    presets["exp_search"] = _expressiveness_preset("exp")
    presets["csl_search"] = _expressiveness_preset("csl")
    presets["sr_search"] = _expressiveness_preset("sr")
    return presets


def main(argv=None):
    p = argparse.ArgumentParser(description="grid search launcher")
    p.add_argument("script", nargs="?", choices=sorted(SCRIPTS),
                   help="target script (with --grid)")
    p.add_argument("--grid", type=str, default=None,
                   help='JSON dict of flag -> list, e.g. '
                        '\'{"K": [2, 3], "kernel": ["spd", "gd"]}\'')
    p.add_argument("--preset", type=str, default=None,
                   choices=sorted(_presets()),
                   help="reference-canonical sweep (run_*_search.py "
                        "equivalents)")
    p.add_argument("--base", type=str, default="",
                   help="extra flags passed to every run")
    p.add_argument("--limit", type=int, default=None,
                   help="run only the first N configs of the sweep")
    args = p.parse_args(argv)

    import importlib

    if (args.preset is None) == (args.grid is None):
        p.error("pass exactly one of --grid (with a script) or --preset")

    if args.preset is not None:
        runs = _presets()[args.preset]
    else:
        if args.script is None:
            p.error("--grid requires a script")
        grid: Dict[str, List] = json.loads(args.grid)
        keys = sorted(grid)
        runs = []
        for combo in itertools.product(*(grid[k] for k in keys)):
            flags = []
            for k, v in zip(keys, combo):
                flags += [f"--{k}", str(v)]
            runs.append((args.script, flags))
    if args.limit is not None:
        runs = runs[:args.limit]

    results = []
    for script, flags in runs:
        mod = importlib.import_module(SCRIPTS[script])
        all_flags = (args.base.split() if args.base else []) + flags
        print(f"=== run {script} {' '.join(flags)} ===", flush=True)
        metric = mod.main(all_flags)
        results.append({"script": script, "config": flags,
                        "metric": metric})
        print(json.dumps(results[-1]), flush=True)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
