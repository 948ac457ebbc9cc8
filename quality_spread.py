#!/usr/bin/env python
"""Quality spreads of the flagship (ZINC) and QM9 task 0, for the JAX
package and the PyTorch port, on one set of flags per task.

One invocation trains one seed of one task on one side and appends a JSON
line (final test MAE, the epoch curve read from the run's log, seconds)
to ``<out>/results.jsonl``; ``summarize`` reads such files and prints
each (task, side, device, backend) group's mean and std over seeds, and
per task d = (port mean - JAX CPU mean) against
se = sqrt(s_jax^2/n_jax + s_port^2/n_port), the smallest gap that could
show (2se), and d and se paired by seed (the seed picks the shuffle
order, and QM9's split, on both sides).  A seed may appear once in each group.

Flags (the same on both sides):
  zinc: the flagship script's defaults (KPGINPlus K=8 L=8 h=104, JK
        concat, geometric combine, no residual, batch 64) with
        --num_epochs 80 --runs 1 --seed S, on
        ``tools/make_zinc_fixture.py --out <dir>/ZINC`` (2000/300/300,
        seed 11); runs r = 0..2 of ``--runs 3 --seed 234`` are the
        invocations at --seed 234, 235, 236.
  qm9:  ``--virtual_node --use_rd --num_epochs 60 --task 0 --seed S`` on
        ``tools/make_qm9_fixture.py --out <dir> --n 640 --seed 7``.

    # the JAX package on the CPU (f32)
    JAX_PLATFORMS=cpu python quality_spread.py run --side jax --task zinc \\
        --seed 234 --backend dense --data <zinc dir> --out <out>
    # the port on the CPU, or on the card (--device cuda)
    python quality_spread.py run --side port --task zinc --seed 234 \\
        --backend dense --device cpu --data <zinc dir> --out <out>
    python quality_spread.py summarize <out> [<out> ...]

``init`` writes the JAX package's run-0 init of a task's model at a seed
as a JAX and a port checkpoint (``tests/test_torch_script_twin.
write_jax_init``); ``run --load_path`` starts a run from one (the
carried-start run: the port at the JAX seed-234 init beside the JAX
seed-234 run):

    JAX_PLATFORMS=cpu python quality_spread.py init --task zinc \\
        --seed 234 --data <zinc dir> --out <out>
    python quality_spread.py run --side port --task zinc --seed 234 \\
        --backend dense --device cpu --data <zinc dir> --out <out> \\
        --load_path <out>/init/jax_init_zinc_234.pt

Only the JAX side and ``init`` import JAX, inside the function.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import sys
import time

ZINC_FLAGS = ["--num_epochs", "80", "--runs", "1"]
QM9_FLAGS = ["--virtual_node", "--use_rd", "--num_epochs", "60",
             "--task", "0"]
ROW = re.compile(r"epoch=(\d+) (.*)")
FIELD = re.compile(r"(\w+)=([-0-9.eE+na]+)")


def script_argv(a) -> list:
    argv = list(ZINC_FLAGS if a.task == "zinc" else QM9_FLAGS)
    argv += ["--seed", str(a.seed), "--dataset_dir", a.data,
             "--cache_dir", os.path.join(a.out, "cache", a.side),
             "--save_dir", os.path.join(a.out, "save", a.side, a.task,
                                        f"{a.device}_{a.backend}",
                                        str(a.seed)),
             "--backend", a.backend]
    if a.side == "port":
        argv += ["--device", a.device]
    if a.load_path:
        argv += ["--load_path", a.load_path]
    return argv


def epoch_rows(save_dir: str) -> list:
    """The per-epoch rows of the run's ``log.txt`` (both packages log
    ``epoch=N k=v ...``)."""
    rows = []
    for path in sorted(glob.glob(os.path.join(save_dir, "train", "*",
                                              "log.txt"))):
        with open(path) as f:
            for line in f:
                m = ROW.search(line)
                if m:
                    row = {"epoch": int(m.group(1))}
                    row.update({k: float(v) for k, v in
                                FIELD.findall(m.group(2))})
                    rows.append(row)
    return rows


def run(a) -> dict:
    if a.side == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        if a.task == "zinc":
            from kpgnn_tpu.scripts.train_zinc import main
        else:
            from kpgnn_tpu.scripts.train_qm9 import main
        device = "cpu"
    else:
        if a.task == "zinc":
            from kpgnn_tpu_torch.scripts.train_zinc import main
        else:
            from kpgnn_tpu_torch.scripts.train_qm9 import main
        device = a.device
    argv = script_argv(a)
    t0 = time.time()
    mae = main(argv)
    seconds = time.time() - t0
    save_dir = argv[argv.index("--save_dir") + 1]
    rec = {"task": a.task, "side": a.side, "device": device,
           "backend": a.backend, "seed": a.seed, "test_mae": mae,
           "seconds": seconds, "argv": argv,
           "load_path": a.load_path, "epochs": epoch_rows(save_dir)}
    if device == "cuda":
        import subprocess
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "results.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps({k: rec[k] for k in
                      ("task", "side", "device", "backend", "seed",
                       "test_mae", "seconds")}))
    return rec


def init(a) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tests.test_torch_script_twin import write_jax_init
    flags = ZINC_FLAGS if a.task == "zinc" else QM9_FLAGS
    paths = write_jax_init(os.path.join(a.out, "init"), a.task,
                           flags + ["--dataset_dir", a.data], seed=a.seed)
    print("\n".join(paths))


def mean_std(xs):
    """Mean and sample std (n - 1; 0 for one value)."""
    n = len(xs)
    m = sum(xs) / n
    s = math.sqrt(sum((x - m) ** 2 for x in xs) / (n - 1)) if n > 1 else 0.0
    return m, s


def read_results(paths) -> dict:
    """The rows of each ``.jsonl`` path (a directory: every ``*.jsonl`` in
    it), grouped by (task, side, device, backend) and keyed by seed; the
    carried-start rows left out.  A seed that appears twice in a group
    (a rerun, or two runs' files meeting) is refused."""
    groups, where = {}, {}
    for p in paths:
        files = ([p] if p.endswith(".jsonl")
                 else sorted(glob.glob(os.path.join(p, "*.jsonl"))))
        for f in files:
            with open(f) as fh:
                for n, line in enumerate(fh, 1):
                    r = json.loads(line)
                    if r.get("load_path"):
                        continue
                    key = (r["task"], r["side"], r["device"], r["backend"])
                    seen = groups.setdefault(key, {})
                    if r["seed"] in seen:
                        raise SystemExit(
                            f"seed {r['seed']} of {'/'.join(key)} twice: "
                            f"{where[key, r['seed']]} and {f}:{n}")
                    seen[r["seed"]] = r
                    where[key, r["seed"]] = f"{f}:{n}"
    return {k: [v[s] for s in sorted(v)] for k, v in groups.items()}


def summarize(paths) -> dict:
    groups = read_results(paths)
    out = {}
    for key, rs in sorted(groups.items()):
        maes = [r["test_mae"] for r in rs]
        m, s = mean_std(maes)
        secs = [r["seconds"] for r in rs]
        out["/".join(key)] = {
            "seeds": [r["seed"] for r in rs], "maes": maes, "mean": m,
            "std": s, "seconds_per_run": sum(secs) / len(secs)}
        print(f"{'/'.join(key):32s} n={len(maes)} seeds="
              f"{[r['seed'] for r in rs]} mean={m!r} std={s!r} "
              f"s/run={sum(secs) / len(secs):.1f}")
    for task in sorted({k[0] for k in groups}):
        jax_key = next((k for k in groups if k[0] == task
                        and k[1] == "jax"), None)
        if jax_key is None:
            continue
        mj, sj = mean_std([r["test_mae"] for r in groups[jax_key]])
        nj = len(groups[jax_key])
        for key in sorted(k for k in groups if k[0] == task
                          and k[1] == "port"):
            maes = [r["test_mae"] for r in groups[key]]
            mp, sp = mean_std(maes)
            se = math.sqrt(sj ** 2 / nj + sp ** 2 / len(maes))
            d = mp - mj
            row = {"d": d, "se": se, "smallest_seen": 2 * se}
            # paired by seed: the seed picks the shuffle order (and
            # QM9's split) on both sides, so a seed's difference drops
            # the split's variance
            jax_by_seed = {r["seed"]: r["test_mae"] for r in groups[jax_key]}
            diffs = [r["test_mae"] - jax_by_seed[r["seed"]]
                     for r in groups[key] if r["seed"] in jax_by_seed]
            if len(diffs) > 1:
                pd, ps = mean_std(diffs)
                row.update(paired_n=len(diffs), paired_d=pd,
                           paired_se=ps / math.sqrt(len(diffs)))
            out[f"{task}/d/{key[2]}/{key[3]}"] = row
            print(f"{task}: port {key[2]}/{key[3]} - jax cpu: d={d!r} "
                  f"se={se!r} |d|/se={abs(d) / se if se else math.inf:.2f}"
                  f" (a gap under 2se={2 * se!r} cannot be seen)"
                  + (f"; paired over {row['paired_n']} seeds: "
                     f"d={row['paired_d']!r} se={row['paired_se']!r}"
                     if "paired_d" in row else ""))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--side", choices=("jax", "port"), required=True)
    r.add_argument("--task", choices=("zinc", "qm9"), required=True)
    r.add_argument("--seed", type=int, default=234)
    r.add_argument("--backend", default="dense",
                   choices=("dense", "pallas"))
    r.add_argument("--device", default="cuda")
    r.add_argument("--data", required=True,
                   help="dataset dir: the one holding ZINC/ or QM9/")
    r.add_argument("--out", required=True)
    r.add_argument("--load_path", default=None)
    i = sub.add_parser("init")
    i.add_argument("--task", choices=("zinc", "qm9"), required=True)
    i.add_argument("--seed", type=int, default=234)
    i.add_argument("--data", required=True)
    i.add_argument("--out", required=True)
    s = sub.add_parser("summarize")
    s.add_argument("paths", nargs="+")
    a = p.parse_args(argv)
    if a.cmd == "run":
        run(a)
    elif a.cmd == "init":
        init(a)
    else:
        summarize(a.paths)


if __name__ == "__main__":
    sys.exit(main())
