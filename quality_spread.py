#!/usr/bin/env python
"""Quality spreads of the JAX package and the PyTorch port, one flag set
per task, the same on both sides but ``--device``.

One invocation trains one seed of one task on one side and appends a JSON
line (the final metric, the epoch curve read from the run's log, seconds)
to ``<out>/results.jsonl``; ``summarize`` reads such files and prints
each (task:task_id and cuts, side, device, backend) group's mean and std over
seeds, and per task d = (port mean - JAX CPU mean) against
se = sqrt(s_jax^2/n_jax + s_port^2/n_port), pass when |d| <= 2se (2se is
the smallest gap that could show), and, where the seed draws the split
(QM9), d and se paired by seed.  A seed may appear once in each group,
and a group's rows, and a port group against its JAX group, must share
their flags (the argv less the per-run options: seed, directories,
device, backend, load path).

Flags (the same on both sides; ``--task_id`` is the script's ``--task``,
0 by default; ``--num_epochs``, ``--n_graphs`` and ``--data_scale`` cut
a task's scale, on both sides alike, and become part of its flags):
  zinc: the flagship script's defaults (KPGINPlus K=8 L=8 h=104, JK
        concat, geometric combine, no residual, batch 64) with
        --num_epochs 80 --runs 1 --seed S, on
        ``tools/make_zinc_fixture.py --out <dir>/ZINC`` (2000/300/300,
        seed 11); runs r = 0..2 of ``--runs 3 --seed 234`` are the
        invocations at --seed 234, 235, 236.
  qm9:  ``--virtual_node --use_rd --num_epochs 60 --task I --seed S`` on
        ``tools/make_qm9_fixture.py --out <dir> --n 640 --seed 7``.
  qm9_prime: the QM9 sweep's second config (QM9_SWEEP_r05.jsonl line 2),
        ``--model_name KPGINPrime --K 16 --num_layer 16 --residual
        --use_rd --num_epochs 60 --task I --seed S``, on the same fixture.
  counting, graph_property, node_property: the scripts' defaults (their
        data generated from the script's fixed seed 1234) with ``--runs 1
        --task I --seed S``: counting KPGINPlus K=3 L=3 h=96 on 5000
        graphs, 250 epochs, ``--ystd train``; the property tasks
        KPGINPlus K=6 L=6 (h=96 graph, 128 node), 250 epochs.
  counting_prime: the JAX package's counting record, "canonical KPGIN'
        K=4 L=2" on 5000 graphs (COMPONENTS.md), pinned to its own
        preset (kpgnn_tpu/scripts/run_search.py, ``structure_counting``):
        ``--model_name KPGINPrime --K 4 --num_layer 2 --wo_path_encoding
        --runs 1 --task I --seed S``.

    # the JAX package on the CPU (f32)
    JAX_PLATFORMS=cpu python quality_spread.py run --side jax --task zinc \\
        --seed 234 --backend dense --data <zinc dir> --out <out>
    # the port on the CPU, or on the card (--device cuda)
    python quality_spread.py run --side port --task zinc --seed 234 \\
        --backend dense --device cpu --data <zinc dir> --out <out>
    # a generated task, cut to 100 epochs
    python quality_spread.py run --side port --task node_property \\
        --task_id 1 --num_epochs 100 --seed 234 --backend pallas \\
        --device cuda --out <out>
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
QM9_FLAGS = ["--virtual_node", "--use_rd", "--num_epochs", "60"]
# QM9_SWEEP_r05.jsonl line 2's config: the kernel at its 16-hop limit
QM9_PRIME_FLAGS = ["--model_name", "KPGINPrime", "--K", "16",
                   "--num_layer", "16", "--residual", "--use_rd",
                   "--num_epochs", "60"]
# the JAX package's "canonical KPGIN' K=4 L=2" counting record
# (kpgnn_tpu/scripts/run_search.py's structure_counting preset)
COUNTING_PRIME_FLAGS = ["--model_name", "KPGINPrime", "--K", "4",
                        "--num_layer", "2", "--wo_path_encoding",
                        "--runs", "1"]
# task: (script module, its flags, whether it reads --data, whether the
# seed draws the split)
TASKS = {
    "zinc": ("train_zinc", ZINC_FLAGS, True, False),
    "qm9": ("train_qm9", QM9_FLAGS, True, True),
    "qm9_prime": ("train_qm9", QM9_PRIME_FLAGS, True, True),
    "counting": ("train_counting", ["--runs", "1"], False, False),
    "counting_prime": ("train_counting", COUNTING_PRIME_FLAGS, False,
                       False),
    "graph_property": ("train_graph_property", ["--runs", "1"], False,
                       False),
    "node_property": ("train_node_property", ["--runs", "1"], False,
                      False),
}
# cuts of scale, applied the same on both sides
CUTS = ("num_epochs", "n_graphs", "data_scale")
# per-run options, left out when two groups' flags are compared
PER_RUN = ("--seed", "--dataset_dir", "--cache_dir", "--save_dir",
           "--device", "--backend", "--load_path")
ROW = re.compile(r"epoch=(\d+) (.*)")
FIELD = re.compile(r"(\w+)=([-0-9.eE+na]+)")


def script_argv(a) -> list:
    _, flags, reads_data, _ = TASKS[a.task]
    argv = list(flags)
    if a.task != "zinc":
        argv += ["--task", str(a.task_id)]
    for cut in CUTS:
        value = getattr(a, cut, None)
        if value is not None:
            if f"--{cut}" in argv:
                del argv[argv.index(f"--{cut}"):argv.index(f"--{cut}") + 2]
            argv += [f"--{cut}", str(value)]
    data = a.data or os.path.join(a.out, "data")
    argv += ["--seed", str(a.seed), "--dataset_dir", data,
             "--cache_dir", os.path.join(a.out, "cache", a.side),
             "--save_dir", os.path.join(a.out, "save", a.side, a.task,
                                        str(a.task_id),
                                        f"{a.device}_{a.backend}",
                                        str(a.seed)),
             "--backend", a.backend]
    if a.side == "port":
        argv += ["--device", a.device]
    if a.load_path:
        argv += ["--load_path", a.load_path]
    return argv


def flag_set(argv) -> tuple:
    """``argv`` less its per-run options: what two sides must share."""
    out, skip = [], False
    for x in argv:
        if skip:
            skip = False
        elif x in PER_RUN:
            skip = True
        else:
            out.append(x)
    return tuple(out)


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


def metric_name(task: str) -> str:
    return "log10_mse" if task.endswith("property") else "mae"


def run(a) -> dict:
    import importlib
    module = TASKS[a.task][0]
    if a.side == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        a.device = "cpu"
        main = importlib.import_module(f"kpgnn_tpu.scripts.{module}").main
    else:
        main = importlib.import_module(
            f"kpgnn_tpu_torch.scripts.{module}").main
    argv = script_argv(a)
    t0 = time.time()
    metric = main(argv)
    seconds = time.time() - t0
    save_dir = argv[argv.index("--save_dir") + 1]
    rec = {"task": a.task, "task_id": a.task_id, "side": a.side,
           "device": a.device, "backend": a.backend, "seed": a.seed,
           "metric": metric, "metric_name": metric_name(a.task),
           "seconds": seconds, "argv": argv,
           "load_path": a.load_path, "epochs": epoch_rows(save_dir)}
    if a.device == "cuda":
        import subprocess
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "results.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps({k: rec[k] for k in
                      ("task", "task_id", "side", "device", "backend",
                       "seed", "metric", "seconds")}))
    return rec


def init(a) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tests.test_torch_script_twin import write_jax_init
    a.side, a.device, a.backend, a.load_path = "jax", "cpu", "dense", None
    argv = script_argv(a)
    paths = write_jax_init(os.path.join(a.out, "init"),
                           TASKS[a.task][0][len("train_"):], argv,
                           seed=a.seed)
    print("\n".join(paths))


def mean_std(xs):
    """Mean and sample std (n - 1; 0 for one value)."""
    n = len(xs)
    m = sum(xs) / n
    s = math.sqrt(sum((x - m) ** 2 for x in xs) / (n - 1)) if n > 1 else 0.0
    return m, s


def value(r) -> float:
    """A row's metric (PR 13's rows call it ``test_mae``)."""
    return r["metric"] if "metric" in r else r["test_mae"]


def label(r) -> str:
    """The task a row belongs to: its name and, where the row names one,
    the script's ``--task`` and the cuts it ran at past its task's own
    flags (``CUTS``)."""
    if "task_id" not in r:
        return r["task"]
    argv, own = r.get("argv", []), TASKS.get(r["task"], (None, []))[1]
    cuts = ""
    for c in CUTS:
        flag = f"--{c}"
        if flag in argv[:-1]:
            v = argv[argv.index(flag) + 1]
            if flag not in own or own[own.index(flag) + 1] != v:
                cuts += f" {c}={v}"
    return f"{r['task']}:{r['task_id']}{cuts}"


def read_results(paths) -> dict:
    """The rows of each ``.jsonl`` path (a directory: every ``*.jsonl`` in
    it), grouped by (task, side, device, backend) and keyed by seed; the
    carried-start rows left out.  A seed that appears twice in a group
    (a rerun, or two runs' files meeting) is refused, and so is a group
    whose rows ran on other flags than each other."""
    groups, where, flags = {}, {}, {}
    for p in paths:
        files = ([p] if p.endswith(".jsonl")
                 else sorted(glob.glob(os.path.join(p, "*.jsonl"))))
        for f in files:
            with open(f) as fh:
                for n, line in enumerate(fh, 1):
                    r = json.loads(line)
                    if r.get("load_path"):
                        continue
                    key = (label(r), r["side"], r["device"], r["backend"])
                    seen = groups.setdefault(key, {})
                    if r["seed"] in seen:
                        raise SystemExit(
                            f"seed {r['seed']} of {'/'.join(key)} twice: "
                            f"{where[key, r['seed']]} and {f}:{n}")
                    fs = flag_set(r.get("argv", []))
                    if flags.setdefault(key, fs) != fs:
                        raise SystemExit(
                            f"{'/'.join(key)}: {f}:{n} ran {fs}, "
                            f"{where[key, next(iter(seen))]} "
                            f"{flags[key]}")
                    seen[r["seed"]] = r
                    where[key, r["seed"]] = f"{f}:{n}"
    return {k: [v[s] for s in sorted(v)] for k, v in groups.items()}


def summarize(paths) -> dict:
    """Each group's mean and std, and per task each port group against
    the JAX CPU group: d, se, 2se (the smallest gap the seeds could
    show), whether |d| <= 2se, and, where the seed draws the split, d
    and se paired by seed.  A port group on other flags than the JAX
    group's is refused."""
    groups = read_results(paths)
    out = {}
    for key, rs in sorted(groups.items()):
        vals = [value(r) for r in rs]
        m, s = mean_std(vals)
        secs = [r["seconds"] for r in rs]
        out["/".join(key)] = {
            "seeds": [r["seed"] for r in rs], "values": vals, "mean": m,
            "std": s, "seconds_per_run": sum(secs) / len(secs),
            "metric": rs[0].get("metric_name", "mae")}
        print(f"{'/'.join(key):40s} n={len(vals)} seeds="
              f"{[r['seed'] for r in rs]} mean={m!r} std={s!r} "
              f"s/run={sum(secs) / len(secs):.1f}")
    for task in sorted({k[0] for k in groups}):
        jax_key = next((k for k in groups if k[0] == task
                        and k[1] == "jax"), None)
        if jax_key is None:
            continue
        jrows = groups[jax_key]
        mj, sj = mean_std([value(r) for r in jrows])
        nj = len(jrows)
        for key in sorted(k for k in groups if k[0] == task
                          and k[1] == "port"):
            prows = groups[key]
            jf = flag_set(jrows[0].get("argv", []))
            pf = flag_set(prows[0].get("argv", []))
            if jf != pf:
                raise SystemExit(f"{'/'.join(key)} ran {pf}, "
                                 f"{'/'.join(jax_key)} {jf}")
            vals = [value(r) for r in prows]
            mp, sp = mean_std(vals)
            se = math.sqrt(sj ** 2 / nj + sp ** 2 / len(vals))
            d = mp - mj
            row = {"d": d, "se": se, "smallest_seen": 2 * se,
                   "pass": abs(d) <= 2 * se}
            # paired by seed where the seed draws the split on both
            # sides (QM9): a seed's difference drops the split's variance
            base = task.split(":")[0]
            jax_by_seed = {r["seed"]: value(r) for r in jrows}
            diffs = [value(r) - jax_by_seed[r["seed"]]
                     for r in prows if r["seed"] in jax_by_seed]
            if len(diffs) > 1 and TASKS.get(base, (0, 0, 0, True))[3]:
                pd, ps = mean_std(diffs)
                row.update(paired_n=len(diffs), paired_d=pd,
                           paired_se=ps / math.sqrt(len(diffs)))
            out[f"{task}/d/{key[2]}/{key[3]}"] = row
            print(f"{task}: port {key[2]}/{key[3]} - jax cpu: d={d!r} "
                  f"se={se!r} |d|/se={abs(d) / se if se else math.inf:.2f}"
                  f" {'pass' if row['pass'] else 'FAIL'} |d| <= 2se"
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
    i = sub.add_parser("init")
    for q in (r, i):
        q.add_argument("--task", choices=tuple(TASKS), required=True)
        q.add_argument("--task_id", type=int, default=0,
                       help="the script's --task (not for zinc)")
        q.add_argument("--seed", type=int, default=234)
        q.add_argument("--data", default=None,
                       help="dataset dir: the one holding ZINC/ or QM9/ "
                            "(zinc and qm9 only)")
        q.add_argument("--out", required=True)
        q.add_argument("--num_epochs", type=int, default=None)
        q.add_argument("--n_graphs", type=int, default=None,
                       help="counting only")
        q.add_argument("--data_scale", type=float, default=None,
                       help="graph and node property only")
    r.add_argument("--backend", default="dense",
                   choices=("dense", "pallas", "coo"))
    r.add_argument("--device", default="cuda")
    r.add_argument("--load_path", default=None)
    s = sub.add_parser("summarize")
    s.add_argument("paths", nargs="+")
    a = p.parse_args(argv)
    if a.cmd in ("run", "init") and TASKS[a.task][2] and not a.data:
        p.error(f"--task {a.task} needs --data")
    if a.cmd == "run":
        run(a)
    elif a.cmd == "init":
        init(a)
    else:
        summarize(a.paths)


if __name__ == "__main__":
    sys.exit(main())
