"""Readings for the limits of ``correct``: the program's numbers over
many seeds, and the control's, in one process.

    python3 -m benchmark.control --workload <cell> --program <seeds...> \\
        --control <seeds...> [--half_batch <seeds...>] [--seconds 2]

The program's readings are whole runs of the cell (``drive.run``) with a
short window: training compares its first steps, which set-up takes, and
scoring compares every step of the window; ``--half_batch`` seeds read
the program with a planted fault (half the batch left out of the loss).
The control is the reference put in the program's place and computed in
the next precision below the configuration's, f32 with TF32 matmuls,
against the reference in full f32, on the same inputs at the cell's own
sizes (the traffic kind's ``control``).  Prints one JSON line per
reading.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import drive, manifest


def control_numbers(cfg: dict, tr: dict, seed: int, device):
    """The control's numbers for one seed."""
    return manifest.kind(tr).control(cfg, tr, seed, device)


def plant_half_batch() -> None:
    """A fault in the program, for its readings: the loss's mean taken
    over the first half of the batch's real graphs."""
    from kpgnn_tpu_torch.train import loop
    real = loop._masked_loss

    def masked_loss(pred, y, mask, loss):
        keep = mask & (torch.cumsum(mask.long(), 0) <= mask.sum() // 2)
        return real(pred, y, keep, loss)
    loop._masked_loss = masked_loss


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--half_batch", type=int, nargs="*", default=[],
                   help="seeds of program readings with half the batch "
                        "left out of the loss (a planted fault)")
    args = p.parse_args(argv)
    doc = manifest.load()
    cell = manifest.cell(doc, args.workload)
    cfg = manifest.config(doc, cell["config"])
    tr = manifest.traffic(cell["traffic"])
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    for seed in args.program:
        res = drive.run(cfg, tr, seed, args.seconds, False, "cuda",
                        time.perf_counter(), log=log)
        print(json.dumps({"cell": cell["name"], "side": "program",
                          "seed": seed, **res.numbers,
                          "note": res.notes}), flush=True)
    if args.half_batch:
        plant_half_batch()
    for seed in args.half_batch:
        res = drive.run(cfg, tr, seed, args.seconds, False, "cuda",
                        time.perf_counter(), log=log)
        print(json.dumps({"cell": cell["name"], "side": "half_batch",
                          "seed": seed, **res.numbers}), flush=True)
    for seed in args.control:
        nums = control_numbers(cfg, tr, seed, torch.device("cuda"))
        print(json.dumps({"cell": cell["name"], "side": "control",
                          "seed": seed, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
