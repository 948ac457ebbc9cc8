"""Run one cell of the port's benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the port (``kpgnn_tpu_torch``).  It finds the cell's configuration,
traffic mix, limits and metric readers by the names ``BENCHMARK.json``
gives, runs the cell on the card (``drive.run``), checks what the timed
path produced against the plain reference, and prints, as its last line
on standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics with ``--trace 0``, the
per-layer ones with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``check``, each compared number beside its
limit; the same comparisons are the last lines on standard error.  It
exits non-zero without a result when no card (or too few) is present,
when the traced run's profile holds no device event, or when the JAX
package or JAX itself was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "kpgnn_tpu")


def loaded_forbidden():
    """Top-level names of loaded modules that the run must not hold,
    compared whole (``kpgnn_tpu_torch`` is not ``kpgnn_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return 1


def execute(cell: dict, cfg: dict, tr: dict, lims: dict, metrics,
            seed: int, seconds: float, trace: bool, device: str, log):
    """Everything of a run after the look for a card: (exit code, the
    result object or None)."""
    from . import drive, manifest

    res = drive.run(cfg, tr, seed, seconds, trace, device, T_START,
                    log=log)
    if res.trace_error:
        log(f"benchmark: {res.trace_error}")
        return 1, None
    found = loaded_forbidden()
    if found:
        log(f"benchmark: modules loaded that the port must not load: "
            f"{found}")
        return 1, None
    rec = res.record
    values = {}
    for m in metrics:
        v = manifest.reader(m["name"])(rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    gps = manifest.reader("graphs_per_s")(rec)
    log(f"graphs_per_s {gps} ({'traced' if trace else 'untraced'} run), "
        f"{rec.steps} steps, window {rec.window_s:.4f} s, setup "
        f"{rec.setup_s:.4f} s, prep {rec.prep_s:.4f} s, nvcc "
        f"{json.dumps(rec.build_s)}")
    for note in res.notes:
        log(f"check: {note}")
    log(f"check: numbers {json.dumps(res.numbers)}")
    ok = all(math.isfinite(res.numbers[k]) and res.numbers[k] <= lim
             for k, lim in lims.items())
    import torch
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": (torch.cuda.get_device_name(0)
                            if device == "cuda" else device),
                   "count": cell["chips"],
                   "memory_peak_bytes": rec.memory_peak}
    out = {"correct": ok, "attempted": rec.steps, "failed": 0,
           "metrics": values, "device": device_info}
    if trace:
        t = rec.trace
        device_info.update(busy_s=t.busy_s, window_s=t.span_s)
        out["breakdown"] = {"device_ops": t.device_ops,
                            "idle_gaps": t.idle_gaps}
    out["check"] = manifest.check_lines(res.numbers, lims)
    for k, lim in lims.items():
        log(f"{k} {float(res.numbers[k])!r} limit {lim!r}")
    return 0, out


def main(argv=None) -> int:
    args = parse(argv)
    from . import manifest

    doc = manifest.load()
    cell = manifest.cell(doc, args.workload)
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{torch.cuda.device_count()} CUDA devices, the cell "
                    f"asks for {cell['chips']}")
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    rc, out = execute(cell, manifest.config(doc, cell["config"]),
                      manifest.traffic(cell["traffic"]),
                      manifest.limits(cell["name"]),
                      manifest.metrics_of(doc, cell["name"],
                                          bool(args.trace)),
                      args.seed, args.seconds, bool(args.trace), "cuda", log)
    if out is not None:
        print(json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
