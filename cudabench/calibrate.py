#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from (not run by
the benchmark's own runs).

    python3 cudabench/calibrate.py --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 3 [--first-seed N] [--out PATH]

Runs the cell --seeds times with the program as the configuration states
(strict FP32) and --control-seeds times with the control: the program
with TF32 numerics on every float32 matrix product, the nearest
precision below 'float32, TF32 off' (drivers/wake.py program_context). Each run is a whole run of run.py
(set-up, a window of --seconds, the check) on another seed, in this one
process. Prints and writes every number compared, and per number the
largest sound reading and the smallest control reading.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE, HERE / "drivers", HERE.parent):
    sys.path.insert(0, str(p))

import harness  # noqa: E402
import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    rows = []
    plan = [("program", "highest")] * args.seeds + \
        [("control", "tf32")] * args.control_seeds
    for i, (side, precision) in enumerate(plan):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        try:
            out, checks = run.run(cell, seed, args.seconds, False, dev,
                                  precision=precision, t_start=t0)
            numbers = {k: c["value"] for k, c in checks.items()}
            err = None
        except Exception as exc:  # a control that crashes has failed
            numbers, out, err = {}, {}, f"{type(exc).__name__}: {exc}"
        row = {"side": side, "seed": seed, "numbers": numbers, "error": err,
               "metrics": out.get("metrics"), "failed": out.get("failed"),
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for side, pick in (("program", max), ("control", min)):
        vals = [r["numbers"] for r in rows if r["side"] == side and r["numbers"]]
        summary[side] = ({k: pick(v[k] for v in vals) for k in vals[0]}
                         if vals else {})
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
