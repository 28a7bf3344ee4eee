#!/usr/bin/env python3
"""The spread of a cell's end-to-end metrics, as the bounds are set from
it (not run by the benchmark's own runs).

    python3 cudabench/spread.py --workload <cell> --seeds S1,...,S6 \
        [--sets 2] [--trace-seeds T1,T2,T3] [--seconds 30] [--out PATH]

Runs `run.py` once per seed in each of --sets sets (each run a process of
its own, the same seeds in every set), then once per trace seed with
--trace 1. For each metric and set it prints the values, the median and
the spread: the distance between the first and third quartiles of
statistics.quantiles(values, n=4), as a share of the median. Every run's
last line is kept in --out.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def one(cell: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", cell,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], capture_output=True, text=True, cwd=HERE.parent)
    lines = proc.stdout.strip().splitlines()
    try:
        out = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        out = {"error": proc.stderr[-2000:]}
    out.update(seed=seed, trace=trace, rc=proc.returncode,
               wall_s=time.perf_counter() - t0,
               stderr_tail=proc.stderr[-1500:])
    return out


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = []
    for k in range(args.sets):
        for seed in seeds:
            runs.append(dict(one(args.workload, seed, args.seconds, 0),
                             set=k))
            r = runs[-1]
            print(json.dumps({key: r.get(key) for key in (
                "set", "seed", "rc", "correct", "metrics", "checks",
                "wall_s")}), flush=True)
    for seed in filter(None, args.trace_seeds.split(",")):
        runs.append(one(args.workload, int(seed), args.seconds, 1))
        r = runs[-1]
        print(json.dumps({key: r.get(key) for key in (
            "seed", "rc", "correct", "metrics", "device", "checks",
            "wall_s")}), flush=True)
    summary = {}
    for k in range(args.sets):
        vals = {}
        for r in runs:
            if r.get("set") == k and r.get("trace") == 0 and "metrics" in r:
                for name, m in r["metrics"].items():
                    vals.setdefault(name, []).append(m["value"])
        summary[f"set{k}"] = {
            name: {"values": v, "median": statistics.median(v),
                   "spread": spread(v) if len(v) >= 2 else None}
            for name, v in vals.items()}
    summary["correct"] = [r.get("correct") for r in runs]
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": runs,
                                              "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
