#!/usr/bin/env python3
"""Benchmark of optconpy_tpu_torch on NVIDIA GPUs: one cell, one run.

    python3 cudabench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's files by name (harness.py), sets the program up (counted
in setup_s, from the start of this process to the window's start), runs
the window for --seconds (with --trace 1, a bounded slice of it under
torch.profiler), then checks what the window produced against the plain
float64 reference, and prints as its last line one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device, with --trace 1 breakdown, and
last the numbers compared beside their limits (also the last lines of
standard error). Exits non-zero without a result when there is no CUDA
card, fewer cards than the cell asks for, or when a JAX module was
loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
for p in (HERE, HERE / "drivers", HERE.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# A library that would load JAX by itself is kept from it; every cache of
# the program stays inside the checkout (its nvcc build is build/).
os.environ.setdefault("USE_FLAX", "0")
os.environ["TRITON_CACHE_DIR"] = str(HERE.parent / "build" / "triton")

import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(cell, dev) -> dict:
    import torch

    if dev.type != "cuda":  # the CPU tests
        return {"platform": "cpu", "kind": "cpu", "count": cell.chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": cell.chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run(cell, seed: int, seconds: float, trace: bool, dev,
        precision: str = "highest", t_start: float | None = None):
    """One run of `cell` on `dev`: set-up, window, check. Returns (result
    dict, checks). precision 'tf32' runs the control (calibrate.py,
    drivers/wake.py program_context)."""
    driver = harness.load_module("drivers", cell.traffic["driver"])
    state = driver.setup(cell, seed, dev, precision)
    setup_s = time.perf_counter() - (T_START if t_start is None else t_start)
    return measure(cell, driver, state, seed, seconds, trace, dev, setup_s)


def measure(cell, driver, state, seed: int, seconds: float, trace: bool,
            dev, setup_s: float):
    """The window, the metrics and the check of a set-up `state`. The CPU
    tests call it with dev = cpu (no timing is read from it)."""
    from optconpy_tpu_torch.ops import conv_kernel, spmm_kernel

    sl = harness.Slice(trace, counters={
        "k1_launches": lambda: conv_kernel.launches,
        "k2_launches": lambda: spmm_kernel.launches,
    })
    rec = driver.window(state, seconds, seed, sl)
    device = device_info(cell, dev)
    e2e = driver.end_to_end(state, rec)
    attempted, failed = driver.counts(state, rec)
    t_check = time.perf_counter()
    numbers = driver.check(state, rec, seed)
    state.timings["check_s"] = time.perf_counter() - t_check
    checks = {k: {"value": v, "limit": cell.limits.get(k)}
              for k, v in numbers.items()}
    correct = failed == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "device": device}
    if trace:
        tr = sl.trace
        ctx = SimpleNamespace(trace=tr, setup=state.timings, cell=cell)
        metrics = {}
        for m in cell.per_layer:
            value = harness.load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["metrics"] = metrics
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        out["breakdown"] = {
            "device_ops": tr.top_ops(10),
            "idle_gaps": sorted(([k, v] for k, v in tr.idle_by_host.items()),
                                key=lambda r: -r[1])[:10],
        }
    else:
        values = dict(e2e, setup_s=setup_s)
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
    diagnostics = getattr(driver, "diagnostics", None)
    out["timings"] = dict(state.timings, setup_s=setup_s,
                          **(diagnostics(rec) if diagnostics else {}))
    return out, checks


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("cudabench: torch.cuda.is_available() is false; this benchmark "
              "needs an NVIDIA GPU and does not fall back to the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"cudabench: {cell.name} asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    out, checks = run(cell, args.seed, args.seconds, bool(args.trace), dev)
    bad = harness.forbidden_modules()
    if bad:
        print(f"cudabench: modules loaded that the port must not use: {bad}",
              file=sys.stderr)
        return 3
    print(f"timings: {out.pop('timings')}", file=sys.stderr)
    for line in harness.check_lines(checks):
        print(line, file=sys.stderr)
    print(harness.result_line(checks=checks, **out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
