"""The benchmark's plumbing: the files of a cell found by name, the window,
the traced slice and its reduction to busy time, idle gaps and launches,
the device's busy time over a whole window, and the result line.

Layout (every name is the one in BENCHMARK.json):
  configs/<config>.json     one configuration: its source and every size;
  traffic/<traffic>.json    one traffic mix: its parameters and the driver
                            (drivers/<driver>.py) that feeds them to the
                            program's entry point;
  workloads/<cell>.json     one cell: configuration, traffic, chips and the
                            limits of the numbers its check compares;
  metrics/<metric>.py       one reader per per-layer metric: read(ctx)
                            returns the value, or None where the cell gives
                            it nothing to read;
  reference/                the plain float64 reference.
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optconpy_tpu")  # top-level names

# Host API calls that launch work on the device (profiler runtime events).
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
    "cuGraphLaunch",
})


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"cudabench: no {kind[:-1]} named {name!r} "
                         f"({path.relative_to(ROOT)})")
    return json.loads(path.read_text())


_MODULES: dict = {}


def load_module(kind: str, name: str):
    """drivers/<name>.py or metrics/<name>.py, loaded once a process."""
    if (kind, name) in _MODULES:
        return _MODULES[kind, name]
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"cudabench: no {kind[:-1]} named {name!r} "
                         f"({path.relative_to(ROOT)})")
    spec = importlib.util.spec_from_file_location(f"cudabench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _MODULES[kind, name] = mod
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell's files, and the metrics BENCHMARK.json gives it: an
    end-to-end metric with no `workloads` key belongs to every cell; a
    per-layer one without it to every cell reporting what it moves."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = load_json("workloads", name)
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(name, load_json("configs", w["config"]),
                load_json("traffic", w["traffic"]), int(w["chips"]),
                dict(w.get("limits", {})), e2e, per_layer)


def mixed_seed(seed: int, *salt: int) -> int:
    """A 63-bit generator seed from the run's seed and a stream index."""
    x = int(seed) & 0xFFFFFFFFFFFFFFFF
    for s in salt:
        x = (x * 6364136223846793005 + 1442695040888963407 + int(s)) \
            & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 29
    return x & 0x7FFFFFFFFFFFFFFF


def p95(values) -> float:
    """The 95th percentile of all samples (linear between order
    statistics, numpy's default)."""
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=float), 95))


# --- the traced slice ----------------------------------------------------

def merge_intervals(spans):
    """Union of (start, end) intervals as a sorted disjoint list."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


SEARCH_BACK = 4096  # host events searched back from a gap's middle


def busy_and_gaps(device_spans, host_spans, lo, hi):
    """Device busy time in [lo, hi] (the union of its operations), and
    each idle gap named by the innermost host operation running at its
    middle. Times in one unit; host_spans are (name, start, end)."""
    merged = merge_intervals(
        (max(s, lo), min(e, hi)) for s, e in device_spans if e > lo and s < hi)
    busy = sum(e - s for s, e in merged)
    gaps, prev = [], lo
    for s, e in merged + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    host = sorted(host_spans, key=lambda h: h[1])
    starts = [h[1] for h in host]
    named = {}
    for g0, g1 in gaps:
        # the innermost host operation running at the gap's middle: the
        # latest-starting one that has not ended by then
        mid, key = 0.5 * (g0 + g1), "host (no traced operation)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - SEARCH_BACK, -1), -1):
            if host[j][2] >= mid:
                key = host[j][0]
                break
        named[key] = named.get(key, 0.0) + (g1 - g0)
    return busy, named


@dataclass
class Trace:
    """What the traced slice leaves for the per-layer readers."""

    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: list = field(default_factory=list)  # (name, start_us, end_us)
    launches: int = 0  # host launch calls (LAUNCH_CALLS)
    idle_by_host: dict = field(default_factory=dict)  # name -> s
    units: dict = field(default_factory=dict)  # work done in the slice
    counters: dict = field(default_factory=dict)  # counter deltas

    def device_seconds(self, match) -> tuple[float, int]:
        """Seconds and count of the device operations whose lower-case
        name `match` accepts."""
        sel = [(e - s) for n, s, e in self.kernels if match(n.lower())]
        return sum(sel) * 1e-6, len(sel)

    def top_ops(self, k=10):
        acc = {}
        for n, s, e in self.kernels:
            acc[n[:120]] = acc.get(n[:120], 0.0) + (e - s) * 1e-6
        return sorted(([n, t] for n, t in acc.items()), key=lambda r: -r[1])[:k]


class Slice:
    """Profiles one bounded slice of the window when tracing is on:
    drivers call begin() and end(**units) around it."""

    def __init__(self, enabled: bool, counters=None):
        self.enabled = enabled
        self.counters = counters or {}
        self._trace: Trace | None = None
        self._prof = self._done = None

    def begin(self) -> None:
        if not self.enabled or self._prof is not None or self._done:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._c0 = {k: f() for k, f in self.counters.items()}
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    @property
    def open(self) -> bool:
        return self._prof is not None

    @property
    def pending(self) -> bool:
        """Tracing is on and the slice has not ended yet."""
        return self.enabled and self._done is None and self._trace is None

    def end(self, **units) -> None:
        if self._prof is None:
            return
        import torch

        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        counters = {k: f() - self._c0[k] for k, f in self.counters.items()}
        self._done = (self._prof, window_s, units, counters)
        self._prof = None

    @property
    def trace(self) -> Trace | None:
        """The slice's reduction, made on first use (after the window)."""
        if self._trace is None and self._done is not None:
            self._trace = reduce_profile(*self._done)
            self._done = None
        return self._trace


class DeviceBusy:
    """The device's busy seconds over a whole window, for an end-to-end
    metric read from the device's trace: a profile of the device's
    operations alone (CUDA activity, no host operations recorded), its
    kernel, copy and set intervals united once the window has closed.
    busy_s stays None where it is not enabled."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.busy_s: float | None = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        import torch

        torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(*exc)
        if exc[0] is None:
            cuda = torch.autograd.DeviceType.CUDA
            spans = [(e.start_ns(), e.end_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == cuda]
            if spans:
                self.busy_s = 1e-9 * sum(e - s
                                         for s, e in merge_intervals(spans))
        return False


def reduce_profile(prof, window_s, units, counters) -> Trace:
    """The slice's raw profiler events (kineto's, read without building
    torch's event tree, which takes minutes for a slice of some 10^5
    launches), in microseconds."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kernels, host, launches = [], [], 0
    for e in prof.profiler.kineto_results.events():
        name, t0, t1 = e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3
        if e.device_type() == cuda:
            kernels.append((name, t0, t1))
        else:
            if name in LAUNCH_CALLS:
                launches += 1
            host.append((name, t0, t1))
    lo = min((s for _, s, _ in host), default=0.0)
    hi = max([e for _, _, e in host] + [e for _, _, e in kernels] + [lo])
    busy_us, idle = busy_and_gaps([(s, e) for _, s, e in kernels],
                                  host, lo, hi)
    return Trace(window_s=window_s, busy_s=busy_us * 1e-6, kernels=kernels,
                 launches=launches,
                 idle_by_host={k: v * 1e-6 for k, v in idle.items()},
                 units=units, counters=counters)


def idle_share(trace: Trace) -> float | None:
    """Percent of the traced window in which no device operation ran."""
    if trace.window_s <= 0 or not trace.kernels:
        return None
    return 100.0 * (1.0 - min(trace.busy_s, trace.window_s) / trace.window_s)


# --- the result ------------------------------------------------------------

def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is jax's, its kin's or the JAX
    package's (compared whole: the port's name only begins with it)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def check_lines(checks: dict) -> list[str]:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in checks.items()]


def result_line(*, correct, attempted, failed, metrics, device, checks,
                breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
