"""Structured metrics: a JSONL stream of timed stages and results.

Counterpart of optconpy_tpu/utils/metrics.py. Torch returns before the
card finishes, so both timers synchronize every CUDA device in use
before they read the clock; otherwise a stage time would be the time to
enqueue its kernels.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from pathlib import Path

import torch


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class MetricsLogger:
    """Append-only JSONL metrics stream with a wall-clock column."""

    def __init__(self, path: str | Path | None = None):
        self.path = Path(path) if path else None
        self._t0 = time.time()
        self.records: list[dict] = []
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, event: str, **fields) -> dict:
        rec = {"event": event, "wall_s": round(time.time() - self._t0, 4)}
        rec.update(fields)
        self.records.append(rec)
        if self.path:
            with self.path.open("a") as f:
                f.write(json.dumps(rec, default=float) + "\n")
        return rec

    @contextmanager
    def timed(self, event: str, **fields):
        """Log the elapsed wall time of a block, device work included."""
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        self.log(event, seconds=time.perf_counter() - t0, **fields)


def device_timeit(fn, *args, repeats: int = 3, warmup: int = 1) -> float:
    """Best-of-N wall seconds of fn(*args), device work included."""
    for _ in range(warmup):
        fn(*args)
    best = float("inf")
    for _ in range(repeats):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best
