"""Time to gains: backward DRE steps through the matrix-free tier
(`riccati.build_dre_cache_dae_matfree`: block-Jacobi and pressure-Schur
FGMRES over the SpMM kernel K2), back to back.

Each step is `riccati.dre_backward_sweep`'s step, driven one at a time so
that whole steps are counted: `riccati.newton_adi_are` warm-started from
the later step's gain, with the constant term M^T Z_next / sqrt(dt). A
sweep of the configuration's `nts` steps restarts from X = 0 with an
alpha drawn from the seed within +-alpha_jitter of the configuration's,
as a user varies the cost between gain computations.

The end-to-end metric is the device's time a step: the device's busy
seconds over the whole window (harness.DeviceBusy, with tracing off),
over the steps completed in it. The host's rate of whole steps, which
the host's speed sets on this launch-bound path, is read in the traced
run over the steps before its slice (krylov.dre_steps_per_s.gains).

Mix keys: alpha_jitter, warmup_steps, check_steps (the most steps the
check follows), slice_steps ([first, end) of the traced slice, in
steps).
"""
from __future__ import annotations

import math
import time

import numpy as np

import harness
import wake

END_TO_END = ("dre_device_ms_per_step",)
_REFERENCE = {}  # one configuration's reference sweep; calibrate.py reuses it


class Gains:
    """The program's objects of the gains cell: the f32 system, the
    shift schedule and the matrix-free shifted-saddle cache."""

    def __init__(self, cfg, mix, dev, precision):
        import torch

        from optconpy_tpu_torch.models.cylinder import cylinder_setup
        from optconpy_tpu_torch.riccati import (
            build_dre_cache_dae_matfree,
            dre_shift_schedule_dae,
        )

        self.cfg, self.mix, self.dev = cfg, mix, dev
        self.ctx = lambda: wake.program_context(precision)
        g = cfg["gains"]
        self.timings = {}
        clock = time.perf_counter
        with self.ctx():
            t = clock()
            np_ops, sys64, _ = cylinder_setup(
                re=cfg["re"], refinement=cfg["refinement"], device=dev,
                dtype=torch.float64)
            self.timings["host_fem_s"] = clock() - t
            self.sys = sys64.to(dtype=torch.float32)
            del sys64
            got = dict(n=self.sys.n, n_p=self.sys.n_p, m=self.sys.m_in,
                       p=self.sys.p_out)
            want = {k: cfg[k] for k in got}
            if got != want:
                raise RuntimeError(f"sizes {got} differ from the "
                                   f"configuration's {want}")
            t = clock()
            interval = cfg.get("assumed", {}).get("shift_interval")
            sig, sseq, iseq = dre_shift_schedule_dae(
                np_ops["A"], np_ops["M"], np_ops["J"], cfg["dt"],
                num_shifts=g["num_shifts"], n_adi=g["n_adi"],
                interval=tuple(interval) if interval else None)
            self.timings["shifts_s"] = clock() - t
            t = clock()
            self.cache = build_dre_cache_dae_matfree(
                self.sys, cfg["dt"], sig, block=g["fgmres_block"],
                m_krylov=g["fgmres_m_krylov"],
                max_cycles=g["fgmres_max_cycles"], tol=g["fgmres_tol"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.timings["matfree_cache_s"] = clock() - t
        self.sig = torch.as_tensor(sseq).to(device=dev, dtype=torch.float32)
        self.idx = [int(i) for i in iseq]

    def alpha(self, seed: int, sweep: int) -> float:
        u = np.random.default_rng(harness.mixed_seed(seed, 101, sweep)).random()
        return self.cfg["alpha"] * (1.0 + self.mix["alpha_jitter"]
                                    * (2.0 * u - 1.0))

    def start(self, alpha: float) -> None:
        import torch

        n, m = self.sys.b.shape
        r = self.cfg["gains"]["r_max"]
        self.z = torch.zeros((n, r), dtype=torch.float32, device=self.dev)
        self.k = torch.zeros((m, n), dtype=torch.float32, device=self.dev)
        self.alpha_now = alpha

    def step(self):
        """One backward DRE step; returns its gain K (m, n)."""
        import torch

        from optconpy_tpu_torch.riccati import newton_adi_are

        g = self.cfg["gains"]
        w_extra = self.sys.mass.matmat(self.z) * (1.0 / math.sqrt(self.cfg["dt"]))
        self.z, self.k = newton_adi_are(
            self.sys, self.cache, self.alpha_now, self.sig, self.idx,
            n_newton=g["n_newton"], out_rank=g["r_max"], k0=self.k,
            w_extra=w_extra, compress_rtol=g["compress_rtol"])
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return self.k

    def release(self) -> None:
        import torch

        self.sys = self.cache = self.z = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def setup(cell, seed: int, dev, precision: str = "highest"):
    state = Gains(cell.config, cell.traffic, dev, precision)
    with state.ctx():
        state.start(state.alpha(seed, -1))
        for _ in range(cell.traffic["warmup_steps"]):
            state.step()
    return state


def window(state, seconds: float, seed: int, sl) -> dict:
    import torch

    nts = state.cfg["gains"]["nts"]
    first, end = state.mix["slice_steps"]
    gains, alphas, stamps = [], [], []
    busy = harness.DeviceBusy(not sl.enabled and state.dev.type == "cuda")
    with state.ctx(), busy:
        if state.dev.type == "cuda":
            torch.cuda.synchronize(state.dev)
        t0 = time.perf_counter()
        while True:
            i = len(gains)
            if i % nts == 0:
                alphas.append(state.alpha(seed, i // nts))
                state.start(alphas[-1])
            if i == first:
                sl.begin()
            gains.append(state.step().clone())
            stamps.append(time.perf_counter() - t0)
            if i + 1 == end:
                sl.end(steps=end - first,
                       adi_iters=(end - first) * state.cfg["gains"]["n_newton"]
                       * len(state.idx),
                       steps_before=first,
                       seconds_before=stamps[first - 1] if first else 0.0)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and not sl.pending:
                break
    return {"gains": gains, "alphas": alphas, "elapsed": elapsed,
            "stamps": stamps, "device_busy_s": busy.busy_s,
            "fgmres": state.cache.stats.as_dict()}


def diagnostics(rec) -> dict:
    """Each step's end (s into the window), the host's rate of whole
    steps over the window, the device's busy seconds and the FGMRES
    record."""
    return {"step_ends_s": [round(t, 3) for t in rec["stamps"]],
            "host_dre_steps_per_s": len(rec["gains"]) / rec["elapsed"],
            "device_busy_s": rec["device_busy_s"],
            "fgmres": rec["fgmres"]}


def end_to_end(state, rec) -> dict:
    """The device's busy milliseconds over the window's whole steps
    (None where the device was not profiled: tracing on, or no card)."""
    busy = rec["device_busy_s"]
    return {"dre_device_ms_per_step":
            None if busy is None else 1e3 * busy / len(rec["gains"])}


def counts(state, rec) -> tuple[int, int]:
    """DRE steps attempted, and those whose gain is not finite."""
    import torch

    return len(rec["gains"]), sum(
        not bool(torch.isfinite(k).all()) for k in rec["gains"])


def check(state, rec, seed: int) -> dict:
    """The gain of every step the window completed, up to the mix's
    check_steps (a sound window completes fewer), each against the
    reference's step of the same sweep (same alpha), by the worst step."""
    from reference import plain

    cfg, g = state.cfg, state.cfg["gains"]
    nts = g["nts"]
    gains = rec["gains"]
    state.release()
    key = (repr(cfg), str(state.dev))
    if key not in _REFERENCE:
        _REFERENCE.clear()
        prob = plain.Problem(cfg["re"], cfg["refinement"], state.dev)
        sched = plain.shift_schedule(
            prob, cfg["dt"], g["num_shifts"], g["n_adi"],
            cfg.get("assumed", {}).get("shift_interval"))
        _REFERENCE[key] = plain.DRESweep(
            prob, cfg["alpha"], cfg["dt"], *sched, g["n_newton"],
            g["r_max"], g["compress_rtol"])
    sweep = _REFERENCE[key]
    worst = 0.0
    for i, k in enumerate(gains[:state.mix["check_steps"]]):
        if i % nts == 0:
            sweep.restart(rec["alphas"][i // nts])
        worst = max(worst, plain.rel_dev(k, sweep.step()))
    return {"gain": worst}
