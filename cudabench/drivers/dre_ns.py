"""Time to gains on config 3's headline tier: backward DRE steps through
the dense shifted-saddle inverse stack, built on the card by Newton-Schulz
ladders (`riccati.build_dre_cache_dae_ns`) and applied as one GEMM a
solve (`solvers.saddle.SaddleShiftedInverseCache`), back to back.

Set-up, as a user of the port runs the tier (each stage on the harness
clock): `models.cylinder.cylinder_setup` (host FEM, steady state),
`riccati.dre_shift_schedule_dae` over the configuration's assumed
interval, `build_dre_cache_dae_ns(sys32, dt, sig, certify_tol)` with its
float64 certification (ns_build_s; the device synchronized at its end),
and the mix's warm-up steps. The stack is built once.

Each step is `riccati.dre_backward_sweep`'s step, driven one at a time as
drivers/dre_matfree.py drives it (its Gains.step: `newton_adi_are` warm-
started from the later step's gain, with the constant term
M^T Z_next / sqrt(dt)); a sweep of `nts` steps restarts from X = 0 with
an alpha drawn from the seed within +-alpha_jitter of the
configuration's. The end-to-end metric is the same as the matrix-free
cell's: the device's busy seconds over the whole untraced window
(harness.DeviceBusy) over the steps completed.

The control (precision 'tf32', calibrate.py) runs the window's products
in TF32 (drivers/wake.py program_context) and builds the stack as the
configuration states, certified: under TF32 the Newton-Schulz passes
cannot bring the float64 probe to 5e-4, and a stack that does not
certify is not the configuration's tier.

The check is drivers/dre_matfree.py's: every step the window completed,
up to check_steps, against reference/plain.py's DRESweep at the
configuration's own 8-shift schedule (float64, a dense LU and SMW a
shifted saddle) at the same alphas, by the worst step's gain. The one
departure it measures: the program applies Newton-Schulz inverses,
certified only to a probed residual (5e-4, in float64), in float32,
where the reference factors each saddle exactly. At refinement 2 the
reference's 8 LUs hold 8 x 17,396^2 float64 (19.4 GB), so the check
frees the program's stack first.

Set-up records the build (ns_build: its Newton-Schulz passes, the shifts
stored, ladder rungs, shifts certified and the worst float64 residual,
from the info build_dre_cache_dae_ns returns) beside the stage times.

Mix keys: alpha_jitter, warmup_steps, check_steps, slice_steps ([first,
end) of the traced slice, in steps).
"""
from __future__ import annotations

import time

import harness
import wake

matfree = harness.load_module("drivers", "dre_matfree")

END_TO_END = matfree.END_TO_END
end_to_end = matfree.end_to_end
counts = matfree.counts
check = matfree.check


class NSGains(matfree.Gains):
    """The program's objects of the dense-inverse gains cell: the f32
    system, the shift schedule and the Newton-Schulz inverse stack."""

    def __init__(self, cfg, mix, dev, precision):
        import torch

        from optconpy_tpu_torch.models.cylinder import cylinder_setup
        from optconpy_tpu_torch.riccati import (
            build_dre_cache_dae_ns,
            dre_shift_schedule_dae,
        )

        self.cfg, self.mix, self.dev = cfg, mix, dev
        self.ctx = lambda: wake.program_context(precision)
        g = cfg["gains"]
        self.timings = {}
        clock = time.perf_counter
        with wake.program_context("highest"):  # the control: window only
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
            self.cache, info = build_dre_cache_dae_ns(
                self.sys, cfg["dt"], sig, certify_tol=g["certify_tol"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.timings["ns_build_s"] = clock() - t
        self.timings["ns_build"] = {
            "ns_passes": info["ns_passes"],
            "shifts": len(info["residuals"]),
            "ladder_rungs": info["ladder_rungs"],
            "certified": sum(bool(c) for c in info["certified"]),
            "worst_residual": max(info["residuals"]),
        }
        self.sig = torch.as_tensor(sseq).to(device=dev, dtype=torch.float32)
        self.idx = [int(i) for i in iseq]


def setup(cell, seed: int, dev, precision: str = "highest"):
    state = NSGains(cell.config, cell.traffic, dev, precision)
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
                       * len(state.idx))
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and not sl.pending:
                break
    return {"gains": gains, "alphas": alphas, "elapsed": elapsed,
            "stamps": stamps, "device_busy_s": busy.busy_s}


def diagnostics(rec) -> dict:
    """Each step's end (s into the window), the host's rate of whole
    steps over the window and the device's busy seconds."""
    return {"step_ends_s": [round(t, 3) for t in rec["stamps"]],
            "host_dre_steps_per_s": len(rec["gains"]) / rec["elapsed"],
            "device_busy_s": rec["device_busy_s"]}

