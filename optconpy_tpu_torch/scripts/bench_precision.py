"""Matmul precision tiers on the bench-shape fused rollout: counterpart
of the JAX package's scripts/bench_precision.py.

The bench's closed loop (cylinder wake Re=100, refinement 1, 1024
scenarios x 64 steps, dt 0.005, alpha 1e-2; the t=0 gain of a 4-step DRE
sweep at 6 shifts, 16 ADI iterations and rank 32, broadcast over every
step, no feedforward) runs through the fused stepper, which launches the
convection kernel and the SpMM kernel once a step, under each tier of
utils/runtime.py::matmul_precision: 'highest' (strict FP32), 'high'
(TF32) and 'default' (bf16-rounded operands with FP32 accumulation,
the numerics of a 1-pass bf16 GEMM, emulated by strict FP32 GEMMs). The
convection and SpMM kernels compute in FP32 under every tier. Each tier's
outputs are compared with the 'highest' run and with an f64 run of the
same recurrence on the host (4 scenarios), and its solves/s is the min
of 3 warm synchronized runs; the 'default' tier is not timed, since its
GEMMs do not run in bf16. The horizon curve compares every tier with
the f64 recurrence on 2 scenarios at 64, 200 and 500 steps (the
prefixes of one 500-step run: the gain is constant and there is no
feedforward, so a shorter horizon is the same steps). Run:

    python -m optconpy_tpu_torch.scripts.bench_precision [--out FILE]
"""
from __future__ import annotations

import numpy as np
import torch

from ..fem.device_conv import ConvKernel, FusedConvKernel
from ..models.cylinder import cylinder_setup
from ..mpc.nse_rollout import batched_nse_closed_loop, build_nse_fused
from ..riccati import (
    build_dre_cache_dae,
    dre_backward_sweep,
    dre_shift_schedule_dae,
)
from ..utils.runtime import TIERS, matmul_precision
from ._common import cli_main, clock, log

RE, REFINEMENT, S_BATCH, NTS, DT, ALPHA = 100.0, 1, 1024, 64, 0.005, 1e-2
NTS_GAIN, R_MAX, N_SHIFTS, N_ADI = 4, 32, 6, 16
S_REF = 4  # scenarios of the f64 check of the tier table
S_H = 2  # scenarios of the horizon curve
HORIZONS = (64, 200, 500)
SEED = 0
TIMED_TIERS = ("highest", "high")  # tiers whose GEMMs run as named


def f64_recurrence(fused64, conv64, k0, c, v0, nts: int) -> torch.Tensor:
    """ys (S, nts+1, p) of the fused explicit-feedback recurrence in f64,
    written out from the step's operators (pmat, gmat, inv_vv, c0, vbar)
    and the plain convection conv64 (ConvKernel, f64): the independent
    reference of the rollout. v0 (S, n), k0 (m, n), c (p, n)."""
    v = v0
    ys = [v @ c.T]
    for _ in range(nts):
        u = -(v - fused64.vbar) @ k0.T
        v = (v @ fused64.pmat.T + u @ fused64.gmat.T
             - conv64.conv_inner_batch_t(v.T).T @ fused64.inv_vv.T
             + fused64.c0)
        ys.append(v @ c.T)
    return torch.stack(ys, dim=1)


def _rel(a: torch.Tensor, b: torch.Tensor, scale=None) -> float:
    scale = b.abs().max() if scale is None else scale
    return float((a - b).abs().max() / scale)


def run(device, *, ops=None, problem: str | None = None,
        s_batch: int = S_BATCH, nts: int = NTS, horizons=HORIZONS,
        s_ref: int = S_REF, s_h: int = S_H, log=log,
        arrays: dict | None = None) -> dict:
    """The tier table and the horizon curve on `device`; returns the
    reference's PRECISION dict under its keys (every tier in the curve),
    with what each tier's GEMMs and the convection ran as, and the
    seconds of each stage. ops: (np_ops, sys, cond) of another setup
    with np_ops["vbar_full"] (tests pass a small one, with its `problem`
    name); arrays, when given, receives k0, v0, the f64 outputs and each
    tier's ys."""
    device = torch.device(device)
    stamp = clock(device)
    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    t0 = stamp()
    if ops is None:
        ops = cylinder_setup(re=RE, refinement=REFINEMENT, device=device,
                             dtype=f64)
        problem = f"cylinder_re{int(RE)}_ref{REFINEMENT}"
    np_ops, sys64, cond = ops
    sys = sys64.to(dtype=f32)
    conv = FusedConvKernel.build(np_ops["full"], cond, device=device)
    n, m = sys.b.shape
    t_setup = stamp() - t0
    log(f"setup {t_setup:.1f}s: n={n}")

    t0 = stamp()
    sig, sseq, iseq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], DT, num_shifts=N_SHIFTS,
        n_adi=N_ADI,
    )
    _, ks_gain = dre_backward_sweep(
        sys, build_dre_cache_dae(sys, DT, sig), ALPHA, DT, NTS_GAIN, sseq,
        iseq, n_newton=1, r_max=R_MAX,
    )
    k0 = ks_gain[0]
    t_gain = stamp() - t0
    t0 = stamp()
    fused64 = build_nse_fused(np_ops, cond, DT, device=cpu, dtype=f64)
    fused = fused64.to(device, f32)
    t_build = stamp() - t0
    rng = np.random.default_rng(SEED)
    v0 = torch.as_tensor(
        fused64.vbar.numpy()[None] + 1e-3 * rng.standard_normal((s_batch, n)),
        dtype=f32,
    ).to(device)
    log(f"gain (DRE, lu tier) {t_gain:.1f}s, fused step build {t_build:.1f}s")

    # The f64 recurrence on the host from the same (f32) initial states.
    t0 = stamp()
    conv64 = ConvKernel.build(np_ops["full"], cond, device=cpu, dtype=f64)
    k0_64, c64, v0_64 = k0.to(cpu, f64), sys64.c.to(cpu), v0.to(cpu, f64)
    h_max = max(horizons)
    ys_ref = f64_recurrence(fused64, conv64, k0_64, c64, v0_64[:s_ref], nts)
    ys_ref_h = f64_recurrence(fused64, conv64, k0_64, c64, v0_64[:s_h],
                              h_max)
    t_ref = stamp() - t0
    y_scale = ys_ref.abs().max()
    log(f"f64 references ({s_ref} x {nts}, {s_h} x {h_max}) {t_ref:.1f}s")

    def rollout(v, steps):
        return batched_nse_closed_loop(
            sys, conv, fused, k0.expand(steps + 1, m, n),
            torch.zeros((steps + 1, n), dtype=f32, device=device), v,
            ALPHA, DT,
        )[2]

    tiers, curve, ys_highest, tier_ys = {}, {str(h): {} for h in horizons}, \
        None, {}
    for tier in ("highest", "high", "default"):
        timed = tier in TIMED_TIERS
        with matmul_precision(tier):
            tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
            ys = rollout(v0, nts)
            times = []
            for _ in range(3 if timed else 0):
                t0 = stamp()
                rollout(v0, nts)
                times.append(stamp() - t0)
            ys_h = rollout(v0[:s_h], h_max)
        ys = ys.to(cpu, f64)
        ys_h = ys_h.to(cpu, f64)
        tier_ys[tier] = ys
        if ys_highest is None:
            ys_highest = ys
        t_roll = min(times) if times else None
        tiers[tier] = {
            "solves_per_s": s_batch * nts / t_roll if timed else None,
            "rollout_s": t_roll,
            "rel_dev_vs_highest": _rel(ys, ys_highest, y_scale),
            "rel_dev_vs_f64": _rel(ys[:s_ref], ys_ref, y_scale),
            "finite": bool(torch.isfinite(ys).all()),
            "gemm": TIERS[tier],
            "tf32": tf32,
            "timed": timed,
        }
        rec = tiers[tier]
        log(f"{tier:8s}: "
            + (f"{rec['solves_per_s']:9.0f} solves/s" if timed
               else "not timed (emulated)")
            + f"  dev_vs_highest {rec['rel_dev_vs_highest']:.2e}  dev_vs_f64 "
              f"{rec['rel_dev_vs_f64']:.2e}  ({rec['gemm']})")
        for h in horizons:
            part = ys_h[:, :h + 1]
            curve[str(h)][tier] = {
                "rel_dev_vs_f64": _rel(part, ys_ref_h[:, :h + 1]),
                "finite": bool(torch.isfinite(part).all()),
            }
            log(f"horizon {h:4d} ({tier:7s}): dev_vs_f64 "
                f"{curve[str(h)][tier]['rel_dev_vs_f64']:.2e}")
    if arrays is not None:
        arrays.update(k0=k0, v0=v0, ys_ref=ys_ref, ys_ref_h=ys_ref_h,
                      ys=tier_ys)
    return {
        "experiment": "rollout_matmul_precision",
        "problem": problem,
        "n_state": int(n),
        "scenarios": s_batch,
        "horizon_steps": nts,
        "f64_ref_scenarios": s_ref,
        "tiers": tiers,
        "high_tier_horizon_curve": curve,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "horizon_scenarios": s_h,
        "convection": ("conv_p2 (CUDA C++, FP32) under every tier"
                       if device.type == "cuda"
                       else "plain torch FP32 (conv_inner_batch_plain)"),
        "setup_s": t_setup,
        "gain_s": t_gain,
        "step_build_s": t_build,
        "f64_reference_s": t_ref,
    }


def main(argv=None) -> dict:
    return cli_main(run, __doc__.splitlines()[0], argv)


if __name__ == "__main__":
    main()
