"""Certify the gains of the bench shape: counterpart of the JAX
package's scripts/validate_gains.py (GAINQ).

The bench's DRE configuration (cylinder wake Re=100, refinement 1,
dt 0.005, alpha 1e-2; 6 DRE steps, 6 shifts, 32 ADI iterations, one
Newton step, rank 32) runs in f32 on the 'inverse' tier and in f64 on
the 'lu' tier, both on the device; the projected generalized-Riccati
residual of every step's f32 factors is measured in f64 on the host
(riccati/validate.py) against RESIDUAL_BOUND, and the f32-vs-f64
deviation of the t=0 gain is reported. Run:

    python -m optconpy_tpu_torch.scripts.validate_gains [--out FILE]
"""
from __future__ import annotations

import torch

from ..models.cylinder import cylinder_setup
from ..riccati import (
    build_dre_cache_dae,
    dre_backward_sweep,
    dre_shift_schedule_dae,
)
from ._common import cli_main, clock, log, projected_residuals

RE, REFINEMENT, DT, ALPHA = 100.0, 1, 0.005, 1e-2
NTS_GAIN, R_MAX, N_SHIFTS, N_ADI, N_NEWTON = 6, 32, 6, 32, 1
RESIDUAL_BOUND = 1e-3  # the certified bound of the shipped f32 gains


def certify(np_ops, zs, ks, alpha: float = ALPHA, dt: float = DT,
            log=log) -> dict:
    """The projected residual of every step's factors of one sweep
    (zs (T+1, n, r), ks (T+1, m, n)), with one Leray projector. Raises
    RuntimeError when the worst is not below RESIDUAL_BOUND. Returns
    projected_residuals' dict with "worst"."""
    rec = projected_residuals(np_ops, zs, ks, range(len(ks) - 1), alpha, dt,
                              log=log)
    rec["worst"] = max(rec["residuals"])
    if not rec["worst"] < RESIDUAL_BOUND:
        raise RuntimeError(f"gains fail the residual bound: {rec['worst']:.3e}"
                           f" (bound {RESIDUAL_BOUND:g})")
    return rec


def run(device, *, ops=None, problem: str | None = None,
        nts_gain: int = NTS_GAIN, n_shifts: int = N_SHIFTS,
        n_adi: int = N_ADI, r_max: int = R_MAX, log=log,
        arrays: dict | None = None) -> dict:
    """The bench-shape certification on `device`; returns the
    reference's GAINQ dict (and, where the reference has none, the
    seconds of each stage). ops: (np_ops, sys, cond) of another setup
    (tests pass a small one, with its `problem` name); arrays, when
    given, receives the f32 and f64 zs and ks and the residuals."""
    stamp = clock(device)
    if ops is None:
        ops = cylinder_setup(re=RE, refinement=REFINEMENT, device=device,
                             dtype=torch.float64)
        problem = f"cylinder_re{int(RE)}_ref{REFINEMENT}"
    np_ops, sys64, _ = ops
    sig, sseq, iseq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], DT, num_shifts=n_shifts,
        n_adi=n_adi,
    )

    def sweep(dtype):
        sysd = sys64.to(dtype=dtype)
        cache = build_dre_cache_dae(
            sysd, DT, sig,
            solver="inverse" if dtype == torch.float32 else "lu",
        )
        return dre_backward_sweep(sysd, cache, ALPHA, DT, nts_gain, sseq,
                                  iseq, n_newton=N_NEWTON, r_max=r_max)

    t0 = stamp()
    zs32, ks32 = sweep(torch.float32)
    t_f32 = stamp() - t0
    log(f"f32 sweep (bench config, inverse tier) {t_f32:.1f}s")
    rec = certify(np_ops, zs32, ks32, log=log)
    log(f"projector built once ({rec['projector_s']:.2f}s): "
        f"{rec['saved_s']:.2f}s of host time saved over {len(ks32) - 1} steps")

    t0 = stamp()
    zs64, ks64 = sweep(torch.float64)
    t_f64 = stamp() - t0
    log(f"f64 sweep (lu tier) {t_f64:.1f}s")
    k0_dev = float((ks32[0].double() - ks64[0]).abs().max()
                   / ks64[0].abs().max())
    log(f"f32 vs f64 gain deviation |dK|/|K| = {k0_dev:.3e}")
    if arrays is not None:
        arrays.update(zs32=zs32, ks32=ks32, zs64=zs64, ks64=ks64,
                      residuals=rec["residuals"])
    return {
        "problem": problem,
        "bench_params": {
            "dt": DT, "alpha": ALPHA, "nts_gain": nts_gain,
            "r_max": r_max, "n_shifts": n_shifts, "n_adi": n_adi,
            "n_newton": N_NEWTON, "dtype": "float32",
        },
        "projected_residuals": [round(r, 8) for r in rec["residuals"]],
        "worst_residual": rec["worst"],
        "residual_bound": RESIDUAL_BOUND,
        "f32_vs_f64_gain_dev": k0_dev,
        "pass": bool(rec["worst"] < RESIDUAL_BOUND),
        "device": str(torch.device(device)),
        "f32_sweep_s": t_f32,
        "f64_sweep_s": t_f64,
        "projector_s": rec["projector_s"],
        "residual_s": rec["residual_s"],
        "projector_saved_s": rec["saved_s"],
    }


def main(argv=None) -> dict:
    return cli_main(run, __doc__.splitlines()[0], argv)


if __name__ == "__main__":
    main()
