"""Config 3XL: the refinement-3 cylinder wake (n=31,282, n_p=4,145)
through the matrix-free tier, f32, on one device.

Counterpart of the JAX package's scripts/config3xl_cylinder.py: no
O((n + n_p)^2) object anywhere. It builds the block-Jacobi and
pressure-Schur FGMRES cache at 8 shifts, probes one solve a shift,
runs a first and a warm DRE sweep (4 steps x 16 ADI iterations, rank
40), measures the CPU splu baseline of one shifted saddle, and checks,
each raising: |J Z|/|Z| < 1e-4, finite gains, the projected DRE residual
< 1e-2 at steps 0 and 2 (host f64), and a finite closed loop of 8
scenarios x 20 steps (implicit feedback, matrix-free stepper, the
convection kernel every step).

The FGMRES tolerance is set by feasibility: |J Z|/|Z| follows the inner
tolerance about 1:1 at this size, so tol = FEASIBILITY_BOUND / 2. Run:

    python -m optconpy_tpu_torch.scripts.config3xl_cylinder [--out FILE]
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..fem.device_conv import FusedConvKernel
from ..models.cylinder import cylinder_setup
from ..mpc import batched_nse_closed_loop, build_nse_stepper_matfree
from ..riccati import (
    build_dre_cache_dae_matfree,
    dre_backward_sweep,
    dre_shift_schedule_dae,
)
from ._common import (
    cli_main,
    clock,
    log,
    projected_residuals,
    stats_since,
)
from .config3_cylinder import feasibility, rollout_v0

RE = 60.0
REFINEMENT = 3
DT = 0.01
NTS_GAIN = 4
NTS_ROLL = 20
ALPHA = 1e-4
R_MAX = 40
N_SHIFTS = 8
N_ADI = 16
S_BATCH = 8
FEASIBILITY_BOUND = 1e-4
FGMRES_TOL = FEASIBILITY_BOUND / 2.0  # 5e-5: feasibility-bound
DRE_CYCLES, ROLL_CYCLES = 8, 10
RESIDUAL_BOUND = 1e-2
PROBE_COLS = 4


def cpu_splu_baseline(np_ops: dict, sig, *, q_cols: int, adi_iters: int,
                      dt: float = DT, log=log) -> dict:
    """The reference architecture at this n: one scipy splu of the first
    shifted saddle and 3 solves on q_cols columns; the ADI rate with
    len(sig) such factors amortized over adi_iters iterations of one
    solve each."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    m_sp = np_ops["M"].tocsr()
    at_til = (np_ops["A"].T - m_sp / (2.0 * dt)).tocsr()
    j_sp = np_ops["J"].tocsr()
    n, n_p = m_sp.shape[0], j_sp.shape[0]
    loadavg = round(os.getloadavg()[0], 2)
    t0 = time.perf_counter()
    lu = spla.splu(sp.bmat([[at_til + sig[0] * m_sp, j_sp.T], [j_sp, None]],
                           format="csc"))
    t_factor = time.perf_counter() - t0
    lu_nnz = int(lu.L.nnz + lu.U.nnz)
    log(f"cpu splu ONE shifted saddle at n+np={n + n_p}: {t_factor:.1f}s, "
        f"L+U nnz {lu_nnz / 1e6:.1f}M (~{lu_nnz * 16 / 2**30:.2f} GiB)")
    v = np.random.default_rng(2).standard_normal((n, q_cols))
    zeros_p = np.zeros((n_p, q_cols))
    n_solves = 3
    t0 = time.perf_counter()
    for _ in range(n_solves):
        v = lu.solve(np.concatenate([v, zeros_p]))[:n]
        v /= max(np.abs(v).max(), 1e-30)
    t_solve = (time.perf_counter() - t0) / n_solves
    rate = adi_iters / (len(sig) * t_factor + adi_iters * t_solve)
    log(f"cpu ADI baseline at ref3: {t_solve * 1e3:.0f} ms/solve, "
        f"{rate:.3f} iters/s (amortizing {len(sig)} x {t_factor:.1f}s "
        f"factors; loadavg {loadavg})")
    return {"factor_s": t_factor, "lu_nnz": lu_nnz, "solve_s": t_solve,
            "adi_iters_per_s": rate, "loadavg_1min": loadavg}


def run(device, *, ops=None, problem: str | None = None,
        nts_gain: int = NTS_GAIN, nts_roll: int = NTS_ROLL,
        n_shifts: int = N_SHIFTS, n_adi: int = N_ADI, r_max: int = R_MAX,
        s_batch: int = S_BATCH, block: int = 512, tol: float = FGMRES_TOL,
        dtype=torch.float32, log=log, arrays: dict | None = None) -> dict:
    """Config 3XL on `device`; returns the reference's CONFIG3XL dict
    (and the records the reference does not keep: FGMRES records, load
    average, projector seconds, peak device memory). ops: (np_ops, sys,
    cond) of another setup with its `problem` name (tests pass a small
    one, with a smaller block and FGMRES tol); arrays, when given,
    receives zs, ks, the probe relres, the rollout's vs, the DRE cache and
    the f32 system."""
    stamp = clock(device)
    cuda = torch.device(device).type == "cuda"
    t0 = stamp()  # (initialises CUDA before its memory statistics)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if ops is None:
        ops = cylinder_setup(re=RE, refinement=REFINEMENT, device=device,
                             dtype=torch.float64)
        problem = f"cylinder_re{int(RE)}_ref{REFINEMENT}"
    np_ops, sys64, cond = ops
    sysd = sys64.to(dtype=dtype)
    n, m = sysd.b.shape
    t_setup = stamp() - t0
    log(f"setup {t_setup:.1f}s: n={n} np={sysd.n_p}")

    t0 = time.perf_counter()
    sig, sseq, iseq = dre_shift_schedule_dae(
        np_ops["A"], np_ops["M"], np_ops["J"], DT, num_shifts=n_shifts,
        n_adi=n_adi,
    )
    t_shifts = time.perf_counter() - t0
    log(f"shifts {t_shifts:.1f}s: [{sig[0]:.1f}, {sig[-1]:.1f}]")

    t0 = stamp()
    cache = build_dre_cache_dae_matfree(sysd, DT, sig, block=block, tol=tol,
                                        max_cycles=DRE_CYCLES)
    t_cache = stamp() - t0
    log(f"matfree cache {t_cache:.1f}s (block {cache.block}, np={cache.n_p})")

    # one solve a shift on a random right-hand side: the Krylov
    # convergence at this size
    rng = np.random.default_rng(1)
    probe = torch.as_tensor(rng.standard_normal((n, PROBE_COLS)),
                            dtype=dtype).to(device)
    relres = []
    t0 = stamp()
    for i in range(len(sig)):
        _, rel = cache.solve_relres(i, probe)
        relres.append(float(rel))
        log(f"  shift {i} ({sig[i]:.1f}): relres {relres[-1]:.2e}")
    t_probe = stamp() - t0
    log(f"probe solves {t_probe:.1f}s")
    probe_stats = cache.stats.as_dict()

    adi_iters = nts_gain * n_adi

    def sweep(alpha):
        return dre_backward_sweep(sysd, cache, alpha, DT, nts_gain, sseq,
                                  iseq, n_newton=1, r_max=r_max)

    k0_solves = cache.stats.solves
    t0 = stamp()
    zs, ks = sweep(ALPHA)
    t_dre = stamp() - t0
    fgmres_first = stats_since(cache.stats, k0_solves)
    log(f"DRE sweep {t_dre:.1f}s ({adi_iters / t_dre:.2f} ADI iters/s "
        f"first); FGMRES {fgmres_first}")
    k0_solves = cache.stats.solves
    t0 = stamp()
    sweep(ALPHA * 1.0001)
    t_dre_warm = stamp() - t0
    adi_warm = adi_iters / t_dre_warm
    fgmres_warm = stats_since(cache.stats, k0_solves)
    log(f"warm DRE sweep {t_dre_warm:.1f}s ({adi_warm:.2f} ADI iters/s); "
        f"FGMRES {fgmres_warm}")
    if arrays is not None:
        arrays.update(dre_cache=cache, sys=sysd)
    del cache

    cpu = cpu_splu_baseline(np_ops, sig, q_cols=sysd.p_out + r_max + m,
                            adi_iters=adi_iters, log=log)

    feas = feasibility(sysd, zs[0])
    k0 = ks[0]
    log(f"|J Z|/|Z| = {feas:.2e}, |K| = {float(k0.abs().max()):.3e}")
    if not feas < FEASIBILITY_BOUND:
        raise RuntimeError(f"|JZ|/|Z| = {feas:.2e} (bound "
                           f"{FEASIBILITY_BOUND:g})")
    if not bool(torch.isfinite(k0).all()):
        raise RuntimeError("gains not finite")

    res = projected_residuals(np_ops, zs, ks, (0, nts_gain // 2), ALPHA, DT,
                              log=log)
    worst_res = max(res["residuals"])
    log(f"residual validation {res['projector_s'] + res['residual_s']:.1f}s "
        f"(projector built once: {res['saved_s']:.1f}s saved)")
    if not worst_res < RESIDUAL_BOUND:
        raise RuntimeError(f"projected DRE residual {worst_res:.3e} (bound "
                           f"{RESIDUAL_BOUND:g})")

    conv = FusedConvKernel.build(np_ops["full"], cond, device=device,
                                 dtype=dtype)
    t0 = stamp()
    stepper = build_nse_stepper_matfree(np_ops, cond, DT, device=device,
                                        dtype=dtype, block=block, tol=tol,
                                        max_cycles=ROLL_CYCLES)
    t_stepper = stamp() - t0
    log(f"matfree stepper {t_stepper:.1f}s")
    ks_roll = k0.expand(nts_roll + 1, m, n)
    ws = torch.zeros((nts_roll + 1, n), dtype=dtype, device=device)
    v0 = rollout_v0(stepper, s_batch, rng)
    t0 = stamp()
    vs, _, _ = batched_nse_closed_loop(sysd, conv, stepper, ks_roll, ws, v0,
                                       ALPHA, DT, feedback="implicit")
    t_roll = stamp() - t0
    finite = bool(torch.isfinite(vs).all())
    log(f"rollout {t_roll:.1f}s ({s_batch} scenarios x {nts_roll} steps), "
        f"finite={finite}; FGMRES {stepper.saddle.stats.as_dict()}")
    if not finite:
        raise RuntimeError("closed loop not finite")
    peak_gb = (torch.cuda.max_memory_allocated(device) / 1e9 if cuda
               else None)
    if arrays is not None:
        arrays.update(zs=zs, ks=ks, relres=relres, vs=vs, sig=sig)
    return {
        "config": "3XL",
        "problem": problem,
        "n_state": int(n),
        "n_pressure": int(sysd.n_p),
        "solver": "matfree_fgmres_blockjacobi_schur",
        "setup_s": round(t_setup, 1),
        "shifts_s": round(t_shifts, 1),
        "cache_build_s": round(t_cache, 1),
        "fgmres_relres_per_shift": [round(r, 9) for r in relres],
        "probe_s": round(t_probe, 2),
        "dre_sweep_s": round(t_dre, 1),
        "adi_iters_per_s_first": round(adi_iters / t_dre, 3),
        "dre_sweep_warm_s": round(t_dre_warm, 1),
        "adi_iters_per_s_warm": round(adi_warm, 3),
        "fgmres_dre_first": fgmres_first,
        "fgmres_dre_warm": fgmres_warm,
        "fgmres_probe": probe_stats,
        "cpu_splu_factor_s_per_shift": round(cpu["factor_s"], 1),
        "cpu_splu_lu_nnz": cpu["lu_nnz"],
        "cpu_splu_solve_s": round(cpu["solve_s"], 3),
        "cpu_adi_iters_per_s": round(cpu["adi_iters_per_s"], 4),
        "host_loadavg_1min": cpu["loadavg_1min"],
        "adi_warm_vs_cpu": round(adi_warm / cpu["adi_iters_per_s"], 2),
        "feasibility_JZ": feas,
        "worst_dre_residual": worst_res,
        "projected_residuals": res["residuals"],
        "residual_bound": RESIDUAL_BOUND,
        "projector_s": res["projector_s"],
        "projector_saved_s": res["saved_s"],
        "stepper_build_s": round(t_stepper, 1),
        "rollout_s": round(t_roll, 1),
        "rollout_steps": s_batch * nts_roll,
        "finite": finite,
        "peak_device_memory_gb": peak_gb,
        "device": str(torch.device(device)),
        "note": "no O((n+np)^2) object anywhere",
    }


def main(argv=None) -> dict:
    return cli_main(run, __doc__.splitlines()[0], argv)


if __name__ == "__main__":
    main()
