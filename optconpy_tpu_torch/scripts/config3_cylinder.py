"""Config 3: the linearized cylinder wake at Re=60, refinement 2
(n=15,316), low-rank ADI / DRE Riccati feedback on one device.

Counterpart of the JAX package's scripts/config3_cylinder.py. The shift
interval takes its bottom from the projected pencil of the coarse mesh
(refinement 1) and its top from ARPACK on the fine, unprojected pencil,
cached on disk (utils/cache.load_or_comp). Then:

  - the matrix-free tier (block-Jacobi and pressure-Schur FGMRES, no
    O((n + n_p)^2) object) at 12 shifts: a first DRE sweep and warm
    repeats (median of 3);
  - the Newton-Schulz (NS) dense inverse-stack tier, built on the
    device, at 8 shifts, with its warm repeats, and the NS-vs-matrix-free
    parity of the t=0 gain;
  - the CPU baseline: scipy splu of every shifted saddle and the ADI
    recurrence in numpy f64 (median of 3, with the load average);
  - checks, each raising: |J Z|/|Z| < 1e-5, the projected DRE residual
    < 1e-2 at steps 0 and 8 (host f64), and the controlled/uncontrolled
    perturbation energy ratio at T < 0.5 over 16 scenarios x 100 steps
    (implicit feedback, matrix-free stepper, the NS tier's gain).

Validation at this size is residual and behavioural: no dense golden is
feasible at 15k. Run:

    python -m optconpy_tpu_torch.scripts.config3_cylinder [--out FILE]
"""
from __future__ import annotations

import os
import statistics
import time

import numpy as np
import torch

from ..fem.device_conv import FusedConvKernel
from ..models.cylinder import cylinder_setup
from ..mpc import batched_nse_closed_loop, build_nse_stepper_matfree
from ..riccati import (
    build_dre_cache_dae_matfree,
    build_dre_cache_dae_ns,
    dre_backward_sweep,
    dre_shift_schedule_dae,
)
from ..riccati.shifts import spectral_interval, spectral_interval_dae
from ..utils.cache import load_or_comp
from ._common import cli_main, clock, log, projected_residuals

RE = 60.0
REFINEMENT = 2
DT = 0.01
NTS_GAIN = 16  # DRE steps (the gain converges to quasi-steady in O(10))
NTS_ROLL = 100
ALPHA = 1e-4
R_MAX = 40
N_SHIFTS = 12
NS_SHIFTS = 8
N_ADI = 16
S_BATCH = 16
# The inner Krylov tolerance from the outer accuracy budget: a quarter
# of the ADI schedule's own truncation floor, the projected DRE step
# residual 4.2e-4 the reference measured at (N_SHIFTS, N_ADI, R_MAX).
ADI_TRUNCATION_FLOOR = 4.2e-4
FGMRES_TOL = ADI_TRUNCATION_FLOOR / 4.0
DRE_CYCLES, ROLL_CYCLES = 8, 10
FEASIBILITY_BOUND = 1e-5
RESIDUAL_BOUND = 1e-2
ENERGY_RATIO_BOUND = 0.5


def coarse_mesh_interval(np_coarse: dict, np_fine: dict) -> tuple:
    """(lo, hi): lo of the projected pencil (A, M)|ker J of the coarse
    mesh (dense; the bottom is mesh-converged), hi of the fine mesh's
    unprojected pencil (ARPACK)."""
    lo, _ = spectral_interval_dae(np_coarse["A"], np_coarse["M"],
                                  np_coarse["J"])
    _, hi = spectral_interval(np_fine["A"], np_fine["M"])
    return lo, hi


def shift_interval(np_ops: dict, *, re: float = RE,
                   refinement: int = REFINEMENT, cache_dir=None) -> tuple:
    """The script's shift interval (a_min, a_max) of the fine setup
    np_ops, with the coarse mesh at refinement 1; computed once and
    loaded from cache_dir after (utils/cache.load_or_comp)."""

    def interval_art():
        np1, _, _ = cylinder_setup(re=re, refinement=1,
                                   device=torch.device("cpu"),
                                   dtype=torch.float64)
        lo, hi = coarse_mesh_interval(np1, np_ops)
        return {"lo": np.asarray(lo), "hi": np.asarray(hi)}

    iv = load_or_comp(f"cyl_re{int(re)}_ref{refinement}", "interval",
                      interval_art, cache_dir=cache_dir)
    return float(iv["lo"]), float(iv["hi"])


def schedule(interval: tuple, num_shifts: int, n_adi: int = N_ADI,
             dt: float = DT):
    """(sig, sigma_seq, idx_seq) of num_shifts Wachspress shifts over the
    interval, time-shifted for the DRE."""
    return dre_shift_schedule_dae(None, None, None, dt,
                                  num_shifts=num_shifts, n_adi=n_adi,
                                  interval=interval)


def timed_sweeps(sysd, cache, sched, *, warm: int = 3, alpha: float = ALPHA,
                 dt: float = DT, nts: int = NTS_GAIN, r_max: int = R_MAX):
    """A first DRE sweep at alpha and `warm` repeats at alpha (1 + 1e-4
    r), each ending in a synchronize. Returns (zs, ks, first seconds,
    warm seconds)."""
    _, sseq, iseq = sched
    stamp = clock(sysd.b.device)

    def sweep(a):
        return dre_backward_sweep(sysd, cache, a, dt, nts, sseq, iseq,
                                  n_newton=1, r_max=r_max)

    t0 = stamp()
    zs, ks = sweep(alpha)
    t_first = stamp() - t0
    samples = []
    for rep in range(warm):
        t0 = stamp()
        sweep(alpha * (1 + 1e-4 * (rep + 1)))
        samples.append(stamp() - t0)
    return zs, ks, t_first, samples


def cpu_adi_baseline(np_ops: dict, sig, *, q_cols: int, n_adi: int = N_ADI,
                     adi_iters: int, dt: float = DT, log=log) -> dict:
    """The reference architecture at this n: scipy splu of every shifted
    saddle [[Atil^T + s M, J^T], [J, 0]] and the ADI recurrence in numpy
    f64 on q_cols columns (min(n_adi, 8) iterations, median of 3), the
    factors amortized over adi_iters iterations."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    m_sp = np_ops["M"].tocsr()
    at_til = (np_ops["A"].T - m_sp / (2.0 * dt)).tocsr()
    j_sp = np_ops["J"].tocsr()
    n, n_p = m_sp.shape[0], j_sp.shape[0]
    t0 = time.perf_counter()
    lus = [spla.splu(sp.bmat([[at_til + s * m_sp, j_sp.T], [j_sp, None]],
                             format="csc")) for s in sig]
    t_factor = time.perf_counter() - t0
    log(f"cpu ADI factors ({len(sig)} shifted saddles at n={n}) "
        f"{t_factor:.1f}s")
    w = np.random.default_rng(1).standard_normal((n, q_cols))
    zeros_p = np.zeros((n_p, q_cols))

    def shift_solve(i, rhs):
        return lus[i].solve(np.concatenate([rhs, zeros_p]))[:n]

    loadavg = round(os.getloadavg()[0], 2)
    n_iters = min(n_adi, 8)
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        v = shift_solve(0, w)
        for it in range(1, n_iters):
            i = it % len(sig)
            v = v - (sig[i] + sig[i - 1]) * shift_solve(i, m_sp @ v)
        samples.append((time.perf_counter() - t0) / n_iters)
    t_iter = float(np.median(samples))
    rate = adi_iters / (t_factor + adi_iters * t_iter)
    log(f"cpu ADI baseline {t_iter * 1e3:.1f} ms/iter (median of "
        f"{[round(1e3 * t, 1) for t in samples]} ms, loadavg {loadavg}) -> "
        f"{rate:.2f} iters/s (amortized factors)")
    return {"factor_s": t_factor, "iter_s": t_iter, "iter_samples_s": samples,
            "adi_iters_per_s": rate, "loadavg_1min": loadavg}


def feasibility(sysd, z) -> float:
    """|J Z| / |Z| (max norms): the Riccati iterates lie in ker J."""
    return float(sysd.jmat.matmat(z).abs().max() / z.abs().max().clamp_min(
        1e-30))


def rollout_v0(stepper, s_batch: int, rng) -> torch.Tensor:
    """The closed loop's initial states: the steady state plus 1e-3
    N(0, 1) perturbations from rng, in the stepper's dtype."""
    vbar = stepper.vbar.cpu().numpy()
    return torch.as_tensor(
        vbar[None] + 1e-3 * rng.standard_normal((s_batch, vbar.shape[0])),
        dtype=stepper.vbar.dtype,
    ).to(stepper.vbar.device)


def energy_ratio(sysd, conv, stepper, k0, v0, *, nts: int = NTS_ROLL,
                 alpha: float = ALPHA, dt: float = DT) -> dict:
    """The closed loop with the gain k0 held and without feedback
    (implicit feedback, no feedforward): the mean perturbation energy
    (v - vbar)^T M (v - vbar) at T, controlled over uncontrolled; each
    rollout's seconds, whether all its outputs are finite, and the
    outputs' shape."""
    n, m = sysd.b.shape[0], sysd.b.shape[1]
    stamp = clock(v0.device)
    ks = k0.expand(nts + 1, m, n)
    ws = torch.zeros((nts + 1, n), dtype=v0.dtype, device=v0.device)

    def energy_t(vs):
        d = (vs[:, -1, :] - stepper.vbar).T.contiguous()
        return float((d * sysd.mass.matmat(d)).sum(0).mean())

    rec = {}
    for name, gains in (("c", ks), ("u", torch.zeros_like(ks))):
        t0 = stamp()
        out = batched_nse_closed_loop(sysd, conv, stepper, gains, ws, v0,
                                      alpha, dt, feedback="implicit")
        rec[f"rollout_{name}_s"] = stamp() - t0
        rec[f"finite_{name}"] = all(bool(torch.isfinite(x).all())
                                    for x in out)
        rec[f"energy_{name}"] = energy_t(out[0])
        rec["ys_shape"] = tuple(out[2].shape)
        del out
    rec["ratio"] = rec["energy_c"] / rec["energy_u"]
    return rec


def run(device, *, ops=None, problem: str | None = None, interval=None,
        cache_dir=None, nts_gain: int = NTS_GAIN, nts_roll: int = NTS_ROLL,
        n_shifts: int = N_SHIFTS, ns_shifts: int = NS_SHIFTS,
        n_adi: int = N_ADI, r_max: int = R_MAX, s_batch: int = S_BATCH,
        warm: int = 3, dtype=torch.float32, log=log,
        arrays: dict | None = None) -> dict:
    """Config 3 on `device`; returns the reference's CONFIG3 dict (and
    the seconds and records the reference does not keep). ops: (np_ops,
    sys, cond) of another setup with its `problem` name and shift
    `interval` (tests pass a small one); arrays, when given, receives
    the matrix-free and NS gains and factors and the rollout's v0."""
    stamp = clock(device)
    t0 = stamp()
    if ops is None:
        ops = cylinder_setup(re=RE, refinement=REFINEMENT, device=device,
                             dtype=torch.float64)
        problem = f"cylinder_re{int(RE)}_ref{REFINEMENT}"
    np_ops, sys64, cond = ops
    sysd = sys64.to(dtype=dtype)
    n, m = sysd.b.shape
    log(f"setup {stamp() - t0:.1f}s: n={n} np={sysd.n_p}")

    t0 = time.perf_counter()
    if interval is None:
        interval = shift_interval(np_ops, cache_dir=cache_dir)
    a_min, a_max = interval
    log(f"interval [{a_min:.2f}, {a_max:.1f}] ({time.perf_counter() - t0:.1f}s)")
    sched = schedule(interval, n_shifts, n_adi)
    adi_iters = nts_gain * n_adi

    # the matrix-free tier
    t0 = stamp()
    cache = build_dre_cache_dae_matfree(sysd, DT, sched[0], tol=FGMRES_TOL,
                                        max_cycles=DRE_CYCLES)
    log(f"matfree cache (block-Jacobi {cache.block}) {stamp() - t0:.1f}s")
    zs_mf, ks_mf, t_dre, mf_warm = timed_sweeps(sysd, cache, sched, warm=warm,
                                                nts=nts_gain, r_max=r_max)
    t_dre_warm = statistics.median(mf_warm) if mf_warm else float("nan")
    log(f"matfree DRE sweep {t_dre:.1f}s ({adi_iters / t_dre:.2f} ADI "
        f"iters/s first); warm {t_dre_warm:.1f}s ({adi_iters / t_dre_warm:.2f} "
        f"ADI iters/s, median of {warm})")
    fgmres = cache.stats.as_dict()
    del cache  # free the matfree preconditioners before the dense tier

    # the dense Newton-Schulz tier
    sched8 = schedule(interval, ns_shifts, n_adi)
    t0 = stamp()
    cache_ns, ns_info = build_dre_cache_dae_ns(sysd, DT, sched8[0],
                                               verbose=log)
    t_ns_build = stamp() - t0
    log(f"NS dense stack build {t_ns_build:.1f}s (rungs "
        f"{ns_info['ladder_rungs']}, worst residual "
        f"{max(ns_info['residuals']):.2e})")
    zs, ks, t_dre_ns, ns_warm = timed_sweeps(sysd, cache_ns, sched8, warm=warm,
                                             nts=nts_gain, r_max=r_max)
    del cache_ns
    t_dre_ns_warm = statistics.median(ns_warm) if ns_warm else float("nan")
    log(f"dense-NS DRE sweep {t_dre_ns:.2f}s first, warm {t_dre_ns_warm:.2f}s "
        f"({adi_iters / t_dre_ns_warm:.1f} ADI iters/s, median of {warm})")
    k_dev = float((ks[0] - ks_mf[0]).abs().max()
                  / ks_mf[0].abs().max().clamp_min(1e-30))
    log(f"gain parity dense-NS vs matfree: {k_dev:.2e}")

    cpu = cpu_adi_baseline(np_ops, sched[0], q_cols=sysd.p_out + r_max + m,
                           n_adi=n_adi, adi_iters=adi_iters, log=log)

    feas = feasibility(sysd, zs[0])
    k0 = ks[0]
    log(f"|J Z|/|Z| = {feas:.2e}, |K| = {float(k0.abs().max()):.3e}")
    if not feas < FEASIBILITY_BOUND:
        raise RuntimeError(f"|JZ|/|Z| = {feas:.2e} (bound "
                           f"{FEASIBILITY_BOUND:g})")
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
    stepper = build_nse_stepper_matfree(np_ops, cond, DT, device=device,
                                        dtype=dtype, tol=FGMRES_TOL,
                                        max_cycles=ROLL_CYCLES)
    v0 = rollout_v0(stepper, s_batch, np.random.default_rng(0))
    roll = energy_ratio(sysd, conv, stepper, k0, v0, nts=nts_roll)
    log(f"rollout {roll['rollout_c_s']:.1f}s: perturbation energy T-ratio "
        f"controlled/uncontrolled = {roll['ratio']:.3e} (u: "
        f"{roll['energy_u']:.3e}, c: {roll['energy_c']:.3e})")
    if not roll["ratio"] < ENERGY_RATIO_BOUND:
        raise RuntimeError(f"energy ratio {roll['ratio']:.3e} (bound "
                           f"{ENERGY_RATIO_BOUND:g})")
    if not (roll["finite_c"] and roll["finite_u"]):
        raise RuntimeError("closed loop not finite")
    if arrays is not None:
        arrays.update(zs_mf=zs_mf, ks_mf=ks_mf, zs=zs, ks=ks, v0=v0,
                      sig=sched[0], sig8=sched8[0])
    adi_warm = adi_iters / t_dre_warm
    adi_ns_warm = adi_iters / t_dre_ns_warm
    return {
        "config": 3,
        "problem": problem,
        "n_state": int(n),
        "solver": "dense_ns_inverse (headline) + matfree_fgmres",
        "feasibility_JZ": feas,
        "energy_ratio_T": roll["ratio"],
        "energy_ratio_bound": ENERGY_RATIO_BOUND,
        "worst_dre_residual": worst_res,
        "residual_bound": RESIDUAL_BOUND,
        "ns_build_s": round(t_ns_build, 1),
        "ns_shifts": ns_shifts,
        "ns_stack_residuals": [float(r) for r in ns_info["residuals"]],
        "adi_iters_per_s_warm_dense_ns": round(adi_ns_warm, 2),
        "dre_sweep_warm_dense_ns_s": round(t_dre_ns_warm, 2),
        "dense_ns_warm_samples_s": [round(t, 3) for t in ns_warm],
        "gain_parity_dense_vs_matfree": k_dev,
        "adi_iters_per_s_first": round(adi_iters / t_dre, 3),
        "adi_iters_per_s_warm_matfree": round(adi_warm, 3),
        "cpu_adi_iters_per_s": round(cpu["adi_iters_per_s"], 3),
        "cpu_sampling": "median_of_3",
        "host_loadavg_1min": cpu["loadavg_1min"],
        "fgmres_tol": FGMRES_TOL,
        "fgmres_tol_derivation": "ADI_TRUNCATION_FLOOR/4 (see header)",
        "adi_warm_vs_cpu_dense_ns": round(adi_ns_warm / cpu["adi_iters_per_s"],
                                          2),
        "adi_warm_vs_cpu_matfree": round(adi_warm / cpu["adi_iters_per_s"], 2),
        "dre_sweep_s": round(t_dre, 1),
        "dre_sweep_warm_s": round(t_dre_warm, 1),
        "rollout_s": round(roll["rollout_c_s"], 2),
        "finite": roll["finite_c"],
        "interval": [a_min, a_max],
        "fgmres_matfree_dre": fgmres,
        "projected_residuals": res["residuals"],
        "projector_s": res["projector_s"],
        "projector_saved_s": res["saved_s"],
        "device": str(torch.device(device)),
    }


def main(argv=None) -> dict:
    return cli_main(run, __doc__.splitlines()[0], argv)


if __name__ == "__main__":
    main()
