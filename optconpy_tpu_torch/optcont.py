"""optcon_nse — the end-to-end experiment driver.

Counterpart of optconpy_tpu/optcont.py: config -> assemble -> steady
state -> target y* -> backward DRE sweep (gains per timestep,
checkpointed under the config hash) -> feedforward sweep -> batched
closed loop (nonlinear NSE or linear LTI) -> outputs and cost. The same
config runs the same tiers as in the reference; everything runs on the
card unless the caller passes device="cpu".

Three behaviours of the reference are not copied: a Newton-Schulz
inverse stack with a shift that missed its certification tolerance
raises here instead of feeding the gains; the 'inverse' tier stores its
inverse stack under the caller's cache_dir; and the matrix-free tiers
report their FGMRES solves (extras["fgmres"], a "fgmres" metrics record
per stage) and warn, naming the stage, when a solve stopped at the cycle
cap above fgmres_tol.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .utils.cache import load_or_comp, write_meta
from .utils.config import OptConConfig
from .utils.metrics import MetricsLogger

# Residual the Newton-Schulz inverse stack of dre_solver='inverse_ns' must
# reach at every shift (the reference driver's default).
NS_CERTIFY_TOL = 5e-4


@dataclass
class OptConResult:
    """Outputs of one optcon_nse run (host numpy, gains on the device)."""

    cfg: OptConConfig
    times: np.ndarray  # (nts+1,)
    ys: np.ndarray  # (S, nts+1, p) closed-loop outputs
    us: np.ndarray  # (S, nts, m) control inputs
    ystar: np.ndarray  # (nts+1, p) target
    cost: float  # mean tracking cost over scenarios
    gains: Any  # (nts+1, m, n) tensor
    extras: dict


def get_ystarvec(
    cost_cfg, times: np.ndarray, p: int, y_ref: np.ndarray | None = None
) -> np.ndarray:
    """Target output signal y*(t): (nts+1, p).

    'zero' regulates to the output origin, 'const' holds an absolute
    step, 'steady_offset' holds y_ref + amp (a reachable perturbation of
    the steady output), 'sin' rides a sinusoid on y_ref.
    """
    nts1 = len(times)
    if y_ref is None:
        y_ref = np.zeros(p)
    if cost_cfg.ystar == "zero":
        return np.zeros((nts1, p))
    if cost_cfg.ystar == "const":
        return np.full((nts1, p), cost_cfg.ystar_amp)
    if cost_cfg.ystar == "steady_offset":
        return np.tile(y_ref[None, :], (nts1, 1)) + cost_cfg.ystar_amp
    if cost_cfg.ystar == "sin":
        sig = cost_cfg.ystar_amp * np.sin(
            2.0 * np.pi * cost_cfg.ystar_freq * times
        )
        return np.tile(y_ref[None, :], (nts1, 1)) + sig[:, None]
    raise ValueError(f"unknown ystar family: {cost_cfg.ystar}")


def _setup_problem(cfg: OptConConfig, device):
    """Dispatch to the problem family; returns (np_ops, sys64, cond) with
    sys64 on `device` in float64.

    cond is None for unconstrained problems (heat1d, config 1): no
    divergence constraint, no convection, and the driver takes the
    linear LTI path instead of the NSE one.
    """
    p = cfg.problem
    if p.name == "cylinderwake":
        from .models.cylinder import cylinder_setup

        return cylinder_setup(re=p.re, refinement=p.refinement, device=device)
    if p.name == "drivencavity":
        from .models.cavity import cavity_stokes_setup
        from .solvers.steady import solve_steady_nse_host

        np_ops, sys, cond = cavity_stokes_setup(nx=p.nx, device=device)
        # Linearization point = steady NSE cavity flow (gains use the
        # Stokes operator, correct at the cavity's low Re).
        np_ops["vbar_full"], _ = solve_steady_nse_host(np_ops["full"], cond)
        return np_ops, sys, cond
    if p.name == "heat1d":
        from .fem.heat1d import heat1d_operators

        np_ops, sys = heat1d_operators(n=p.n_dof, device=device)
        return np_ops, sys, None
    raise ValueError(f"unknown problem: {p.name}")


def _check_tiers(solver_cfg) -> str:
    """Refuse unknown tiers before any work starts; returns the DRE tier
    with 'auto' resolved: the matrix-free step tier pairs with the
    matrix-free DRE tier (no O((n + n_p)^2) object), every other step
    tier with the dense 'inverse' one."""
    if solver_cfg.step_solver not in ("lu", "inverse", "fused", "matfree"):
        raise ValueError(f"unknown step_solver: {solver_cfg.step_solver}")
    dre_solver = solver_cfg.dre_solver
    if dre_solver == "auto":
        dre_solver = (
            "matfree" if solver_cfg.step_solver == "matfree" else "inverse"
        )
    if dre_solver not in ("lu", "inverse", "inverse_ns", "matfree"):
        raise ValueError(f"unknown dre_solver: {dre_solver}")
    return dre_solver


def _ns_cache(sys, dt, sig):
    """The 'inverse_ns' tier: the Newton-Schulz stack built on sys's
    device; raises unless every shift is certified."""
    from .riccati import build_dre_cache_dae_ns

    cache, info = build_dre_cache_dae_ns(
        sys, dt, sig, certify_tol=NS_CERTIFY_TOL
    )
    failed = [
        (float(s), r)
        for s, r, ok in zip(sig, info["residuals"], info["certified"])
        if not ok
    ]
    if failed:
        raise RuntimeError(
            f"Newton-Schulz inverse stack not certified at "
            f"{info['certify_tol']:g} for shifts (shift, residual) {failed}; "
            f"refusing to compute gains from it"
        )
    return cache


def optcon_nse(
    cfg: OptConConfig,
    v0_batch: np.ndarray | None = None,
    cache_dir: str | None = None,
    metrics: MetricsLogger | None = None,
    vtk_dir: str | None = None,
    controlled: bool = True,
    *,
    device="cuda",
) -> OptConResult:
    """Run the full backward-forward optimal-control pipeline on `device`
    (the card by default; pass device="cpu" for the host).

    v0_batch: (S, n) initial inner states; default = one scenario at the
    steady state (heat1d: the bump profile). Gains and feedforward are
    computed once and shared across the batch, then the closed loop
    runs every scenario as a column of one solve per step.
    controlled=False skips the backward sweeps and rolls out the plain
    plant (u = 0), the comparison baseline for every controlled run.
    Tiers: step_solver 'lu' | 'inverse' | 'fused' | 'matfree'; dre_solver
    'lu' | 'inverse' | 'inverse_ns' | 'matfree' | 'auto' ('matfree' with
    the matfree step tier, else 'inverse'); the matfree tiers solve to
    fgmres_tol within fgmres_cycles restarts. `metrics` receives the
    seconds of the stages setup, dre_backward_sweep, feedforward_sweep,
    step_build and closed_loop_rollout, each ending in a device
    synchronize, and for a matrix-free tier the record of its FGMRES
    solves (event "fgmres", also in extras["fgmres"][stage] with stage
    "dre" or "rollout"; the DRE record is absent when the gains came
    from the checkpoint).
    """
    from . import utils
    from .control import (
        build_costate_cache,
        build_costate_cache_dae,
        feedforward_sweep,
    )
    from .riccati import dre_backward_sweep

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "optcon_nse: device='cuda' but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the host"
        )
    # Strict FP32 for the whole run; refuses any other precision of the
    # run or of its rollout.
    utils.setup(cfg.solver.matmul_precision)
    utils.setup(cfg.solver.rollout_matmul_precision)
    dre_solver = _check_tiers(cfg.solver)
    met = metrics or MetricsLogger()
    key = cfg.hash()
    write_meta(key, {"config": cfg.to_json()}, cache_dir)
    dtype = getattr(torch, cfg.solver.dtype)
    dt = cfg.time.dt
    nts = cfg.time.nts
    times = cfg.time.t0 + dt * np.arange(nts + 1)

    with met.timed("setup", problem=cfg.problem.name):
        np_ops, sys64, cond = _setup_problem(cfg, device)
    constrained = cond is not None
    sys = sys64.to(dtype=dtype)
    n, m = sys.b.shape
    p_out = sys.p_out
    met.log(
        "operators", n=n, n_p=sys.n_p if constrained else 0, m=m, p=p_out
    )
    fgmres_stats = {}  # stage -> FgmresStats of a matrix-free tier

    def compute_gains():
        from .riccati import (
            build_dre_cache,
            build_dre_cache_dae,
            build_dre_cache_dae_matfree,
            dre_shift_schedule,
            dre_shift_schedule_dae,
        )

        if constrained:
            sig, sigma_seq, idx_seq = dre_shift_schedule_dae(
                np_ops["A"], np_ops["M"], np_ops["J"], dt,
                num_shifts=cfg.solver.num_shifts, n_adi=cfg.solver.n_adi,
            )
            if dre_solver == "matfree":
                cache = build_dre_cache_dae_matfree(
                    sys, dt, sig, tol=cfg.solver.fgmres_tol,
                    max_cycles=cfg.solver.fgmres_cycles,
                )
                fgmres_stats["dre"] = cache.stats
            elif dre_solver == "inverse_ns":
                cache = _ns_cache(sys, dt, sig)
            else:
                # The 'inverse' stack is stored under the config hash in
                # the caller's cache_dir, so a warm restart skips the
                # splu builds.
                cache = build_dre_cache_dae(
                    sys, dt, sig, solver=dre_solver,
                    cache_key=(
                        f"optcont_{key}" if dre_solver == "inverse" else None
                    ),
                    cache_dir=cache_dir,
                )
        else:
            sig, sigma_seq, idx_seq = dre_shift_schedule(
                np_ops["A"], np_ops["M"], dt,
                num_shifts=cfg.solver.num_shifts, n_adi=cfg.solver.n_adi,
            )
            cache = build_dre_cache(
                sys, dt, sig,
                solver=dre_solver if dre_solver in ("lu", "inverse")
                else "lu",
            )
        zs, ks = dre_backward_sweep(
            sys, cache, cfg.cost.alpha, dt, nts, sigma_seq, idx_seq,
            n_newton=cfg.solver.n_newton, r_max=cfg.solver.r_max,
        )
        return {"ks": ks.cpu().numpy(), "z0": zs[0].cpu().numpy()}

    if constrained:
        vbar_i = cond.restrict(np_ops["vbar_full"])
    else:
        vbar_i = np.zeros(n)
    y_bar = np.asarray(np_ops["C"] @ vbar_i)
    ystar = get_ystarvec(cfg.cost, times, p_out, y_ref=y_bar)

    def on_device(x):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    if controlled:
        with met.timed("dre_backward_sweep", nts=nts):
            gains = load_or_comp(key, "gains", compute_gains, cache_dir)
        ks = on_device(gains["ks"])

        # --- Feedforward sweep (perturbation coordinates). ---
        with met.timed("feedforward_sweep"):
            costate_cache = (
                build_costate_cache_dae(sys, dt) if constrained
                else build_costate_cache(sys, dt)
            )
            ws = feedforward_sweep(
                sys, costate_cache, ks, on_device(ystar - y_bar[None, :]), dt
            )
    else:
        ks = torch.zeros((nts + 1, m, n), dtype=dtype, device=device)
        ws = torch.zeros((nts + 1, n), dtype=dtype, device=device)

    # --- Forward closed loop (nonlinear NSE or linear LTI). ---
    if constrained:
        from .fem.device_conv import ConvKernel, FusedConvKernel
        from .mpc import (
            batched_nse_closed_loop,
            build_nse_fused,
            build_nse_stepper,
            build_nse_stepper_matfree,
        )

        step_solver = cfg.solver.step_solver
        # The convection kernel serves the fused and matfree tiers in
        # float32; the plain tensor path covers float64 and the others.
        conv_cls = (
            FusedConvKernel
            if step_solver in ("fused", "matfree") and dtype == torch.float32
            else ConvKernel
        )
        with met.timed("step_build", tier=step_solver):
            conv = conv_cls.build(np_ops["full"], cond, device=device,
                                  dtype=dtype)
            if step_solver == "fused":
                stepper = build_nse_fused(
                    np_ops, cond, dt, device=device, dtype=dtype,
                    scheme=cfg.solver.imex_scheme,
                )
            elif step_solver == "matfree":
                stepper = build_nse_stepper_matfree(
                    np_ops, cond, dt, device=device, dtype=dtype,
                    scheme=cfg.solver.imex_scheme, tol=cfg.solver.fgmres_tol,
                    max_cycles=cfg.solver.fgmres_cycles,
                )
                fgmres_stats["rollout"] = stepper.saddle.stats
            else:
                stepper = build_nse_stepper(
                    np_ops, cond, dt, device=device, dtype=dtype,
                    scheme=cfg.solver.imex_scheme, solver=step_solver,
                )
        if v0_batch is None:
            v0_batch = np.asarray(vbar_i)[None, :]
        v0_dev = on_device(v0_batch)
        with met.timed("closed_loop_rollout", scenarios=len(v0_batch)):
            vs, us, ys = batched_nse_closed_loop(
                sys, conv, stepper, ks, ws, v0_dev, cfg.cost.alpha, dt,
                feedback=cfg.solver.feedback,
            )
    else:
        from .fem.heat1d import initial_state
        from .mpc import batched_closed_loop, build_step_cache

        with met.timed("step_build", tier="lu"):
            stepper = build_step_cache(sys, dt)
        if v0_batch is None:
            v0_batch = initial_state(n)[None, :]
        v0_dev = on_device(v0_batch)
        with met.timed("closed_loop_rollout", scenarios=len(v0_batch)):
            vs, us, ys = batched_closed_loop(
                sys, stepper, ks, ws, v0_dev, cfg.cost.alpha, dt,
                feedback=cfg.solver.feedback,
            )

    ys_np = ys.cpu().numpy()
    us_np = us.cpu().numpy()
    track_err = ys_np - ystar[None, :, :]
    cost = float(
        np.mean(
            np.sum(track_err**2, axis=(1, 2)) * dt
            + cfg.cost.alpha * np.sum(us_np**2, axis=(1, 2)) * dt
        )
    )
    met.log("result", cost=cost, max_abs_y=float(np.abs(ys_np).max()))
    fgmres = {stage: st.as_dict() for stage, st in fgmres_stats.items()}
    for stage, rec in fgmres.items():
        met.log("fgmres", stage=stage, **rec)
        if rec["above_tol"]:
            warnings.warn(
                f"optcon_nse: {rec['above_tol']} of {rec['solves']} FGMRES "
                f"solves of the {stage} stage stopped at the cycle cap above "
                f"fgmres_tol {rec['tol']:g} (worst relative residual "
                f"{rec['worst_relres']:.3e})",
                RuntimeWarning, stacklevel=2,
            )

    if vtk_dir is not None and constrained:
        from .utils.vtk import write_vtk_series

        vs0_full = np.stack([cond.expand(v) for v in vs[0].cpu().numpy()])
        write_vtk_series(
            vtk_dir, np_ops["space"], vs0_full, times,
            stride=max(1, nts // 20),
        )

    return OptConResult(
        cfg=cfg,
        times=times,
        ys=ys_np,
        us=us_np,
        ystar=ystar,
        cost=cost,
        gains=ks,
        extras={
            "metrics": met.records,
            "steady_info": np_ops.get("steady_info"),
            "cache_key": key,
            **({"fgmres": fgmres} if fgmres else {}),
        },
    )
