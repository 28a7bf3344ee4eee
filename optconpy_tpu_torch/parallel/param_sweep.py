"""Parameter-sweep MPC (config 5): thousands of closed-loop scenarios
across a family of linearizations, e.g. Re in [60, 150].

Counterpart of optconpy_tpu/parallel/param_sweep.py:
R parameter buckets (one linearization, gain and stepper each) x S
scenarios a bucket. The geometry is shared across the buckets (same
mesh, different viscosity and steady state), so one convection
evaluator serves the whole sweep and only the step caches and gains
are per bucket; the bucket caches are stacked on a leading R axis
(NSEStepCache.stack) and the rollout is one time loop over all R x S
scenarios (mpc/nse_rollout.py nse_sweep_outputs). Buckets of unequal
real counts are padded to one width and masked out of the statistics.
sharded_sweep_rollout splits the scenario axis over torch.distributed
ranks and all-reduces the statistics' partial sums.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..mpc.nse_rollout import (
    NSEStepCache,
    build_nse_stepper,
    build_sweep_steppers_ns_chain,
    nse_sweep_outputs,
)
from .sharded_mpc import all_reduce_stats


def build_sweep_gains_and_caches(
    setups: list,
    dt: float,
    alpha: float,
    dtype=torch.float32,
    num_shifts: int = 8,
    n_adi: int = 16,
    nts_gain: int = 8,
    r_max: int = 24,
    solver: str = "inverse",
    interval=None,
    cache_keys: list | None = None,
    cache_dir: str | None = None,
    dre_solver: str = "inverse",
    conv=None,
    info: dict | None = None,
):
    """Per-bucket gains and stepper caches, one bucket after another.

    setups: (np_ops, sys, cond) per parameter value (models/*, np_ops
    with vbar_full), every sys on one device, where every tensor goes.
    Returns (the stacked NSEStepCache, ks (R, m, n)): each bucket's t=0
    gain of an nts_gain-step backward DRE sweep (one Newton step).

    dre_solver: 'inverse' (host splu velocity-block inverse stack;
    with cache_keys, bucket i's stack is stored under cache_keys[i] in
    cache_dir and reloaded, riccati.load_or_build_inverse_stack) or
    'matfree' (block-Jacobi and pressure-Schur FGMRES, no dense object).
    solver: the stepper tier, 'lu' or 'inverse' (host f64 factor or
    inverse per bucket, build_nse_stepper) or 'inverse_ns' (the
    Newton-Schulz chain across the buckets,
    build_sweep_steppers_ns_chain, which needs `conv`, the shared
    geometry's ConvKernel). interval: a precomputed spectral interval
    for every bucket's shifts (riccati.dre_shift_schedule_dae).

    info, when given, receives "buckets": per bucket the seconds of the
    shifts, the DRE cache and the DRE sweep (the device synchronized at
    each boundary) and, on 'matfree', the DRE sweep's FGMRES record;
    "steppers_s" and, on 'inverse_ns', "ns_residuals" (each bucket's
    float64-evaluated residual) and "ns_chain"
    (build_sweep_steppers_ns_chain's info).
    """
    from ..riccati import (
        build_dre_cache_dae,
        build_dre_cache_dae_matfree,
        dre_backward_sweep,
        dre_shift_schedule_dae,
    )

    if dre_solver not in ("inverse", "matfree"):
        raise ValueError(f"unknown DRE tier: {dre_solver}")
    if solver not in ("lu", "inverse", "inverse_ns"):
        raise ValueError(f"unknown stepper tier: {solver}")
    if solver == "inverse_ns" and conv is None:
        raise ValueError("the 'inverse_ns' steppers need conv, the shared "
                         "geometry's ConvKernel")
    device = setups[0][1].b.device

    def stamp():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    gains, buckets = [], []
    for i, (np_ops, sys64, cond) in enumerate(setups):
        t0 = stamp()
        sys = sys64.to(dtype=dtype)
        sig, sigma_seq, idx_seq = dre_shift_schedule_dae(
            np_ops["A"], np_ops["M"], np_ops["J"], dt,
            num_shifts=num_shifts, n_adi=n_adi, interval=interval,
        )
        t1 = stamp()
        if dre_solver == "matfree":
            dre_cache = build_dre_cache_dae_matfree(sys, dt, sig)
        else:
            dre_cache = build_dre_cache_dae(
                sys, dt, sig, solver="inverse",
                cache_key=None if cache_keys is None else cache_keys[i],
                cache_dir=cache_dir,
            )
        t2 = stamp()
        _, ks = dre_backward_sweep(
            sys, dre_cache, alpha, dt, nts_gain, sigma_seq, idx_seq,
            n_newton=1, r_max=r_max,
        )
        gains.append(ks[0])
        t3 = stamp()
        rec = {
            "shifts_s": t1 - t0, "dre_cache_s": t2 - t1,
            "dre_sweep_s": t3 - t2,
        }
        if dre_solver == "matfree":
            rec["fgmres"] = dre_cache.stats.as_dict()
        buckets.append(rec)
        del dre_cache  # free the bucket's solver before the next one
    t0 = stamp()
    if solver == "inverse_ns":
        caches, residuals, chain = build_sweep_steppers_ns_chain(
            setups, dt, conv, dtype=dtype)
        if info is not None:
            info["ns_residuals"] = residuals
            info["ns_chain"] = chain
    else:
        caches = [
            build_nse_stepper(np_ops, cond, dt, device=device, dtype=dtype,
                              solver=solver)
            for np_ops, _sys, cond in setups
        ]
    cache_stack = NSEStepCache.stack(caches)
    del caches
    t1 = stamp()
    if info is not None:
        info["buckets"] = buckets
        info["steppers_s"] = t1 - t0
    return cache_stack, torch.stack(gains)


# The reference's sweep_rollout (its parallel/param_sweep.py) forwards
# to nse_sweep_outputs with implicit feedback; here it is that function.
sweep_rollout = nse_sweep_outputs


def sweep_partials(ys, u_sq, alpha: float, dt: float, ystar, mask):
    """This block's partial sums of the sweep statistics (the part of
    the reference's sharded_sweep_rollout before its psum and pmax).

    ys (R, S, T+1, p), u_sq (R, S, T); ystar (R, p) each bucket's target
    (zeros: regulation); mask (R, S) 1 for a real scenario and 0 for a
    padded one. Returns (sums (3, R): per bucket the cost sum_t ||y -
    y*||^2 dt + alpha sum_t ||u||^2 dt, the real count and the terminal
    ||y - y*||, each summed over the block's real scenarios; maxima (R,):
    max |y| over them). Padded rows are selected out (torch.where),
    never multiplied by 0, so a padded row that diverged to inf or NaN
    adds nothing, here or on another rank.
    """
    valid = mask > 0
    dy = ys - ystar[:, None, None, :]
    cost = (dy**2).sum(dim=(2, 3)) * dt + alpha * u_sq.sum(dim=2) * dt
    zero = ys.new_zeros(())
    err_t = torch.where(valid, dy[:, :, -1, :].norm(dim=-1), zero)
    max_y = torch.where(valid[:, :, None, None], ys.abs(), zero)
    sums = torch.stack([
        torch.where(valid, cost, zero).sum(dim=1),
        mask.to(ys.dtype).sum(dim=1),
        err_t.sum(dim=1),
    ])
    return sums, max_y.amax(dim=(1, 2, 3))


def finish_sweep_stats(sums, maxima) -> dict:
    """Per-bucket statistics from (global) partials of sweep_partials:
    mean_cost and tracking_err_T, the means over the real scenarios;
    max_abs_y; scenarios, the real count."""
    safe = sums[1].clamp_min(1.0)
    return {
        "mean_cost": sums[0] / safe,
        "max_abs_y": maxima,
        "tracking_err_T": sums[2] / safe,
        "scenarios": sums[1],
    }


def masked_sweep_stats(ys, u_sq, alpha: float, dt: float, ystar,
                       mask) -> dict:
    """Per-bucket statistics of a sweep on one process (the reference's
    sharded block statistics, parallel/param_sweep.py
    sharded_sweep_rollout, where the reductions across scenario shards
    are the identity): finish_sweep_stats of sweep_partials. Returns per
    bucket (R,) mean_cost, max_abs_y, tracking_err_T and scenarios."""
    return finish_sweep_stats(*sweep_partials(ys, u_sq, alpha, dt, ystar,
                                              mask))


def sharded_sweep_rollout(mesh, sys, conv, cache_stack: NSEStepCache, ks,
                          v0_local, alpha: float, dt: float, nts: int,
                          ystar=None, mask_local=None):
    """The config-5 sweep with the scenario axis sharded over the mesh's
    ranks (parallel/mesh.py): bucket operands and gains are the same on
    every rank, v0_local (R, S/world, n) is this rank's block
    (shard_scenarios(mesh, v0, dim=1)), mask_local its (R, S/world)
    block of the validity mask (None: every row real); ystar (R, p)
    (None: zeros). The block's partial statistics are all-reduced (one
    SUM of costs, counts and terminal errors, one MAX of |y|) before the
    means. Returns (ys (R, S/world, nts+1, p), this rank's block; the
    global per-bucket statistics of masked_sweep_stats)."""
    ys, u_sq, _ = sweep_rollout(sys, conv, cache_stack, ks, v0_local, alpha,
                                dt, nts)
    if ystar is None:
        ystar = ys.new_zeros((ys.shape[0], ys.shape[-1]))
    if mask_local is None:
        mask_local = ys.new_ones(ys.shape[:2])
    sums, maxima = sweep_partials(ys, u_sq, alpha, dt, ystar, mask_local)
    return ys, finish_sweep_stats(*all_reduce_stats(mesh, sums, maxima))


def assign_re_buckets(re_values: np.ndarray, re_buckets: np.ndarray):
    """Nearest-bucket assignment for a continuous parameter sweep:
    scenario i with parameter re_values[i] uses the gain and
    linearization of the closest bucket (ties go to the lower index)."""
    return np.argmin(
        np.abs(re_values[:, None] - re_buckets[None, :]), axis=1
    ).astype(np.int32)
