"""Receding-horizon MPC — config 4 (BASELINE.md).

Counterpart of optconpy_tpu/mpc/receding.py. At each macro step:
re-linearize the NSE about the batch mean, update the Riccati gains over
the prediction horizon (warm-started from the previous macro step's
gain), roll the scenario batch forward under the new feedback for
`apply` steps, shift the horizon. The macro loop is a Python loop that
rebuilds or refreshes the solver caches about each new linearization
point; it crosses to the host every macro step.

Three tiers, chosen by RHConfig.solver:
  * 'lu': ConvKernel.linearized_parts re-linearizes on the device, then
    dense saddle LUs for the stepper and every shift. The LUs are
    factored on the HOST in f64 and applied on the device (the port's
    convention for every LU, ops/dense.py), so this tier copies the
    dense operators to the host each macro where the reference's
    docstring says "device". O((n + n_p)^2) per shift: toy scale.
  * 'matfree': host sparse re-linearization (fem.taylor_hood
    convection_matrices) and matrix-free caches (solvers/matfree.py):
    FGMRES everywhere over the SpMM kernel, no O((n + n_p)^2) object. On
    later macros the caches are refreshed (operators repacked, the
    block-Jacobi preconditioners kept) unless refresh_caches is off.
  * 'dense_ns': the matrix-free stepper, and a dense DRE stack of full
    shifted-saddle inverses on the device (solvers/ns_inverse.py
    NSShiftStack) refreshed by Newton-Schulz passes each macro. Every
    refresh is certified by the build's probe (in f64 for an f32 stack)
    and a shift that misses is rebuilt from the ladder; the reference's
    refresh is not certified.

The stepper refresh of a later macro runs on a worker thread while the
DRE sweep runs; the rollout joins it. On CUDA the worker enqueues its
copies on the caller's current stream, so the rollout that follows the
join reads complete tensors. While the NaN sanitizer is on
(utils/runtime.py), the worker runs under a sanitizer mode of its own:
dispatch modes are per thread.

Per macro the loop records the gain, the state spread, and the quality
of its solves: the matfree tier's staleness probe (one solve on the
smallest-|shift| pencil, the reference's), the worst FGMRES relative
residual of the DRE sweep and of the rollout and how many of their
solves ended above tol (SaddleMatfreeCache.stats); the dense_ns tier's
worst certified refresh residual and its rebuild count.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from ..riccati.dre import dre_backward_sweep
from ..solvers.ns_inverse import NSShiftStack
from ..solvers.saddle import SaddleLU, SaddleShiftedLUCache
from ..utils.cache import code_salt
from ..utils.runtime import in_sanitizer
from .nse_rollout import NSEStepCache, batched_nse_closed_loop

NS_CERTIFY_TOL = 5e-4  # the dense_ns stack's certification (the reference's)


@dataclass(frozen=True)
class RHConfig:
    """Receding-horizon shape: predict `horizon` steps, apply `apply`."""

    horizon: int = 16  # DRE prediction steps per macro step
    apply: int = 8  # plant steps applied before re-linearizing
    dt: float = 0.01
    alpha: float = 1e-4
    n_newton: int = 1
    r_max: int = 32
    relinearize: bool = True
    # 'lu' (dense caches), 'matfree' (FGMRES everywhere) or 'dense_ns'
    # (matfree stepper + the NS-refreshed dense DRE stack).
    solver: str = "lu"
    fgmres_tol: float = 1e-6
    fgmres_cycles: int = 8
    # ADI iterations for macro steps after the first: the warm start from
    # the previous gain leaves the Newton step nearly converged, so later
    # macros can run a truncated shift schedule. None = full.
    warm_n_adi: int | None = None
    # Refresh (not rebuild) the matfree caches on macro steps after the
    # first: operator values update, preconditioners persist.
    refresh_caches: bool = True
    # Preconditioner staleness: the matfree loop probes the relres of one
    # solve on the hardest shift each macro; above relres_refresh_factor
    # * fgmres_tol the next refresh re-inverts the block-Jacobi blocks.
    # precond_refresh_every also forces it every K macros (0 = never).
    precond_refresh_every: int = 0
    relres_refresh_factor: float = 10.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rebuild_caches(m_d, a_stokes_d, j_d, conv, vnom_free, cfg: RHConfig,
                    sig):
    """The 'lu' tier's caches about vnom: re-linearization on the device,
    LUs factored on the host. Returns (stepper_lu, l1_inner, dre_cache):
      stepper: [[M/dt - A_stokes + L1(vnom), J^T], [J, 0]]
      gains:   Atil = (A_stokes - L1 - L2)(vnom) - M/(2 dt)
    """
    free = conv.free
    vnom_full = conv.expand(vnom_free)
    l1, l2 = conv.linearized_parts(vnom_full)
    l1_i = l1[free[:, None], free]
    l1l2_i = l1.add_(l2)[free[:, None], free]
    del l1, l2
    stepper_lu = SaddleLU.build(m_d / cfg.dt - a_stokes_d + l1_i, j_d)
    at_til = (a_stokes_d - l1l2_i).T - m_d / (2.0 * cfg.dt)
    dre_cache = SaddleShiftedLUCache.build(
        at_til, m_d, j_d,
        torch.as_tensor(np.asarray(sig, np.float64)).to(at_til.dtype),
    )
    return stepper_lu, l1_i, dre_cache


def _rebuild_caches_matfree(np_ops: dict, cond, vnom_free: np.ndarray,
                            cfg: RHConfig, sig, *, device, dtype,
                            prev: tuple | None = None,
                            refresh_precond: bool = False,
                            executor):
    """Host sparse re-linearization and the matrix-free (or dense_ns)
    caches for one macro step; nothing (n + n_p)^2 is formed for the
    stepper.

    prev: (stepper, dre_cache) of the previous macro step. When given,
    the caches are refreshed about the new operators: the stepper's
    saddle repacked (block-Jacobi kept, or re-inverted when
    refresh_precond), its implicit convection repacked; the DRE cache
    refreshed likewise, or NS-refreshed (dense_ns). The stepper refresh
    runs on the executor's worker thread: a Future of (stepper, seconds
    the refresh took) is returned in its place.

    Returns (NSEMatfreeStepCache or Future, dre cache)."""
    import scipy.sparse as sp

    from ..fem.taylor_hood import convection_matrices
    from ..ops.spmm_kernel import pack_spmm
    from ..solvers.matfree import SaddleMatfreeCache
    from .nse_rollout import build_nse_stepper_matfree

    full = np_ops["full"]
    vnom_full = np.zeros(full["M"].shape[0])
    vnom_full[cond.dirichlet] = cond.g
    vnom_full[cond.free] = np.asarray(vnom_free, dtype=np.float64)

    l1, l2 = convection_matrices(full, vnom_full)
    m_sp = sp.csr_matrix(np_ops["M"])
    a_lin = sp.csr_matrix(cond.mat_inner(full["A"] - l1 - l2))
    c = 1.0 / (2.0 * cfg.dt)
    at_dre = (a_lin.T - c * m_sp).tocsr()

    if prev is not None:
        stepper_prev, dre_prev = prev
        a_stokes_i = sp.csr_matrix(cond.mat_inner(full["A"]))
        l1_i = sp.csr_matrix(cond.mat_inner(l1))
        lin = (a_stokes_i - l1_i).tocsr()
        m_pre = m_sp if refresh_precond else None
        stream = (torch.cuda.current_stream(device)
                  if torch.device(device).type == "cuda" else None)

        def build_stepper():
            t0 = time.perf_counter()
            with (torch.cuda.stream(stream) if stream is not None
                  else nullcontext()):
                new = dataclasses.replace(
                    stepper_prev,
                    saddle=stepper_prev.saddle.refresh_operator(
                        (-lin).tocsr(), m_sp=m_pre
                    ),
                    l1_pack=pack_spmm(l1_i, device=device, dtype=dtype),
                )
            return new, time.perf_counter() - t0

        if isinstance(dre_prev, NSShiftStack):
            dre_new = dre_prev.refresh(at_dre)
        else:
            dre_new = dre_prev.refresh_operator(at_dre, m_sp=m_pre)
        return executor.submit(in_sanitizer(build_stepper)), dre_new

    stepper = build_nse_stepper_matfree(
        dict(np_ops, vbar_full=vnom_full), cond, cfg.dt, device=device,
        dtype=dtype, tol=cfg.fgmres_tol, max_cycles=cfg.fgmres_cycles,
    )
    j_sp = sp.csr_matrix(np_ops["J"])
    if cfg.solver == "dense_ns":
        dre_cache = NSShiftStack(at_dre, m_sp, j_sp, sig, device=device,
                                 dtype=dtype, certify_tol=NS_CERTIFY_TOL)
    else:
        dre_cache = SaddleMatfreeCache.build(
            at_dre, m_sp, j_sp, np.asarray(sig), schur_offset=-c,
            device=device, dtype=dtype, tol=cfg.fgmres_tol,
            max_cycles=cfg.fgmres_cycles,
        )
    return stepper, dre_cache


def _fingerprint(n, m, s, cfg: RHConfig, dtype, sig) -> str:
    """Config fingerprint stored in every checkpoint, salted with this
    package's name and version: a foreign or stale file (another problem
    size, horizon, dt, shift schedule, dtype or package) is refused."""
    return hashlib.sha256(repr((
        code_salt(), n, m, s, cfg.dt, cfg.horizon, cfg.apply, cfg.alpha,
        cfg.solver, str(dtype), np.asarray(sig, np.float64).tobytes(),
    )).encode()).hexdigest()[:16]


def receding_horizon_mpc(
    sys,
    conv,
    np_ops: dict,
    cond,
    cfg: RHConfig,
    sig: np.ndarray,
    sigma_seq: np.ndarray,
    idx_seq: np.ndarray,
    v0_batch: torch.Tensor,
    n_macro: int,
    metrics=None,
    profile: bool = False,
    checkpoint: str | None = None,
):
    """Run n_macro receding-horizon macro steps on sys's device in sys's
    dtype. Returns a dict: vs (S, n_macro*apply + 1, n), us (S,
    n_macro*apply, m), ks (n_macro, m, n) the gain applied in each macro,
    v_final (S, n), resumed_from, and macros, one record per macro (the
    module docstring's solve-quality fields, max_gain, mean_state_norm).

    sys: DAESystem at the initial linearization (mass, b, c reused; the
    stiff part is re-linearized every macro step per cfg.solver).
    conv: the rollout's convection (FusedConvKernel for float32 on the
    card, ConvKernel otherwise).
    profile: synchronize the device around each stage and record per
    macro the seconds {rebuild_s, dre_s, probe_s, stepper_join_s,
    rollout_s, total_s} under result['timings'], the seconds the worker
    thread's stepper refresh took beside the DRE sweep
    (stepper_refresh_s, 0 without one).
    checkpoint: optional npz path. After every macro step the loop state
    (macro index, scenario batch, warm-start gain) is written atomically;
    a later call with the same path resumes from the last completed step
    and returns only the trajectories from there (resumed_from > 0). A
    checkpoint of another config raises ValueError.
    metrics: a MetricsLogger; each macro logs an "mpc_macro_step" record.
    """
    if cfg.solver not in ("lu", "matfree", "dense_ns"):
        raise ValueError(f"unknown receding-horizon solver: {cfg.solver}")
    dtype, device = sys.b.dtype, sys.b.device
    n, m = sys.b.shape
    full = np_ops["full"]

    def on_device(x):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    vbar0 = on_device(cond.restrict(np_ops["vbar_full"]))
    if cfg.solver == "lu":
        m_d, _, j_d = sys.dense()
        a_stokes_d = on_device(cond.mat_inner(full["A"]).toarray())
        fv = on_device(cond.mat_bc_rhs(full["A"]))
        fp = on_device(cond.jmat_bc_rhs(full["J"]))

    v_batch = torch.as_tensor(v0_batch).to(device=device, dtype=dtype)
    k_prev = torch.zeros((m, n), dtype=dtype, device=device)
    fingerprint = _fingerprint(n, m, int(v_batch.shape[0]), cfg, dtype, sig)
    start_macro = 0
    if checkpoint is not None and os.path.exists(checkpoint):
        with np.load(checkpoint) as ck:
            ck_fp = str(ck["fingerprint"]) if "fingerprint" in ck else ""
            if ck_fp != fingerprint:
                raise ValueError(
                    f"checkpoint {checkpoint} fingerprint {ck_fp!r} does "
                    f"not match this run's config ({fingerprint!r}); "
                    "remove the file or fix the config"
                )
            done = int(ck["macro"])
            if 0 < done <= n_macro:
                start_macro = done
                v_batch = on_device(ck["v_batch"])
                k_prev = on_device(ck["k_prev"])

    def stamp():
        """Wall clock at a stage boundary, the device drained first under
        profile."""
        if profile:
            _sync(device)
        return time.perf_counter()

    vs_hist = [v_batch]
    us_hist, ks_hist, timings, macros = [], [], [], []
    prev_caches = None
    need_precond_refresh = False
    matfree = cfg.solver in ("matfree", "dense_ns")
    pipe_ex = ThreadPoolExecutor(1) if matfree else None
    sig_np = np.asarray(sig, np.float64)
    try:
        for macro in range(start_macro, n_macro):
            t_macro0 = stamp()
            rec = {"macro": macro}
            # vnom is only the linearization point; the feedback setpoint
            # stays the target vbar0 (regulating to the moving batch mean
            # would pin the batch wherever it happens to be).
            vnom = v_batch.mean(dim=0) if cfg.relinearize else vbar0
            if matfree:
                warm = macro > start_macro
                force_every = (
                    cfg.precond_refresh_every > 0 and warm
                    and (macro - start_macro) % cfg.precond_refresh_every == 0
                )
                rec["precond_refresh"] = bool(
                    warm and cfg.refresh_caches
                    and (need_precond_refresh or force_every)
                )
                # On refresh macros `stepper` is a Future resolving on the
                # worker thread while the DRE sweep below runs.
                stepper, dre_cache = _rebuild_caches_matfree(
                    np_ops, cond, vnom.cpu().numpy(), cfg, sig,
                    device=device, dtype=dtype,
                    prev=(prev_caches if cfg.refresh_caches and warm
                          else None),
                    refresh_precond=rec["precond_refresh"],
                    executor=pipe_ex,
                )
            else:
                stepper_lu, l1_i, dre_cache = _rebuild_caches(
                    m_d, a_stokes_d, j_d, conv, vnom, cfg, sig)
                cache = NSEStepCache(lu=stepper_lu, l1_imp=l1_i, fv=fv,
                                     fp=fp, vbar=vbar0)
            t_dre0 = stamp()
            # Warm macros run a truncated ADI schedule: the previous gain
            # seeds the Newton step close to the solution.
            n_adi_k = len(sigma_seq)
            if cfg.warm_n_adi is not None and macro > start_macro:
                n_adi_k = min(cfg.warm_n_adi, n_adi_k)
            is_ns = isinstance(dre_cache, NSShiftStack)
            _, ks = dre_backward_sweep(
                sys, dre_cache.cache() if is_ns else dre_cache, cfg.alpha,
                cfg.dt, cfg.horizon, np.asarray(sigma_seq)[:n_adi_k],
                np.asarray(idx_seq)[:n_adi_k], n_newton=cfg.n_newton,
                r_max=cfg.r_max, k_init=k_prev,
            )
            k_now = k_prev = ks[0]
            ks_hist.append(k_now)
            t_probe0 = stamp()
            if is_ns:
                rec["ns_refresh_residuals"] = list(dre_cache.residuals)
                rec["ns_refresh_worst_residual"] = max(dre_cache.residuals)
                rec["ns_refresh_rebuilds"] = dre_cache.rebuilds
            elif cfg.solver == "matfree":
                rec["fgmres_dre"] = dre_cache.stats.as_dict()
                # Staleness probe: one solve on the hardest (smallest
                # |shift|) pencil. Above relres_refresh_factor * tol the
                # next refresh re-inverts the preconditioner.
                hard_i = int(np.argmin(np.abs(sig_np)))
                _, rel = dre_cache.solve_relres(hard_i,
                                                sys.mass.matvec(vnom))
                rec["fgmres_probe_relres"] = rel
                need_precond_refresh = (
                    rel > cfg.relres_refresh_factor * cfg.fgmres_tol
                )
            t_join0 = stamp()
            t_refresh = 0.0
            if matfree:
                if isinstance(stepper, Future):
                    stepper, t_refresh = stepper.result()
                prev_caches = (stepper, dre_cache)
                # Linearized about vnom, regulating to the target vbar0.
                cache = dataclasses.replace(stepper, vbar=vbar0)
            t_roll0 = stamp()
            vs, us, _ = batched_nse_closed_loop(
                sys, conv, cache, k_now.expand(cfg.apply + 1, m, n),
                torch.zeros((cfg.apply + 1, n), dtype=dtype, device=device),
                v_batch, cfg.alpha, cfg.dt, feedback="implicit",
            )
            v_batch = vs[:, -1]
            vs_hist.append(vs[:, 1:])
            us_hist.append(us)
            if matfree:
                rec["fgmres_rollout"] = cache.saddle.stats.as_dict()
            t_end = stamp()
            if profile:
                timings.append({
                    "rebuild_s": t_dre0 - t_macro0,
                    "dre_s": t_probe0 - t_dre0,
                    "probe_s": t_join0 - t_probe0,
                    "stepper_join_s": t_roll0 - t_join0,
                    "rollout_s": t_end - t_roll0,
                    "total_s": t_end - t_macro0,
                    "stepper_refresh_s": t_refresh,
                })
            if checkpoint is not None:
                tmp = checkpoint + ".tmp.npz"
                np.savez(tmp, macro=macro + 1,
                         v_batch=v_batch.cpu().numpy(),
                         k_prev=k_prev.cpu().numpy(), fingerprint=fingerprint)
                os.replace(tmp, checkpoint)
            rec["max_gain"] = float(k_now.abs().max())
            rec["mean_state_norm"] = float(
                (v_batch - vnom[None]).norm(dim=1).mean())
            macros.append(rec)
            if metrics is not None:
                metrics.log("mpc_macro_step", step=macro, **{
                    k: v for k, v in rec.items() if k != "macro"})
    finally:
        if pipe_ex is not None:
            pipe_ex.shutdown(wait=True)

    out = {
        "vs": torch.cat([vs_hist[0][:, None]] + vs_hist[1:], dim=1),
        "us": (torch.cat(us_hist, dim=1) if us_hist
               else torch.zeros((v_batch.shape[0], 0, m), dtype=dtype,
                                device=device)),
        "ks": (torch.stack(ks_hist) if ks_hist
               else torch.zeros((0, m, n), dtype=dtype, device=device)),
        "v_final": v_batch,
        "resumed_from": start_macro,
        "macros": macros,
    }
    if profile:
        out["timings"] = timings
    return out
