"""Closed-loop linear (LTI) rollouts with a cached implicit-step factor.

Counterpart of optconpy_tpu/mpc/rollout.py: factor the implicit step
once on the host, then per step apply the feedback (tall-skinny
products) and one cached solve. Scenarios are batched as columns: the
state is (n, S), so each step is one solve with S right-hand sides.
"""
from __future__ import annotations

import torch

from ..ops.dense import LUSolver


def _scheme_theta(scheme: str) -> float:
    if scheme == "euler":
        return 1.0
    if scheme == "cn":
        return 0.5
    raise ValueError(f"unknown time scheme: {scheme}")


def build_step_cache(sys, dt: float, scheme: str = "euler") -> LUSolver:
    """LU of the implicit time-step system M/dt - theta A, factored once
    (theta = 1 Euler, 1/2 trapezoid / Crank-Nicolson)."""
    m_d, a_d = sys.dense()
    return LUSolver.factor(m_d / dt - _scheme_theta(scheme) * a_d)


def build_step_cache_dae(sys, dt: float, scheme: str = "euler"):
    """Saddle LU of [[M/dt - theta A, J^T], [J, 0]] for constrained
    rollouts; its apply returns the velocity block, so the rollout below
    runs unchanged for DAE systems (iterates stay in ker J)."""
    from ..solvers.saddle import SaddleLU

    m_d, a_d, j_d = sys.dense()
    return SaddleLU.build(m_d / dt - _scheme_theta(scheme) * a_d, j_d)


def _rollout_columns(sys, cache, ks, ws, v0, alpha, dt, feedback, scheme):
    """The closed loop on batch-last states v0 (n, S); returns time-major
    (vs (nts+1, n, S), us (nts, m, S), ys (nts+1, p, S))."""
    _scheme_theta(scheme)  # refuses an unknown scheme
    if feedback not in ("explicit", "implicit"):
        raise ValueError(f"unknown feedback mode: {feedback}")
    b, bt = sys.b, sys.b.T
    if scheme == "cn":
        k_seq = 0.5 * (ks[:-1] + ks[1:])
        w_seq = 0.5 * (ws[:-1] + ws[1:])
    else:
        k_seq, w_seq = ks[:-1], ws[:-1]

    def rhs_lin(v):
        r = sys.mass.matmat(v) / dt
        if scheme == "cn":
            r = r + 0.5 * sys.stiff.matmat(v)
        return r

    if feedback == "implicit":
        gmat = cache.apply(b)  # (n, m), hoisted out of the time loop
        eye_m = torch.eye(sys.m_in, dtype=gmat.dtype, device=gmat.device)
    v = v0
    vs, us = [v], []
    for k_gain, w_k in zip(k_seq, w_seq):
        uff = ((bt @ w_k) / alpha)[:, None]
        if feedback == "implicit" and scheme == "cn":
            rhs = rhs_lin(v) - 0.5 * (b @ (k_gain @ v)) + b @ uff
            x0 = cache.apply(rhs)
            s_small = eye_m + 0.5 * (k_gain @ gmat)
            corr = torch.linalg.solve(s_small, k_gain @ x0)
            v_next = x0 - 0.5 * (gmat @ corr)
            u = -0.5 * (k_gain @ (v + v_next)) + uff
        elif feedback == "implicit":
            x0 = cache.apply(rhs_lin(v) + b @ uff)
            s_small = eye_m + k_gain @ gmat
            corr = torch.linalg.solve(s_small, k_gain @ x0)
            v_next = x0 - gmat @ corr
            u = -(k_gain @ v_next) + uff
        else:
            u = -(k_gain @ v) + uff
            v_next = cache.apply(rhs_lin(v) + b @ u)
        v = v_next
        vs.append(v)
        us.append(u)
    vs = torch.stack(vs)
    return vs, torch.stack(us), sys.c @ vs


def closed_loop_rollout(sys, cache, ks: torch.Tensor, ws: torch.Tensor,
                        v0: torch.Tensor, alpha: float, dt: float,
                        feedback: str = "explicit", scheme: str = "euler"):
    """Forward closed loop of one scenario; returns (vs (nts+1, n),
    us (nts, m), ys (nts+1, p)).

    ks: (nts + 1, m, n) gains; ws: (nts + 1, n) feedforward states;
    v0: (n,). The cache must be built with the SAME scheme
    (build_step_cache(..., scheme=...)).

    scheme='euler':
      feedback='explicit':
        u_k = -K_k v_k + (1/alpha) B^T w_k
        (M/dt - A) v_{k+1} = M v_k / dt + B u_k
      feedback='implicit' (robust for cheap-control gains whose
      closed-loop poles exceed 1/dt):
        (M/dt - A + B K_k) v_{k+1} = M v_k/dt + (1/alpha) B B^T w_k
        u_k = -K_k v_{k+1} + (1/alpha) B^T w_k
      by SMW on the same cached LU: G = (M/dt - A)^-1 B is constant, so
      each step adds only an (m, m) solve.
    scheme='cn' (trapezoid), with K_mid = (K_k + K_{k+1})/2 and w_mid:
      feedback='explicit':
        u_k = -K_mid v_k + (1/alpha) B^T w_mid
        (M/dt - A/2) v_{k+1} = (M/dt + A/2) v_k + B u_k
      feedback='implicit' (trapezoid on F = A - B K_mid):
        (M/dt - A/2 + B K_mid/2) v+ = (M/dt + A/2 - B K_mid/2) v + B uff_mid
        u_k = -K_mid (v_k + v_{k+1})/2 + uff_mid
    """
    vs, us, ys = _rollout_columns(
        sys, cache, ks, ws, v0[:, None], alpha, dt, feedback, scheme
    )
    return vs[..., 0], us[..., 0], ys[..., 0]


def batched_closed_loop(sys, cache, ks: torch.Tensor, ws: torch.Tensor,
                        v0_batch: torch.Tensor, alpha: float, dt: float,
                        feedback: str = "explicit", scheme: str = "euler"):
    """closed_loop_rollout over a scenario batch v0_batch (S, n), all
    scenarios as the columns of one solve per step; gains and
    feedforward are shared. Returns scenario-major (vs (S, nts+1, n),
    us (S, nts, m), ys (S, nts+1, p))."""
    vs, us, ys = _rollout_columns(
        sys, cache, ks, ws, v0_batch.T, alpha, dt, feedback, scheme
    )
    return vs.permute(2, 0, 1), us.permute(2, 0, 1), ys.permute(2, 0, 1)
