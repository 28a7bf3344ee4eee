"""LQR feedback + tracking feedforward.

Counterpart of optconpy_tpu/control/lqr.py. The DRE sweep reduces its
factors to gains K_k = alpha^-1 B^T X_k M, so a rollout only does
tall-skinny products; the tracking feedforward w_k solves the backward
affine costate system
 (M^T/dt - F_k^T) w_k = M^T w_{k+1}/dt + C^T ystar_k,  F_k = A - B K_k,
on ONE cached LU of (M^T/dt - A^T) (a saddle LU for constrained
systems), the time-varying feedback entering through SMW.
"""
from __future__ import annotations

import torch

from ..ops.dense import LUSolver
from ..ops.lowrank import smw_solve


def build_costate_cache(sys, dt: float) -> LUSolver:
    """LU of (M^T/dt - A^T) for the backward feedforward sweep (host
    LAPACK f64, cast to sys's device and dtype)."""
    m_d, a_d = sys.dense()
    return LUSolver.factor(m_d.T / dt - a_d.T)


def build_costate_cache_dae(sys, dt: float):
    """Saddle LU of [[M^T/dt - A^T, J^T], [J, 0]]: the adjoint DAE's
    feedforward sweep (the costate w also lives in ker J)."""
    from ..solvers.saddle import SaddleLU

    m_d, a_d, j_d = sys.dense()
    return SaddleLU.build(m_d.T / dt - a_d.T, j_d)


def feedforward_sweep(sys, cache, ks: torch.Tensor, ystar: torch.Tensor,
                      dt: float) -> torch.Tensor:
    """Backward implicit-Euler tracking sweep; returns ws (nts+1, n).

    ks: (nts + 1, m, n) gains from dre_backward_sweep.
    ystar: (nts + 1, p) target outputs on the time grid.
    ws[nts] = 0 (no terminal cost).
    """
    nts = ks.shape[0] - 1
    ct = sys.c.T
    ws = torch.zeros((nts + 1, sys.n), dtype=sys.b.dtype, device=sys.b.device)
    for k in range(nts - 1, -1, -1):
        rhs = sys.mass.matvec(ws[k + 1]) / dt + ct @ ystar[k]
        # (M^T/dt - A^T + K^T B^T) w = rhs  ==  (cached - U V^T) with
        # U = -K^T, V = B  (smw_solve solves (A_c - U V^T) x = b).
        ws[k] = smw_solve(cache.apply, -ks[k].T, sys.b, rhs)
    return ws


def control_input(sys, alpha: float, k_gain: torch.Tensor,
                  w_k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u = -K v + (1/alpha) B^T w  (tracking-LQR input)."""
    return -(k_gain @ v) + (sys.b.T @ w_k) / alpha
