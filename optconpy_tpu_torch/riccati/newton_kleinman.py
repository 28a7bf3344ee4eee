"""Newton-Kleinman iteration for the generalized algebraic Riccati eq.

Solves  A^T X M + M^T X A - M^T X B R^-1 B^T X M + C^T C = 0  (R = alpha I)
for X ~= Z Z^T: each Newton step is one low-rank ADI Lyapunov solve with
the feedback-shifted F_j = A - B K_j, whose shifted solves are cached
once while the feedback enters through SMW. Counterpart of
optconpy_tpu/riccati/newton_kleinman.py, as a Python loop.

Gain convention: K = R^-1 B^T X M  (m, n), closed loop F = A - B K.
Newton Lyapunov RHS factor: W_j = [C^T, sqrt(alpha) K_j^T].
"""
from __future__ import annotations

import torch

from ..ops.lowrank import compress
from .lyap_adi import lowrank_adi


def gain_from_factor(z: torch.Tensor, sys, alpha: float) -> torch.Tensor:
    """K = (1/alpha) B^T Z Z^T M via tall-skinny products."""
    return ((sys.b.T @ z) @ (sys.mass.matmat(z)).T) / alpha


def newton_adi_are(
    sys,
    cache,
    alpha: float,
    sigma_seq: torch.Tensor,
    idx_seq: list[int],
    n_newton: int,
    out_rank: int,
    k0: torch.Tensor,
    w_extra: torch.Tensor,
):
    """Low-rank generalized ARE solve from the gain k0; returns (Z, K).

    cache holds the shifted solves of (A^T + sigma_j M) for the distinct
    shifts referenced by idx_seq. w_extra: (n, r) additional constant-
    term factor (the DRE's M^T Z_next / sqrt(dt)).
    """
    n = sys.b.shape[0]
    dtype, device = sys.b.dtype, sys.b.device
    k = k0
    sqrt_alpha = torch.sqrt(torch.tensor(alpha, dtype=dtype))
    z = torch.zeros((n, out_rank), dtype=dtype, device=device)
    for _ in range(n_newton):
        z_full = lowrank_adi(
            cache,
            smw_u=k.T,
            smw_v=sys.b,
            mass=sys.mass,
            w=torch.cat([sys.c.T, w_extra, sqrt_alpha * k.T], dim=1),
            sigma_seq=sigma_seq,
            idx_seq=idx_seq,
        )
        z = compress(z_full, out_rank)
        k = gain_from_factor(z, sys, alpha)
    return z, k
