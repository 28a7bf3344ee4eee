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

from ..ops.lowrank import COMPRESS_RTOL, compress
from ..utils.profiling import span
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
    n_newton: int = 8,
    out_rank: int = 40,
    k0: torch.Tensor | None = None,
    w_extra: torch.Tensor | None = None,
    compress_rtol: float = COMPRESS_RTOL,
):
    """Low-rank generalized ARE solve from the gain k0; returns (Z, K).

    cache holds the shifted solves of (A^T + sigma_j M) for the distinct
    shifts referenced by idx_seq. k0: (m, n) initial gain, zeros when
    None (a stable A; an unstable one needs a stabilizing k0, see
    riccati/are.py). w_extra: (n, r) additional constant-term factor
    (the DRE's M^T Z_next / sqrt(dt)), left out of W when None.
    compress_rtol: the relative singular-value cut of each step's
    compression (ops/lowrank.py compress's rtol).
    """
    with span("newton.solve"):
        n, m = sys.b.shape
        dtype, device = sys.b.dtype, sys.b.device
        k = (torch.zeros((m, n), dtype=dtype, device=device) if k0 is None
             else k0)
        sqrt_alpha = torch.sqrt(torch.tensor(alpha, dtype=dtype))
        extra = [] if w_extra is None else [w_extra]
        z = torch.zeros((n, out_rank), dtype=dtype, device=device)
        for _ in range(n_newton):
            z_full = lowrank_adi(
                cache,
                smw_u=k.T,
                smw_v=sys.b,
                mass=sys.mass,
                w=torch.cat([sys.c.T, *extra, sqrt_alpha * k.T], dim=1),
                sigma_seq=sigma_seq,
                idx_seq=idx_seq,
            )
            z = compress(z_full, out_rank=out_rank, rtol=compress_rtol)
            k = gain_from_factor(z, sys, alpha)
    return z, k
