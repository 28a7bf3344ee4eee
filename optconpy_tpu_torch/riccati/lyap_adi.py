"""Low-rank ADI for generalized Lyapunov equations — the inner engine.

Solves  F^T X M + M^T X F = -W W^T  for X ~= Z Z^T, with F = A - B K
handled through SMW on the cached shifted solves. Counterpart of
optconpy_tpu/riccati/lyap_adi.py::lowrank_adi, as a Python loop.

Iteration (real shifts sigma_i < 0):
    V_1 = (F^T + sigma_1 M)^{-1} W
    V_i = V_{i-1} - (sigma_i + sigma_{i-1}) (F^T + sigma_i M)^{-1} (M V_{i-1})
    Z   = [sqrt(-2 sigma_1) V_1, ..., sqrt(-2 sigma_J) V_J]
"""
from __future__ import annotations

import torch

from ..ops.sparse import ELL


def lowrank_adi(
    cache,
    smw_u: torch.Tensor,
    smw_v: torch.Tensor,
    mass: ELL,
    w: torch.Tensor,
    sigma_seq: torch.Tensor,
    idx_seq: list[int],
) -> torch.Tensor:
    """Run the full ADI schedule; returns Z (n, n_iter * q).

    cache: shifted solves (A^T + sigma_j M) for the DISTINCT shifts
        (solvers/saddle.py SaddleShiftedInverseCache).
    smw_u, smw_v: (n, m) low-rank feedback update, so the actual solves
        are (A^T + sigma M - smw_u smw_v^T)^{-1}.
    w: (n, q) right-hand-side factor.
    sigma_seq: (n_iter,) shift value per iteration, w's dtype/device.
    idx_seq: n_iter host ints, each iteration's shift in `cache`.
    """

    def solve(i, rhs):
        return cache.solve_smw(i, smw_u, smw_v, rhs)

    v = solve(idx_seq[0], w)
    cols = [torch.sqrt(-2.0 * sigma_seq[0]) * v]
    for it in range(1, len(idx_seq)):
        mv = mass.matmat(v)
        v = v - (sigma_seq[it] + sigma_seq[it - 1]) * solve(idx_seq[it], mv)
        cols.append(torch.sqrt(-2.0 * sigma_seq[it]) * v)
    return torch.cat(cols, dim=1)
