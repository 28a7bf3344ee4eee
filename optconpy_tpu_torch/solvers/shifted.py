"""Shifted-system solvers: (A^T + sigma_i M) x = b for every shift i.

Counterpart of optconpy_tpu/solvers/shifted.py: one host LU (or explicit
inverse) per distinct ADI shift, reused across the whole Newton/ADI
sweep; feedback updates F = A - B K never refactor, they go through
Sherman-Morrison-Woodbury on the cached factors. `i` is a host int.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.dense import host_inverse, host_lu_factor, lu_apply, to_host64
from ..ops.lowrank import smw_solve


@dataclass(frozen=True)
class ShiftedLUCache:
    """Dense LU factors of (A^T + sigma_i M) stacked over shifts.

    lu: (J, n, n); piv: (J, n) 1-based int32.
    """

    lu: torch.Tensor
    piv: torch.Tensor

    @staticmethod
    def build(at_dense: torch.Tensor, m_dense: torch.Tensor, shifts):
        """Factor A^T + sigma_i M for every shift on the host (f64),
        cast to at_dense's device and dtype."""
        at_np, m_np = to_host64(at_dense), to_host64(m_dense)
        facs = [
            host_lu_factor(at_np + sigma * m_np, device=at_dense.device,
                           dtype=at_dense.dtype)
            for sigma in to_host64(shifts)
        ]
        return ShiftedLUCache(
            torch.stack([f[0] for f in facs]),
            torch.stack([f[1] for f in facs]),
        )

    def solve(self, i: int, rhs: torch.Tensor) -> torch.Tensor:
        """x = (A^T + sigma_i M)^{-1} rhs, rhs (n,) or (n, k)."""
        return lu_apply(self.lu[i], self.piv[i], rhs)

    def solve_smw(self, i: int, u: torch.Tensor, v: torch.Tensor,
                  rhs: torch.Tensor) -> torch.Tensor:
        """x = (A^T + sigma_i M - U V^T)^{-1} rhs via SMW on the cached LU.

        For closed-loop shifts F^T + sigma M with F = A - B K:
        U = K^T (n, m), V = B (n, m).
        """
        return smw_solve(lambda r: self.solve(i, r), u, v, rhs)


@dataclass(frozen=True)
class ShiftedInverseCache:
    """Host-built explicit inverses of (A^T + sigma_i M), applied as one
    GEMM per solve. Same solve/solve_smw contract."""

    inv: torch.Tensor  # (J, n, n)

    @staticmethod
    def build(at_dense: torch.Tensor, m_dense: torch.Tensor, shifts):
        at_np, m_np = to_host64(at_dense), to_host64(m_dense)
        return ShiftedInverseCache(torch.stack([
            host_inverse(at_np + sigma * m_np, device=at_dense.device,
                         dtype=at_dense.dtype)
            for sigma in to_host64(shifts)
        ]))

    def solve(self, i: int, rhs: torch.Tensor) -> torch.Tensor:
        return self.inv[i] @ rhs

    def solve_smw(self, i: int, u: torch.Tensor, v: torch.Tensor,
                  rhs: torch.Tensor) -> torch.Tensor:
        return smw_solve(lambda r: self.solve(i, r), u, v, rhs)
