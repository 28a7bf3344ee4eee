"""Saddle-point solvers: [[F, J^T], [J, 0]] systems.

Counterpart of the parts of optconpy_tpu/solvers/saddle.py on the main
path: the host scipy saddle solve used by the steady state, and the
shifted-saddle inverse cache that turns every ADI solve into one GEMM.
The velocity-block solve applies the discrete Leray projection
implicitly (iterates stay in ker J); the projector is never formed.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.lowrank import smw_solve


def solve_sadpnt_scipy(a_sp, j_sp, rhs_v, rhs_p=None):
    """Host sparse-LU saddle solve; returns (v, p)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    n = a_sp.shape[0]
    n_p = j_sp.shape[0]
    if rhs_p is None:
        rhs_p = np.zeros(n_p)
    big = sp.bmat(
        [[a_sp, j_sp.T], [j_sp, None]], format="csc"
    )
    sol = spla.spsolve(big, np.concatenate([rhs_v, rhs_p]))
    return sol[:n], sol[n:]


@dataclass(frozen=True)
class SaddleShiftedInverseCache:
    """Explicit velocity-block inverses of the shifted saddle systems
    [[A^T + sigma_i M, J^T], [J, 0]], applied as one GEMM per solve.

    inv: (J, n, n) tensor, one block per distinct shift.
    """

    inv: torch.Tensor
    n: int

    @staticmethod
    def build_sparse_host(
        at_sp, m_sp, j_sp, shifts, dtype=np.float32,
    ) -> np.ndarray:
        """Host build of the stacked (J, n, n) velocity-block inverses
        as a numpy array of `dtype` (the cacheable artifact).

        Each shift gets one splu of its saddle pencil; the identity RHS
        is solved in 512-column panels, which keeps the working set
        ~10 MB per thread instead of one dense (n+np, n) block.
        """
        panel_cols = 512
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        at_sp = sp.csr_matrix(at_sp)
        m_sp = sp.csr_matrix(m_sp)
        j_sp = sp.csr_matrix(j_sp)
        n = at_sp.shape[0]
        n_p = j_sp.shape[0]

        def one(sigma):
            big = sp.bmat(
                [[at_sp + sigma * m_sp, j_sp.T], [j_sp, None]],
                format="csc",
            )
            lu = spla.splu(big)
            inv = np.empty((n, n), dtype=np.dtype(dtype))
            rhs = np.zeros((n + n_p, panel_cols))
            for lo in range(0, n, panel_cols):
                w = min(panel_cols, n - lo)
                rhs[:, :w] = 0.0
                rhs[lo : lo + w, :w] = np.eye(w)
                inv[:, lo : lo + w] = lu.solve(rhs[:, :w])[:n]
            return inv

        # SuperLU's factor/solve release the GIL: thread the shifts.
        shifts = np.asarray(shifts, np.float64)
        workers = min(len(shifts), os.cpu_count() or 1)
        with ThreadPoolExecutor(workers) as ex:
            invs = list(ex.map(one, shifts))
        return np.stack(invs)

    def solve(self, i: int, rhs: torch.Tensor) -> torch.Tensor:
        """Velocity block of the i-th shifted saddle solve; rhs (n,) or
        (n, k)."""
        return self.inv[i][: self.n, : self.n] @ rhs

    def solve_smw(self, i: int, u: torch.Tensor, v: torch.Tensor,
                  rhs: torch.Tensor) -> torch.Tensor:
        """Feedback-shifted solve with velocity block A^T + sigma M - U V^T
        (the constraint rows are untouched by feedback)."""
        return smw_solve(lambda r: self.solve(i, r), u, v, rhs)

    def to(self, device=None, dtype=None) -> "SaddleShiftedInverseCache":
        return SaddleShiftedInverseCache(
            self.inv.to(device=device, dtype=dtype), self.n
        )
