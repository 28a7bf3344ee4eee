# Frozen copy of optconpy_tpu_torch/fem/condense.py at commit 3a68254c7aaa53570d941aa3f88a196ecc19d430, kept
# here so that a later change to the port cannot move the yardstick; less
# the functions the cylinder wake does not reach.
"""Dirichlet condensation — the reference's condense_sysmatsbybcs contract.

(SURVEY.md SS2 row 3): eliminate Dirichlet velocity dofs from the
assembled operators, producing the inner (free-dof) system plus the
BC contributions to the right-hand sides:

    A_ii v_i = f_i - A_ig g          (momentum rows)
    J_i  v_i = -J_g g                (continuity rows)

Also pins one pressure dof (enclosed flows: pressure unique up to a
constant) by dropping its row from J. All host-side numpy/scipy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp


@dataclass(frozen=True)
class BCCondenser:
    """Index bookkeeping for velocity Dirichlet BCs + pressure pinning."""

    free: np.ndarray  # (nf,) indices of free velocity dofs
    dirichlet: np.ndarray  # (nd,) indices of constrained dofs
    g: np.ndarray  # (nd,) boundary values
    press_keep: np.ndarray  # (np-1,) kept pressure dofs

    @staticmethod
    def build(n_vdofs: int, dirichlet_mask: np.ndarray, g_full: np.ndarray,
              n_press: int, pin_pressure: bool = True) -> "BCCondenser":
        dirichlet = np.where(dirichlet_mask)[0]
        free = np.where(~dirichlet_mask)[0]
        keep = np.arange(1 if pin_pressure else 0, n_press)
        return BCCondenser(
            free.astype(np.int64),
            dirichlet.astype(np.int64),
            np.asarray(g_full)[dirichlet],
            keep.astype(np.int64),
        )

    def mat_inner(self, a):
        return sp.csr_matrix(a)[self.free][:, self.free]

    def mat_bc_rhs(self, a):
        """-A[free, dirichlet] @ g — momentum-row BC contribution."""
        return -sp.csr_matrix(a)[self.free][:, self.dirichlet] @ self.g

    def jmat_inner(self, j):
        return sp.csr_matrix(j)[self.press_keep][:, self.free]

    def jmat_bc_rhs(self, j):
        """-J[kept, dirichlet] @ g — continuity-row BC contribution."""
        return -sp.csr_matrix(j)[self.press_keep][:, self.dirichlet] @ self.g

    def expand(self, v_inner: np.ndarray) -> np.ndarray:
        """Lift an inner vector back to the full velocity dof set."""
        out_shape = (len(self.free) + len(self.dirichlet),) + v_inner.shape[1:]
        full = np.zeros(out_shape, v_inner.dtype)
        full[self.free] = v_inner
        full[self.dirichlet] = self.g.reshape(
            (-1,) + (1,) * (v_inner.ndim - 1)
        )
        return full

    def restrict(self, v_full: np.ndarray) -> np.ndarray:
        return np.asarray(v_full)[self.free]
