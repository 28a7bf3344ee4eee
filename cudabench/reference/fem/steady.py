# Frozen copy of optconpy_tpu_torch/solvers/steady.py at commit 3a68254c7aaa53570d941aa3f88a196ecc19d430, with
# solvers/saddle.py::solve_sadpnt_scipy of the same commit inlined.
"""Steady-state Navier-Stokes: Stokes -> Picard -> Newton iterations.

Host f64 scipy, the same math as optconpy_tpu/solvers/steady.py: each
iterate is a saddle-point Oseen solve with re-assembled convection. The
steady state is the linearization point of the device pipeline.

Convention (A = -nu*K is the Hurwitz Stokes operator, N(v)v the
physical convection (v.grad)v in weak form): the steady NSE reads
  A v - N(v)v + J^T p + fv0 = 0,   J v = g.
Iteration (full-dof velocity v with Dirichlet values held fixed):
  Stokes:   A v + J^T p = -fv0,                 J v = g
  Picard:  (A - L1(v)) v+ + J^T p = -fv0,       J v+ = g
  Newton:  (A - L1(v) - L2(v)) v+ + J^T p = -fv0 - N(v)v,  J v+ = g
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .condense import BCCondenser
from .taylor_hood import convection_matrices


def solve_sadpnt_scipy(a_sp, j_sp, rhs_v, rhs_p=None):
    """Host sparse-LU saddle solve; returns (v, p)."""
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


def solve_steady_nse_host(
    full_ops: dict,
    cond: BCCondenser,
    fv0_full: np.ndarray | None = None,
    n_picard: int = 12,
    n_newton: int = 12,
    tol: float = 1e-12,
    verbose: bool = False,
):
    """Returns (v_full, info). v_full includes the Dirichlet values.

    full_ops: output of fem.taylor_hood.assemble_stokes (FULL dof set).
    cond: BC condenser for the velocity space (+ pressure pinning).
    fv0_full: constant forcing on full dofs (default 0).
    """
    a_full = full_ops["A"]
    n_full = a_full.shape[0]
    if fv0_full is None:
        fv0_full = np.zeros(n_full)
    j_full = full_ops["J"]
    fp = cond.jmat_bc_rhs(j_full)

    def saddle_solve(lin_full, extra_rhs_full=None):
        a_i = cond.mat_inner(lin_full)
        rhs_v = (
            cond.mat_bc_rhs(lin_full)
            - cond.restrict(fv0_full)
        )
        if extra_rhs_full is not None:
            rhs_v = rhs_v + cond.restrict(extra_rhs_full)
        j_i = cond.jmat_inner(j_full)
        v_i, _ = solve_sadpnt_scipy(a_i, j_i, rhs_v, fp)
        return cond.expand(v_i)

    # Stokes initial guess.
    v = saddle_solve(a_full)
    res_hist = []

    def residual(v_full):
        l1, _ = convection_matrices(full_ops, v_full)
        conv = l1 @ v_full
        r_full = a_full @ v_full - conv + fv0_full
        # Momentum residual on free dofs modulo pressure gradient:
        # project out range(J^T) by solving a small least squares.
        r = cond.restrict(r_full)
        j_i = cond.jmat_inner(j_full)
        lam = sp.linalg.spsolve(
            (j_i @ j_i.T).tocsc(), j_i @ r
        )
        r = r - j_i.T @ lam
        return np.linalg.norm(r) / max(np.linalg.norm(v_full), 1e-30)

    for it in range(n_picard):
        l1, _ = convection_matrices(full_ops, v)
        v_new = saddle_solve(a_full - l1)
        dv = np.linalg.norm(v_new - v) / max(np.linalg.norm(v_new), 1e-30)
        v = v_new
        if verbose:
            print(f"picard {it}: dv={dv:.2e}")
        if dv < 1e-4:
            break

    for it in range(n_newton):
        l1, l2 = convection_matrices(full_ops, v)
        conv = l1 @ v
        v_new = saddle_solve(a_full - l1 - l2, extra_rhs_full=-conv)
        dv = np.linalg.norm(v_new - v) / max(np.linalg.norm(v_new), 1e-30)
        v = v_new
        res = residual(v)
        res_hist.append(res)
        if verbose:
            print(f"newton {it}: dv={dv:.2e} res={res:.2e}")
        if res < tol:
            break

    return v, {"residual": res_hist[-1] if res_hist else None,
               "history": res_hist}
