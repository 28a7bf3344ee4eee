"""Gain-quality check at production scale (host, f64, numpy/scipy).

Measures the projected generalized-Riccati residual of one backward DRE
step's low-rank factors, with no dense n x n object beyond tall-skinny
products. Same math as optconpy_tpu/riccati/validate.py.

Each backward implicit-Euler DRE step solves the generalized ARE

    Atil^T X M + M X Atil - M X B B^T X M / alpha + Q_k = 0,
    Atil = A - M/(2 dt),   Q_k = C^T C + M X_next M / dt,

whose Newton-final Lyapunov form with F = Atil - B K, X = Z Z^T is

    F^T X M + M X F + W W^T = 0,
    W = [C^T, M Z_next / sqrt(dt), sqrt(alpha) K^T].

On the constrained (index-2 DAE) pencil the equation holds on ker J
only, so the residual is measured through the Leray projector
Pi^T y = y - J^T (J M^-1 J^T)^-1 J M^-1 y, applied with sparse
factorizations (never formed). Returned as
||Pi^T R Pi||_2 / ||Pi^T W W^T Pi||_2.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def leray_projector(np_ops: dict):
    """y -> Pi^T y for (n, q) host blocks, from np_ops' M and J: an splu
    of M, the dense (n_p, n_p) Schur complement J M^-1 J^T and its LU.
    Build it once per operator set and pass it to dre_step_residual."""
    return _leray_projector_t(sp.csr_matrix(np_ops["M"]),
                              sp.csr_matrix(np_ops["J"]))


def _leray_projector_t(m_sp, j_sp):
    """Returns y -> Pi^T y for (n, q) blocks (host, sparse factors)."""
    m_lu = spla.splu(sp.csc_matrix(m_sp))
    jt = sp.csc_matrix(j_sp.T)
    # Schur S_p = J M^-1 J^T, dense (np x np) — np << n.
    sp_lu = sla.lu_factor(j_sp @ m_lu.solve(jt.toarray()))

    def pit(y):
        lam = sla.lu_solve(sp_lu, j_sp @ m_lu.solve(np.asarray(y)))
        return np.asarray(y) - jt @ lam

    return pit


def _stacked_residual_norm(u_parts, d_signs):
    """||R||_2 for the symmetric R = U D U^T, U = [u_parts...], where
    each (i, j, s) in d_signs adds s (U_i U_j^T + U_j U_i^T) for i != j
    and s U_i U_i^T for i == j; one thin QR of U."""
    u = np.concatenate(u_parts, axis=1)
    t = np.linalg.qr(u, mode="r")
    sizes = [p.shape[1] for p in u_parts]
    offs = np.cumsum([0] + sizes)
    d = np.zeros((t.shape[1], t.shape[1]))
    for i, j, s in d_signs:
        bi = slice(offs[i], offs[i + 1])
        bj = slice(offs[j], offs[j + 1])
        eye = s * np.eye(sizes[i], sizes[j])
        d[bi, bj] += eye
        if i != j:
            d[bj, bi] += eye.T
    mid = t @ d @ t.T
    mid = 0.5 * (mid + mid.T)
    return float(np.abs(np.linalg.eigvalsh(mid)).max())


def dre_step_residual(np_ops: dict, z_k, k_k, z_next, alpha: float,
                      dt: float, pit=None) -> float:
    """Relative projected residual of one backward DRE step's factors.

    np_ops: scipy dict with M, A, J, B, C; z_k/k_k: the step's factor
    and gain from dre_backward_sweep (host arrays of any float dtype,
    promoted to f64); z_next: the later-time factor feeding this
    step's constant term. pit: np_ops' leray_projector, built here when
    not given (the result is the same bits either way).
    """
    m_sp = sp.csr_matrix(np_ops["M"])
    a_sp = sp.csr_matrix(np_ops["A"])
    b = np.asarray(np_ops["B"], dtype=np.float64)
    c = np.asarray(np_ops["C"], dtype=np.float64)
    z = np.asarray(z_k, dtype=np.float64)
    k_gain = np.asarray(k_k, dtype=np.float64)
    zn = np.asarray(z_next, dtype=np.float64)

    # F^T Z = Atil^T Z - K^T (B^T Z)
    ft_z = a_sp.T @ z - (m_sp @ z) / (2.0 * dt) - k_gain.T @ (b.T @ z)
    w = np.concatenate(
        [c.T, (m_sp @ zn) / np.sqrt(dt), np.sqrt(alpha) * k_gain.T],
        axis=1,
    )
    if pit is None:
        pit = _leray_projector_t(m_sp, sp.csr_matrix(np_ops["J"]))
    w = pit(w)
    # Pi^T M Z = M Z holds for Z in ker J, but f32 factors only hold
    # J Z to ~1e-6: project M Z too for a clean f64 measurement.
    res = _stacked_residual_norm(
        [pit(ft_z), pit(m_sp @ z), w], [(0, 1, 1.0), (2, 2, 1.0)]
    )
    w_norm = _stacked_residual_norm([w], [(0, 0, 1.0)])
    return res / max(w_norm, 1e-300)
