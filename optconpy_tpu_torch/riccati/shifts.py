"""ADI shift selection — offline, on the host (numpy/scipy).

The parts of optconpy_tpu/riccati/shifts.py that the DRE shift
schedules reach, with the same math: the spectral interval of the
pencil (unconstrained) or of the projected pencil (constrained), shifted
by 1/(2 dt) analytically for the DRE's time-shifted pencil, and
Wachspress-optimal real log-spaced shifts over it.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def spectral_interval(a, m) -> tuple[float, float]:
    """[lo, hi] of |Re lambda| for the stable pencil (A, M), A ~ Hurwitz:
    the eigenvalues of M^{-1} A lie in [-a_max, -a_min] (symmetric case).
    Dense eigenvalues for n <= 600, ARPACK extremes above."""
    n = a.shape[0]
    if n <= 600:
        lam = np.linalg.eigvals(
            np.linalg.solve(
                m.toarray() if sp.issparse(m) else np.asarray(m),
                a.toarray() if sp.issparse(a) else np.asarray(a),
            )
        )
        re = -np.real(lam)
    else:
        a_s = sp.csc_matrix(a)
        m_s = sp.csc_matrix(m)
        # Largest-magnitude and smallest-magnitude generalized eigenvalues,
        # from a fixed ARPACK start vector so the interval repeats bit for
        # bit run to run.
        v0 = np.ones(n)
        lam_big = spla.eigs(
            a_s, k=1, M=m_s, which="LM", return_eigenvectors=False, v0=v0
        )
        lam_small = spla.eigs(
            a_s, k=1, M=m_s, sigma=0.0, which="LM", return_eigenvectors=False,
            v0=v0,
        )
        re = -np.real(np.concatenate([lam_big, lam_small]))
    re = re[re > 0]
    return float(re.min()), float(re.max())


def _nullspace_basis(j_sp, m_sp) -> np.ndarray:
    """M-orthonormal basis Theta (n, n - np) of ker J (dense, host) —
    the same construction as optconpy_tpu/golden/dae_reduce.py."""
    j = j_sp.toarray() if hasattr(j_sp, "toarray") else np.asarray(j_sp)
    m = m_sp.toarray() if hasattr(m_sp, "toarray") else np.asarray(m_sp)
    _, s, vt = np.linalg.svd(j, full_matrices=True)
    rank = int((s > s[0] * 1e-10).sum()) if len(s) else 0
    theta0 = vt[rank:].T  # orthonormal kernel basis (n, n-rank)
    gram = theta0.T @ m @ theta0
    ell = np.linalg.cholesky(gram)
    return theta0 @ np.linalg.inv(ell).T  # Theta^T M Theta = I


def spectral_interval_dae(a_sp, m_sp, j_sp) -> tuple[float, float]:
    """Spectral interval of the PROJECTED pencil (A, M) restricted to
    ker J — the spectrum that governs constrained ADI convergence.
    Dense; for moderate n only."""
    theta = _nullspace_basis(j_sp, m_sp)
    a = a_sp.toarray() if sp.issparse(a_sp) else np.asarray(a_sp)
    lam = np.linalg.eigvals(theta.T @ a @ theta)
    re = -np.real(lam)
    re = re[re > 0]
    return float(re.min()), float(re.max())


def spectral_interval_dae_cheap(a_sp, m_sp) -> tuple[float, float]:
    """Cheap large-n interval for DRE-SHIFTED constrained pencils:
    (0, a_max) with a_max from sparse ARPACK on the UNPROJECTED pencil.

    Valid for the DRE only: the time shift c = 1/(2 dt) added to both
    interval ends dwarfs the projected pencil's smallest real part, and
    a_max of the unprojected pencil bounds the projected one.
    """
    a_s = sp.csc_matrix(a_sp)
    m_s = sp.csc_matrix(m_sp)
    # Deterministic ARPACK start vector, so the shifts (and every cache
    # keyed by them) repeat run to run.
    v0 = np.ones(a_s.shape[0])
    lam_big = spla.eigs(
        a_s, k=1, M=m_s, which="LM", return_eigenvectors=False, v0=v0
    )
    a_max = float(np.max(-np.real(lam_big)))
    return 0.0, a_max


def wachspress_shifts(a_min: float, a_max: float, num: int) -> np.ndarray:
    """Log-spaced real negative shifts covering [-a_max, -a_min]:
    sigma_j = -a_min (a_max/a_min)^((2j-1)/(2J)), j = 1..J."""
    j = np.arange(1, num + 1)
    ratio = max(a_max / a_min, 1.0 + 1e-12)
    return -a_min * ratio ** ((2 * j - 1) / (2 * num))


def cycled_shifts(shifts: np.ndarray, n_iter: int) -> np.ndarray:
    """Repeat the shift set cyclically to a full ADI iteration schedule."""
    reps = int(np.ceil(n_iter / len(shifts)))
    return np.tile(shifts, reps)[:n_iter]


def dre_shifted_interval(
    a_min: float, a_max: float, dt: float
) -> tuple[float, float]:
    """Spectral interval of (A - M/(2 dt), M) from that of (A, M)."""
    c = 1.0 / (2.0 * dt)
    return a_min + c, a_max + c
