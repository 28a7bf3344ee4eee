# Frozen copy of the parts of optconpy_tpu_torch/riccati/shifts.py and
# riccati/dre.py::_schedule that the DRE shift schedules of the cylinder
# reach, at commit 3a68254c7aaa53570d941aa3f88a196ecc19d430.
"""ADI shift selection on the host: the cheap DRE interval of a large
constrained pencil, Wachspress shifts over it and the cycled schedule."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def spectral_interval_dae_cheap(a_sp, m_sp) -> tuple[float, float]:
    """(0, a_max) with a_max from ARPACK on the unprojected pencil (A, M),
    from a fixed start vector so that it repeats run to run. Valid for
    the DRE only, whose time shift 1/(2 dt) dwarfs the smallest real
    part."""
    a_s = sp.csc_matrix(a_sp)
    m_s = sp.csc_matrix(m_sp)
    v0 = np.ones(a_s.shape[0])
    lam_big = spla.eigs(
        a_s, k=1, M=m_s, which="LM", return_eigenvectors=False, v0=v0
    )
    return 0.0, float(np.max(-np.real(lam_big)))


def wachspress_shifts(a_min: float, a_max: float, num: int) -> np.ndarray:
    """sigma_j = -a_min (a_max/a_min)^((2j-1)/(2J)), j = 1..J."""
    j = np.arange(1, num + 1)
    ratio = max(a_max / a_min, 1.0 + 1e-12)
    return -a_min * ratio ** ((2 * j - 1) / (2 * num))


def cycled_shifts(shifts: np.ndarray, n_iter: int) -> np.ndarray:
    reps = int(np.ceil(n_iter / len(shifts)))
    return np.tile(shifts, reps)[:n_iter]


def dre_schedule(a_min, a_max, dt, num_shifts, n_adi):
    """(sig, sigma_seq, idx_seq) over the DRE-shifted interval
    [a_min + 1/(2 dt), a_max + 1/(2 dt)]."""
    c = 1.0 / (2.0 * dt)
    sig = wachspress_shifts(a_min + c, a_max + c, num_shifts)
    idx = np.arange(num_shifts, dtype=np.int32)
    return sig, cycled_shifts(sig, n_adi), cycled_shifts(idx, n_adi)
