"""Differential Riccati equation — backward implicit-Euler sweep.

  -M^T X' M = A^T X M + M^T X A - M^T X B R^-1 B^T X M + C^T C,
  X(tE) = 0, R = alpha I.

Implicit Euler in X turns every backward step into a generalized ARE
with the CONSTANT time-shifted matrix  Atil = A - M/(2 dt)  and constant
term  C^T C + M^T X_{k+1} M / dt. Because Atil is time-independent, one
shifted-saddle inverse stack serves the whole sweep; each step runs a
warm-started Newton-ADI with the previous step's gain. Counterpart of
the main-path parts of optconpy_tpu/riccati/dre.py.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from .. import __version__
from ..solvers.saddle import SaddleShiftedInverseCache
from . import shifts as shiftmod
from .newton_kleinman import newton_adi_are


def dre_shift_schedule_dae(
    a_np, m_np, j_np, dt: float, num_shifts: int = 12, n_adi: int = 24,
):
    """Host shift setup for constrained systems: projected spectral
    interval of (A, M)|ker J, time-shifted analytically.

    Returns (sig, sigma_seq, idx_seq): the distinct Wachspress shifts
    and the cycled per-iteration schedule (values + cache indices).
    n <= 1200 uses the exact dense projected interval and larger n the
    cheap (0, ARPACK a_max) one (shifts.spectral_interval_dae_cheap).
    """
    if a_np.shape[0] <= 1200:
        a_min, a_max = shiftmod.spectral_interval_dae(a_np, m_np, j_np)
    else:
        a_min, a_max = shiftmod.spectral_interval_dae_cheap(a_np, m_np)
    a_min_s, a_max_s = shiftmod.dre_shifted_interval(a_min, a_max, dt)
    sig = shiftmod.wachspress_shifts(a_min_s, a_max_s, num_shifts)
    idx = np.arange(num_shifts, dtype=np.int32)
    reps = int(np.ceil(n_adi / num_shifts))
    return sig, np.tile(sig, reps)[:n_adi], np.tile(idx, reps)[:n_adi]


def _fingerprint(mat):
    """Shape, nnz and checksums of values AND sparsity pattern: two
    operators with equal values on different patterns must differ."""
    import scipy.sparse as sp

    m = sp.csr_matrix(mat)

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]

    return (
        m.shape, int(m.nnz), digest(m.data),
        digest(m.indices.astype(np.int64)), digest(m.indptr.astype(np.int64)),
    )


def inverse_stack_digest(at_til_sp, m_sp, j_sp, sig, dtype, cache_key):
    """Disk-cache digest of an inverse stack: the caller's key plus a
    fingerprint of every operator the build consumes."""
    return hashlib.sha256(
        repr((
            cache_key, np.asarray(sig, np.float64).tobytes(),
            str(np.dtype(dtype)),
            _fingerprint(at_til_sp), _fingerprint(m_sp), _fingerprint(j_sp),
        )).encode()
    ).hexdigest()[:12]


def load_or_build_inverse_stack(
    at_til_sp, m_sp, j_sp, sig, dtype, cache_key=None, cache_dir=None,
):
    """The (J, n, n) shifted-saddle inverse stack as a host numpy array.

    With a cache_key the stack is stored uncompressed under cache_dir
    (default: $OPTCONPY_TPU_CACHE, else ./data) and loaded on the next
    call with the same key and operators. Returns (inv_np, source) with
    source in {'built', 'disk'}.
    """
    path = None
    if cache_key is not None:
        digest = inverse_stack_digest(
            at_til_sp, m_sp, j_sp, sig, dtype, cache_key
        )
        d = cache_dir or os.environ.get(
            "OPTCONPY_TPU_CACHE", os.path.join(os.getcwd(), "data")
        )
        salt = "torch-v" + __version__.replace(".", "_")
        path = os.path.join(d, f"dreinv_{digest}-{salt}.npy")
        if os.path.exists(path):
            return np.load(path), "disk"
    inv_np = SaddleShiftedInverseCache.build_sparse_host(
        at_til_sp, m_sp, j_sp, np.asarray(sig), dtype=dtype
    )
    if path is not None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp.npy"
        np.save(tmp, inv_np)
        os.replace(tmp, path)
    return inv_np, "built"


def dre_backward_sweep(
    sys,
    cache: SaddleShiftedInverseCache,
    alpha: float,
    dt: float,
    nts: int,
    sigma_seq,
    idx_seq,
    n_newton: int = 2,
    r_max: int = 40,
):
    """Backward DRE sweep; returns (zs, ks) with

    zs: (nts + 1, n, r_max) low-rank factors, X_k ~= Z_k Z_k^T
        (zs[nts] = terminal = 0),
    ks: (nts + 1, m, n) feedback gains K_k = (1/alpha) B^T X_k M.

    sigma_seq / idx_seq: the cycled ADI schedule (numpy or tensors).
    Warm start: each step's Newton begins from the previous (later-time)
    step's gain; the terminal step's from zero.
    """
    n, m = sys.b.shape
    dtype, device = sys.b.dtype, sys.b.device
    sig = torch.as_tensor(sigma_seq).to(device=device, dtype=dtype)
    idx = [int(i) for i in torch.as_tensor(idx_seq).tolist()]
    inv_sqrt_dt = 1.0 / float(np.sqrt(dt))

    z = torch.zeros((n, r_max), dtype=dtype, device=device)
    k = torch.zeros((m, n), dtype=dtype, device=device)
    zs = [z]  # backward order: [terminal, X_{nts-1}, ..., X_0]
    ks = [k]
    for _ in range(nts):
        w_extra = sys.mass.matmat(z) * inv_sqrt_dt
        z, k = newton_adi_are(
            sys, cache, alpha, sig, idx,
            n_newton=n_newton, out_rank=r_max, k0=k, w_extra=w_extra,
        )
        zs.append(z)
        ks.append(k)
    return torch.stack(zs[::-1]), torch.stack(ks[::-1])
