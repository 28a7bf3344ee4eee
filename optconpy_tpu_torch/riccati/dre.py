"""Differential Riccati equation — backward implicit-Euler sweep.

  -M^T X' M = A^T X M + M^T X A - M^T X B R^-1 B^T X M + C^T C,
  X(tE) = 0, R = alpha I.

Implicit Euler in X turns every backward step into a generalized ARE
with the CONSTANT time-shifted matrix  Atil = A - M/(2 dt)  and constant
term  C^T C + M^T X_{k+1} M / dt. Because Atil is time-independent, one
shifted-saddle inverse stack serves the whole sweep; each step runs a
warm-started Newton-ADI with the previous step's gain. Counterpart of
optconpy_tpu/riccati/dre.py: host LU or explicit inverse per shift
('lu', 'inverse'), unconstrained (LTI) or saddle; the saddle inverse
stack built on the device by Newton-Schulz; and the memory-lean saddle
tiers, reference LUs + GMRES ('krylov') and matrix-free FGMRES.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from ..solvers.saddle import (
    SaddleShiftedInverseCache,
    SaddleShiftedLUCache,
)
from ..solvers.shifted import ShiftedInverseCache, ShiftedLUCache
from ..utils.cache import cache_root, code_salt
from . import shifts as shiftmod
from .newton_kleinman import newton_adi_are


def _schedule(a_min, a_max, dt, num_shifts, n_adi):
    """(sig, sigma_seq, idx_seq): Wachspress shifts over the DRE-shifted
    interval and the cycled per-iteration schedule (values + indices)."""
    a_min_s, a_max_s = shiftmod.dre_shifted_interval(a_min, a_max, dt)
    sig = shiftmod.wachspress_shifts(a_min_s, a_max_s, num_shifts)
    idx = np.arange(num_shifts, dtype=np.int32)
    return (
        sig,
        shiftmod.cycled_shifts(sig, n_adi),
        shiftmod.cycled_shifts(idx, n_adi),
    )


def dre_shift_schedule(
    a_np, m_np, dt: float, num_shifts: int = 12, n_adi: int = 24,
):
    """Host shift setup for the unconstrained DRE: the spectral interval
    of (A, M), time-shifted analytically. Returns (sig, sigma_seq,
    idx_seq)."""
    a_min, a_max = shiftmod.spectral_interval(a_np, m_np)
    return _schedule(a_min, a_max, dt, num_shifts, n_adi)


def dre_shift_schedule_dae(
    a_np, m_np, j_np, dt: float, num_shifts: int = 12, n_adi: int = 24,
    interval: tuple | None = None,
):
    """Host shift setup for constrained systems: projected spectral
    interval of (A, M)|ker J, time-shifted analytically.

    Returns (sig, sigma_seq, idx_seq): the distinct Wachspress shifts
    and the cycled per-iteration schedule (values + cache indices).
    interval: a precomputed (a_min, a_max) of (A, M) that replaces the
    spectral one. Without it, n <= 1200 uses the exact dense projected
    interval and larger n the cheap (0, ARPACK a_max) one
    (shifts.spectral_interval_dae_cheap).
    """
    if interval is not None:
        a_min, a_max = interval
    elif a_np.shape[0] <= 1200:
        a_min, a_max = shiftmod.spectral_interval_dae(a_np, m_np, j_np)
    else:
        a_min, a_max = shiftmod.spectral_interval_dae_cheap(a_np, m_np)
    return _schedule(a_min, a_max, dt, num_shifts, n_adi)


def _shifts_as(sig, like: torch.Tensor) -> torch.Tensor:
    """The shifts rounded to the cache dtype, as the reference passes
    them to its builders."""
    return torch.as_tensor(np.asarray(sig, np.float64)).to(like.dtype)


def build_dre_cache(sys, dt: float, sig, solver: str = "lu"):
    """Shifted cache of (Atil^T + sigma_j M), Atil = A - M/(2 dt), for an
    LTISystem, on its device in its dtype. solver: 'lu' (triangular
    solves) or 'inverse' (one GEMM per solve)."""
    m_d, a_d = sys.dense()
    at_til = a_d.T - m_d / (2.0 * dt)  # M symmetric
    cls = {"lu": ShiftedLUCache, "inverse": ShiftedInverseCache}[solver]
    return cls.build(at_til, m_d, _shifts_as(sig, at_til))


def build_dre_cache_dae(
    sys, dt: float, sig, solver: str = "lu",
    cache_key: str | None = None, cache_dir: str | None = None,
):
    """Shifted saddle cache of [[Atil^T + sigma M, J^T], [J, 0]] on sys's
    device in sys's dtype.

    solver: 'lu' (dense host LU per shift) or 'inverse' (velocity-block
    inverses from sparse LU, load_or_build_inverse_stack; with a
    cache_key the stack is stored under cache_dir and reloaded).
    """
    from ..ops.sparse import ell_to_scipy

    if solver == "inverse":
        m_sp = ell_to_scipy(sys.mass)
        a_sp = ell_to_scipy(sys.stiff)
        j_sp = ell_to_scipy(sys.jmat)
        at_til_sp = (a_sp.T - m_sp / (2.0 * dt)).tocsr()
        inv_np, _src = load_or_build_inverse_stack(
            at_til_sp, m_sp, j_sp, np.asarray(sig),
            torch.empty((), dtype=sys.b.dtype).numpy().dtype,
            cache_key=cache_key, cache_dir=cache_dir,
        )
        return SaddleShiftedInverseCache(
            torch.as_tensor(inv_np).to(sys.b.device), sys.n
        )
    if solver != "lu":
        raise ValueError(f"unknown DRE cache solver: {solver}")
    m_d, a_d, j_d = sys.dense()
    at_til = a_d.T - m_d / (2.0 * dt)
    return SaddleShiftedLUCache.build(at_til, m_d, j_d, _shifts_as(sig, at_til))


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
        path = os.path.join(
            cache_root(cache_dir), f"dreinv_{digest}-{code_salt()}.npy"
        )
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


def build_dre_cache_dae_ns(
    sys, dt: float, sig, certify_tol: float = 5e-4, verbose=None,
):
    """Dense shifted-saddle inverse cache of [[Atil^T + sigma M, J^T],
    [J, 0]], Atil = A - M/(2 dt), built on sys's device in sys's dtype
    by Newton-Schulz ladders (solvers/ns_inverse.py) instead of host
    splu. Memory: len(sig) * n^2 values for the stack, plus three
    (n + n_p)^2 working arrays during the build.

    Returns (cache, info); info carries the per-shift residuals and
    certification flags (build_inverse_stack_ns).
    """
    from ..ops.sparse import ell_to_scipy
    from ..solvers.ns_inverse import build_inverse_stack_ns

    m_sp = ell_to_scipy(sys.mass)
    a_sp = ell_to_scipy(sys.stiff)
    j_sp = ell_to_scipy(sys.jmat)
    at_til = (a_sp.T - m_sp / (2.0 * dt)).tocsr()
    inv_stack, info = build_inverse_stack_ns(
        at_til, m_sp, j_sp, sig, device=sys.b.device, dtype=sys.b.dtype,
        certify_tol=certify_tol, verbose=verbose,
    )
    return SaddleShiftedInverseCache(inv_stack, sys.n), info


def build_dre_cache_dae_krylov(sys, dt: float, sig, n_iter: int = 30,
                               n_ref: int = 2):
    """Memory-lean shifted saddle cache of [[Atil^T + sigma M, J^T],
    [J, 0]]: n_ref reference saddle LUs (host f64) and GMRES
    (solvers/krylov.py) instead of one LU per shift, on sys's device in
    sys's dtype."""
    from ..solvers.krylov import SaddleShiftedKrylovCache

    m_d, a_d, j_d = sys.dense()
    at_til = a_d.T - m_d / (2.0 * dt)
    return SaddleShiftedKrylovCache.build(
        at_til, sys.mass, j_d, sig, n_iter=n_iter, n_ref=n_ref
    )


def build_dre_cache_dae_matfree(
    sys, dt: float, sig, block: int = 512, m_krylov: int = 30,
    max_cycles: int = 8, tol: float = 1e-6,
):
    """Matrix-free shifted saddle cache (solvers/matfree.py): block-Jacobi
    and pressure-Schur FGMRES over the SpMM kernel, no O((n + n_p)^2)
    object, on sys's device in sys's dtype.

    The implicit-Euler time shift -1/(2 dt) is folded into Atil^T and
    passed as schur_offset, so the pressure preconditioner sees the total
    signed mass coefficient sigma - 1/(2 dt).
    """
    from ..ops.sparse import ell_to_scipy
    from ..solvers.matfree import SaddleMatfreeCache

    m_sp = ell_to_scipy(sys.mass)
    a_sp = ell_to_scipy(sys.stiff)
    j_sp = ell_to_scipy(sys.jmat)
    c = 1.0 / (2.0 * dt)
    return SaddleMatfreeCache.build(
        (a_sp.T - c * m_sp).tocsr(), m_sp, j_sp, sig, schur_offset=-c,
        device=sys.b.device, dtype=sys.b.dtype, block=block,
        m_krylov=m_krylov, max_cycles=max_cycles, tol=tol,
    )


def dre_backward_sweep(
    sys,
    cache,
    alpha: float,
    dt: float,
    nts: int,
    sigma_seq,
    idx_seq,
    n_newton: int = 2,
    r_max: int = 40,
    k_init: torch.Tensor | None = None,
):
    """Backward DRE sweep; returns (zs, ks) with

    zs: (nts + 1, n, r_max) low-rank factors, X_k ~= Z_k Z_k^T
        (zs[nts] = terminal = 0),
    ks: (nts + 1, m, n) feedback gains K_k = (1/alpha) B^T X_k M.

    cache: any shifted cache with solve_smw(i, u, v, rhs) (the LTI or
    saddle LU, inverse, Krylov and matrix-free caches). sigma_seq /
    idx_seq: the cycled ADI
    schedule (numpy or tensors).
    Warm start: each step's Newton begins from the previous (later-time)
    step's gain; the terminal step's from k_init (receding-horizon MPC
    passes the previous macro step's gain; ks[nts] is k_init), else from
    zero. The terminal factor stays 0.
    """
    n, m = sys.b.shape
    dtype, device = sys.b.dtype, sys.b.device
    sig = torch.as_tensor(sigma_seq).to(device=device, dtype=dtype)
    idx = [int(i) for i in torch.as_tensor(idx_seq).tolist()]
    inv_sqrt_dt = 1.0 / float(np.sqrt(dt))

    z = torch.zeros((n, r_max), dtype=dtype, device=device)
    k = (
        torch.zeros((m, n), dtype=dtype, device=device) if k_init is None
        else k_init.to(device=device, dtype=dtype)
    )
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
