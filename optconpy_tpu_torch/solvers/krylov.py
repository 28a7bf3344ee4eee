"""Krylov solvers and the memory-lean shifted caches built on them.

Counterpart of optconpy_tpu/solvers/krylov.py, as Python loops over
plain tensors. Right-hand sides are column blocks (n, q): every column
runs its own recurrence with per-column scalars, sharing the matvecs,
so a (n, q) solve costs the same matvec count as one column.

  * cg: conjugate gradients for SPD systems, fixed iteration count;
  * gmres: one cycle of right-preconditioned GMRES(m) that stores the
    preconditioned basis (so it is flexible); each Arnoldi step's
    modified Gram-Schmidt goes through ops/arnoldi_kernel.py::mgs_step,
    one kernel launch on the card and the same loop on the CPU;
  * fgmres: restarted gmres cycles until every column's relative
    residual is below tol. One host read of the residual per cycle; a
    residual that is not finite raises instead of ending the loop;
  * ShiftedKrylovCache / SaddleShiftedKrylovCache: a few host LUs at
    reference shifts and GMRES on the left-preconditioned shifted
    system, with the solve / solve_smw contract of the per-shift LU
    caches (riccati/lyap_adi.py consumes it).

The guards that keep float32 finite are the reference's: the Arnoldi
breakdown threshold 64 eps |beta|, the truncation of a singular R in the
small least-squares solve, unit rhs columns in fgmres and a zero initial
guess for a zero rhs column.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.arnoldi_kernel import mgs_step
from ..ops.dense import host_lu_factor, lu_apply, to_host64
from ..ops.lowrank import smw_solve
from ..utils import profiling
from ..utils.profiling import span
from .saddle import _saddle64

TINY = 1e-30  # floor of a norm used as a divisor
BREAKDOWN_EPS = 64.0  # breakdown and truncation threshold, in units of eps

# Counters (utils/profiling.py names their metrics): fgmres calls, their
# restart cycles, the calls returned above tol at max_cycles.
fgmres_solves = 0
fgmres_cycles = 0
fgmres_capped = 0


def _dotcols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-column inner products of (n, q) blocks: returns (q,)."""
    return (a * b).sum(dim=0)


def _columns(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    return (x[:, None], True) if x.ndim == 1 else (x, False)


def cg(matvec, b: torch.Tensor, x0: torch.Tensor | None = None,
       n_iter: int = 50, precond=None):
    """Conjugate gradients for SPD systems, b (n,) or (n, q).

    Fixed iteration count; a column whose denominators vanish stops
    updating (no division by ~0). Returns (x, final residual norms (q,)).
    """
    b, squeeze = _columns(b)
    x = torch.zeros_like(b) if x0 is None else _columns(x0)[0]
    pc = precond or (lambda v: v)
    r = b - matvec(x)
    z = pc(r)
    p = z
    rz = _dotcols(r, z)
    for _ in range(n_iter):
        ap = matvec(p)
        denom = _dotcols(p, ap)
        alpha = torch.where(denom.abs() > TINY, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = pc(r)
        rz_new = _dotcols(r, z)
        beta = torch.where(rz.abs() > TINY, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
    res = _dotcols(r, r).sqrt()
    return (x[:, 0], res[0]) if squeeze else (x, res)


def gmres(matvec, b: torch.Tensor, x0: torch.Tensor | None = None,
          n_iter: int = 20, precond=None):
    """One cycle of right-preconditioned GMRES(n_iter), column-batched.

    Solves A x = b with A nonsymmetric; precond approximates A^-1.
    b: (n,) or (n, q). The basis (n_iter + 1, n, q) and the
    preconditioned basis (n_iter, n, q) are stored; the least-squares
    problem is solved per column by a Householder QR of the Hessenberg
    matrix. Returns (x, final residual norms (q,)).
    """
    b, squeeze = _columns(b)
    n, q = b.shape
    dtype, device = b.dtype, b.device
    pc = precond or (lambda v: v)
    x0 = torch.zeros_like(b) if x0 is None else _columns(x0)[0]
    eps = torch.finfo(dtype).eps

    r0 = b - matvec(x0)
    beta = _dotcols(r0, r0).sqrt()  # (q,)
    safe_beta = beta.clamp_min(TINY)
    m = n_iter
    vs = torch.zeros((m + 1, n, q), dtype=dtype, device=device)
    vs[0] = r0 / safe_beta
    zs = torch.empty((m, n, q), dtype=dtype, device=device)
    h = torch.zeros((m + 1, m, q), dtype=dtype, device=device)
    for j in range(m):
        with span("krylov.arnoldi_step"):
            zs[j] = pc(vs[j])
            # Modified Gram-Schmidt against v_0..v_j, the breakdown guard,
            # H's column and v_{j+1}: one kernel launch on the card.
            mgs_step(vs, matvec(zs[j]).contiguous(), h, j, safe_beta,
                     BREAKDOWN_EPS * eps)

    # min ||beta e1 - H y|| per column by a thin QR of H (q, m+1, m):
    # normal equations would square its condition number.
    qmat, rmat = torch.linalg.qr(h.permute(2, 0, 1), mode="reduced")
    qtb = qmat[:, 0, :] * beta[:, None]
    # A singular R (breakdown columns) is TRUNCATED: rows with a
    # negligible diagonal get y_i = 0 (the Moore-Penrose choice); nudging
    # the diagonal to 1e-30 would amplify roundoff by 1e30. This also
    # zeroes legitimate directions whose diagonal sits > ~1e5 below the
    # largest in f32, which restarts recover.
    diag = rmat.diagonal(dim1=-2, dim2=-1).abs()  # (q, m)
    dmax = diag.amax(dim=-1, keepdim=True)
    sing = diag <= BREAKDOWN_EPS * eps * dmax.clamp_min(TINY)
    eye = torch.eye(m, dtype=dtype, device=device)
    rmat = torch.where(sing[..., None], eye, rmat)
    qtb = torch.where(sing, 0.0, qtb)
    y = torch.linalg.solve_triangular(rmat, qtb[..., None], upper=True)[..., 0]
    x = x0 + torch.einsum("jnq,qj->nq", zs, y)
    r = b - matvec(x)
    res = _dotcols(r, r).sqrt()
    return (x[:, 0], res[0]) if squeeze else (x, res)


def fgmres(matvec, b: torch.Tensor, precond=None, m: int = 30,
           tol: float = 1e-6, max_cycles: int = 8,
           x0: torch.Tensor | None = None):
    """Restarted flexible GMRES: gmres(m) cycles until every column's
    relative residual is <= tol, or max_cycles.

    b: (n,) or (n, q). Columns are normalized first (the system is linear
    in b): badly scaled batches are routine here, an ADI chain's late
    iterations hand this solver columns spanning 1e-13..1e-8, and with
    unit columns the solver only sees O(1) data. A zero column counts
    as converged; its warm-start column is dropped (x0 / 1e-30 would
    amplify it). Returns (x, relres), relres the final largest column
    relative residual as a Python float. Raises RuntimeError when the
    residual of a cycle is not finite.
    """
    global fgmres_solves, fgmres_cycles, fgmres_capped
    b, squeeze = _columns(b)
    bnorm = _dotcols(b, b).sqrt()
    safe = bnorm.clamp_min(TINY)
    bs = b / safe
    if x0 is None:
        x = torch.zeros_like(b)
    else:
        x = torch.where(bnorm > TINY, _columns(x0)[0] / safe, 0.0)
    fgmres_solves += 1
    rel = math.inf
    cycle = 0
    while cycle < max_cycles and rel > tol:
        with span("krylov.fgmres_cycle"):
            x, res = gmres(matvec, bs, x0=x, n_iter=m, precond=precond)
            rel = float(res.max())  # unit columns: the relative residual
        cycle += 1
        fgmres_cycles += 1
        profiling.host_reads += 1
        if not math.isfinite(rel):
            raise RuntimeError(
                f"fgmres: relative residual {rel} after cycle {cycle} of "
                f"{max_cycles} is not finite"
            )
    if rel > tol:
        fgmres_capped += 1
    x = x * safe
    return (x[:, 0], rel) if squeeze else (x, rel)


def _pick_references(shifts_np, n_ref: int):
    """Log-spaced reference shifts and the nearest reference of each
    shift (host). Returns (refs (n_ref,), idx (n_shifts,))."""
    logs = np.log(-np.asarray(shifts_np))
    lo, hi = logs.min(), logs.max()
    centers = lo + (hi - lo) * (np.arange(n_ref) + 0.5) / n_ref
    refs = -np.exp(centers)
    idx = np.argmin(np.abs(logs[:, None] - centers[None, :]), axis=1)
    return refs, idx.astype(np.int32)


@dataclass(frozen=True)
class _ReferenceLUs:
    """Host f64 LUs at reference shifts, applied on the device, and the
    per-shift offsets dsig_i = shift_i - ref_sigma[ref_idx[i]] in the
    working dtype."""

    lu: torch.Tensor  # (n_ref, N, N)
    piv: torch.Tensor  # (n_ref, N) 1-based int32
    ref_idx: list  # host ints: the reference of each shift
    dsig: torch.Tensor  # (n_shifts,)

    @staticmethod
    def build(mats, shifts, n_ref, like: torch.Tensor) -> "_ReferenceLUs":
        """mats(sigma) -> the host f64 matrix at a reference shift."""
        refs, idx = _pick_references(to_host64(shifts), n_ref)
        facs = [
            host_lu_factor(mats(s), device=like.device, dtype=like.dtype)
            for s in refs
        ]

        def cast(a):
            return torch.as_tensor(to_host64(a)).to(like.device, like.dtype)

        return _ReferenceLUs(
            torch.stack([f[0] for f in facs]),
            torch.stack([f[1] for f in facs]),
            [int(r) for r in idx],
            cast(shifts) - cast(refs)[torch.as_tensor(idx).long()],
        )

    def solve(self, i: int, rhs: torch.Tensor) -> torch.Tensor:
        r = self.ref_idx[i]
        return lu_apply(self.lu[r], self.piv[r], rhs)


@dataclass(frozen=True)
class ShiftedKrylovCache:
    """A few reference LUs + GMRES: the memory-lean ShiftedLUCache.

    Same solve/solve_smw contract as solvers.shifted.ShiftedLUCache, but
    holds n_ref (default 2) log-spaced reference factorizations instead
    of one per shift: with P = A^T + sigma_r M, GMRES runs on
    (I + dsig P^-1 M) x = P^-1 rhs, dsig = sigma_i - sigma_r.
    """

    refs: _ReferenceLUs
    mass: object  # ELL M
    n_iter: int

    @staticmethod
    def build(at_dense: torch.Tensor, mass, shifts, n_iter: int = 30,
              n_ref: int = 2) -> "ShiftedKrylovCache":
        """at_dense: (n, n) A^T; mass: ELL M; shifts: negative reals.
        Factors on the host in f64, cast to at_dense's device/dtype."""
        at_np, m_np = to_host64(at_dense), to_host64(mass.todense())
        return ShiftedKrylovCache(
            _ReferenceLUs.build(lambda s: at_np + s * m_np, shifts, n_ref,
                                at_dense),
            mass, n_iter,
        )

    def solve(self, i: int, rhs: torch.Tensor) -> torch.Tensor:
        """x = (A^T + sigma_i M)^-1 rhs by preconditioned GMRES."""
        rhs, squeeze = _columns(rhs)
        dsig = self.refs.dsig[i]

        def op(x):
            return x + dsig * self.refs.solve(i, self.mass.matmat(x))

        x, _ = gmres(op, self.refs.solve(i, rhs), n_iter=self.n_iter)
        return x[:, 0] if squeeze else x

    def solve_smw(self, i: int, u: torch.Tensor, v: torch.Tensor,
                  rhs: torch.Tensor) -> torch.Tensor:
        """(A^T + sigma_i M - U V^T)^-1 rhs via SMW on solve()."""
        return smw_solve(lambda r: self.solve(i, r), u, v, rhs)


@dataclass(frozen=True)
class SaddleShiftedKrylovCache:
    """A few reference saddle LUs + GMRES: the memory-lean
    SaddleShiftedLUCache (same solve/solve_smw contract).

    S(sigma_i) = S(sigma_r) + dsig blockdiag(M, 0); GMRES runs on
    (I + dsig S_r^-1 blockdiag(M, 0)) x = S_r^-1 [rhs; 0] over the full
    (v, p) space, so every iterate satisfies the constraint rows.
    """

    refs: _ReferenceLUs
    mass: object  # ELL M
    n: int  # velocity block size
    n_iter: int

    @staticmethod
    def build(at_dense: torch.Tensor, mass, j_dense: torch.Tensor, shifts,
              n_iter: int = 30, n_ref: int = 2) -> "SaddleShiftedKrylovCache":
        at_np, m_np = to_host64(at_dense), to_host64(mass.todense())
        return SaddleShiftedKrylovCache(
            _ReferenceLUs.build(
                lambda s: _saddle64(at_np + s * m_np, j_dense), shifts,
                n_ref, at_dense,
            ),
            mass, at_dense.shape[0], n_iter,
        )

    def solve(self, i: int, rhs: torch.Tensor) -> torch.Tensor:
        """Velocity block of the i-th shifted saddle solve (zero pressure
        rhs); rhs (n,) or (n, k)."""
        rhs, squeeze = _columns(rhs)
        n = self.n
        n_tot = self.refs.lu.shape[1]
        dsig = self.refs.dsig[i]

        def op(x_big):
            upd = x_big.new_zeros((n_tot, x_big.shape[1]))
            upd[:n] = self.mass.matmat(x_big[:n])
            return x_big + dsig * self.refs.solve(i, upd)

        rhs_big = rhs.new_zeros((n_tot, rhs.shape[1]))
        rhs_big[:n] = rhs
        x_big, _ = gmres(op, self.refs.solve(i, rhs_big), n_iter=self.n_iter)
        v = x_big[:n]
        return v[:, 0] if squeeze else v

    def solve_smw(self, i: int, u: torch.Tensor, v: torch.Tensor,
                  rhs: torch.Tensor) -> torch.Tensor:
        return smw_solve(lambda r: self.solve(i, r), u, v, rhs)
