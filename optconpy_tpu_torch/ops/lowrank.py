"""Low-rank factor utilities on tensors: tall-skinny QR, truncation, SMW.

Counterpart of optconpy_tpu/ops/lowrank.py. Factors keep a fixed
(n, r) width whose trailing columns are exactly zero when unused, so
the DRE sweep's buffers never change shape.
"""
from __future__ import annotations

import torch

from ..utils import profiling
from ..utils.profiling import span


def tsqr_cholqr2(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """CholeskyQR2 for tall-skinny Z (n, r): two Gram+Cholesky passes.

    Accurate to ~machine eps for cond(Z) < 1/sqrt(eps). Zero columns
    are handled by regularizing the Gram diagonal; the corresponding R
    rows stay ~0.
    """
    r = z.shape[1]
    finfo = torch.finfo(z.dtype)
    eye = torch.eye(r, dtype=z.dtype, device=z.device)

    def _pass(zz):
        g = zz.T @ zz
        # Regularize so all-zero (masked) columns don't break Cholesky.
        shift = finfo.eps * torch.trace(g) + finfo.tiny
        c = torch.linalg.cholesky(g + shift * eye)
        q = torch.linalg.solve_triangular(c, zz.T, upper=False).T
        return q, c.T  # R upper triangular

    q1, r1 = _pass(z)
    q2, r2 = _pass(q1)
    return q2, r2 @ r1


# The relative singular-value cut the Newton-ADI solves pass to
# compress (newton_adi_are's and dre_backward_sweep's compress_rtol).
COMPRESS_RTOL = 1e-9


def compress(z: torch.Tensor, out_rank: int | None = None,
             rtol: float = 1e-8, method: str = "qr") -> torch.Tensor:
    """Column-compress a low-rank factor, keeping a fixed shape.

    Z (n, r) -> Z' (n, out_rank or min(n, r)) with Z'Z'^T ~= ZZ^T: thin
    QR (tsqr with `method`; 'qr' when n < r), SVD of the small R factor,
    drop singular values < rtol * s_max by zeroing (dropped columns
    become exact zeros). Columns come out ordered by decreasing singular
    value, so truncating to out_rank keeps the dominant subspace; a
    wider out_rank pads with zeros.
    """
    with span("lowrank.compress"):
        n, r = z.shape
        q, rr = tsqr(z, method=method if n >= r else "qr")
        # On CUDA, cuSOLVER's default SVD driver (Jacobi) left the f32 DRE
        # gains 1.1e-3 from f64 at the bench shape on an H100; the QR-based
        # gesvd gave 1.9e-6, and ran faster. The driver exists only on
        # CUDA.
        driver = "gesvd" if rr.is_cuda else None
        u, s, _ = torch.linalg.svd(rr, full_matrices=False, driver=driver)
        profiling.host_reads += 1  # the SVD checks its result on the host
        s_masked = torch.where(s > rtol * s[0], s, torch.zeros_like(s))
        zc = q @ (u * s_masked[None, :])
    k = zc.shape[1]  # = min(n, r)
    if out_rank is None or out_rank <= k:
        return zc[:, :out_rank]
    return torch.nn.functional.pad(zc, (0, out_rank - k))


def smw_solve(ainv_apply, u: torch.Tensor, v: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """Sherman-Morrison-Woodbury: solve (A - U V^T) x = b.

    `ainv_apply(rhs)` applies A^{-1}; one factorization (here an
    explicit inverse) of A serves all feedback-shifted solves A - B K^T.
    """
    aib = ainv_apply(b)
    aiu = ainv_apply(u)
    r = u.shape[1]
    cap = torch.eye(r, dtype=b.dtype, device=b.device) - v.T @ aiu
    profiling.host_reads += 1  # linalg.solve checks its result on the host
    return aib + aiu @ torch.linalg.solve(cap, v.T @ aib)


def tsqr(z: torch.Tensor, method: str = "qr") -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Thin QR of a tall-skinny Z (n, r): Householder ('qr') or
    CholeskyQR2 ('cholqr2')."""
    if method == "cholqr2":
        return tsqr_cholqr2(z)
    return torch.linalg.qr(z, mode="reduced")


def append_columns(z: torch.Tensor, v: torch.Tensor,
                   ncols: int) -> tuple[torch.Tensor, int]:
    """Append v's columns into the first free slots of the fixed-width
    buffer z: z (n, r_max) with columns [0, ncols) used, v (n, rv).
    Returns a new buffer and the new column count; raises when v does
    not fit."""
    rv = v.shape[1]
    if ncols + rv > z.shape[1]:
        raise ValueError(f"{rv} columns do not fit after {ncols} of "
                         f"{z.shape[1]}")
    out = z.clone()
    out[:, ncols:ncols + rv] = v.to(z.dtype)
    return out, ncols + rv


def lowrank_matvec(z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Z Z^T) @ x via two tall-skinny products (never forms ZZ^T)."""
    return z @ (z.T @ x)
