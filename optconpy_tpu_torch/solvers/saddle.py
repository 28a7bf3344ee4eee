"""Saddle-point solvers: [[F, J^T], [J, 0]] systems.

Counterpart of optconpy_tpu/solvers/saddle.py: the host scipy saddle
solve used by the steady state; one saddle matrix factored (SaddleLU)
or inverted (SaddleInverse) on the host in f64 and applied on the
device; and the same per ADI shift (SaddleShiftedLUCache,
SaddleShiftedInverseCache, whose inverses may also come from splu or
the Newton-Schulz build on the device). The velocity-block solve applies
the discrete Leray projection implicitly (iterates stay in ker J); the
projector is never formed.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..ops.dense import (
    host_inverse,
    host_lu_factor,
    inverse64,
    lu_apply,
    to_host64,
)
from ..ops.lowrank import smw_solve
from ..utils.profiling import span

# Counter (utils/profiling.py lists its metric): the velocity-block
# inverses SaddleShiftedInverseCache.solve applied.
inverse_applies = 0


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


def _saddle64(f, j) -> np.ndarray:
    """[[F, J^T], [J, 0]] as a dense host f64 array."""
    f_np, j_np = to_host64(f), to_host64(j)
    n, n_p = f_np.shape[0], j_np.shape[0]
    big = np.zeros((n + n_p, n + n_p))
    big[:n, :n] = f_np
    big[:n, n:] = j_np.T
    big[n:, :n] = j_np
    return big


def _stack_rhs(rhs_v, rhs_p):
    """[rhs_v; rhs_p] as columns (rhs_p None = zeros) and whether the
    caller passed one vector."""
    squeeze = rhs_v.ndim == 1
    rv = rhs_v[:, None] if squeeze else rhs_v
    if rhs_p is None:
        return rv, None, squeeze
    return rv, rhs_p[:, None] if rhs_p.ndim == 1 else rhs_p, squeeze


def _pad_pressure(rv, rp, n_p):
    if rp is None:
        rp = rv.new_zeros(rv.shape[:-2] + (n_p, rv.shape[-1]))
    return torch.cat([rv, rp], dim=-2)


class _SaddleApply:
    """apply/apply_full over a subclass's `_solve(rhs_v, rhs_p)`, which
    returns the stacked (velocity; pressure) solution columns. A solver
    whose tensors carry leading batch axes (stack) solves a batch of
    saddle systems, one per leading index, against rhs with the same
    leading axes."""

    def apply(self, rhs_v: torch.Tensor, rhs_p: torch.Tensor | None = None):
        """Solve; rhs_v (n,) or (..., n, k), rhs_p None (zeros) or
        (n_p,)/(..., n_p, k). Returns the velocity block only."""
        sol, squeeze = self._solve(rhs_v, rhs_p)
        v = sol[..., : self.n, :]
        return v[..., 0] if squeeze else v

    def apply_full(self, rhs_v: torch.Tensor, rhs_p: torch.Tensor):
        """Solve returning (velocity, pressure)."""
        sol, squeeze = self._solve(rhs_v, rhs_p)
        v, p = sol[..., : self.n, :], sol[..., self.n:, :]
        return (v[..., 0], p[..., 0]) if squeeze else (v, p)

    @classmethod
    def stack(cls, solvers):
        """Solvers of one size as one whose tensors carry a leading axis,
        one index per solver."""
        return cls(**{
            f.name: (solvers[0].n if f.name == "n" else torch.stack(
                [getattr(s, f.name) for s in solvers]))
            for f in fields(cls)
        })


@dataclass(frozen=True)
class SaddleLU(_SaddleApply):
    """Dense LU of one saddle matrix, factored on the host in f64 and
    applied on the device by triangular solves.

    lu: (n+np, n+np); piv: (n+np,) 1-based int32; n: velocity block size.
    """

    lu: torch.Tensor
    piv: torch.Tensor
    n: int

    @staticmethod
    def build(f_dense: torch.Tensor, j_dense: torch.Tensor) -> "SaddleLU":
        """Host-LAPACK factorization of [[F, J^T], [J, 0]], cast to
        f_dense's device and dtype."""
        lu, piv = host_lu_factor(
            _saddle64(f_dense, j_dense), device=f_dense.device,
            dtype=f_dense.dtype,
        )
        return SaddleLU(lu, piv, f_dense.shape[0])

    def _solve(self, rhs_v, rhs_p):
        rv, rp, squeeze = _stack_rhs(rhs_v, rhs_p)
        big = _pad_pressure(rv, rp, self.lu.shape[-1] - self.n)
        return lu_apply(self.lu, self.piv, big), squeeze

    def velocity_block(self) -> torch.Tensor:
        """(..., n, n) velocity block of the inverse, by solving against
        the identity with a zero pressure rhs."""
        eye = torch.eye(self.n, dtype=self.lu.dtype, device=self.lu.device)
        return self.apply(eye.expand(self.lu.shape[:-2] + (self.n, self.n)))


@dataclass(frozen=True)
class SaddleInverse(_SaddleApply):
    """Explicit saddle inverse applied as one GEMM per solve, computed on
    the host in f64 and cast. Same apply contract as SaddleLU."""

    inv: torch.Tensor  # (n+np, n+np)
    n: int

    @staticmethod
    def build(f_dense: torch.Tensor, j_dense: torch.Tensor) -> "SaddleInverse":
        return SaddleInverse(
            host_inverse(_saddle64(f_dense, j_dense), device=f_dense.device,
                         dtype=f_dense.dtype),
            f_dense.shape[0],
        )

    def _solve(self, rhs_v, rhs_p):
        rv, rp, squeeze = _stack_rhs(rhs_v, rhs_p)
        big = _pad_pressure(rv, rp, self.inv.shape[-1] - self.n)
        return self.inv @ big, squeeze

    def velocity_block(self) -> torch.Tensor:
        """(..., n, n) velocity block of the inverse: a view, no copy."""
        return self.inv[..., : self.n, : self.n]


def _shifted_saddles(at_dense, m_dense, j_dense, shifts):
    """The host f64 saddle matrices [[A^T + sigma M, J^T], [J, 0]]."""
    at_np, m_np = to_host64(at_dense), to_host64(m_dense)
    for sigma in to_host64(shifts):
        yield _saddle64(at_np + sigma * m_np, j_dense)


@dataclass(frozen=True)
class SaddleShiftedLUCache:
    """Dense LUs of [[A^T + sigma_i M, J^T], [J, 0]] over shifts, factored
    on the host. Same solve/solve_smw contract as ShiftedLUCache on the
    constrained velocity space: every solve keeps its result in ker J.

    lu: (J, n+np, n+np); piv: (J, n+np) 1-based int32.
    """

    lu: torch.Tensor
    piv: torch.Tensor
    n: int

    @staticmethod
    def build(at_dense, m_dense, j_dense, shifts) -> "SaddleShiftedLUCache":
        facs = [
            host_lu_factor(big, device=at_dense.device, dtype=at_dense.dtype)
            for big in _shifted_saddles(at_dense, m_dense, j_dense, shifts)
        ]
        return SaddleShiftedLUCache(
            torch.stack([f[0] for f in facs]),
            torch.stack([f[1] for f in facs]),
            at_dense.shape[0],
        )

    def solve(self, i: int, rhs: torch.Tensor) -> torch.Tensor:
        """Velocity block of the i-th shifted saddle solve (zero pressure
        rhs); rhs (n,) or (n, k)."""
        rv, _, squeeze = _stack_rhs(rhs, None)
        big = _pad_pressure(rv, None, self.lu.shape[1] - self.n)
        v = lu_apply(self.lu[i], self.piv[i], big)[: self.n]
        return v[:, 0] if squeeze else v

    def solve_smw(self, i: int, u: torch.Tensor, v: torch.Tensor,
                  rhs: torch.Tensor) -> torch.Tensor:
        """Feedback-shifted saddle solve with velocity block
        A^T + sigma M - U V^T (the constraint rows are untouched)."""
        return smw_solve(lambda r: self.solve(i, r), u, v, rhs)


@dataclass(frozen=True)
class SaddleShiftedInverseCache:
    """Explicit velocity-block inverses of the shifted saddle systems
    [[A^T + sigma_i M, J^T], [J, 0]], applied as one GEMM per solve.

    inv: (J, n, n) tensor, one block per distinct shift.
    """

    inv: torch.Tensor
    n: int

    @staticmethod
    def build(at_dense, m_dense, j_dense, shifts) -> "SaddleShiftedInverseCache":
        """Dense host f64 inverses of the shifted saddles, cast to
        at_dense's device and dtype; the velocity blocks are kept."""
        n = at_dense.shape[0]
        inv = np.stack([
            inverse64(big)[:n, :n]
            for big in _shifted_saddles(at_dense, m_dense, j_dense, shifts)
        ])
        return SaddleShiftedInverseCache(
            torch.as_tensor(inv).to(device=at_dense.device,
                                    dtype=at_dense.dtype),
            n,
        )

    @staticmethod
    def build_sparse_host(
        at_sp, m_sp, j_sp, shifts, dtype=np.float32, panel_cols=512,
    ) -> np.ndarray:
        """Host build of the stacked (J, n, n) velocity-block inverses
        as a numpy array of `dtype` (the cacheable artifact).

        Each shift gets one splu of its saddle pencil; the identity RHS
        is solved in panel_cols-column panels (512: a working set of
        ~10 MB per thread instead of one dense (n+np, n) block). The
        inverses are the same for any panel width.
        """
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

    @staticmethod
    def build_sparse(at_sp, m_sp, j_sp, shifts, *, device,
                     dtype=torch.float32) -> "SaddleShiftedInverseCache":
        """build_sparse_host's inverses (f64 on the host: one splu a
        shift) cast once to `dtype` on `device`."""
        invs = SaddleShiftedInverseCache.build_sparse_host(
            at_sp, m_sp, j_sp, shifts, dtype=np.float64
        )
        return SaddleShiftedInverseCache(
            torch.from_numpy(invs).to(device=device, dtype=dtype),
            at_sp.shape[0],
        )

    def solve(self, i: int, rhs: torch.Tensor) -> torch.Tensor:
        """Velocity block of the i-th shifted saddle solve; rhs (n,) or
        (n, k). One apply of the block: one GEMM (GEMV for a vector)."""
        global inverse_applies

        inverse_applies += 1
        with span("inverse.solve"):
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
