"""Matrix-free shifted saddle solves: no O((n + n_p)^2) object anywhere.

Counterpart of optconpy_tpu/solvers/matfree.py. Every solve of
[[A^T + s_i M, J^T], [J, 0]] is restarted FGMRES (solvers/krylov.py)
whose large-n primitives are

  * the saddle apply of solvers/ns_inverse.py over the SpMM kernel
    (ops/spmm_kernel.py, four launches) in an RCM velocity ordering with
    window-sorted pressure rows (SaddleOpsPack);
  * a block-Jacobi velocity preconditioner: dense inverses of the
    diagonal blocks of F_i = A^T + s_i M in that ordering, applied as one
    batched (nb, B, B) @ (nb, B, q) product (torch.bmm), O(n B) memory
    per shift;
  * a pressure Schur preconditioner: the Schur complement of
    [[F_i, J^T], [J, 0]] is S ~ -(1/s_i) L_p with L_p = J diag(M)^-1 J^T
    (the mass-dominated limit), so S^-1 ~ -s_i L_p^-1 with one dense
    (n_p, n_p) inverse shared by all shifts (one more SpMM launch).

diag(M), not row-sum lumping: the row sums of a P2 velocity mass matrix
vanish at the vertices.

Contract: solve(i, rhs) / solve_smw(i, u, v, rhs) as the saddle LU
caches (consumed by riccati/lyap_adi.py); apply / apply_full as SaddleLU
(consumed by mpc/nse_rollout.py), with an optional warm start. Inputs
and outputs are in the original dof order; the orderings are applied at
the boundary.

FGMRES stops at max_cycles without raising. Every solve of a cache adds
the relative residual it reached to the cache's FgmresStats record
(from the one host read a restart cycle that fgmres makes anyway), so a
caller can see how many solves ended above tol and how far.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.lowrank import smw_solve
from ..ops.spmm_kernel import pack_spmm, spmm
from ..utils.profiling import span
from .krylov import fgmres
from .ns_inverse import (
    SaddleOpsPack,
    _apply_big,
    count_sparse,
    ordered_operators,
)


def _block_jacobi_inverses(f_sp, block: int, n_pad: int) -> np.ndarray:
    """Dense f64 inverses of the diagonal blocks of f_sp (host); the rows
    past n get identity blocks, so the batched apply has one shape."""
    import scipy.sparse as sp

    f_csr = sp.csr_matrix(f_sp)
    n = f_csr.shape[0]
    nb = n_pad // block
    blocks = np.tile(np.eye(block), (nb, 1, 1))
    for t in range(nb):
        lo, hi = t * block, min((t + 1) * block, n)
        if lo >= n:
            break
        w = hi - lo
        blocks[t, :w, :w] = f_csr[lo:hi, :][:, lo:hi].toarray()
    return np.linalg.inv(blocks)


@dataclass
class FgmresStats:
    """Record of a cache's FGMRES solves: the relative residual each
    reached, hence how many solves, the worst, and how many ended above
    tol (at the cycle cap). Mutable and held by reference, so the frozen
    cache can feed it."""

    tol: float
    relres: list = field(default_factory=list)

    def record(self, relres: float) -> None:
        self.relres.append(relres)

    @property
    def solves(self) -> int:
        return len(self.relres)

    @property
    def worst_relres(self) -> float:
        return max(self.relres, default=0.0)

    @property
    def above_tol(self) -> int:
        return sum(r > self.tol for r in self.relres)

    def as_dict(self) -> dict:
        return {"tol": self.tol, "solves": self.solves,
                "worst_relres": self.worst_relres,
                "above_tol": self.above_tol}


@dataclass(frozen=True)
class SaddleMatfreeCache:
    """Shifted saddle solves [[A^T + s_i M, J^T], [J, 0]] by block-Jacobi
    and pressure-Schur preconditioned FGMRES (module docstring).

    ops: the device packs in the permuted ordering; bj_inv (n_shifts, nb,
    block, block) block-Jacobi inverses; lp_inv (n_p, n_p) the inverse
    of J diag(M)^-1 J^T; shifts / schur_coeffs: each shift's mass
    coefficient and the total signed mass coefficient that scales the
    Schur preconditioner, as Python floats rounded to the working dtype;
    perm, p_perm (and their inverses): original -> permuted gather
    indices on the device.
    """

    ops: SaddleOpsPack
    bj_inv: torch.Tensor
    lp_inv: torch.Tensor
    shifts: tuple
    schur_coeffs: tuple
    perm: torch.Tensor
    iperm: torch.Tensor
    p_perm: torch.Tensor
    p_iperm: torch.Tensor
    block: int
    m_krylov: int
    max_cycles: int
    tol: float
    stats: FgmresStats = field(default=None, compare=False)

    def __post_init__(self):
        if self.stats is None:
            object.__setattr__(self, "stats", FgmresStats(self.tol))

    @property
    def n(self) -> int:
        return self.ops.n

    @property
    def n_p(self) -> int:
        return self.ops.n_p

    @staticmethod
    def build(at_sp, m_sp, j_sp, shifts, schur_offset: float = 0.0,
              dtype=torch.float32, block: int = 512, m_krylov: int = 30,
              max_cycles: int = 8, tol: float = 1e-6, *,
              device) -> "SaddleMatfreeCache":
        """Host setup (scipy, f64), then the packs and inverses on
        `device` in `dtype`.

        at_sp: (n, n) scipy A^T (pass the forward operator for forward
            saddle steps); F_i = at_sp + shifts[i] M.
        schur_offset: added to each shift for the Schur scaling, when
            at_sp already holds a mass shift (the DRE folds -1/(2 dt)
            into it and passes +(-1/(2 dt)) here).
        """
        import scipy.sparse as sp

        at_r, m_r, j_r, perm, p_perm = ordered_operators(at_sp, m_sp, j_sp)
        n = at_r.shape[0]
        shifts_np = np.atleast_1d(np.asarray(shifts, dtype=np.float64))
        n_pad = -(-n // block) * block
        bj = np.stack([
            _block_jacobi_inverses(at_r + s * m_r, block, n_pad)
            for s in shifts_np
        ])
        # L_p = J diag(M)^-1 J^T with diag, NOT row-sum lumping.
        lp = (j_r @ sp.diags(1.0 / m_r.diagonal()) @ j_r.T).toarray()

        def dev(x, dt=dtype):
            x = np.ascontiguousarray(x)  # the RCM order is a reversed view
            return torch.as_tensor(x).to(device=device, dtype=dt)

        def rounded(x):
            return tuple(torch.as_tensor(x).to(dtype).tolist())

        return SaddleMatfreeCache(
            ops=SaddleOpsPack.pack(at_r, m_r, j_r, device=device,
                                   dtype=dtype),
            bj_inv=dev(bj),
            lp_inv=dev(np.linalg.inv(lp)),
            shifts=rounded(shifts_np),
            schur_coeffs=rounded(shifts_np + schur_offset),
            perm=dev(perm, torch.long),
            iperm=dev(np.argsort(perm), torch.long),
            p_perm=dev(p_perm, torch.long),
            p_iperm=dev(np.argsort(p_perm), torch.long),
            block=block,
            m_krylov=m_krylov,
            max_cycles=max_cycles,
            tol=tol,
        )

    def refresh_operator(self, at_sp_new, m_sp=None) -> "SaddleMatfreeCache":
        """The cache for a new A^T on the same mesh (M, J, orderings and
        the Schur inverse unchanged): repacks A^T and by default keeps the
        block-Jacobi preconditioner. FGMRES holds each solve to its
        tolerance against the new operator within max_cycles, so a stale
        preconditioner changes iteration counts, or leaves solves above
        tol at the cycle cap. The new cache starts its own FgmresStats
        record: each operator's solves are counted apart.

        m_sp: pass M to also re-invert the block-Jacobi blocks about the
        new operator, from float32-rounded operators (the preconditioner
        needs no float64), for callers that drift far from the build
        point.
        """
        import scipy.sparse as sp

        perm = self.perm.cpu().numpy()
        at_r = sp.csr_matrix(at_sp_new)[perm][:, perm].tocsr()
        device, dtype = self.bj_inv.device, self.bj_inv.dtype
        new = {"ops": dataclasses.replace(
            self.ops, at=pack_spmm(at_r, device=device, dtype=dtype)
        )}
        if m_sp is not None:
            m_r = sp.csr_matrix(m_sp)[perm][:, perm].tocsr().astype(np.float32)
            at32 = at_r.astype(np.float32)
            n_pad = self.bj_inv.shape[1] * self.block
            bj = np.stack([
                _block_jacobi_inverses(at32 + s * m_r, self.block, n_pad)
                for s in np.asarray(self.shifts, np.float32)
            ])
            new["bj_inv"] = torch.as_tensor(bj).to(device=device, dtype=dtype)
        return dataclasses.replace(self, stats=None, **new)

    # ---- internals (in the permuted ordering) ----

    def _bj_apply(self, bj_i: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Block-diagonal solve: one batched (nb, B, B) @ (nb, B, q)."""
        n, q = x.shape
        nb = bj_i.shape[0]
        xp = x.new_zeros((nb * self.block, q))
        xp[:n] = x
        return torch.bmm(bj_i, xp.view(nb, self.block, q)).view(-1, q)[:n]

    def _solve_perm(self, i: int, rv: torch.Tensor, rp: torch.Tensor,
                    x0: torch.Tensor | None = None):
        """FGMRES on the permuted saddle system; rv (n, q), rp (n_p, q).
        Returns (v, p, relres) in the permuted ordering."""
        s_i = self.shifts[i]
        sc_i = self.schur_coeffs[i]
        bj_i = self.bj_inv[i]
        n = self.n

        def kop(xb):
            with span("matfree.apply"):
                return _apply_big(self.ops, s_i, xb)

        def prec(xb):
            with span("matfree.precond"):
                # S^-1 ~ -s L_p^-1 (signed: s is the total mass coefficient)
                p = -sc_i * (self.lp_inv @ xb[n:])
                count_sparse(self.ops.jt, p)
                v = self._bj_apply(bj_i, xb[:n] - spmm(self.ops.jt, p))
                return torch.cat([v, p])

        x, rel = fgmres(
            kop, torch.cat([rv, rp]), precond=prec, m=self.m_krylov,
            tol=self.tol, max_cycles=self.max_cycles, x0=x0,
        )
        self.stats.record(rel)
        return x[:n], x[n:], rel

    # ---- public contract (original dof order) ----

    def solve_relres(self, i: int, rhs: torch.Tensor):
        """(x_v, relres) with [[A^T + s_i M, J^T], [J, 0]] [x_v; p] =
        [rhs; 0]: the solve and the FGMRES relative residual it reached
        (FGMRES stops at max_cycles without raising; stats records it, as
        for every solve)."""
        squeeze = rhs.ndim == 1
        if squeeze:
            rhs = rhs[:, None]
        with span("matfree.solve"):
            rp = rhs.new_zeros((self.n_p, rhs.shape[1]))
            v, _, rel = self._solve_perm(i, rhs[self.perm], rp)
            v = v[self.iperm]
        return (v[:, 0] if squeeze else v), rel

    def solve(self, i: int, rhs: torch.Tensor) -> torch.Tensor:
        """x_v with [[A^T + s_i M, J^T], [J, 0]] [x_v; p] = [rhs; 0]."""
        return self.solve_relres(i, rhs)[0]

    def solve_smw(self, i: int, u: torch.Tensor, v: torch.Tensor,
                  rhs: torch.Tensor) -> torch.Tensor:
        """Saddle solve with velocity block A^T + s_i M - U V^T, by SMW on
        solve()."""
        return smw_solve(lambda r: self.solve(i, r), u, v, rhs)

    def apply(self, rhs_v: torch.Tensor, rhs_p: torch.Tensor | None = None,
              i: int = 0, x0: tuple | None = None) -> torch.Tensor:
        """SaddleLU.apply: the velocity solution for a full saddle rhs
        (rhs_p None = zeros)."""
        if rhs_p is None:
            rhs_p = rhs_v.new_zeros((self.n_p,) + tuple(rhs_v.shape[1:]))
        return self.apply_full(rhs_v, rhs_p, i=i, x0=x0)[0]

    def apply_full(self, rhs_v: torch.Tensor, rhs_p: torch.Tensor,
                   i: int = 0, x0: tuple | None = None):
        """(v, p) for the full saddle rhs (rhs_v, rhs_p). x0: an optional
        warm start (v0, p0) in the original order (a transient stepper
        passes the previous step's solution)."""
        squeeze = rhs_v.ndim == 1
        if squeeze:
            rhs_v, rhs_p = rhs_v[:, None], rhs_p[:, None]
        with span("matfree.solve"):
            x0_perm = None
            if x0 is not None:
                v0, p0 = x0
                if squeeze:
                    v0, p0 = v0[:, None], p0[:, None]
                x0_perm = torch.cat([v0[self.perm], p0[self.p_perm]])
            v, p, _ = self._solve_perm(
                i, rhs_v[self.perm], rhs_p[self.p_perm], x0=x0_perm
            )
            v, p = v[self.iperm], p[self.p_iperm]
        return (v[:, 0], p[:, 0]) if squeeze else (v, p)
