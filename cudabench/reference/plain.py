"""The plain reference of the cylinder wake: operators, Riccati gains and
the closed loop in float64, written with dense solves and no kernel, cache
or code of the program under test.

It works out again everything the program's set-up derives from a
configuration: the Taylor-Hood operators and the steady state (the frozen
host FEM of `fem/`), the ADI shifts (`shifts.py`), the low-rank
Newton-ADI backward DRE sweep (one dense LU of the shifted saddle
[[Atil^T + sigma M, J^T], [J, 0]] per shift, the feedback through
Sherman-Morrison-Woodbury) and the IMEX closed loop (the Oseen-Euler step
as one dense LU of [[M/dt - A_stokes + L1(vbar), J^T], [J, 0]], the
convection N(v)v summed element by element from the frozen P2 tensor).

The equations are the program's documented ones:
  DRE step:  A~^T X M + M^T X A~ - M^T X B B^T X M / alpha + C^T C
             + M^T X_next M / dt = 0,  A~ = A - M/(2 dt),
  gain:      K = B^T Z Z^T M / alpha  (X = Z Z^T),
  loop:      u_k = -K (v_k - vbar),
             [[M/dt - A_s + L1, J^T], [J, 0]] [v_k+1; p]
                 = [(M/dt + L1) v_k - N(v_k)v_k + B u_k - f_v; f_p],
             y_k = C v_k.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from . import shifts
from .fem.cylinder import cylinder_setup
from .fem.taylor_hood import convection_matrices, convection_tensor

F64 = torch.float64


def _csr(a, device) -> torch.Tensor:
    a = sp.csr_matrix(a, dtype=np.float64)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(a.indptr, dtype=torch.int64),
            torch.as_tensor(a.indices, dtype=torch.int64),
            torch.as_tensor(a.data), size=a.shape, check_invariants=True,
        ).to(device)


def _dense(a, device) -> torch.Tensor:
    a = a.toarray() if sp.issparse(a) else np.asarray(a)
    return torch.as_tensor(np.asarray(a, np.float64)).to(device)


class Problem:
    """The cylinder wake at (re, refinement) in float64 on `device`."""

    def __init__(self, re: float, refinement: int, device):
        self.device = device
        np_ops, cond = cylinder_setup(re=re, refinement=refinement)
        self.np_ops, self.cond = np_ops, cond
        self.m_sp = sp.csr_matrix(np_ops["M"])
        self.a_sp = sp.csr_matrix(np_ops["A"])
        self.j_sp = sp.csr_matrix(np_ops["J"])
        self.n, self.n_p = self.m_sp.shape[0], self.j_sp.shape[0]
        self.mass = _csr(self.m_sp, device)
        self.b = _dense(np_ops["B"], device)  # (n, m)
        self.c = _dense(np_ops["C"], device)  # (p, n)
        self.vbar = _dense(cond.restrict(np_ops["vbar_full"]), device)
        full = np_ops["full"]
        space = full["space"]
        self.ns = space.n_scalar
        self.tri = torch.as_tensor(np.asarray(space.tri_dofs, np.int64),
                                   device=device)
        self.t0 = _dense(convection_tensor(full).reshape(-1), device).reshape(
            space.mesh.nt, 6, 6, 6, 2)
        dir_values = np.zeros(2 * self.ns)
        dir_values[cond.dirichlet] = cond.g
        self.dir_values = _dense(dir_values, device)
        self.free = torch.as_tensor(cond.free, device=device)

    # --- the convection -------------------------------------------------
    def convection(self, v: torch.Tensor) -> torch.Tensor:
        """N(v)v on the free dofs, Dirichlet values included: (n, S) ->
        (n, S). N[e,i,a] = sum_{j,b,k} T0[e,i,j,k,b] v[e,j,b] v[e,k,a]."""
        s = v.shape[1]
        full = self.dir_values[:, None].repeat(1, s)
        full[self.free] = v
        loc = full.reshape(2, self.ns, s)[:, self.tri]  # (2, nt, 6, S)
        loc = loc.permute(1, 2, 0, 3)  # (nt, 6 local dofs, 2 comps, S)
        g = torch.einsum("eijkb,ejbs->eiks", self.t0, loc)
        out = torch.einsum("eiks,ekas->aeis", g, loc)  # (2, nt, 6, S)
        acc = torch.zeros((2, self.ns, s), dtype=F64, device=self.device)
        idx = self.tri.reshape(-1)
        for a in range(2):
            acc[a].index_add_(0, idx, out[a].reshape(-1, s))
        return acc.reshape(2 * self.ns, s)[self.free]

    # --- the saddle -----------------------------------------------------
    def dense(self, a_sp) -> torch.Tensor:
        """A sparse host matrix as a dense float64 one, formed on the
        device."""
        a = sp.coo_matrix(a_sp)
        a.sum_duplicates()
        out = torch.zeros(a.shape, dtype=F64, device=self.device)
        rows = torch.as_tensor(a.row, dtype=torch.int64, device=self.device)
        cols = torch.as_tensor(a.col, dtype=torch.int64, device=self.device)
        out[rows, cols] = torch.as_tensor(a.data, device=self.device)
        return out

    def saddle(self, f_sp) -> torch.Tensor:
        """The dense [[F, J^T], [J, 0]] on the device."""
        return self.dense(sp.bmat([[f_sp, self.j_sp.T], [self.j_sp, None]]))

    def saddle_lu(self, f_sp):
        """LU factors of the dense [[F, J^T], [J, 0]]."""
        return torch.linalg.lu_factor(self.saddle(f_sp))

    def solve(self, lu, rhs_v, rhs_p=None):
        """Velocity part of the saddle solve for the columns of rhs_v."""
        rhs = torch.zeros((self.n + self.n_p, rhs_v.shape[1]), dtype=F64,
                          device=self.device)
        rhs[:self.n] = rhs_v
        if rhs_p is not None:
            rhs[self.n:] = rhs_p
        return torch.linalg.lu_solve(*lu, rhs)[:self.n]


def shift_schedule(prob: Problem, dt, num_shifts, n_adi, interval=None):
    """The Wachspress schedule over the configuration's interval, or over
    ARPACK's (0, a_max) of (A, M) when it gives none."""
    if interval is None:
        interval = shifts.spectral_interval_dae_cheap(prob.a_sp, prob.m_sp)
    return shifts.dre_schedule(*interval, dt, num_shifts, n_adi)


def compress(z: torch.Tensor, out_rank: int, rtol: float) -> torch.Tensor:
    """Z Z^T ~ Z' Z'^T with Z' of out_rank columns: thin QR, SVD of R,
    singular values under rtol * s_max dropped, dominant columns kept."""
    q, r = torch.linalg.qr(z, mode="reduced")
    # cuSOLVER's default (Jacobi) driver fails to converge on these R and
    # falls back; the QR-based gesvd is the accurate one.
    u, s, _ = torch.linalg.svd(r, full_matrices=False,
                               driver="gesvd" if r.is_cuda else None)
    s = torch.where(s > rtol * s[0], s, torch.zeros_like(s))
    zc = q @ (u * s[None, :])
    if zc.shape[1] >= out_rank:
        return zc[:, :out_rank]
    return torch.nn.functional.pad(zc, (0, out_rank - zc.shape[1]))


class DRESweep:
    """The backward DRE sweep of the low-rank Newton-ADI iteration, step
    by step: `step()` returns the next (earlier-time) gain K (m, n)."""

    def __init__(self, prob: Problem, alpha, dt, sig, sigma_seq, idx_seq,
                 n_newton: int, r_max: int, rtol: float):
        self.prob, self.alpha, self.dt = prob, float(alpha), float(dt)
        self.sigma_seq = [float(s) for s in sigma_seq]
        self.idx_seq = [int(i) for i in idx_seq]
        self.n_newton, self.r_max, self.rtol = n_newton, r_max, rtol
        base = prob.saddle((prob.a_sp.T - prob.m_sp / (2.0 * dt)).tocsr())
        mass = prob.dense(prob.m_sp)
        n = prob.n
        self.lus = {}
        for i in sorted(set(self.idx_seq)):
            shifted = base.clone()
            shifted[:n, :n] += float(sig[i]) * mass
            self.lus[i] = torch.linalg.lu_factor(shifted)
            del shifted
        del base, mass
        self.restart(alpha)

    def restart(self, alpha) -> None:
        """Back to the terminal condition X = 0 (and K = 0), at alpha."""
        n, m = self.prob.b.shape
        self.alpha = float(alpha)
        self.z = torch.zeros((n, self.r_max), dtype=F64, device=self.prob.device)
        self.k = torch.zeros((m, n), dtype=F64, device=self.prob.device)

    def _smw(self, k):
        """Per shift: the solve of (S - [K^T; 0][B; 0]^T) by SMW."""
        p = self.prob
        out = {}
        for i, lu in self.lus.items():
            siu = p.solve(lu, k.T)
            cap = torch.eye(k.shape[0], dtype=F64, device=p.device) - p.b.T @ siu
            out[i] = (lu, siu, torch.linalg.inv(cap))
        return out

    def _adi(self, w, k):
        p, smw = self.prob, self._smw(k)

        def solve(i, rhs):
            lu, siu, capinv = smw[i]
            x = p.solve(lu, rhs)
            return x + siu @ (capinv @ (p.b.T @ x))

        sg, ix = self.sigma_seq, self.idx_seq
        v = solve(ix[0], w)
        cols = [math.sqrt(-2.0 * sg[0]) * v]
        for it in range(1, len(ix)):
            v = v - (sg[it] + sg[it - 1]) * solve(ix[it], p.mass @ v)
            cols.append(math.sqrt(-2.0 * sg[it]) * v)
        return torch.cat(cols, dim=1)

    def step(self) -> torch.Tensor:
        p = self.prob
        w_extra = (p.mass @ self.z) / math.sqrt(self.dt)
        k = self.k
        for _ in range(self.n_newton):
            w = torch.cat([p.c.T, w_extra, math.sqrt(self.alpha) * k.T], dim=1)
            z = compress(self._adi(w, k), self.r_max, self.rtol)
            k = (p.b.T @ z) @ (p.mass @ z).T / self.alpha
        self.z, self.k = z, k
        return k


def t0_gain(prob: Problem, alpha, dt, nts, sched, n_newton, r_max, rtol):
    """The t=0 gain of an nts-step sweep from the terminal X = 0."""
    sweep = DRESweep(prob, alpha, dt, *sched, n_newton, r_max, rtol)
    for _ in range(nts):
        k = sweep.step()
    return k


class ClosedLoop:
    """The Oseen-Euler IMEX closed loop about the steady state, with
    explicit feedback to it."""

    def __init__(self, prob: Problem, dt: float):
        self.prob, self.dt = prob, float(dt)
        np_ops, cond = prob.np_ops, prob.cond
        full = np_ops["full"]
        l1, _ = convection_matrices(full, np_ops["vbar_full"])
        l1 = sp.csr_matrix(cond.mat_inner(l1))
        a_s = sp.csr_matrix(cond.mat_inner(full["A"]))
        self.lu = prob.saddle_lu((prob.m_sp / dt - a_s + l1).tocsr())
        self.rhs_op = _csr((prob.m_sp / dt + l1).tocsr(), prob.device)
        self.fv = _dense(cond.mat_bc_rhs(full["A"]), prob.device)[:, None]
        self.fp = _dense(cond.jmat_bc_rhs(full["J"]), prob.device)[:, None]

    def run(self, k: torch.Tensor, v0: torch.Tensor, nts: int):
        """v0 (S, n) -> (ys (S, nts+1, p), us (S, nts, m)), with
        u_k = -K (v_k - vbar)."""
        p = self.prob
        k = k.to(F64)
        v = v0.T.to(F64).contiguous()
        fp = self.fp.expand(-1, v.shape[1])
        ys, us = [p.c @ v], []
        for _ in range(nts):
            u = -k @ (v - p.vbar[:, None])
            rhs = self.rhs_op @ v - p.convection(v) + p.b @ u - self.fv
            v = p.solve(self.lu, rhs, fp)
            ys.append(p.c @ v)
            us.append(u)
        return (torch.stack(ys).permute(2, 0, 1),
                torch.stack(us).permute(2, 0, 1))


def rel_dev(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max |a - ref| / max |ref| (inf when a is not finite)."""
    a = a.to(device=ref.device, dtype=F64)
    if not bool(torch.isfinite(a).all()):
        return float("inf")
    return float((a - ref).abs().max() / ref.abs().max())
