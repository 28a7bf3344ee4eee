"""The plain reference of the Reynolds parameter sweep (config 5): its
design, and for each bucket its own problem, shift schedule, t = 0 gain,
implicit-feedback closed loop of the bucket's real scenarios, and the
bucket's statistics over them; float64, dense solves, nothing of the
program under test.

The problem, the shifts and the gain are plain.py's (Problem,
shift_schedule, t0_gain: the low-rank Newton-ADI backward DRE sweep on a
dense LU of every shifted saddle). The closed loop is the program's
documented implicit-feedback Oseen-Euler step about the bucket's steady
state vbar, with the constant gain K:

  [[M/dt - A_s + L1 + B K, J^T], [J, 0]] [v_k+1; p]
      = [(M/dt + L1) v_k - N(v_k)v_k + B K vbar - f_v; f_p],
  u_k = -K (v_k+1 - vbar),   y_k = C v_k,

and the statistics over a bucket's real scenarios, against its target
y* = C vbar:

  mean_cost       the mean of sum_{k=0..T} |y_k - y*|^2 dt
                  + alpha sum_{k<T} |u_k|^2 dt,
  tracking_err_T  the mean of |y_T - y*|,
  max_abs_y       the largest |y| entry,
  scenarios       the count.

Departures from the program, none of which changes the mathematics:
  - the program solves the step with the saddle inverse's velocity
    block W and offset d, x0 = W (P v - N(v)v) + d, and folds the
    feedback in by Sherman-Morrison-Woodbury (x0 - G (I + K G)^-1 K x0);
    here one dense LU of the step matrix with B K inside it, solved for
    the right-hand side as written;
  - the program pads every bucket to one width and masks the padding out
    of its statistics; here only a bucket's real scenarios run;
  - the program evaluates every bucket's N(v)v with bucket 0's
    convection evaluator (one mesh, one boundary function) and forms
    L1(vbar) on the device; here each bucket's Problem sums its own
    N(v)v and assembles L1 with the frozen host FEM;
  - the program's gains come from matrix-free FGMRES solves and its
    steppers from a Newton-Schulz chain of inverses, in float32; here
    dense LU factors in float64.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from . import plain
from .fem.taylor_hood import convection_matrices

F64 = torch.float64


def design(re_lo, re_hi, buckets: int, scenarios: int, seed: int):
    """The sweep's Reynolds buckets, evenly spaced over [re_lo, re_hi],
    and the count of each: `scenarios` Reynolds numbers drawn uniformly
    (numpy's default_rng(seed)), each sent to its nearest bucket, the
    lower one on a tie."""
    re_buckets = np.linspace(re_lo, re_hi, buckets)
    draw = np.random.default_rng(seed).uniform(re_lo, re_hi, scenarios)
    nearest = np.argmin(np.abs(draw[:, None] - re_buckets[None, :]), axis=1)
    return re_buckets, np.bincount(nearest, minlength=buckets)


class ImplicitLoop:
    """The bucket's closed loop under the constant gain k (m, n)."""

    def __init__(self, prob: plain.Problem, dt: float, k: torch.Tensor):
        self.prob, self.dt = prob, float(dt)
        self.k = k.to(device=prob.device, dtype=F64)
        np_ops, cond = prob.np_ops, prob.cond
        full = np_ops["full"]
        l1, _ = convection_matrices(full, np_ops["vbar_full"])
        l1 = sp.csr_matrix(cond.mat_inner(l1))
        a_s = sp.csr_matrix(cond.mat_inner(full["A"]))
        step = prob.saddle((prob.m_sp / dt - a_s + l1).tocsr())
        step[:prob.n, :prob.n] += prob.b @ self.k
        self.lu = torch.linalg.lu_factor(step)
        del step
        self.rhs_op = plain._csr((prob.m_sp / dt + l1).tocsr(), prob.device)
        fv = plain._dense(cond.mat_bc_rhs(full["A"]), prob.device)
        self.offset = (prob.b @ (self.k @ prob.vbar) - fv)[:, None]
        self.fp = plain._dense(cond.jmat_bc_rhs(full["J"]), prob.device)

    def run(self, v0: torch.Tensor, nts: int):
        """v0 (S, n) -> (ys (S, nts+1, p), u_sq (S, nts)), u_sq the
        squared norm of each step's control."""
        p = self.prob
        v = v0.T.to(device=p.device, dtype=F64).contiguous()
        fp = self.fp[:, None].expand(-1, v.shape[1])
        vbar = p.vbar[:, None]
        ys, u_sq = [p.c @ v], []
        for _ in range(nts):
            rhs = self.rhs_op @ v - p.convection(v) + self.offset
            v = p.solve(self.lu, rhs, fp)
            u = -self.k @ (v - vbar)
            ys.append(p.c @ v)
            u_sq.append((u * u).sum(dim=0))
        return torch.stack(ys).permute(2, 0, 1), torch.stack(u_sq).T


def statistics(ys: torch.Tensor, u_sq: torch.Tensor, ystar: torch.Tensor,
               alpha: float, dt: float) -> dict:
    """One bucket's statistics over its scenarios ys (S, T+1, p), u_sq
    (S, T) against the target ystar (p,)."""
    dy = ys - ystar
    cost = (dy**2).sum(dim=(1, 2)) * dt + alpha * u_sq.sum(dim=1) * dt
    return {
        "mean_cost": cost.mean(),
        "tracking_err_T": dy[:, -1].norm(dim=-1).mean(),
        "max_abs_y": ys.abs().max(),
        "scenarios": ys.shape[0],
    }


class Bucket:
    """One Reynolds bucket: its problem, shift schedule, t = 0 gain and
    closed loop. gains: num_shifts, n_adi, r_max, nts, n_newton and
    compress_rtol of the DRE sweep."""

    def __init__(self, re: float, refinement: int, dt: float, alpha: float,
                 gains: dict, device):
        self.alpha, self.dt = float(alpha), float(dt)
        self.prob = plain.Problem(re, refinement, device)
        sched = plain.shift_schedule(self.prob, dt, gains["num_shifts"],
                                     gains["n_adi"])
        self.k = plain.t0_gain(self.prob, alpha, dt, gains["nts"], sched,
                               gains["n_newton"], gains["r_max"],
                               gains["compress_rtol"])
        self.loop = ImplicitLoop(self.prob, dt, self.k)
        self.ystar = self.prob.c @ self.prob.vbar

    def run(self, v0: torch.Tensor, nts: int):
        """The loop from v0 (S, n): (ys, u_sq, statistics)."""
        ys, u_sq = self.loop.run(v0, nts)
        return ys, u_sq, statistics(ys, u_sq, self.ystar, self.alpha,
                                    self.dt)
