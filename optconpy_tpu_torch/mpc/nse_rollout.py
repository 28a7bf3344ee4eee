"""Nonlinear NSE closed-loop rollouts — the fused Oseen-IMEX step.

Counterpart of the main-path parts of optconpy_tpu/mpc/nse_rollout.py.
The steady-state-linearized convection L1(vbar) is implicit and only
the quadratic remainder N(v)v - L1(vbar) v stays explicit; the whole
linear part of a step is pre-contracted on the host in f64 into two
(n, n) matrices, so each step of a scenario batch is two GEMMs, the
batched convection and a few tall-skinny products.

State convention: v is the FREE-dof velocity (Dirichlet values live in
the ConvKernel); the feedback regulates the perturbation from the
linearization point vbar:  u_k = -K_k (v_k - vbar) + (1/alpha) B^T w_k.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class NSEFusedCache:
    """Fused Oseen-IMEX step operators for one (problem, dt) pair.

    With S = [[M/dt - A + L1, J^T], [J, 0]]^-1 and blocks
    inv_vv = S[:n,:n], inv_vp = S[:n,n:], the step
        v+ = S_vv rhs_v + S_vp fp,  rhs_v = (M/dt + L1) v - N(v)v + B u - fv
    becomes
        v+ = pmat @ v + inv_vv @ (B u - N(v)v) + c0
    with pmat = inv_vv (M/dt + L1),  c0 = inv_vp fp - inv_vv fv,
    gmat = inv_vv B.
    """

    pmat: torch.Tensor  # (n, n)
    inv_vv: torch.Tensor  # (n, n)
    gmat: torch.Tensor  # (n, m)
    c0: torch.Tensor  # (n,)
    vbar: torch.Tensor  # (n,)
    dt: float  # baked into pmat/c0 at build time, checked at apply

    def to(self, device=None, dtype=None) -> "NSEFusedCache":
        def mv(x):
            return x.to(device=device, dtype=dtype)

        return NSEFusedCache(
            mv(self.pmat), mv(self.inv_vv), mv(self.gmat), mv(self.c0),
            mv(self.vbar), self.dt,
        )


def build_nse_fused(
    np_ops: dict,
    cond,
    dt: float,
    *,
    device,
    dtype=torch.float32,
) -> NSEFusedCache:
    """Host (numpy f64) build of the fused Oseen-IMEX step cache, with
    L1(vbar) implicit; each array crosses to `device`/`dtype` once at
    the end."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from ..fem.taylor_hood import convection_matrices

    full = np_ops["full"]
    m_sp = sp.csr_matrix(np_ops["M"])
    m_i = np.asarray(m_sp.toarray(), dtype=np.float64)
    a_stokes_sp = sp.csr_matrix(cond.mat_inner(full["A"]))
    j_sp = sp.csr_matrix(np_ops["J"])
    n = m_i.shape[0]
    n_p = j_sp.shape[0]

    l1, _ = convection_matrices(full, np_ops["vbar_full"])
    l1_sp = sp.csr_matrix(cond.mat_inner(l1))
    l1_i = np.asarray(l1_sp.toarray(), dtype=np.float64)

    # Sparse LU, explicit inverse by solving against I; f64 host.
    big = sp.bmat(
        [[m_sp / dt - a_stokes_sp + l1_sp, j_sp.T], [j_sp, None]],
        format="csc",
    )
    inv = spla.splu(big).solve(np.eye(n + n_p))
    inv_vv = inv[:n, :n]
    inv_vp = inv[:n, n:]
    fv = np.asarray(cond.mat_bc_rhs(full["A"]), dtype=np.float64)
    fp = np.asarray(cond.jmat_bc_rhs(full["J"]), dtype=np.float64)
    b_np = np.asarray(np_ops["B"].toarray() if hasattr(
        np_ops["B"], "toarray") else np_ops["B"], dtype=np.float64)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(
            device=device, dtype=dtype
        )

    return NSEFusedCache(
        pmat=dev(inv_vv @ (m_i / dt + l1_i)),
        inv_vv=dev(inv_vv),
        gmat=dev(inv_vv @ b_np),
        c0=dev(inv_vp @ fp - inv_vv @ fv),
        vbar=dev(cond.restrict(np_ops["vbar_full"])),
        dt=float(dt),
    )


def batched_nse_closed_loop_fused(
    sys,
    conv,
    cache: NSEFusedCache,
    ks: torch.Tensor,
    ws: torch.Tensor,
    v0_batch: torch.Tensor,
    alpha: float,
    feedback: str = "explicit",
):
    """Fused batched closed loop: a time loop with the whole scenario
    batch inside each step, (B, n) GEMMs and the batch-last convection
    (conv.conv_inner_batch).

    ks: (nts+1, m, n) gains; ws: (nts+1, n) feedforward terms; v0_batch
    (S, n). feedback: 'explicit' applies u_k from v_k; 'implicit' solves
    for u_k from v_{k+1} through an m x m Sherman-Morrison system.
    Returns scenario-major (vs (S, nts+1, n), us (S, nts, m),
    ys (S, nts+1, p)).
    """
    if feedback not in ("explicit", "implicit"):
        raise ValueError(f"unknown feedback mode: {feedback}")
    bt = sys.b.T
    vbar = cache.vbar
    eye_m = torch.eye(sys.m_in, dtype=cache.gmat.dtype, device=vbar.device)
    v = v0_batch
    vs, us = [v0_batch], []
    for k_gain, w_k in zip(ks[:-1], ws[:-1]):
        uff = (bt @ w_k) / alpha
        conv_term = conv.conv_inner_batch(v) @ cache.inv_vv.T
        if feedback == "implicit":
            x0 = (
                v @ cache.pmat.T
                + (uff + k_gain @ vbar) @ cache.gmat.T
                - conv_term
                + cache.c0
            )
            s_mat = eye_m + k_gain @ cache.gmat
            corr = torch.linalg.solve(s_mat, (x0 @ k_gain.T).T).T
            v = x0 - corr @ cache.gmat.T
            u = -(v - vbar) @ k_gain.T + uff
        else:
            u = -(v - vbar) @ k_gain.T + uff
            v = v @ cache.pmat.T + u @ cache.gmat.T - conv_term + cache.c0
        vs.append(v)
        us.append(u)
    vs = torch.stack(vs)
    us = torch.stack(us)
    ys = vs @ sys.c.T
    # time-major -> scenario-major
    return vs.transpose(0, 1), us.transpose(0, 1), ys.transpose(0, 1)


def batched_nse_closed_loop(
    sys,
    conv,
    cache,
    ks: torch.Tensor,
    ws: torch.Tensor,
    v0_batch: torch.Tensor,
    alpha: float,
    dt: float,
    feedback: str = "explicit",
):
    """Closed loop over the scenario initial states v0_batch (S, n).

    Dispatches an NSEFusedCache to batched_nse_closed_loop_fused; other
    step caches are not ported yet and raise. The fused cache bakes dt
    into pmat/c0 at build time, so the passed dt must match it.
    """
    if not isinstance(cache, NSEFusedCache):
        raise TypeError(
            f"batched_nse_closed_loop takes an NSEFusedCache, got "
            f"{type(cache).__name__}"
        )
    if abs(cache.dt - dt) > 1e-12 * max(abs(dt), 1e-30):
        raise ValueError(
            f"dt={dt} disagrees with NSEFusedCache build dt={cache.dt}; "
            f"rebuild the cache for this dt"
        )
    return batched_nse_closed_loop_fused(
        sys, conv, cache, ks, ws, v0_batch, alpha, feedback
    )
