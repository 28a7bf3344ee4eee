"""Nonlinear NSE closed-loop rollouts — IMEX stepping with feedback.

Counterpart of optconpy_tpu/mpc/nse_rollout.py. One saddle solve of the
implicit block per step, explicit convection, feedback gains as
tall-skinny products. The implicit block is solved by a dense host
factor applied on the device (NSEStepCache: a SaddleLU or
SaddleInverse) or, with no O((n + n_p)^2) object, by warm-started
FGMRES (NSEMatfreeStepCache: solvers/matfree.py, with the implicit
convection and the CNAB2 half operator as SpMM packs). Three IMEX
schemes, chosen at build time:
  * explicit: implicit block [[M/dt - A_stokes, J^T], [J, 0]], the whole
    convection N(v)v explicit (CFL-limited);
  * oseen (default): the steady-state-linearized convection L1(vbar)
    joins the implicit block; only N(v)v - L1(vbar) v stays explicit;
  * oseen-cn: the trapezoid on the Oseen-linearized part with
    Adams-Bashforth-2 on the quadratic remainder (CNAB2).
The fused tier (NSEFusedCache) pre-contracts the whole linear part of
an Euler step on the host in f64 into two (n, n) matrices, so each step
of a scenario batch is two GEMMs, the batched convection and a few
tall-skinny products. Every loop keeps the batch last, (n, S), as the
convection kernel reads and writes it.

State convention: v is the FREE-dof velocity (Dirichlet values live in
the ConvKernel); the feedback regulates the perturbation from the
linearization point vbar:  u_k = -K_k (v_k - vbar) + (1/alpha) B^T w_k.

Step (fv, fp are the BC condensation rhs; L1i is the implicit
convection, zero for the explicit scheme):
  [[M/dt - A_stokes + L1i, J^T], [J, 0]] [v+; p]
      = [M v_k/dt - (N(v_k)v_k - L1i v_k) + B u_k - fv; fp]
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.spmm_kernel import pack_spmm, spmm


@dataclass(frozen=True)
class NSEStepCache:
    """Cached IMEX step operators for one (problem, dt) pair.

    lu: SaddleLU or SaddleInverse of the implicit block;
    l1_imp: (n, n) implicitly-treated convection (zeros for the
        explicit scheme);
    fv, fp: BC condensation rhs; vbar: linearization point;
    rhs_half: None for backward-Euler schemes; for CNAB2 the explicit
        half of the linear operator, (A_stokes - L1)/2, applied on the
        rhs each step (the implicit block then carries
        M/dt - (A_stokes - L1)/2). Its presence selects the scheme.
    """

    lu: object
    l1_imp: torch.Tensor
    fv: torch.Tensor
    fp: torch.Tensor
    vbar: torch.Tensor
    rhs_half: torch.Tensor | None = None


def _l1_inner(np_ops, cond, scheme):
    """The inner implicit convection L1(vbar) (scipy), or None for the
    explicit scheme."""
    import scipy.sparse as sp

    from ..fem.taylor_hood import convection_matrices

    if scheme == "explicit":
        return None
    l1, _ = convection_matrices(np_ops["full"], np_ops["vbar_full"])
    return sp.csr_matrix(cond.mat_inner(l1))


def build_nse_stepper(
    np_ops: dict,
    cond,
    dt: float,
    *,
    device,
    dtype=torch.float32,
    scheme: str = "oseen",
    solver: str = "lu",
) -> NSEStepCache:
    """Host builder of the IMEX step cache from the cylinder/cavity setup
    dict (models/*.py) and the BC condenser.

    scheme: 'oseen' (L1(vbar) implicit, Euler), 'explicit' (convection
    explicit, Euler) or 'oseen-cn' (CNAB2).
    solver: 'lu' (host LU, triangular solves on the device) or 'inverse'
    (host explicit inverse, one GEMM per solve).
    """
    from ..solvers.saddle import SaddleInverse, SaddleLU

    if scheme not in ("oseen", "explicit", "oseen-cn"):
        raise ValueError(f"unknown IMEX scheme: {scheme}")
    solver_cls = {"lu": SaddleLU, "inverse": SaddleInverse}[solver]
    full = np_ops["full"]
    m_i = np_ops["M"]
    n = m_i.shape[0]
    l1_sp = _l1_inner(np_ops, cond, scheme)
    l1_i = np.zeros((n, n)) if l1_sp is None else l1_sp.toarray()

    theta = 0.5 if scheme == "oseen-cn" else 1.0
    lin = cond.mat_inner(full["A"]).toarray() - l1_i  # implicit linear part
    imp = m_i.toarray() / dt - theta * lin

    def dev(x):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    return NSEStepCache(
        lu=solver_cls.build(dev(imp), dev(np_ops["J"].toarray())),
        l1_imp=dev(l1_i),
        fv=dev(cond.mat_bc_rhs(full["A"])),
        fp=dev(cond.jmat_bc_rhs(full["J"])),
        vbar=dev(cond.restrict(np_ops["vbar_full"])),
        rhs_half=dev(0.5 * lin) if scheme == "oseen-cn" else None,
    )


@dataclass(frozen=True)
class NSEMatfreeStepCache:
    """Matrix-free IMEX step operators for one (problem, dt) pair.

    saddle: SaddleMatfreeCache of [[M/dt - theta (A_stokes - L1), J^T],
        [J, 0]] with the one mass coefficient 1/dt (theta 1 Euler, 1/2
        CNAB2);
    l1_pack: the implicit convection L1(vbar) as an SpMM pack, None for
        the explicit scheme (never densified: n^2 values at config 3 are
        ~1 GB);
    rhs_half: None (Euler) or (A_stokes - L1)/2 as an SpMM pack, applied
        on the rhs each CNAB2 step;
    dt: the step baked into the saddle, checked at apply.
    """

    saddle: object
    l1_pack: object
    fv: torch.Tensor
    fp: torch.Tensor
    vbar: torch.Tensor
    rhs_half: object
    dt: float


def build_nse_stepper_matfree(
    np_ops: dict,
    cond,
    dt: float,
    *,
    device,
    dtype=torch.float32,
    scheme: str = "oseen",
    block: int = 512,
    m_krylov: int = 30,
    max_cycles: int = 8,
    tol: float = 1e-6,
) -> NSEMatfreeStepCache:
    """Host builder of the matrix-free IMEX step cache (scipy sparse
    only, nothing densified); schemes as build_nse_stepper, FGMRES
    settings as SaddleMatfreeCache."""
    import scipy.sparse as sp

    from ..solvers.matfree import SaddleMatfreeCache

    if scheme not in ("oseen", "explicit", "oseen-cn"):
        raise ValueError(f"unknown IMEX scheme: {scheme}")
    full = np_ops["full"]
    m_i = sp.csr_matrix(np_ops["M"])
    a_stokes_i = sp.csr_matrix(cond.mat_inner(full["A"]))
    l1_i = _l1_inner(np_ops, cond, scheme)
    lin = a_stokes_i if l1_i is None else (a_stokes_i - l1_i).tocsr()
    # F = M/dt - theta (A_stokes - L1): the mass coefficient is +1/dt,
    # which flips the Schur sign against the ADI pencils (signed
    # schur_coeffs in SaddleMatfreeCache).
    theta = 0.5 if scheme == "oseen-cn" else 1.0
    saddle = SaddleMatfreeCache.build(
        (-theta * lin).tocsr(), m_i, np_ops["J"], [1.0 / dt],
        device=device, dtype=dtype, block=block, m_krylov=m_krylov,
        max_cycles=max_cycles, tol=tol,
    )

    def pack(a):
        return pack_spmm(a, device=device, dtype=dtype)

    def dev(x):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    return NSEMatfreeStepCache(
        saddle=saddle,
        l1_pack=None if l1_i is None else pack(l1_i),
        fv=dev(cond.mat_bc_rhs(full["A"])),
        fp=dev(cond.jmat_bc_rhs(full["J"])),
        vbar=dev(cond.restrict(np_ops["vbar_full"])),
        rhs_half=pack((0.5 * lin).tocsr()) if scheme == "oseen-cn" else None,
        dt=float(dt),
    )


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
    scheme: str = "oseen",
) -> NSEFusedCache:
    """Host (numpy f64) build of the fused IMEX step cache, Euler in time
    with L1(vbar) implicit ('oseen') or the whole convection explicit
    ('explicit'); each array crosses to `device`/`dtype` once at the
    end."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    if scheme not in ("oseen", "explicit"):
        raise ValueError(f"unknown IMEX scheme: {scheme}")
    full = np_ops["full"]
    m_sp = sp.csr_matrix(np_ops["M"])
    m_i = np.asarray(m_sp.toarray(), dtype=np.float64)
    a_stokes_sp = sp.csr_matrix(cond.mat_inner(full["A"]))
    j_sp = sp.csr_matrix(np_ops["J"])
    n = m_i.shape[0]
    n_p = j_sp.shape[0]

    l1_sp = _l1_inner(np_ops, cond, scheme)
    if l1_sp is None:
        l1_sp = sp.csr_matrix((n, n))
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
    batch inside each step. The state is kept batch-last, (n, S), so
    the batch-last convection (conv.conv_inner_batch_t) reads and writes
    it directly and each step's products are (n, n) @ (n, S) GEMMs.

    ks: (nts+1, m, n) gains; ws: (nts+1, n) feedforward terms; v0_batch
    (S, n). feedback: 'explicit' applies u_k from v_k; 'implicit' solves
    for u_k from v_{k+1} through an m x m Sherman-Morrison system.
    Returns scenario-major (vs (S, nts+1, n), us (S, nts, m),
    ys (S, nts+1, p)).
    """
    if feedback not in ("explicit", "implicit"):
        raise ValueError(f"unknown feedback mode: {feedback}")
    bt = sys.b.T
    vbar = cache.vbar[:, None]
    c0 = cache.c0[:, None]
    eye_m = torch.eye(sys.m_in, dtype=cache.gmat.dtype, device=vbar.device)
    v = v0_batch.T.contiguous()
    vs, us = [v], []
    for k_gain, w_k in zip(ks[:-1], ws[:-1]):
        uff = ((bt @ w_k) / alpha)[:, None]
        # pmat v - inv_vv N(v)v, the second GEMM accumulating in place
        x0 = cache.pmat @ v
        x0.addmm_(cache.inv_vv, conv.conv_inner_batch_t(v), alpha=-1.0)
        if feedback == "implicit":
            x0 += c0 + cache.gmat @ (uff + k_gain @ vbar)
            s_mat = eye_m + k_gain @ cache.gmat
            corr = torch.linalg.solve(s_mat, k_gain @ x0)
            v = x0 - cache.gmat @ corr
            u = -k_gain @ (v - vbar) + uff
        else:
            u = -k_gain @ (v - vbar) + uff
            v = x0.addmm_(cache.gmat, u).add_(c0)
        vs.append(v)
        us.append(u)
    vs = torch.stack(vs)
    us = torch.stack(us)
    ys = sys.c @ vs
    # time-major, batch-last -> scenario-major
    return vs.permute(2, 0, 1), us.permute(2, 0, 1), ys.permute(2, 0, 1)


def _nse_loop_columns(sys, conv, cache, ks, ws, v0, alpha, dt, feedback):
    """The IMEX closed loop of an NSEStepCache or an NSEMatfreeStepCache
    on batch-last states v0 (n, S); returns time-major (vs (nts+1, n, S),
    us (nts, m, S), ys (nts+1, p, S)).

    The matrix-free cache applies L1 and the CNAB2 half operator through
    the SpMM kernel and warm-starts each step's FGMRES solve from the
    previous step's solution (v, p): in implicit feedback the solution
    before the feedback correction, as the reference carries it."""
    if feedback not in ("explicit", "implicit"):
        raise ValueError(f"unknown feedback mode: {feedback}")
    b, bt = sys.b, sys.b.T
    vbar = cache.vbar[:, None]
    fv = cache.fv[:, None]
    n_p = cache.fp.shape[0]
    fp = cache.fp[:, None].expand(-1, v0.shape[1])
    cn = cache.rhs_half is not None
    if isinstance(cache, NSEMatfreeStepCache):
        apply_op = spmm
        solver, l1 = cache.saddle, cache.l1_pack
        warm = (v0, v0.new_zeros((n_p, v0.shape[1])))

        def solve(rhs_v, warm):
            return solver.apply_full(rhs_v, fp, x0=warm)
    else:
        def apply_op(op, v):
            return op @ v

        solver, l1, warm = cache.lu, cache.l1_imp, None

        def solve(rhs_v, warm):
            return solver.apply_full(rhs_v, fp)

    def q_of(v):
        nv = conv.conv_inner_batch_t(v)
        return nv if l1 is None else nv - apply_op(l1, v)

    def rhs_base(v, q, q_prev):
        r = sys.mass.matmat(v) / dt - fv
        if cn:
            r = r + apply_op(cache.rhs_half, v) - (1.5 * q - 0.5 * q_prev)
        else:
            r = r - q
        return r

    if feedback == "implicit":
        gmat = solver.apply(b, b.new_zeros((n_p, sys.m_in)))  # constant
        eye_m = torch.eye(sys.m_in, dtype=b.dtype, device=b.device)
    v = v0
    q_prev = q_of(v0)  # AB2 seed: q_{-1} := q_0 (first step = CNAB1)
    vs, us = [v], []
    for k_gain, w_k in zip(ks[:-1], ws[:-1]):
        uff = ((bt @ w_k) / alpha)[:, None]
        q = q_of(v)
        if feedback == "implicit":
            rhs_v = rhs_base(v, q, q_prev) + b @ (uff + k_gain @ vbar)
            warm = solve(rhs_v, warm)
            x0 = warm[0]
            corr = torch.linalg.solve(eye_m + k_gain @ gmat, k_gain @ x0)
            v_next = x0 - gmat @ corr
            u = -(k_gain @ (v_next - vbar)) + uff
        else:
            u = -(k_gain @ (v - vbar)) + uff
            warm = solve(rhs_base(v, q, q_prev) + b @ u, warm)
            v_next = warm[0]
        v, q_prev = v_next, q
        vs.append(v)
        us.append(u)
    vs = torch.stack(vs)
    return vs, torch.stack(us), sys.c @ vs


def nse_closed_loop_rollout(
    sys,
    conv,
    cache: NSEStepCache,
    ks: torch.Tensor,
    ws: torch.Tensor,
    v0: torch.Tensor,
    alpha: float,
    dt: float,
    feedback: str = "explicit",
):
    """Nonlinear closed loop of one scenario; returns (vs (nts+1, n),
    us (nts, m), ys (nts+1, p)).

    sys: DAESystem whose stiff is the LINEARIZED operator (for gains);
    mass/b/c are shared with the nonlinear plant.
    ks: (nts+1, m, n); ws: (nts+1, n) feedforward states; v0: (n,).

    feedback='explicit': u_k from the current state v_k.
    feedback='implicit': u_k = -K_k (v_{k+1} - vbar) + ff, with B K_k
    folded into the implicit solve via SMW on the cached saddle solver;
    G = lu^-1 B is constant, so the extra cost is one (m, m) solve a step.

    A cache built with scheme='oseen-cn' (rhs_half present) runs CNAB2:
    the rhs gains (A_stokes - L1)/2 v and the quadratic remainder
    q(v) = N(v)v - L1 v extrapolates as 1.5 q_k - 0.5 q_{k-1}, with
    q_{-1} := q_0 (the first step is CNAB1).
    """
    vs, us, ys = _nse_loop_columns(
        sys, conv, cache, ks, ws, v0[:, None], alpha, dt, feedback
    )
    return vs[..., 0], us[..., 0], ys[..., 0]


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
    """Closed loop over the scenario initial states v0_batch (S, n), all
    scenarios as the columns of one solve per step. Returns
    scenario-major (vs (S, nts+1, n), us (S, nts, m), ys (S, nts+1, p)).

    An NSEFusedCache dispatches to batched_nse_closed_loop_fused; it
    and an NSEMatfreeStepCache bake dt in at build time, so the passed dt
    must match it. An NSEStepCache or an NSEMatfreeStepCache runs the
    IMEX loop of nse_closed_loop_rollout.
    """
    if isinstance(cache, (NSEFusedCache, NSEMatfreeStepCache)):
        if abs(cache.dt - dt) > 1e-12 * max(abs(dt), 1e-30):
            raise ValueError(
                f"dt={dt} disagrees with {type(cache).__name__} build "
                f"dt={cache.dt}; rebuild the cache for this dt"
            )
    if isinstance(cache, NSEFusedCache):
        return batched_nse_closed_loop_fused(
            sys, conv, cache, ks, ws, v0_batch, alpha, feedback
        )
    if not isinstance(cache, (NSEStepCache, NSEMatfreeStepCache)):
        raise TypeError(
            f"batched_nse_closed_loop takes an NSEFusedCache, an "
            f"NSEStepCache or an NSEMatfreeStepCache, got "
            f"{type(cache).__name__}"
        )
    vs, us, ys = _nse_loop_columns(
        sys, conv, cache, ks, ws, v0_batch.T.contiguous(), alpha, dt,
        feedback,
    )
    return vs.permute(2, 0, 1), us.permute(2, 0, 1), ys.permute(2, 0, 1)
