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

The parameter sweep (config 5) runs R buckets of S scenarios, each
bucket with its own linearization, gain and step operators, in one time
loop that keeps no state trajectory (nse_sweep_outputs); its Oseen
steppers come from an inverse of the first bucket carried across the
buckets by certified Newton-Schulz passes
(build_sweep_steppers_ns_chain).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..ops.spmm_kernel import pack_spmm, spmm

# The Newton-Schulz stepper chain (build_sweep_steppers_ns_chain): the
# reference's passes (seed_passes for bucket 0, ns_passes for each later
# bucket) and certify_tol.
CHAIN_SEED_PASSES = 2
CHAIN_PASSES = 4
CHAIN_CERTIFY_TOL = 1e-4


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

    @staticmethod
    def stack(caches) -> "NSEStepCache":
        """The caches of R buckets (one problem geometry) as one
        NSEStepCache whose tensors carry a leading R axis, its lu a
        batched SaddleLU or SaddleInverse (solvers/saddle.py stack): the
        reference's jax.tree.map(jnp.stack) over the per-bucket caches
        (parallel/param_sweep.py build_sweep_gains_and_caches)."""
        def field_stack(name):
            vals = [getattr(c, name) for c in caches]
            if vals[0] is None:
                return None
            if isinstance(vals[0], torch.Tensor):
                return torch.stack(vals)
            return type(vals[0]).stack(vals)

        return NSEStepCache(**{
            f.name: field_stack(f.name) for f in fields(NSEStepCache)
        })


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


def nse_sweep_outputs(
    sys,
    conv,
    cache_stack: NSEStepCache,
    ks: torch.Tensor,
    v0: torch.Tensor,
    alpha: float,
    dt: float,
    nts: int,
    feedback: str = "implicit",
):
    """Closed loops of R buckets x S scenarios in one time loop, each
    bucket with its own step operators and constant gain; keeps no state
    trajectory. Returns (ys (R, S, nts+1, p), u_sq (R, S, nts) the
    squared control norm of each step, v_final (R, S, n)).

    cache_stack: NSEStepCache.stack of the buckets' caches (one
    geometry); ks (R, m, n); v0 (R, S, n). sys supplies the shared mass,
    B and C; alpha is unused (no feedforward), as in the reference.

    The state is kept as one (n, R*S) matrix: the convection takes it
    whole, batch last (conv.conv_inner_batch_t), and each bucket's
    products read and write its (R, n, S) view, whose matrices are
    column blocks of it, so no step copies the state. The step is
    rearranged by linearity into two (n, n) products a bucket, with
    W = S_vv the velocity block of the saddle inverse and
    P = M/dt + L1 (Euler) or M/dt + rhs_half (CNAB2):
        x0 = W (P v - N(v)v) + d,  d = W (-fv [+ B K vbar]) + S_vp fp,
    in CNAB2 with 1.5 q_k - 0.5 q_{k-1} (q = N(v)v - L1 v) in place of
    N(v)v - L1 v and one more product; explicit feedback adds G u_k
    (G = W B), implicit feedback corrects x0 to
    x0 - G (I + K G)^-1 K x0, the m x m inverse formed once a bucket. The
    reference's AB2 seed q_{-1} = q_0 equals the first step's q, so the
    convection runs once a step.
    """
    if feedback not in ("explicit", "implicit"):
        raise ValueError(f"unknown feedback mode: {feedback}")
    r_b, s_b, n = v0.shape
    lu = cache_stack.lu
    cn = cache_stack.rhs_half is not None
    implicit = feedback == "implicit"
    b = sys.b

    # per-bucket operators, formed once
    w = lu.velocity_block()  # (R, n, n)
    gmat = lu.apply(b.expand(r_b, n, sys.m_in))  # (R, n, m)
    d = lu.apply(b.new_zeros((r_b, n, 1)), cache_stack.fp[..., None])
    c = -cache_stack.fv[..., None]  # (R, n, 1)
    vbar = cache_stack.vbar.T[:, :, None]  # (n, R, 1)
    if implicit:
        c = c + b @ (ks @ cache_stack.vbar[..., None])  # + B (K vbar)
        # G (I + K G)^-1, the m x m system inverted once a bucket (f64)
        eye_m = torch.eye(sys.m_in, dtype=b.dtype, device=b.device)
        g_smw = gmat @ torch.linalg.inv((eye_m + ks @ gmat).double()).to(
            b.dtype)
    d = torch.baddbmm(d, w, c)
    pmat = sys.mass.todense() / dt + (
        cache_stack.rhs_half if cn else cache_stack.l1_imp
    )

    def bview(x):  # (n, R*S) -> its (R, n, S) view
        return x.view(n, r_b, s_b).permute(1, 0, 2)

    def controls(x):  # u = -K (x - vbar), bucket by bucket: (R, m, S)
        dx = x.view(n, r_b, s_b) - vbar
        return torch.bmm(ks, dx.permute(1, 0, 2)).neg_()

    v = v0.permute(2, 0, 1).contiguous().view(n, r_b * s_b)
    ys = v.new_empty((nts + 1, sys.p_out, r_b * s_b))
    u_sq = v.new_empty((nts, r_b, s_b))
    torch.matmul(sys.c, v, out=ys[0])
    q_prev = None
    for k in range(nts):
        vb = bview(v)
        if not implicit:
            u = controls(v)
        rhs = conv.conv_inner_batch_t(v)  # N(v)v
        if cn:
            q = rhs
            bview(q).baddbmm_(cache_stack.l1_imp, vb, alpha=-1.0)
            rhs = torch.empty_like(v)
            torch.bmm(pmat, vb, out=bview(rhs))
            rhs.add_(q, alpha=-1.5).add_(
                q if q_prev is None else q_prev, alpha=0.5)
            q_prev = q
        else:
            bview(rhs).baddbmm_(pmat, vb, beta=-1.0)  # P v - N(v)v
        x = torch.empty_like(v)
        xb = bview(x)
        torch.bmm(w, bview(rhs), out=xb)
        xb += d
        if implicit:
            xb.baddbmm_(g_smw, torch.bmm(ks, xb), alpha=-1.0)
            u = controls(x)
        else:
            xb.baddbmm_(gmat, u)
        torch.sum(u * u, dim=1, out=u_sq[k])
        torch.matmul(sys.c, x, out=ys[k + 1])
        v = x
    ys = ys.view(nts + 1, sys.p_out, r_b, s_b).permute(2, 3, 0, 1)
    return (ys.contiguous(), u_sq.permute(1, 2, 0).contiguous(),
            v.view(n, r_b, s_b).permute(1, 2, 0).contiguous())


def nse_closed_loop_outputs(
    sys,
    conv,
    cache: NSEStepCache,
    k_gain: torch.Tensor,
    v0: torch.Tensor,
    alpha: float,
    dt: float,
    nts: int,
    feedback: str = "implicit",
):
    """Memory-lean closed loop of one scenario under the constant gain
    k_gain (m, n): (ys (nts+1, p), u_sq (nts,), v_final (n,)), no state
    trajectory kept. The sweep's loop (nse_sweep_outputs) at one bucket
    of one scenario; the cache's scheme (CNAB2 when rhs_half is present)
    and both feedback modes as there."""
    ys, u_sq, v_final = nse_sweep_outputs(
        sys, conv, NSEStepCache.stack([cache]), k_gain[None],
        v0[None, None], alpha, dt, nts, feedback,
    )
    return ys[0, 0], u_sq[0, 0], v_final[0, 0]


def build_sweep_steppers_ns_chain(
    setups: list,
    dt: float,
    conv,
    *,
    dtype=torch.float32,
):
    """Oseen steppers (scheme 'oseen') of the buckets of a parameter
    sweep (shared geometry), their explicit saddle inverses built on the
    device as a Newton-Schulz chain: bucket 0's inverse is the float64
    inverse of its step matrix, cast to dtype and refined by
    CHAIN_SEED_PASSES passes; each later bucket starts from the previous
    bucket's inverse and takes CHAIN_PASSES passes (adjacent Re buckets
    are close: the passes converge quadratically from the previous
    inverse).

    The step matrix [[M/dt - A_stokes + L1(vbar_r), J^T], [J, 0]] is the
    pencil [[At + s M, J^T], [J, 0]] of solvers/ns_inverse.py with
    At = L1(vbar_r) - A_stokes and s = 1/dt, so a pass is
    ns_inverse._ns_pass_saddle (the sparse products on the SpMM kernel,
    one dense GEMM). Every bucket is packed in the RCM ordering of bucket
    0, so each inverse seeds the next in the same ordering whatever
    sparsity pattern scipy gives a bucket's L1.

    Each bucket is certified as the Newton-Schulz stacks are
    (ns_inverse.certified_passes: the probe evaluated in float64 for a
    float32 chain, further passes while the residual is above
    CHAIN_CERTIFY_TOL and below 1, up to ns_inverse.MAX_CERTIFY_PASSES);
    a bucket that still misses, or whose residual is not finite or >= 1,
    raises RuntimeError.

    setups: (np_ops, sys, cond) per bucket (models/*; np_ops carries
    vbar_full), on one device; conv: a ConvKernel on the shared geometry
    (the device re-linearization L1(vbar_r) of each stepper). Returns
    (steppers, residuals, info): NSEStepCache per bucket (SaddleInverse
    in the original dof order), the float64-evaluated residuals, and
    info with each bucket's passes, extra_passes, residuals_working (the
    probe in dtype) and seconds (pack, passes with their probes,
    stepper).
    """
    import scipy.sparse as sp

    from ..solvers.ns_inverse import (
        SEED,
        SaddleOpsPack,
        certified_passes,
        ordered_operators,
        repack_at,
    )
    from ..solvers.saddle import SaddleInverse

    np_ops0, sys0, cond0 = setups[0]
    device = sys0.b.device
    s = 1.0 / dt

    def pencil_at(np_ops, cond):
        a_st = sp.csr_matrix(cond.mat_inner(np_ops["full"]["A"]))
        return (_l1_inner(np_ops, cond, "oseen") - a_st).tocsr()

    at_r, m_r, j_r, perm, p_perm = ordered_operators(
        pencil_at(np_ops0, cond0), np_ops0["M"], np_ops0["J"])
    n, n_p = m_r.shape[0], j_r.shape[0]
    iorder = torch.as_tensor(
        np.argsort(np.concatenate([perm, n + p_perm]))).to(device)
    pack = SaddleOpsPack.pack(at_r, m_r, j_r, device=device, dtype=dtype)
    pack64 = None
    if dtype != torch.float64:
        pack64 = SaddleOpsPack.pack(at_r, m_r, j_r, device=device,
                                    dtype=torch.float64)
    gen = torch.Generator(device=device).manual_seed(SEED)

    def dev(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    steppers, residuals = [], []
    info = {"passes": [], "extra_passes": [], "residuals_working": [],
            "seconds": []}
    x = None
    for r, (np_ops, _sys, cond) in enumerate(setups):
        t0 = time.perf_counter()
        if r == 0:
            big = sp.bmat([[at_r + s * m_r, j_r.T], [j_r, None]])
            big = torch.as_tensor(big.toarray()).to(device)
            # float64 on the device; its layout may be column-major
            x = torch.linalg.inv(big).to(dtype).contiguous()
            del big
            passes = CHAIN_SEED_PASSES
        else:
            at_r = sp.csr_matrix(pencil_at(np_ops, cond)[perm][:, perm])
            pack, pack64 = repack_at(pack, pack64, at_r)
            passes = CHAIN_PASSES
        sync()
        t1 = time.perf_counter()
        x, res, res_w, extra = certified_passes(
            pack, pack64, s, x, gen, passes, CHAIN_CERTIFY_TOL)
        if not (math.isfinite(res) and res <= CHAIN_CERTIFY_TOL):
            raise RuntimeError(
                f"Newton-Schulz chain: bucket {r} did not certify, residual "
                f"{res:.3e} (float64 probe) against {CHAIN_CERTIFY_TOL:g} "
                f"after {passes + extra} passes"
            )
        t2 = time.perf_counter()
        l1 = conv.linearized_dense(
            torch.as_tensor(np_ops["vbar_full"]).to(conv.t0),
            include_l2=False,
        )[conv.free][:, conv.free]
        full = np_ops["full"]
        steppers.append(NSEStepCache(
            lu=SaddleInverse(x[iorder[:, None], iorder], n),
            l1_imp=l1.to(dtype),
            fv=dev(cond.mat_bc_rhs(full["A"])),
            fp=dev(cond.jmat_bc_rhs(full["J"])),
            vbar=dev(cond.restrict(np_ops["vbar_full"])),
        ))
        del l1
        sync()
        residuals.append(res)
        info["passes"].append(passes + extra)
        info["extra_passes"].append(extra)
        info["residuals_working"].append(res_w)
        info["seconds"].append({
            "pack": t1 - t0, "passes": t2 - t1,
            "stepper": time.perf_counter() - t2,
        })
    return steppers, residuals, info
