"""Device-built dense saddle inverse stacks via Newton-Schulz ladders.

The dense ADI tier applies an explicit (n, n) velocity-block inverse per
shifted saddle pencil [[At + s M, J^T], [J, 0]] as one GEMM
(solvers/saddle.py SaddleShiftedInverseCache). This module builds that
stack on the device from the sparse operators, with no host
factorization. Counterpart of optconpy_tpu/solvers/ns_inverse.py:

  1. Newton-Schulz (X <- X (2I - A X)) converges quadratically whenever
     ||I - A X_0||_2 < 1; one pass is one sparse apply over n + n_p
     columns (four launches of the SpMM kernel, ops/spmm_kernel.py) and
     one dense (n + n_p)^2 GEMM (torch.matmul).
  2. Adjacent shifted saddles differ by (s_i - s_j) M, so an inverse at
     one shift seeds the next; a geometric ladder of synthetic shifts
     bounds the ratio between rungs.
  3. At a large synthetic shift s_huge the pencil is mass-dominated and
     [[s M, J^T], [J, 0]]^-1 has a closed block form in M^-1 (itself a
     short Newton-Schulz iteration from a scaled diagonal) and the
     (n_p, n_p) pressure Schur inverse.

Every shift's inverse is probed with random vectors: its residual and a
pass flag (residual <= certify_tol) are returned, and a residual that is
not finite or not below 1 (Newton-Schulz diverged) raises. The residual
that certifies is evaluated in float64 whatever the stack's dtype: in
float32, v - A(s)(X v) cancels terms that grow with |s|, so its
float32 evaluation has a floor of its own above the iterate's error.

NSShiftStack keeps the full inverses and refreshes them across the
re-linearizations of receding-horizon MPC, each refresh certified by the
same probe and rebuilt from the ladder where it misses.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.spmm_kernel import (
    SpmmPack,
    pack_spmm,
    rcm_permutation,
    sort_rows_by_window,
    spmm,
)

# The reference's ladder constants (optconpy_tpu/solvers/ns_inverse.py).
RUNG_RATIO = 1.6  # largest |s| ratio between neighbouring rungs
PASSES_PER_RUNG = 3
EXTRA_PASSES_AT_SHIFT = 1
MAX_CERTIFY_PASSES = 6  # further passes while a shift misses certify_tol
MINV_TOL = 1e-2
MAX_MINV_PASSES = 30
SEED_TOL = 0.3
MAX_SEED_PASSES = 12
POWER_ITERS = 24
N_PROBES = 8
SEED = 17
REFRESH_SEED = 3  # probes of NSShiftStack.refresh (the reference's key)
REFRESH_PASSES = 2  # the reference's passes per shift per refresh
CERTIFY_ROW_CHUNK = 2048  # rows of X cast to float64 at a time


@dataclass(frozen=True)
class SaddleOpsPack:
    """Sparse device packs of one saddle pencil family
    [[At + s M, J^T], [J, 0]] in an RCM velocity ordering (pressure rows
    sorted by their first velocity column)."""

    at: SpmmPack
    m: SpmmPack
    j: SpmmPack
    jt: SpmmPack
    m_diag: torch.Tensor  # (n,)
    n: int
    n_p: int

    @staticmethod
    def build(at_sp, m_sp, j_sp, *, device, dtype):
        """Host-side packing (scipy); returns (pack, perm, p_perm): perm
        the velocity ordering (pack rows = original rows[perm]), p_perm
        the pressure ordering (J's pack rows = original rows[p_perm])."""
        at_r, m_r, j_r, perm, p_perm = ordered_operators(at_sp, m_sp, j_sp)
        return SaddleOpsPack.pack(at_r, m_r, j_r, device=device,
                                  dtype=dtype), perm, p_perm

    @staticmethod
    def pack(at_r, m_r, j_r, *, device, dtype) -> "SaddleOpsPack":
        """Device packs of operators already in the pack's ordering."""
        def pack(a):
            return pack_spmm(a, device=device, dtype=dtype)

        return SaddleOpsPack(
            at=pack(at_r),
            m=pack(m_r),
            j=pack(j_r),
            jt=pack(j_r.T.tocsr()),
            m_diag=torch.as_tensor(m_r.diagonal()).to(device, dtype),
            n=at_r.shape[0],
            n_p=j_r.shape[0],
        )


def ordered_operators(at_sp, m_sp, j_sp):
    """The pencil's operators in an RCM velocity ordering with pressure
    rows sorted by their first velocity column (host scipy). Returns
    (at_r, m_r, j_r, perm, p_perm): at_r = at[perm][:, perm],
    j_r = j[p_perm][:, perm]."""
    import scipy.sparse as sp

    at = sp.csr_matrix(at_sp)
    m = sp.csr_matrix(m_sp)
    j = sp.csr_matrix(j_sp)
    perm = rcm_permutation(m, at)
    j_c = j[:, perm].tocsr()
    p_perm = sort_rows_by_window(j_c)
    return (
        at[perm][:, perm].tocsr(), m[perm][:, perm].tocsr(),
        j_c[p_perm].tocsr(), perm, p_perm,
    )


def _apply_big(pack: SaddleOpsPack, s: float, x):
    """[[At + s M, J^T], [J, 0]] @ X for X (n + n_p, q)."""
    n = pack.n
    xv, xp = x[:n], x[n:]
    out = torch.empty_like(x)
    top = out[:n]
    torch.add(spmm(pack.at, xv), spmm(pack.m, xv), alpha=s, out=top)
    top += spmm(pack.jt, xp)
    out[n:] = spmm(pack.j, xv)
    return out


def _ns_pass_saddle(pack: SaddleOpsPack, s: float, x):
    """One Newton-Schulz pass against the exact sparse pencil:
    X <- 2X - X (A(s) X)."""
    return torch.addmm(x, x, _apply_big(pack, s, x), beta=2.0, alpha=-1.0)


def _max_rel_norm(r, v) -> float:
    return float((r.norm(dim=0) / v.norm(dim=0)).max())


def _probes(rows: int, like, gen):
    return torch.randn((rows, N_PROBES), generator=gen, dtype=like.dtype,
                       device=like.device)


def _residual_probe(pack: SaddleOpsPack, s: float, x, gen) -> float:
    """max over random probes v of ||v - A(s) (X v)|| / ||v||."""
    v = _probes(x.shape[0], x, gen)
    return _max_rel_norm(v - _apply_big(pack, s, x @ v), v)


def _certify_probe(pack, pack64, s: float, x, gen) -> tuple[float, float]:
    """The probed residual of X at shift s evaluated in X's dtype and in
    float64 (pack64: the float64 pack, None when X is float64). The
    float64 X v is summed from row chunks of X cast to float64, so no
    float64 copy of the whole X exists."""
    v = _probes(x.shape[0], x, gen)
    res = _max_rel_norm(v - _apply_big(pack, s, x @ v), v)
    if pack64 is None:
        return res, res
    v64 = v.double()
    xv = torch.cat([
        x[r:r + CERTIFY_ROW_CHUNK].double() @ v64
        for r in range(0, x.shape[0], CERTIFY_ROW_CHUNK)
    ])
    return res, _max_rel_norm(v64 - _apply_big(pack64, s, xv), v64)


def certified_passes(pack, pack64, s: float, x, gen, passes: int,
                     certify_tol: float):
    """The certification policy of every Newton-Schulz inverse: passes
    passes at shift s, the probe (_certify_probe), then further passes
    while the float64 residual is above certify_tol and below 1, up to
    MAX_CERTIFY_PASSES. Returns (x, res (float64), res_w (x's dtype),
    extra passes); the caller decides what a miss means."""
    for _ in range(passes):
        x = _ns_pass_saddle(pack, s, x)
    res_w, res = _certify_probe(pack, pack64, s, x, gen)
    extra = 0
    while certify_tol < res < 1.0 and extra < MAX_CERTIFY_PASSES:
        x = _ns_pass_saddle(pack, s, x)
        extra += 1
        res_w, res = _certify_probe(pack, pack64, s, x, gen)
    return x, res, res_w, extra


def repack_at(pack, pack64, at_r):
    """(pack, pack64) with A^T replaced by at_r (already in the packs'
    ordering; same orderings and M, J)."""
    pack = dataclasses.replace(
        pack, at=pack_spmm(at_r, device=pack.m_diag.device,
                           dtype=pack.m_diag.dtype))
    if pack64 is not None:
        pack64 = dataclasses.replace(
            pack64, at=pack_spmm(at_r, device=pack64.m_diag.device,
                                 dtype=torch.float64))
    return pack, pack64


def _power_iteration(op, v) -> float:
    """lambda_max of a linear map by POWER_ITERS power steps."""
    lam = v.new_ones(())
    for _ in range(POWER_ITERS):
        w = op(v)
        lam = w.norm()
        v = w / lam.clamp_min(1e-30)
    return float(lam)


def _minv_ns_pass(pack: SaddleOpsPack, x):
    """X <- 2X - X (M X): Newton-Schulz for the SPD mass inverse."""
    return torch.addmm(x, x, spmm(pack.m, x), beta=2.0, alpha=-1.0)


def _minv_residual(pack: SaddleOpsPack, x, gen) -> float:
    v = _probes(pack.n, x, gen)
    return _max_rel_norm(v - spmm(pack.m, x @ v), v)


def _seed_block_inverse(pack: SaddleOpsPack, minv, jm, sp_inv, s_huge):
    """Closed-form [[s M, J^T], [J, 0]]^-1 from M^-1, jm = J M^-1 and the
    pressure Schur inverse S_p^-1 = (J M^-1 J^T)^-1:

      X_vv = (1/s)(M^-1 - M^-1 J^T S_p^-1 J M^-1)
      X_vp = M^-1 J^T S_p^-1,  X_pv = S_p^-1 J M^-1,  X_pp = -s S_p^-1
    """
    n = pack.n
    mjt = jm.T  # M^-1 J^T (M^-1 symmetric to Newton-Schulz accuracy)
    nn = n + pack.n_p
    x = torch.empty((nn, nn), dtype=minv.dtype, device=minv.device)
    x[:n, :n] = (minv - mjt @ (sp_inv @ jm)) / s_huge
    x[:n, n:] = mjt @ sp_inv
    x[n:, :n] = sp_inv @ jm
    x[n:, n:] = -s_huge * sp_inv
    return x


def _rungs_between(s_from: float, s_to: float) -> list[float]:
    """Geometric rungs from s_from down to s_to (same sign, |s|
    decreasing) with ratio <= RUNG_RATIO, ending at s_to."""
    out = []
    cur = s_from
    while abs(cur) / abs(s_to) > RUNG_RATIO:
        cur = cur / RUNG_RATIO
        out.append(cur)
    out.append(s_to)
    return out


def _ladder(pack: SaddleOpsPack, pack64, sig_np, certify_tol: float, gen,
            log, store) -> dict:
    """Steps 1-4 of the build for the shifts sig_np: M^-1, the pressure
    Schur inverse, the mass-dominated seed and the geometric ladder down
    to each shift, with the certifying probe at each. store(pos, x, res,
    res_w, extra) receives shift pos's full permuted iterate, its probed
    residual in float64 and in the working dtype and its extra passes,
    in ladder order (decreasing |s|). Returns the per-shift records and
    the ladder's counts (build_inverse_stack_ns's info without build_s).
    Raises if a residual is not finite or >= 1."""
    n, n_p = pack.n, pack.n_p
    dtype, device = pack.m_diag.dtype, pack.m_diag.device
    ns_passes = 0

    # --- 1. M^-1 by Newton-Schulz from a scaled-diagonal seed ---
    v0 = torch.randn((n, 1), generator=gen, dtype=dtype, device=device)
    lam_dm = _power_iteration(
        lambda v: spmm(pack.m, v) / pack.m_diag[:, None], v0
    )
    minv = torch.diag((1.0 / lam_dm) / pack.m_diag)
    minv_passes = 0
    res_m = _minv_residual(pack, minv, gen)
    while res_m > MINV_TOL and minv_passes < MAX_MINV_PASSES:
        minv = _minv_ns_pass(pack, minv)
        minv_passes += 1
        if minv_passes % 4 == 0 or minv_passes > 20:
            res_m = _minv_residual(pack, minv, gen)
    log(f"  minv: lam_max(D^-1 M)={lam_dm:.2f}, {minv_passes} passes, "
        f"residual {res_m:.1e}")

    # --- 2. pressure Schur inverse (n_p x n_p dense, inverted in f64) ---
    eye_p = torch.eye(n_p, dtype=dtype, device=device)
    jm = spmm(pack.j, minv)  # (n_p, n) = J M^-1
    schur = jm @ spmm(pack.jt, eye_p)
    sp_inv = torch.linalg.inv(schur.double()).to(dtype)
    del eye_p, schur

    # --- 3. mass-dominated synthetic seed ---
    order = np.argsort(-np.abs(sig_np))
    s_sorted = sig_np[order]
    v0 = torch.randn((n, 1), generator=gen, dtype=dtype, device=device)
    lam_p = _power_iteration(lambda v: minv @ spmm(pack.at, v), v0)
    sign = float(np.sign(s_sorted[0]) or 1.0)
    s_huge = sign * max(10.0 * lam_p, 10.0 * abs(s_sorted[0]))
    x = _seed_block_inverse(pack, minv, jm, sp_inv, s_huge)
    del minv, jm, sp_inv
    r_seed = _residual_probe(pack, s_huge, x, gen)
    # Seed refinement at s_huge itself (fixes the approximate M^-1).
    seed_passes = 0
    while r_seed > SEED_TOL and seed_passes < MAX_SEED_PASSES:
        x = _ns_pass_saddle(pack, s_huge, x)
        seed_passes += 1
        r_seed = _residual_probe(pack, s_huge, x, gen)
    ns_passes += seed_passes
    log(f"  seed: s_huge={s_huge:.3e} (|M^-1 At| ~ {lam_p:.2e}), "
        f"{seed_passes} refine passes, residual {r_seed:.2e}")

    # --- 4. geometric ladder s_huge -> shifts, NS at every rung ---
    residuals = [None] * len(sig_np)
    working = [None] * len(sig_np)
    certified = [None] * len(sig_np)
    extras = [None] * len(sig_np)
    s_cur = s_huge
    n_rungs = 0
    for pos, s_target in zip(order, s_sorted):
        s_target = float(s_target)
        for s_r in _rungs_between(s_cur, s_target):
            for _ in range(PASSES_PER_RUNG):
                x = _ns_pass_saddle(pack, s_r, x)
            ns_passes += PASSES_PER_RUNG
            n_rungs += 1
            s_cur = s_r
        x, res, res_w, extra = certified_passes(
            pack, pack64, s_target, x, gen, EXTRA_PASSES_AT_SHIFT,
            certify_tol)
        ns_passes += EXTRA_PASSES_AT_SHIFT + extra
        if not math.isfinite(res) or res >= 1.0:
            raise RuntimeError(
                f"Newton-Schulz diverged at shift {s_target:.4e}: "
                f"residual {res:.3e}"
            )
        residuals[pos] = res
        working[pos] = res_w
        certified[pos] = res <= certify_tol
        extras[pos] = extra
        store(pos, x, res, res_w, extra)
        flag = "certified" if certified[pos] else "NOT certified"
        log(f"  shift {s_target:12.2f}: residual {res:.2e} (in {dtype}: "
            f"{res_w:.2e}) (+{extra} extra passes, {flag})")
    return {
        "residuals": residuals,
        "residuals_working": working,
        "certified": certified,
        "certify_tol": certify_tol,
        "extra_passes": extras,
        "s_huge": s_huge,
        "seed_residual": r_seed,
        "minv_passes": minv_passes,
        "minv_residual": res_m,
        "ladder_rungs": n_rungs,
        "ns_passes": ns_passes,
    }


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _packs(at_sp, m_sp, j_sp, *, device, dtype):
    """The pencil's packs in the RCM ordering: (pack, pack64 (the float64
    pack the certifying probe reads; None for a float64 stack), perm,
    iperm on the device)."""
    at_r, m_r, j_r, perm, _ = ordered_operators(at_sp, m_sp, j_sp)
    pack = SaddleOpsPack.pack(at_r, m_r, j_r, device=device, dtype=dtype)
    pack64 = None
    if dtype != torch.float64:
        pack64 = SaddleOpsPack.pack(at_r, m_r, j_r, device=device,
                                    dtype=torch.float64)
    return pack, pack64, perm, torch.as_tensor(np.argsort(perm)).to(device)


def build_inverse_stack_ns(
    at_sp, m_sp, j_sp, sig, *, device, dtype, certify_tol: float = 5e-4,
    verbose=None,
):
    """Build the (J, n, n) shifted-saddle velocity-block inverse stack on
    `device` in `dtype`. Same output contract as
    SaddleShiftedInverseCache.build_sparse_host (original dof order).

    Returns (inv_stack, info): info["residuals"][i] is shift i's probed
    residual evaluated in float64 and info["certified"][i] whether it is
    <= certify_tol (further passes run while it is not, up to
    MAX_CERTIFY_PASSES); info["residuals_working"][i] is the same probe
    evaluated in `dtype`. Also the ladder's counts and the build time in
    seconds. Raises if a residual is not finite or >= 1 (Newton-Schulz
    diverged).
    """
    log = verbose or (lambda *_: None)
    t_all = time.perf_counter()
    pack, pack64, _, iperm = _packs(at_sp, m_sp, j_sp, device=device,
                                    dtype=dtype)
    sig_np = np.asarray(sig, np.float64).reshape(-1)
    stack = []

    def store(pos, x, *_):
        # allocated at the first shift, after the seed's work arrays
        if not stack:
            stack.append(torch.empty((len(sig_np), pack.n, pack.n),
                                     dtype=dtype, device=device))
        # velocity block, back in the original dof order
        stack[0][pos] = x[iperm[:, None], iperm]

    info = _ladder(
        pack, pack64, sig_np, certify_tol,
        torch.Generator(device=device).manual_seed(SEED), log, store,
    )
    _sync(stack[0])
    info["build_s"] = time.perf_counter() - t_all
    return stack[0], info


class NSShiftStack:
    """Receding-horizon helper: a device-resident stack of full
    shifted-saddle inverses that refreshes in place across MPC
    re-linearizations and exposes the dense-ADI cache view
    (SaddleShiftedInverseCache contract). Counterpart of the reference's
    NSShiftStack, whose refresh is not certified: here every refresh is.

    refresh(at_sp_new) repacks A^T and runs REFRESH_PASSES Newton-Schulz
    passes per shift from the previous inverse, then probes the residual
    as the build does (in float64 for a float32 stack). While a shift
    misses certify_tol, further passes run, up to MAX_CERTIFY_PASSES; a
    shift that still misses, or whose residual is not finite or >= 1
    (the jump left Newton-Schulz's basin), is rebuilt from the ladder
    about the new operator. A build or rebuild that does not certify
    raises. With no further pass, the refresh is the plain 2-pass one.

    After each build or refresh: residuals, residuals_working, certified
    and extra_passes per shift, and rebuilds, the number of shifts the
    last refresh rebuilt.

    Memory: the (J, n + n_p, n + n_p) full inverses plus the (J, n, n)
    velocity-block view (config 4 in float32: 0.81 + 0.62 GB), and the
    float64 packs of a float32 stack.
    """

    def __init__(self, at_sp, m_sp, j_sp, sig, *, device, dtype,
                 certify_tol: float = 5e-4):
        self.sig = np.asarray(sig, np.float64).reshape(-1)
        self.certify_tol = certify_tol
        self.pack, self.pack64, self.perm, self.iperm = _packs(
            at_sp, m_sp, j_sp, device=device, dtype=dtype)
        self.n = self.pack.n
        n_shifts = len(self.sig)
        # allocated at the first shift, after the seed's work arrays
        self.full = self.vv = None
        self.residuals = [None] * n_shifts
        self.residuals_working = [None] * n_shifts
        self.certified = [False] * n_shifts
        self.extra_passes = [0] * n_shifts
        self.rebuilds = 0
        _ladder(self.pack, self.pack64, self.sig, certify_tol,
                torch.Generator(device=device).manual_seed(SEED),
                lambda *_: None, self._store)
        _sync(self.vv)
        self._check("build")

    def _check(self, what: str) -> None:
        if not all(self.certified):
            missed = [float(s) for s, ok in zip(self.sig, self.certified)
                      if not ok]
            raise RuntimeError(
                f"NSShiftStack {what}: shifts {missed} did not certify at "
                f"{self.certify_tol:g} (residuals {self.residuals})"
            )

    def _store(self, i: int, x: torch.Tensor, res, res_w, extra) -> None:
        """Shift i's iterate and its records."""
        if self.full is None:
            shape = (len(self.sig),) + tuple(x.shape)
            self.full = x.new_empty(shape)
            self.vv = x.new_empty((len(self.sig), self.n, self.n))
        self.full[i] = x
        self.vv[i] = x[self.iperm[:, None], self.iperm]
        self.residuals[i], self.residuals_working[i] = res, res_w
        self.certified[i] = res <= self.certify_tol
        self.extra_passes[i] = extra

    def cache(self):
        from .saddle import SaddleShiftedInverseCache

        return SaddleShiftedInverseCache(self.vv, self.n)

    def refresh(self, at_sp_new) -> "NSShiftStack":
        """Certified value-refresh for a re-linearized A^T (same pattern
        and orderings; class docstring). Returns self (mutated)."""
        import scipy.sparse as sp

        at_r = sp.csr_matrix(at_sp_new)[self.perm][:, self.perm].tocsr()
        device = self.vv.device
        self.pack, self.pack64 = repack_at(self.pack, self.pack64, at_r)
        gen = torch.Generator(device=device).manual_seed(REFRESH_SEED)
        missed = []
        for i, s in enumerate(self.sig.tolist()):
            x, res, res_w, extra = certified_passes(
                self.pack, self.pack64, s, self.full[i], gen, REFRESH_PASSES,
                self.certify_tol)
            if res <= self.certify_tol:  # False for NaN
                self._store(i, x, res, res_w, extra)
            else:
                missed.append(i)
            del x
        self.rebuilds = len(missed)
        if missed:
            _ladder(
                self.pack, self.pack64, self.sig[missed], self.certify_tol,
                torch.Generator(device=device).manual_seed(SEED),
                lambda *_: None,
                lambda pos, x, *rec: self._store(missed[pos], x, *rec),
            )
            self._check("rebuild")
        _sync(self.vv)
        return self
