"""Port matrix-free saddle solves (solvers/matfree.py) vs the reference.

On the reference tests' fixtures (tests/test_matfree.py: cavity nx=5,
block 64, 30 Krylov vectors, 12 cycles, tol 1e-11), in f64 on the CPU
where the SpMM kernel takes its plain version: every shift against the
reference's SaddleMatfreeCache and the port's SaddleShiftedLUCache
(1e-8), the full saddle residual with a pressure rhs (1e-8), SMW
(1e-7), the projected ADI (1e-6), both refresh_operator variants
(1e-8), a 2-step DRE sweep against the reference's matrix-free sweep
and the port's 'lu' sweep (1e-6), and the matrix-free closed loop on
the cavity nx=4 in both feedback modes against the reference's and the
port's 'lu' stepper (1e-7). The reference side packs with kind="ell":
its windowed Pallas SpMM accumulates in f32 even on f64 inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch

from optconpy_tpu import native as j_native
from optconpy_tpu.fem.device_conv import ConvKernel as JConvKernel
from optconpy_tpu.models.cavity import cavity_stokes_setup as j_cavity_setup
from optconpy_tpu.mpc import batched_nse_closed_loop as j_nse_loop
from optconpy_tpu.mpc import build_nse_stepper_matfree as j_build_matfree
from optconpy_tpu.riccati import build_dre_cache_dae_matfree as j_dre_matfree
from optconpy_tpu.riccati import dre_backward_sweep as j_dre_sweep
from optconpy_tpu.riccati import lowrank_adi as j_lowrank_adi
from optconpy_tpu.solvers import SaddleMatfreeCache as JMatfree
from optconpy_tpu.solvers.steady import solve_steady_nse_host as j_steady
from optconpy_tpu_torch.fem.device_conv import ConvKernel
from optconpy_tpu_torch.models.cavity import cavity_stokes_setup
from optconpy_tpu_torch.mpc import (
    NSEMatfreeStepCache,
    batched_nse_closed_loop,
    build_nse_stepper,
    build_nse_stepper_matfree,
)
from optconpy_tpu_torch.ops import spmm_kernel
from optconpy_tpu_torch.riccati import (
    build_dre_cache_dae,
    build_dre_cache_dae_matfree,
    dre_backward_sweep,
    dre_shift_schedule_dae,
    lowrank_adi,
)
from optconpy_tpu_torch.riccati.shifts import (
    cycled_shifts,
    spectral_interval_dae,
    wachspress_shifts,
)
from optconpy_tpu_torch.solvers.matfree import SaddleMatfreeCache
from optconpy_tpu_torch.solvers.saddle import SaddleShiftedLUCache
from optconpy_tpu_torch.solvers.steady import solve_steady_nse_host

CPU = torch.device("cpu")
F64 = torch.float64
MF = dict(block=64, m_krylov=30, max_cycles=12, tol=1e-11)
N_SHIFTS = 6


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(x):
    return torch.as_tensor(np.asarray(x)).to(F64)


@pytest.fixture(scope="module", autouse=True)
def _one_host_thread():
    """One torch and one BLAS thread for the module: host BLAS/LAPACK
    work runs many times slower when busy-waiting BLAS threads share
    the cores with other test workers."""
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield


def _j_cavity(nx):
    with pytest.MonkeyPatch.context() as mp:
        # the reference's numpy element path, the port's only one
        mp.setattr(j_native, "available", lambda: False)
        return j_cavity_setup(nx=nx)


@pytest.fixture(scope="module")
def shifted():
    j_ops, j_sys, _ = _j_cavity(5)
    t_ops, t_sys, _ = cavity_stokes_setup(nx=5, device=CPU)
    a_min, a_max = spectral_interval_dae(t_ops["A"], t_ops["M"], t_ops["J"])
    sig = wachspress_shifts(a_min, a_max, N_SHIFTS)
    at = t_ops["A"].T.tocsr()
    mf = SaddleMatfreeCache.build(at, t_ops["M"], t_ops["J"], sig, device=CPU,
                                  dtype=F64, **MF)
    j_mf = JMatfree.build(at, j_ops["M"], j_ops["J"], sig, dtype=jnp.float64,
                          kind="ell", **MF)
    m_d, a_d, j_d = t_sys.dense()
    lu = SaddleShiftedLUCache.build(a_d.T, m_d, j_d, sig)
    return j_sys, t_ops, t_sys, sig, mf, j_mf, lu


@pytest.fixture(scope="module")
def solves(shifted):
    """Each shift's solve in both packages and through the LU cache."""
    _, _, t_sys, sig, mf, j_mf, lu = shifted
    rhs = np.random.default_rng(0).standard_normal((t_sys.n, 3))
    return {
        i: (mf.solve(i, _t(rhs)), lu.solve(i, _t(rhs)),
            np.asarray(j_mf.solve(jnp.int32(i), jnp.asarray(rhs))))
        for i in range(len(sig))
    }


@pytest.mark.parametrize("i", range(N_SHIFTS))
def test_matfree_matches_reference_and_lu(shifted, solves, i):
    _, t_ops, _, _, mf, _, _ = shifted
    got, lu, ref = solves[i]
    assert _rel(got, ref) < 1e-8
    assert _rel(got, lu) < 1e-8
    # feasibility without any explicit projection
    jx = t_ops["J"] @ got.numpy()
    assert np.abs(jx).max() < 1e-9 * max(1.0, got.abs().max().item())


def test_matfree_pack_is_the_ns_pack(shifted):
    """The cache's packs and orderings are SaddleOpsPack's, and the
    pressure ordering matches the reference's p_perm."""
    _, _, _, _, mf, j_mf, _ = shifted
    assert np.array_equal(mf.perm.numpy(), np.asarray(j_mf.perm))
    assert np.array_equal(mf.p_perm.numpy(), np.asarray(j_mf.p_perm))
    assert mf.bj_inv.shape == tuple(j_mf.bj_inv.shape)
    assert _rel(mf.bj_inv, np.asarray(j_mf.bj_inv)) < 1e-12
    assert _rel(mf.lp_inv, np.asarray(j_mf.lp_inv)) < 1e-12
    assert mf.schur_coeffs == tuple(np.asarray(j_mf.schur_coeffs).tolist())


def test_apply_full_residual(shifted):
    """apply_full solves the full saddle system with a pressure rhs (the
    stepper's BC rhs), as SaddleLU does."""
    _, t_ops, t_sys, sig, mf, _, _ = shifted
    rng = np.random.default_rng(1)
    rhs_v = rng.standard_normal((t_sys.n, 2))
    rhs_p = rng.standard_normal((t_sys.n_p, 2))
    i = 1
    v, p = mf.apply_full(_t(rhs_v), _t(rhs_p), i=i)
    v, p = v.numpy(), p.numpy()
    f = t_ops["A"].T + sig[i] * t_ops["M"]
    scale = max(np.abs(rhs_v).max(), np.abs(rhs_p).max())
    assert np.abs(f @ v + t_ops["J"].T @ p - rhs_v).max() < 1e-8 * scale
    assert np.abs(t_ops["J"] @ v - rhs_p).max() < 1e-8 * scale
    v1 = mf.apply(_t(rhs_v[:, 0]), _t(rhs_p[:, 0]), i=i)
    assert v1.shape == (t_sys.n,) and _rel(v1, v[:, 0]) < 1e-9
    # a warm start at the solution converges at once to the same answer
    vw, pw = mf.apply_full(_t(rhs_v), _t(rhs_p), i=i, x0=(_t(v), _t(p)))
    assert _rel(vw, v) < 1e-9 and _rel(pw, p) < 1e-8


def test_solve_smw_matches_lu(shifted):
    j_sys, _, t_sys, _, mf, j_mf, lu = shifted
    rng = np.random.default_rng(2)
    u = 0.1 * rng.standard_normal((t_sys.n, t_sys.m_in))
    rhs = rng.standard_normal((t_sys.n, 2))
    got = mf.solve_smw(3, _t(u), t_sys.b, _t(rhs))
    assert _rel(got, lu.solve_smw(3, _t(u), t_sys.b, _t(rhs))) < 1e-7
    ref = j_mf.solve_smw(jnp.int32(3), jnp.asarray(u), j_sys.b,
                         jnp.asarray(rhs))
    assert _rel(got, np.asarray(ref)) < 1e-7


def test_solve_relres(shifted):
    _, _, t_sys, _, mf, _, _ = shifted
    rhs = _t(np.random.default_rng(3).standard_normal((t_sys.n, 2)))
    x, rel = mf.solve_relres(0, rhs)
    assert isinstance(rel, float) and 0.0 < rel <= MF["tol"]
    assert torch.equal(x, mf.solve(0, rhs))
    x1, rel1 = mf.solve_relres(0, rhs[:, 0])
    assert x1.shape == (t_sys.n,) and rel1 <= MF["tol"]


def test_fgmres_stats_count_every_solve(shifted):
    """solve, solve_relres and apply_full each add one record; at the
    fixture's settings (tol 1e-11, 12 cycles) none ends above tol."""
    _, _, t_sys, _, mf, _, _ = shifted
    rng = np.random.default_rng(4)
    rhs = _t(rng.standard_normal((t_sys.n, 2)))
    before = mf.stats.solves
    mf.solve(2, rhs)
    _, rel = mf.solve_relres(2, rhs)
    mf.apply_full(rhs, _t(rng.standard_normal((t_sys.n_p, 2))), i=2)
    assert mf.stats.solves == before + 3
    assert mf.stats.above_tol == 0
    assert rel <= mf.stats.worst_relres <= MF["tol"]
    assert mf.stats.as_dict()["tol"] == MF["tol"]


def test_fgmres_stats_count_solves_above_tol(shifted):
    """One cycle at tol 1e-14: every solve stops above tol, is counted,
    and the worst relres exceeds tol; the solves still return."""
    _, t_ops, t_sys, sig, _, _, _ = shifted
    mf = SaddleMatfreeCache.build(
        t_ops["A"].T.tocsr(), t_ops["M"], t_ops["J"], sig[:2], device=CPU,
        dtype=F64, **dict(MF, max_cycles=1, tol=1e-14, m_krylov=4),
    )
    rhs = _t(np.random.default_rng(5).standard_normal((t_sys.n, 2)))
    for i in range(2):
        mf.solve(i, rhs)
        mf.apply(rhs, i=i)
    assert mf.stats.solves == mf.stats.above_tol == 4
    assert mf.stats.worst_relres > 1e-14


def test_adi_matches_lu_and_reference(shifted):
    j_sys, _, t_sys, sig, mf, j_mf, lu = shifted
    n_adi = 12
    sseq = cycled_shifts(np.asarray(sig), n_adi)
    iseq = cycled_shifts(np.arange(len(sig), dtype=np.int32), n_adi)
    args = dict(smw_u=torch.zeros((t_sys.n, t_sys.m_in), dtype=F64),
                smw_v=t_sys.b, mass=t_sys.mass, w=t_sys.c.T,
                sigma_seq=_t(sseq), idx_seq=[int(i) for i in iseq])
    z_mf = lowrank_adi(mf, **args)
    assert _rel(z_mf, lowrank_adi(lu, **args)) < 1e-6
    j_z = j_lowrank_adi(
        j_mf, smw_u=jnp.zeros((t_sys.n, t_sys.m_in)), smw_v=j_sys.b,
        mass=j_sys.mass, w=j_sys.c.T, sigma_seq=jnp.asarray(sseq),
        idx_seq=jnp.asarray(iseq),
    )
    assert _rel(z_mf, np.asarray(j_z)) < 1e-6


@pytest.fixture(scope="module")
def refreshed(shifted):
    """A convection-sized asymmetric change of A^T: the refreshed cache
    (kept or re-inverted preconditioner) and a full build of the new
    operator, on 4 shifts."""
    _, t_ops, _, sig, _, _, _ = shifted
    sig4 = sig[:: len(sig) // 4][:4]
    base = SaddleMatfreeCache.build(t_ops["A"].T.tocsr(), t_ops["M"],
                                    t_ops["J"], sig4, device=CPU, dtype=F64,
                                    **MF)
    at = t_ops["A"].T.tocsr()
    pert = sp.csr_matrix(
        (0.05 * np.sign(at.data) * at.data, at.indices, at.indptr),
        shape=at.shape,
    )
    at_new = (at + pert.T).tocsr()
    full = SaddleMatfreeCache.build(at_new, t_ops["M"], t_ops["J"], sig4,
                                    device=CPU, dtype=F64, **MF)
    return base, at_new, full, sig4


@pytest.mark.parametrize("reinvert", [False, True])
def test_refresh_operator_matches_full_build(shifted, refreshed, reinvert):
    """The refreshed cache solves the new operator to the FGMRES
    tolerance: the preconditioner (kept, or re-inverted from f32-rounded
    operators) changes iteration counts only."""
    _, t_ops, t_sys, _, _, _, _ = shifted
    base, at_new, full, sig4 = refreshed
    new = base.refresh_operator(at_new, m_sp=t_ops["M"] if reinvert else None)
    assert (new.bj_inv is base.bj_inv) != reinvert
    # the refreshed cache starts its own record of solves
    assert new.stats is not base.stats and new.stats.solves == 0
    base_solves = base.stats.solves
    assert new.ops.m is base.ops.m and new.lp_inv is base.lp_inv
    rhs = _t(np.random.default_rng(1).standard_normal((t_sys.n, 3)))
    for i in range(len(sig4)):
        assert _rel(new.solve(i, rhs), full.solve(i, rhs)) < 1e-8, i
    assert new.stats.solves == len(sig4) and new.stats.above_tol == 0
    assert base.stats.solves == base_solves


def test_dre_sweep_matches_reference_and_lu(shifted):
    """Two backward DRE steps: the matrix-free gains equal the reference's
    matrix-free gains and the port's 'lu' gains."""
    j_sys, t_ops, t_sys, _, _, _, _ = shifted
    dt, nts = 0.05, 2
    sig, sseq, iseq = dre_shift_schedule_dae(
        t_ops["A"], t_ops["M"], t_ops["J"], dt, num_shifts=N_SHIFTS,
        n_adi=8,
    )
    kw = dict(alpha=1e-2, dt=dt, nts=nts, n_newton=1, r_max=24)
    before = spmm_kernel.launches
    mf = build_dre_cache_dae_matfree(t_sys, dt, sig, block=64,
                                     max_cycles=12, tol=1e-11)
    _, ks_mf = dre_backward_sweep(t_sys, mf, sigma_seq=sseq, idx_seq=iseq,
                                  **kw)
    assert spmm_kernel.launches == before  # the CPU takes the plain version
    _, ks_lu = dre_backward_sweep(t_sys, build_dre_cache_dae(t_sys, dt, sig),
                                  sigma_seq=sseq, idx_seq=iseq, **kw)
    j_mf = j_dre_matfree(j_sys, dt, sig, dtype=jnp.float64, block=64,
                         max_cycles=12, tol=1e-11, kind="ell")
    _, j_ks = j_dre_sweep(j_sys, j_mf, sigma_seq=jnp.asarray(sseq),
                          idx_seq=jnp.asarray(iseq), **kw)
    assert np.abs(ks_mf.numpy()).max() > 0
    assert _rel(ks_mf, ks_lu) < 1e-6
    assert _rel(ks_mf, np.asarray(j_ks)) < 1e-6


# --- the matrix-free closed loop (cavity nx=4) -------------------------------

DT_ROLL, ALPHA_ROLL, NTS_ROLL, S_ROLL = 0.02, 1e-4, 4, 8


@pytest.fixture(scope="module")
def rollout_setup():
    """tests/test_matfree.py:244-262: the cavity nx=4 about its steady
    NSE flow, 8 scenarios, a random gain broadcast over 4 steps."""
    j_ops, j_sys, j_cond = _j_cavity(4)
    j_ops["vbar_full"], _ = j_steady(j_ops["full"], j_cond)
    t_ops, t_sys, t_cond = cavity_stokes_setup(nx=4, device=CPU)
    t_ops["vbar_full"], _ = solve_steady_nse_host(t_ops["full"], t_cond)
    n, m = t_sys.b.shape
    rng = np.random.default_rng(2)
    vbar = t_cond.restrict(t_ops["vbar_full"])
    v0 = vbar[None] + 1e-3 * rng.standard_normal((S_ROLL, n))
    ks = np.broadcast_to(1e-3 * rng.standard_normal((m, n)),
                         (NTS_ROLL + 1, m, n)).copy()
    ws = np.zeros((NTS_ROLL + 1, n))
    return (j_ops, j_sys, j_cond), (t_ops, t_sys, t_cond), (v0, ks, ws)


@pytest.mark.parametrize("feedback", ["explicit", "implicit"])
def test_matfree_rollout_matches_reference_and_lu(rollout_setup, feedback):
    (j_ops, j_sys, j_cond), (t_ops, t_sys, t_cond), (v0, ks, ws) = (
        rollout_setup
    )
    mf_kw = dict(block=64, max_cycles=12, tol=1e-11)
    mf = build_nse_stepper_matfree(t_ops, t_cond, DT_ROLL, device=CPU,
                                   dtype=F64, **mf_kw)
    assert isinstance(mf, NSEMatfreeStepCache) and mf.rhs_half is None
    lu = build_nse_stepper(t_ops, t_cond, DT_ROLL, device=CPU, dtype=F64)
    conv = ConvKernel.build(t_ops["full"], t_cond, device=CPU, dtype=F64)
    args = (_t(ks), _t(ws), _t(v0), ALPHA_ROLL, DT_ROLL)
    got = batched_nse_closed_loop(t_sys, conv, mf, *args, feedback=feedback)
    via_lu = batched_nse_closed_loop(t_sys, conv, lu, *args,
                                     feedback=feedback)
    j_mf = j_build_matfree(j_ops, j_cond, DT_ROLL, dtype=jnp.float64,
                           kind="ell", **mf_kw)
    j_conv = JConvKernel.build(j_ops["full"], j_cond, dtype=jnp.float64)
    ref = j_nse_loop(j_sys, j_conv, j_mf, jnp.asarray(ks), jnp.asarray(ws),
                     jnp.asarray(v0), ALPHA_ROLL, DT_ROLL, feedback=feedback)
    for name, a, b, c in zip("vuy", got, via_lu, ref):
        assert _rel(a, c) < 1e-7, name
        assert _rel(a, b) < 1e-7, name
    with pytest.raises(ValueError, match="dt="):
        batched_nse_closed_loop(t_sys, conv, mf, *args[:-1], 2 * DT_ROLL)
