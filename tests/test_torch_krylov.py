"""Port Krylov solvers (solvers/krylov.py) vs the reference, on the CPU.

cg, gmres and fgmres of both packages take the same seeded numpy inputs
(heat1d's SPD mass matrix, a random nonsymmetric block) and must agree
to roundoff; the float32/float64 breakdown cases and the zero-rhs warm
start of the reference's tests stay finite and accurate; the Krylov
shifted caches (reference LUs + GMRES) match the reference's and the
port's per-shift LU caches on heat1d and the cavity (nx=5), through the
projected ADI too; a non-finite residual makes fgmres raise instead of
stopping as converged.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from optconpy_tpu import native as j_native
from optconpy_tpu.fem.heat1d import heat1d_operators as j_heat1d
from optconpy_tpu.models.cavity import cavity_stokes_setup as j_cavity_setup
from optconpy_tpu.riccati import lowrank_adi as j_lowrank_adi
from optconpy_tpu.solvers import krylov as jk
from optconpy_tpu_torch.fem.heat1d import heat1d_operators
from optconpy_tpu_torch.models.cavity import cavity_stokes_setup
from optconpy_tpu_torch.riccati import lowrank_adi
from optconpy_tpu_torch.riccati.shifts import (
    cycled_shifts,
    spectral_interval,
    spectral_interval_dae,
    wachspress_shifts,
)
from optconpy_tpu_torch.solvers import krylov as tk
from optconpy_tpu_torch.solvers.saddle import SaddleShiftedLUCache
from optconpy_tpu_torch.solvers.shifted import ShiftedLUCache

CPU = torch.device("cpu")
F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(x, dtype=F64):
    return torch.as_tensor(np.asarray(x)).to(dtype)


@pytest.fixture(scope="module", autouse=True)
def _one_host_thread():
    """One torch and one BLAS thread for the module: host BLAS/LAPACK
    work runs many times slower when busy-waiting BLAS threads share
    the cores with other test workers."""
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def heat():
    j_ops, j_sys = j_heat1d(n=64)
    t_ops, t_sys = heat1d_operators(n=64, device=CPU)
    a_min, a_max = spectral_interval(t_ops["A"], t_ops["M"])
    sig = wachspress_shifts(a_min, a_max, 8)
    return j_ops, j_sys, t_ops, t_sys, sig


@pytest.fixture(scope="module")
def cavity():
    with pytest.MonkeyPatch.context() as mp:
        # the reference's numpy element path, the port's only one
        mp.setattr(j_native, "available", lambda: False)
        j_ops, j_sys, _ = j_cavity_setup(nx=5)
    t_ops, t_sys, _ = cavity_stokes_setup(nx=5, device=CPU)
    a_min, a_max = spectral_interval_dae(t_ops["A"], t_ops["M"], t_ops["J"])
    sig = wachspress_shifts(a_min, a_max, 8)
    return j_ops, j_sys, t_ops, t_sys, sig


def _nonsymmetric(n, seed, scale):
    rng = np.random.default_rng(seed)
    return np.eye(n) + scale * rng.standard_normal((n, n)), rng


# --- the solvers on shared inputs -------------------------------------------

def test_cg_matches_reference(heat):
    _, _, t_ops, _, _ = heat
    m_d = t_ops["M"].toarray()
    b = np.random.default_rng(0).standard_normal((64, 3))
    x, res = tk.cg(lambda v: _t(m_d) @ v, _t(b), n_iter=80)
    jx, _ = jk.cg(lambda v: jnp.asarray(m_d) @ v, jnp.asarray(b), n_iter=80)
    assert _rel(x, np.linalg.solve(m_d, b)) < 1e-10
    assert _rel(x, jx) < 1e-12
    assert float(res.max()) < 1e-10
    x1, _ = tk.cg(lambda v: _t(m_d) @ v, _t(b[:, 0]), n_iter=80)
    assert x1.shape == (64,) and _rel(x1, x[:, 0]) < 1e-12


@pytest.mark.parametrize("precond", [False, True])
def test_gmres_matches_reference(precond):
    n = 64
    a, rng = _nonsymmetric(n, 1, 0.3 / np.sqrt(n))
    b = rng.standard_normal((n, 2))
    d = 1.0 / np.diag(a)  # a Jacobi preconditioner
    kw = {"n_iter": 40}
    x, res = tk.gmres(lambda v: _t(a) @ v, _t(b), precond=(
        (lambda v: _t(d)[:, None] * v) if precond else None), **kw)
    jx, jres = jk.gmres(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), precond=(
        (lambda v: jnp.asarray(d)[:, None] * v) if precond else None), **kw)
    assert _rel(x, np.linalg.solve(a, b)) < 1e-8
    assert _rel(x, jx) < 1e-10
    assert res.shape == (2,) and float(res.max()) < 1e-8 * np.abs(b).max()


def test_fgmres_matches_reference():
    """Restarted cycles with a short basis: the same cycle count, the
    same answer, a Python-float residual."""
    n = 64
    a, rng = _nonsymmetric(n, 4, 0.5 / np.sqrt(n))
    b = rng.standard_normal((n, 3))
    b[:, 2] *= 1e-9
    x, rel = tk.fgmres(lambda v: _t(a) @ v, _t(b), m=8, tol=1e-11,
                       max_cycles=20)
    jx, jrel = jk.fgmres(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), m=8,
                         tol=1e-11, max_cycles=20)
    assert isinstance(rel, float) and rel <= 1e-11
    assert abs(rel - float(jrel)) <= 1e-12
    for c in range(3):
        assert _rel(x[:, c], np.linalg.solve(a, b[:, c])) < 1e-9, c
        assert _rel(x[:, c], np.asarray(jx)[:, c]) < 1e-10, c


@pytest.mark.parametrize("dtype, tol_gmres, tol_fgmres", [
    (torch.float32, 1e-4, 1e-6), (torch.float64, 1e-10, 1e-10),
])
def test_breakdown_stays_finite(dtype, tol_gmres, tol_fgmres):
    """Columns that converge (or are zero) before the basis fills yield
    finite, accurate solutions (reference test_krylov.py:178-265): rhs
    columns spanning 9 orders of magnitude with an exact zero column and
    a basis far larger than needed, then restarted cycles, then the ADI
    pattern of re-solving a small previous solution."""
    n = 48
    a, rng = _nonsymmetric(n, 3, 0.05)
    b = rng.standard_normal((n, 4))
    b[:, 1] *= 1e-6
    b[:, 2] = 0.0
    b[:, 3] *= 1e3
    at, bt = _t(a, dtype), _t(b, dtype)

    def matvec(x):
        return at @ x

    x, _ = tk.gmres(matvec, bt, n_iter=40)
    assert torch.isfinite(x).all()
    err = np.abs(a @ x.double().numpy() - b)
    assert err[:, 0].max() < tol_gmres * np.abs(b[:, 0]).max()
    assert err[:, 3].max() < tol_gmres * np.abs(b[:, 3]).max()
    assert x[:, 2].abs().max() < (1e-6 if dtype == torch.float32 else 1e-12)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    jx, _ = jk.gmres(lambda v: jnp.asarray(a, jdt) @ v, jnp.asarray(b, jdt),
                     n_iter=40)
    assert np.isfinite(np.asarray(jx)).all()
    assert _rel(x, np.asarray(jx)) < (
        1e-5 if dtype == torch.float32 else 1e-10)

    xf, rel = tk.fgmres(matvec, bt, m=20, tol=tol_fgmres, max_cycles=8)
    assert torch.isfinite(xf).all() and rel <= tol_fgmres
    err = np.abs(a @ xf.double().numpy() - b)
    assert err[:, 0].max() < 100 * tol_fgmres * np.abs(b[:, 0]).max()

    v = bt
    for _ in range(8):
        v, _ = tk.gmres(matvec, 1e-2 * v, n_iter=30)
    assert torch.isfinite(v).all()


def test_fgmres_zero_rhs_with_warm_start():
    """A zero rhs column with a nonzero warm-start column starts from zero
    instead of amplifying x0 by 1/1e-30 (reference test_krylov.py:268)."""
    n = 32
    a, rng = _nonsymmetric(n, 5, 0.05)
    b = rng.standard_normal((n, 3)).astype(np.float32)
    b[:, 1] = 0.0
    x0 = rng.standard_normal((n, 3)).astype(np.float32)
    a32 = _t(a, torch.float32)
    x, rel = tk.fgmres(lambda v: a32 @ v, _t(b, torch.float32),
                       x0=_t(x0, torch.float32), m=20, tol=1e-6)
    assert torch.isfinite(x).all() and rel <= 1e-6
    assert x[:, 1].abs().max() < 1e-6
    err = np.abs(a @ x.double().numpy() - b)
    assert err[:, 0].max() < 1e-4 * np.abs(b[:, 0]).max()


@pytest.mark.parametrize("where", ["operator", "rhs"])
def test_fgmres_nonfinite_residual_raises(where):
    """The reference's loop condition rel > tol is false for NaN, so a
    NaN solve ends as converged; the port raises, naming the cycle."""
    n = 16
    a, rng = _nonsymmetric(n, 6, 0.05)
    b = rng.standard_normal((n, 2))
    if where == "operator":
        a[3, 5] = np.nan
    else:
        b[7, 1] = np.inf
    with pytest.raises(RuntimeError, match="cycle 1 of 8 is not finite"):
        tk.fgmres(lambda v: _t(a) @ v, _t(b), m=10, tol=1e-8)


# --- the shifted caches ------------------------------------------------------

@pytest.fixture(scope="module")
def heat_solves(heat):
    j_ops, j_sys, t_ops, t_sys, sig = heat
    at = t_ops["A"].T.toarray()
    rhs = np.random.default_rng(2).standard_normal((t_sys.n, 4))
    kr = tk.ShiftedKrylovCache.build(_t(at), t_sys.mass, sig, n_iter=25)
    lu = ShiftedLUCache.build(_t(at), t_sys.mass.todense(), sig)
    j_kr = jk.ShiftedKrylovCache.build(jnp.asarray(at), j_sys.mass,
                                       jnp.asarray(sig), n_iter=25)
    return {
        i: (kr.solve(i, _t(rhs)), lu.solve(i, _t(rhs)),
            np.asarray(j_kr.solve(jnp.int32(i), jnp.asarray(rhs))))
        for i in range(len(sig))
    }


@pytest.mark.parametrize("i", range(8))
def test_shifted_krylov_matches_lu_and_reference(heat_solves, i):
    got, lu, ref = heat_solves[i]
    assert _rel(got, lu) < 1e-8
    assert _rel(got, ref) < 1e-10


@pytest.fixture(scope="module")
def saddle_caches(cavity):
    j_ops, j_sys, t_ops, t_sys, sig = cavity
    m_d, a_d, j_d = t_sys.dense()
    kr = tk.SaddleShiftedKrylovCache.build(a_d.T, t_sys.mass, j_d, sig,
                                           n_iter=30)
    lu = SaddleShiftedLUCache.build(a_d.T, m_d, j_d, sig)
    jm, ja, jj = j_sys.dense()
    j_kr = jk.SaddleShiftedKrylovCache.build(ja.T, j_sys.mass, jj,
                                             jnp.asarray(sig), n_iter=30)
    return kr, lu, j_kr


@pytest.mark.parametrize("i", [0, 3, 7])
def test_saddle_shifted_krylov_matches_lu_and_reference(cavity,
                                                        saddle_caches, i):
    _, _, t_ops, t_sys, _ = cavity
    kr, lu, j_kr = saddle_caches
    rhs = np.random.default_rng(3).standard_normal((t_sys.n, 3))
    got = kr.solve(i, _t(rhs))
    assert _rel(got, lu.solve(i, _t(rhs))) < 1e-7
    ref = np.asarray(j_kr.solve(jnp.int32(i), jnp.asarray(rhs)))
    assert _rel(got, ref) < 1e-9
    # the solution stays in ker J
    jx = t_ops["J"] @ got.numpy()
    assert np.abs(jx).max() < 1e-8 * max(1.0, got.abs().max().item())
    u = 0.1 * np.random.default_rng(4).standard_normal((t_sys.n, t_sys.m_in))
    smw = kr.solve_smw(i, _t(u), t_sys.b, _t(rhs[:, :2]))
    assert _rel(smw, lu.solve_smw(i, _t(u), t_sys.b, _t(rhs[:, :2]))) < 1e-7


def test_adi_with_krylov_cache_matches_lu_and_reference(cavity,
                                                        saddle_caches):
    """The projected low-rank ADI factor through the Krylov cache equals
    the one through the per-shift LU cache and the reference's."""
    j_ops, j_sys, _, t_sys, sig = cavity
    kr, lu, j_kr = saddle_caches
    n_adi = 16
    sseq = cycled_shifts(np.asarray(sig), n_adi)
    iseq = cycled_shifts(np.arange(len(sig), dtype=np.int32), n_adi)
    args = dict(smw_u=torch.zeros((t_sys.n, t_sys.m_in), dtype=F64),
                smw_v=t_sys.b, mass=t_sys.mass, w=t_sys.c.T,
                sigma_seq=_t(sseq), idx_seq=[int(i) for i in iseq])
    z_kr = lowrank_adi(kr, **args)
    z_lu = lowrank_adi(lu, **args)
    j_z = j_lowrank_adi(
        j_kr, smw_u=jnp.zeros((t_sys.n, t_sys.m_in)), smw_v=j_sys.b,
        mass=j_sys.mass, w=j_sys.c.T, sigma_seq=jnp.asarray(sseq),
        idx_seq=jnp.asarray(iseq),
    )
    assert _rel(z_kr, z_lu) < 1e-6
    assert _rel(z_kr, np.asarray(j_z)) < 1e-8
